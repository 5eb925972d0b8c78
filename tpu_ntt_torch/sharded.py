"""The four-step (Bailey) decomposition of a large-n transform, on one device
and sharded over a mesh: the port of ``tpu_ntt.sharded``.

Under JAX's names: ``default_split``, ``FourStepPlan``, ``KernelFourStep``,
the chains ``fourstep_fwd_kernel``, ``fourstep_inv_kernel`` and
``fourstep_nwc_poly_mult_kernel`` (and ``fourstep_*_local``, the same chains
on a ``FourStepPlan``'s plain sub-plans), ``shard_batch`` and ``batch_pjit``
(pure data parallelism), and ``ShardedNtt``, the four-step with its stage
exchange over one mesh axis (kernel K6, ``kernels/a2a.py``).

With n = n1 * n2, the natural-order input is the row-major (n1, n2) matrix
M, i = i1 * n2 + i2, and the output index is k = k2 * n1 + k1.  With
psi1 = psi^n2 and psi2 = psi^n1, the negacyclic spectrum is

    X[k2*n1 + k1] = sum_i2 omega2^(i2*k2) * [omega^(k1*i2) * psi^i2]
                    * sum_i1 M[i1, i2] * psi1^i1 * omega1^(i1*k1)

so a forward is (1) the column pass, a negacyclic transform of length n1
down each column, (2) the mid table omega^(k1*i2) * psi^i2, (3) the row
pass, a cyclic transform of length n2 along each row; the cyclic spectrum
drops the psi factors.  The inverse runs the mirror: row inverse, the
inverse mid table, column inverse, n^-1 = n1^-1 * n2^-1 inside the two.

On the card (``KernelFourStep``): the column pass is the sub-plan's
``nwc_ntt_fwd``/``ntt_fwd`` down the columns, through its column methods
(``kernels._plan.ColumnPassPlan``): at 30 < width <= 62 (``SubPlan64``)
``csrc/nwc64.cu``'s ``nwc64_forward_cols`` and ``nwc64_inverse_cols``, at
the Goldilocks q (``GoldilocksSubPlan64``) ``csrc/gl64.cu``'s
``gl64_forward_cols`` and ``gl64_inverse_cols``, which read each tile of
adjacent columns of the natural rows once and write it once, where JAX
moves the axis in XLA around its kernel (tpu_ntt/sharded.py:419-442).  The
result is ``from_cols(transform(to_cols(x)))``, the column methods' plain
version; a sub-plan without column methods (``PlainSubPlan``) takes that
transpose route.  The mid table rides
the row kernel as its entry scale: ``ntt_fwd_scaled``, ``ntt_inv_scaled``
and, for a product, ``cyclic_poly_mult_scaled`` with pre = the forward mid
and post = the inverse mid (K1a's ``_cyclic_scaled_kernel``,
tpu_ntt/sharded.py:527-562), so no pass of its own runs between the two.
That holds for both families: JAX folds the mids into its row kernel only
below q = 2^62 and multiplies them in XLA for Goldilocks (``row_scales`` is
``None`` there, tpu_ntt/sharded.py:444-460, :557-560); the port's Goldilocks
row kernels take them as plain tables, one phi-fold product each.  A
``FourStepPlan`` runs the same chains on ``PlainSubPlan``s, torch ops over
``ntt`` and ``ring.mul_tw`` for the rings no sub-plan kernel covers (24-bit
q, sub-sizes below 32 points), as JAX runs its XLA no-gather locals there.

Layout.  The column pass emits k1 bit-reversed (the sub-plan's order), so
row j1 of the mid tables takes k1 = bitrev(j1); the row pass emits k2
bit-reversed.  Position j1 * n2 + j2 then holds X[bitrev(j2) * n1 +
bitrev(j1)], which is X[bitrev_n(j1 * n2 + j2)]: the flat plans' own
bit-reversed order, so one layout map serves every n of the family.
(JAX's sub-kernels emit their four-step order instead, so its mid rows are
permuted by that map, sharded.py:380-383; ``convert`` maps its layouts.)

Tables: the sub-plans are of n1 and n2 points; the four mid tables are
(n1, n2) tables in the ring's twiddle form (Shoup pairs (w, w'), or (w,)
of plain values for Goldilocks) built on first use, each row a geometric
sequence in Python ints (about a second each at n = 2^20).  No plan of n
points is built: its tables take tens of seconds at 2^20.

The mesh.  JAX runs one controller that drives every device of a mesh
through ``shard_map``; so does the port, in one process: a ``Mesh`` is an
array of ``torch.device``s, a ``ShardedTensor`` holds one tensor a mesh
position, and ``ShardedNtt`` loops over the shards.  ``make_mesh`` puts its
shards on one card by default, as logical shards, or on the devices it is
given.  ``ShardedNtt`` keeps JAX's layout contract: a natural element is
(..., n1, n2) with axis -1 split over ``coeff_axis``, a four-step one
(a spectrum) with axis -2 split; each shard runs the column pass on its
(..., n1, n2 / D) block, one exchange (``fused_exchange=True``: K6's
kernel, ``kernels.a2a.all_to_all``; False, JAX's default: its plain
version, the counterpart of ``jax.lax.all_to_all``) gives it rows
[me * n1 / D, (me + 1) * n1 / D), and its row kernel scales them by the
same rows of the mid tables.  JAX multiplies by the mid before the
exchange (tpu_ntt/sharded.py:798, :823); the port folds it into the row
kernel, as on one device, so a sharded op's result is the single-device
chain's, bit for bit, and its spectra are in the same layout and domain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import ntt, reference
from .modmath import GOLDILOCKS_Q, make_ring
from .params import NttParams, Reduction


def default_split(n: int) -> tuple[int, int]:
    """Balanced n = n1 * n2 (n1 >= n2, both powers of two), the larger
    factor to the column pass for odd log2(n): ``tpu_ntt.sharded
    .default_split``."""
    log_n = n.bit_length() - 1
    n1 = 1 << (log_n - log_n // 2)
    return n1, n // n1


class FourStepPlan:
    """The constants of the four-step at one parameter set and split: the
    sub-parameters, the bit-reversal of the column index and the mid
    tables, built on first use in the ring's twiddle form on ``device``,
    and the column and row sub-plans ``col_k`` and ``row_k``: here
    ``PlainSubPlan``s, any ring and any n1, n2 (JAX's XLA locals)."""

    def __init__(self, p: NttParams, n1: int, n2: int, device=None):
        if n1 * n2 != p.n:
            raise ValueError(f"n1*n2 = {n1 * n2} != n = {p.n}")
        self.p, self.n1, self.n2 = p, n1, n2
        self.device = ntt.resolve_device(device)
        q = p.q
        self.col_params = NttParams(n=n1, q=q, psi=pow(p.psi, n2, q),
                                    name=f"{p.name}_col")
        self.row_params = NttParams(n=n2, q=q, psi=pow(p.psi, n1, q),
                                    name=f"{p.name}_row")
        self.ring = make_ring(p, Reduction.SHOUP)
        self.brv1 = reference.bit_reverse_permutation(n1)

    def _mid(self, root: int, fold: int) -> tuple:
        """The (n1, n2) table (root^k1 * fold)^i2 with k1 = bitrev(j1) at
        row j1, one geometric row a column position: a Shoup pair (w, w'),
        or for Goldilocks, whose ring encodes plain values, (w,)."""
        q, vals = self.p.q, []
        for j1 in range(self.n1):
            rho = pow(root, self.brv1[j1], q) * fold % q
            cur = 1
            for _ in range(self.n2):
                vals.append(cur)
                cur = cur * rho % q
        tw = self.ring.encode_tw(vals, self.device)
        if isinstance(tw, torch.Tensor):
            tw = (tw,)
        return tuple(t.reshape(self.n1, self.n2) for t in tw)

    @functools.cached_property
    def kmid(self):
        """omega^(k1*i2): the cyclic forward's mid table."""
        return self._mid(self.p.omega, 1)

    @functools.cached_property
    def kmid_inv(self):
        return self._mid(self.p.omega_inv, 1)

    @functools.cached_property
    def kmid_nwc(self):
        """omega^(k1*i2) * psi^i2: the negacyclic forward's, the outer twist
        folded in."""
        return self._mid(self.p.omega, self.p.psi)

    @functools.cached_property
    def kmid_inv_nwc(self):
        return self._mid(self.p.omega_inv, self.p.psi_inv)

    def spectrum_indices(self) -> np.ndarray:
        """(n1, n2) array: the natural spectrum index held at transform
        position [j1, j2], bitrev(j2) * n1 + bitrev(j1) (the module
        docstring's layout)."""
        brv2 = np.asarray(reference.bit_reverse_permutation(self.n2))
        return brv2[None, :] * self.n1 + np.asarray(self.brv1)[:, None]

    @functools.cached_property
    def col_k(self):
        return PlainSubPlan(self.col_params, self.device)

    @functools.cached_property
    def row_k(self):
        return PlainSubPlan(self.row_params, self.device)

    def to_cols(self, *xs: torch.Tensor, width: int | None = None) -> torch.Tensor:
        """(R, n1 * width) rows, each an (n1, width) matrix (by default
        width = n2: natural rows; a shard's block is narrower) -> (len(xs) *
        R * width, n1): each column of each matrix as a contiguous row, the
        xs stacked."""
        width = width or self.n2
        rows = xs[0].numel() // (self.n1 * width)
        out = xs[0].new_empty((len(xs), rows, width, self.n1))
        for dst, x in zip(out, xs):
            dst.copy_(x.reshape(rows, self.n1, width).transpose(1, 2))
        return out.reshape(len(xs) * rows * width, self.n1)

    def from_cols(self, y: torch.Tensor, width: int | None = None) -> torch.Tensor:
        """The inverse of ``to_cols``: (R * width, n1) -> (R, n1 * width)."""
        width = width or self.n2
        rows = y.numel() // (self.n1 * width)
        return (y.reshape(rows, width, self.n1).transpose(1, 2)
                .contiguous().reshape(rows, self.n1 * width))

    def as_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(R, n) -> (R * n1, n2): the rows of each polynomial's matrix."""
        return x.reshape(x.numel() // self.n2, self.n2)


class PlainSubPlan:
    """A sub-transform of the four-step as plain torch ops over ``ntt`` and
    ``ring.mul_tw``, for the rings no sub-plan kernel covers (24-bit q,
    sub-sizes below 32 points): JAX runs its XLA no-gather locals there
    (tpu_ntt/sharded.py:278-316).  Its methods are those of the kernel
    sub-plans' (``kernels._plan.ScaledKernelPlan``), with their meanings, so
    one chain serves both; spectra are bit-reversed, and a cacheable one is
    in the plain domain, as JAX's XLA-locals spectra are."""

    def __init__(self, p: NttParams, device):
        self.p = p
        self.plan = ntt.NttPlan(p, Reduction.SHOUP, device)
        self.ring = self.plan.ring

    def ntt_fwd(self, x):
        return ntt.ntt_fwd_bitrev(self.plan, x)

    def ntt_inv(self, x):
        return ntt.ntt_inv_bitrev(self.plan, x)

    def nwc_ntt_fwd(self, x):
        return ntt.nwc_fwd_merged(self.plan, x)

    def nwc_ntt_inv(self, x):
        return ntt.nwc_inv_merged(self.plan, x)

    def _times(self, x, table):
        """Row r of the (..., B, n) x times row r % P of a (P, n) mid table
        (a Shoup pair, or the 1-tuple of Goldilocks' plain values)."""
        period, n = table[0].shape
        tw = table if len(table) == 2 else table[0]
        return self.ring.mul_tw(x.reshape(-1, period, n), tw).reshape(x.shape)

    def ntt_fwd_scaled(self, x, pre, cacheable=False):
        """NTT(pre . x); ``cacheable`` changes nothing: the plain domain."""
        return self.ntt_fwd(self._times(x, pre))

    def ntt_inv_scaled(self, x, post):
        return self._times(self.ntt_inv(x), post)

    def cyclic_poly_mult_scaled(self, a, b, pre, post):
        return self.cyclic_poly_mult_cached_scaled(a, self.ntt_fwd_scaled(b, pre), pre, post)

    def cyclic_poly_mult_cached_scaled(self, a, spectrum, pre, post):
        return self.ntt_inv_scaled(self.ring.mul(self.ntt_fwd_scaled(a, pre), spectrum), post)

    def dot_scaled(self, a, b, pre, post, cached=False):
        fb = b if cached else self.ntt_fwd_scaled(b, pre)
        c = self.ring.mul(self.ntt_fwd_scaled(a, pre), fb)
        acc = c[0]
        for k in range(1, c.shape[0]):
            acc = self.ring.add(acc, c[k])
        return self.ntt_inv_scaled(acc, post)


class KernelFourStep(FourStepPlan):
    """The four-step on the card: sub-plan kernels for the column and row
    passes, 32 <= n1, n2 <= 8192: ``SubPlan64`` at 30 < width <= 62 (q <
    2^62: the strict Shoup folds of the row kernel), ``GoldilocksSubPlan64``
    at q = 2^64 - 2^32 + 1 (plain tables, phi-fold products)."""

    @staticmethod
    def sub_plan(q: int):
        """The sub-plan class of the four-step at q."""
        from .kernels.gl64 import GoldilocksSubPlan64  # kernels imports this module
        from .kernels.mxu64 import SubPlan64

        return GoldilocksSubPlan64 if q == GOLDILOCKS_Q else SubPlan64

    @classmethod
    def supported(cls, p: NttParams, n1: int, n2: int) -> bool:
        """Both sub-transforms have a kernel (no table is built)."""
        sub = cls.sub_plan(p.q)
        return sub.covers(n1, p.q) and sub.covers(n2, p.q)

    def __init__(self, p: NttParams, n1: int, n2: int, device=None):
        if not self.supported(p, n1, n2):
            raise ValueError(f"no kernel covers the sub-transforms n1={n1}, "
                             f"n2={n2} at width {p.width}")
        super().__init__(p, n1, n2, device)
        sub = self.sub_plan(p.q)
        self.col_k = sub(self.col_params, self.device)
        self.row_k = sub(self.row_params, self.device)



def _run(plan, method: str, plain: bool, *args):
    """A sub-plan's method, or with ``plain`` its plain version on any
    device (the chain's plain version, which chip_smoke.py compares)."""
    return getattr(plan, method + "_plain" if plain else method)(*args)


def columns(fs: FourStepPlan, method: str, plain: bool, *xs: torch.Tensor,
            width: int | None = None) -> torch.Tensor:
    """The column transforms ``method`` (``ntt_fwd``, ``nwc_ntt_fwd``,
    ``ntt_inv`` or ``nwc_ntt_inv`` of ``fs.col_k``) down every column of
    each of xs, (R, n1 * width) natural rows (by default width = n2; a
    shard's block is narrower), out stacked as (len(xs) * R, n1 * width)
    rows in the same layout.  A sub-plan with column methods
    (``SubPlan64``'s and ``GoldilocksSubPlan64``'s ``*_cols``) writes each
    operand's columns in place of the transposes; any other takes the
    transposes around its row method."""
    width, col = width or fs.n2, fs.col_k
    if hasattr(col, method + "_cols"):
        out = xs[0].new_empty((len(xs), xs[0].numel()))
        for dst, x in zip(out, xs):
            _run(col, method + "_cols", plain, x, width, dst)
        return out.reshape(-1, fs.n1 * width)
    return fs.from_cols(_run(col, method, plain, fs.to_cols(*xs, width=width)), width=width)


def column_fwd(fs: FourStepPlan, nwc: bool, plain: bool, *xs: torch.Tensor) -> torch.Tensor:
    """The column pass of (R, n) natural rows, several stacked: the column
    transforms (negacyclic with ``nwc``), out as the (len(xs) * R * n1, n2)
    rows the row kernels take."""
    return fs.as_rows(columns(fs, "nwc_ntt_fwd" if nwc else "ntt_fwd", plain, *xs))


def column_inv(fs: FourStepPlan, y: torch.Tensor, nwc: bool, plain: bool) -> torch.Tensor:
    """The inverse column pass of (R * n1, n2) rows out of a row kernel:
    (R, n) natural rows."""
    return columns(fs, "nwc_ntt_inv" if nwc else "ntt_inv", plain,
                   y.reshape(-1, fs.n1 * fs.n2))


def fourstep_fwd_kernel(fs: FourStepPlan, x: torch.Tensor, nwc: bool = False,
                        cacheable: bool = False, plain: bool = False) -> torch.Tensor:
    """Forward four-step of (R, n) natural rows, bit-reversed spectra out:
    cyclic, or with ``nwc`` negacyclic (the outer twist in the column pass
    and the mid table); ``cacheable`` multiplies by the row plan's domain
    factor in the row kernel (the cached-spectrum domain: 2^64 mod q, or 1
    for Goldilocks)."""
    pre = fs.kmid_nwc if nwc else fs.kmid
    y = _run(fs.row_k, "ntt_fwd_scaled", plain, column_fwd(fs, nwc, plain, x), pre, cacheable)
    return y.reshape(x.shape)


def fourstep_inv_kernel(fs: FourStepPlan, x: torch.Tensor, nwc: bool = False,
                        plain: bool = False) -> torch.Tensor:
    """Inverse of ``fourstep_fwd_kernel``: (R, n) bit-reversed spectra in,
    natural rows out, n^-1 (and with ``nwc`` the untwist) applied."""
    post = fs.kmid_inv_nwc if nwc else fs.kmid_inv
    y = _run(fs.row_k, "ntt_inv_scaled", plain, fs.as_rows(x), post)
    return column_inv(fs, y, nwc, plain).reshape(x.shape)


def fourstep_nwc_poly_mult_kernel(fs: FourStepPlan, a: torch.Tensor,
                                  b: torch.Tensor, nwc: bool = True,
                                  plain: bool = False) -> torch.Tensor:
    """a * b mod (x^n + 1, q) for (R, n) rows (with ``nwc=False`` mod
    x^n - 1): one column forward over a and b together, one row kernel
    for the mid tables, both row forwards, the slot products and the row
    inverse (``cyclic_poly_mult_scaled``: post . INTT(NTT(pre . a) o
    NTT(pre . b)) is the row transforms' product by the convolution
    theorem, tpu_ntt/sharded.py:536-546), one column inverse."""
    m = column_fwd(fs, nwc, plain, a, b)
    ma, mb = m.chunk(2)
    pre, post = (fs.kmid_nwc, fs.kmid_inv_nwc) if nwc else (fs.kmid, fs.kmid_inv)
    c = _run(fs.row_k, "cyclic_poly_mult_scaled", plain, ma, mb, pre, post)
    return column_inv(fs, c, nwc, plain).reshape(a.shape)


# JAX names the chains on its XLA locals apart (tpu_ntt/sharded.py:278-316);
# here one chain serves both kinds of plan, run on a FourStepPlan's
# PlainSubPlans: torch ops on any device.
fourstep_fwd_local = fourstep_fwd_kernel
fourstep_inv_local = fourstep_inv_kernel
fourstep_nwc_poly_mult_local = fourstep_nwc_poly_mult_kernel


# ---------------------------------------------------------------------------
# The mesh and sharded tensors
# ---------------------------------------------------------------------------


class Mesh:
    """An array of ``torch.device``s with a name for each axis, the
    counterpart of ``jax.sharding.Mesh``; a device may repeat (logical
    shards of one card)."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if devices.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {devices.shape} needs {devices.ndim} "
                             f"distinct axis names, got {names}")
        self.devices = devices
        self.axis_names = names

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device_list(self) -> list:
        """The devices in mesh order (row-major over the axes)."""
        return list(self.devices.flat)

    def coords(self, index: int) -> dict:
        """Axis name -> coordinate of the index-th position in mesh order."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(index, self.devices.shape))))

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.device_list() == other.device_list())

    __hash__ = None

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"


def make_mesh(shape, names, device=None) -> Mesh:
    """A mesh of prod(shape) shards: by default all on the current CUDA
    device (logical shards of one card), which must exist; ``device="cpu"``
    (or any one device) for all on it; or a sequence of prod(shape)
    devices, one a position in mesh order."""
    shape = tuple(shape)
    size = int(np.prod(shape, dtype=np.int64))
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a mesh of CPU shards")
    if device is None or isinstance(device, (str, torch.device)):
        devices = [ntt.resolve_device(device)] * size
    else:
        devices = [ntt.resolve_device(d) for d in device]
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a mesh of {size} positions")
    grid = np.empty(size, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    return Mesh(grid.reshape(shape), names)


class ShardedTensor:
    """A tensor split over a mesh, the counterpart of a JAX array with a
    ``NamedSharding``: ``spec`` names, for each dimension, the mesh axis it
    is split over, or None (``PartitionSpec``'s entries); ``shards`` holds
    one tensor a mesh position, in mesh order, each on its position's
    device.  Positions that differ only on axes the spec does not name hold
    replicas."""

    def __init__(self, mesh: Mesh, spec, shards):
        self.mesh, self.spec, self.shards = mesh, tuple(spec), list(shards)
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of {mesh.size}")
        for name in self.spec:
            if name is not None and name not in mesh.axis_names:
                raise ValueError(f"spec {self.spec} names no axis of {mesh.axis_names}")
        for s, d in zip(self.shards, mesh.device_list()):
            if s.dim() != len(self.spec) or s.shape != self.shards[0].shape:
                raise ValueError(f"a shard of shape {tuple(s.shape)} under spec {self.spec}")
            if s.device != d:
                raise ValueError(f"a shard is on {s.device}, its mesh position on {d}")

    @property
    def shape(self) -> tuple:
        """The global shape."""
        sizes = self.mesh.shape
        return tuple(k * (sizes[name] if name else 1)
                     for k, name in zip(self.shards[0].shape, self.spec))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def _index(self, i: int) -> tuple:
        """The global slices the i-th shard holds."""
        coords = self.mesh.coords(i)
        return tuple(slice(coords[name] * k, (coords[name] + 1) * k) if name else slice(None)
                     for k, name in zip(self.shards[0].shape, self.spec))

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (by default the first shard's)."""
        device = self.shards[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for i, s in enumerate(self.shards):
            out[self._index(i)].copy_(s)
        return out


def shard(mesh: Mesh, spec, x: torch.Tensor) -> ShardedTensor:
    """Split the global tensor x over the mesh by ``spec`` (padded with None
    to x's dimensions): a contiguous copy of each block on its position's
    device, as ``jax.device_put`` with a ``NamedSharding`` places it."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    sizes = mesh.shape
    for k, name in zip(x.shape, spec):
        if name is not None and (name not in sizes or k % sizes[name]):
            raise ValueError(f"cannot split {tuple(x.shape)} by {spec} over {sizes}")
    shards = []
    for i, device in enumerate(mesh.device_list()):
        coords = mesh.coords(i)
        index = tuple(slice(coords[name] * (k // sizes[name]),
                            (coords[name] + 1) * (k // sizes[name])) if name else slice(None)
                      for k, name in zip(x.shape, spec))
        shards.append(x[index].to(device, memory_format=torch.contiguous_format, copy=True))
    return ShardedTensor(mesh, spec, shards)


# ---------------------------------------------------------------------------
# Batch data parallelism
# ---------------------------------------------------------------------------


def shard_batch(mesh: Mesh, axis: str, x: torch.Tensor) -> ShardedTensor:
    """x with its leading (batch) axis split over ``axis``, every other axis
    whole: ``tpu_ntt.sharded.shard_batch``."""
    return shard(mesh, (axis,), x)


def _plan_on(plan, device: torch.device):
    """``plan``'s parameters on ``device``: the plan itself where it lies
    there (or where it has no device, as an ``NttParams``), else a new one."""
    if getattr(plan, "device", device) == device:
        return plan
    if isinstance(plan, ntt.NttPlan):
        return ntt.NttPlan(plan.p, plan.ring.reduction, device)
    return type(plan)(plan.p, device)


def batch_pjit(plan, fn, mesh: Mesh, axis: str = "batch"):
    """``run(*elems)``: ``fn(plan, *shards)`` on each mesh position's shards,
    every argument and result split on its leading (batch) axis over
    ``axis`` (a global tensor is split first); ``tpu_ntt.sharded.batch_pjit``.
    Pure data parallelism: each shard runs the single-device path (its
    kernels, unchanged) with a plan of the same parameters on its device,
    and no exchange runs."""
    plans = {}

    def run(*elems):
        parts = []
        for e in elems:
            if not isinstance(e, ShardedTensor):
                e = shard_batch(mesh, axis, e)
            if e.mesh != mesh or e.spec != (axis,) + (None,) * (len(e.spec) - 1):
                raise ValueError(f"an argument is split by {e.spec} over {e.mesh}, "
                                 f"not on its leading axis over {axis!r} of {mesh}")
            parts.append(e.shards)
        outs = []
        for i, device in enumerate(mesh.device_list()):
            if device not in plans:
                plans[device] = _plan_on(plan, device)
            outs.append(fn(plans[device], *(p[i] for p in parts)))
        return ShardedTensor(mesh, (axis,) + (None,) * (outs[0].dim() - 1), outs)

    return run


# ---------------------------------------------------------------------------
# The mesh-sharded four-step
# ---------------------------------------------------------------------------

_MIDS = ("kmid", "kmid_inv", "kmid_nwc", "kmid_inv_nwc")


def _fourstep_on(fs: FourStepPlan, device: torch.device) -> FourStepPlan:
    """fs itself on its device; elsewhere a plan of the same kind and split
    whose built mid tables are fs's, copied."""
    if fs.device == device:
        return fs
    copy = type(fs)(fs.p, fs.n1, fs.n2, device)
    for name in _MIDS:
        if name in fs.__dict__:
            copy.__dict__[name] = tuple(t.to(device) for t in fs.__dict__[name])
    return copy


class ShardedNtt:
    """The four-step of ``fs`` sharded over ``coeff_axis`` of ``mesh``:
    ``tpu_ntt.sharded.ShardedNtt`` (tpu_ntt/sharded.py:691-1013).

    Layout contract (JAX's): natural-layout elements are (..., n1, n2) with
    the last axis split over ``coeff_axis`` (and the leading batch axis, if
    any, over ``batch_axis`` when given); four-step-layout (transform-domain)
    elements are (..., n1, n2) with axis -2 split over ``coeff_axis``.  The
    transform domain is the single-device chain's: bit-reversed (the module
    docstring), a cached spectrum in the row plan's domain (times 2^64 mod q
    at 30 < width <= 62 on a ``KernelFourStep``, plain for Goldilocks and on
    a plain ``FourStepPlan``), so spectra move between this and
    ``kernels.fourstep64.FourStepPlan64`` of the same fs unchanged.

    Each op takes and returns ``ShardedTensor``s on ``mesh`` (``put_natural``
    makes them).  A ``KernelFourStep`` runs the sub-plan kernels on CUDA
    shards (their plain versions on CPU shards); a ``FourStepPlan`` its
    ``PlainSubPlan``s on either.  One exchange a transform: the forward of
    a product stacks a and b (the dot its 2K operands) into one call, so a
    product makes two calls of D launches, moving the bytes of JAX's three
    all-to-alls.  ``fused_exchange=True`` runs K6 (``kernels.a2a.all_to_all``),
    False, JAX's default, its plain version (``all_to_all_plain``)."""

    def __init__(self, fs: FourStepPlan, mesh: Mesh, coeff_axis: str = "coeff",
                 batch_axis: str | None = None, fused_exchange: bool = False):
        if coeff_axis not in mesh.shape or (batch_axis is not None
                                            and batch_axis not in mesh.shape):
            raise ValueError(f"axes {coeff_axis!r}, {batch_axis!r} are not all in "
                             f"{mesh.axis_names}")
        self.fs, self.mesh = fs, mesh
        self.coeff_axis, self.batch_axis = coeff_axis, batch_axis
        self.fused_exchange = fused_exchange
        self.d = mesh.shape[coeff_axis]
        if fs.n2 % self.d or fs.n1 % self.d:
            raise ValueError(f"n1={fs.n1} and n2={fs.n2} must be divisible by mesh "
                             f"axis size {self.d}")
        kinds = {d.type for d in mesh.device_list()}
        if not kinds <= {"cpu", "cuda"} or len(kinds) > 1:
            raise ValueError(f"a mesh on {sorted(kinds)}: its shards must all lie on "
                             "the CPU or all on CUDA devices")
        axis = mesh.axis_names.index(coeff_axis)
        positions = np.arange(mesh.size).reshape(mesh.devices.shape)
        #: the mesh positions of each exchange, in coeff order
        self._groups = np.moveaxis(positions, axis, -1).reshape(-1, self.d).tolist()
        self._me = [mesh.coords(i)[coeff_axis] for i in range(mesh.size)]
        self._devices = mesh.device_list()
        self._plans = {}

    # -- specs ---------------------------------------------------------------
    def _spec(self, batched: bool, shard_from_end: int, stacked: bool = False) -> tuple:
        lead = ((None,) if stacked else ()) + ((self.batch_axis,) if batched else ())
        tail = [None, None]
        tail[2 - shard_from_end] = self.coeff_axis
        return (*lead, *tail)

    def spec_natural(self, batched: bool = True, stacked: bool = False) -> tuple:
        return self._spec(batched, 1, stacked)

    def spec_fourstep(self, batched: bool = True, stacked: bool = False) -> tuple:
        return self._spec(batched, 2, stacked)

    def put_natural(self, x: torch.Tensor, batched: bool = True,
                    stacked: bool = False) -> ShardedTensor:
        return shard(self.mesh, self.spec_natural(batched, stacked), x)

    # -- the pieces ----------------------------------------------------------
    def _plan(self, i: int) -> FourStepPlan:
        device = self._devices[i]
        if device not in self._plans:
            self._plans[device] = _fourstep_on(self.fs, device)
        return self._plans[device]

    def _mid(self, i: int, name: str) -> tuple:
        """The rows of mid table ``name`` that shard i's rows meet."""
        h = self.fs.n1 // self.d
        lo = self._me[i] * h
        return tuple(t[lo:lo + h] for t in getattr(self._plan(i), name))

    def _local(self, x: ShardedTensor, spec: tuple):
        """x's leading local dimensions and its shards as (L, rows, cols)
        blocks, after checking it is laid out by ``spec`` on this mesh."""
        if not isinstance(x, ShardedTensor) or x.mesh != self.mesh or x.spec != spec:
            got = (x.spec, x.mesh) if isinstance(x, ShardedTensor) else type(x).__name__
            raise ValueError(f"expected a ShardedTensor split by {spec} over {self.mesh}, "
                             f"got {got}")
        *lead, rows, cols = x.shards[0].shape
        return tuple(lead), [s.reshape(-1, rows, cols) for s in x.shards]

    def _exchange(self, blocks: list, split_from_end: int) -> list:
        """The stage exchange of every group of peers on the coeff axis."""
        from .kernels import a2a  # kernels imports this module

        run = a2a.all_to_all if self.fused_exchange else a2a.all_to_all_plain
        out = [None] * len(blocks)
        for group in self._groups:
            for i, y in zip(group, run([blocks[i] for i in group], split_from_end)):
                out[i] = y
        return out

    def _columns(self, i: int, method: str, *blocks: torch.Tensor) -> torch.Tensor:
        """Column pass ``method`` of shard i's sub-plan on its natural
        (L, n1, n2 / D) blocks, stacked (``columns``)."""
        width = self.fs.n2 // self.d
        flat = [b.reshape(-1, self.fs.n1 * width) for b in blocks]
        return columns(self._plan(i), method, False, *flat,
                       width=width).reshape(-1, self.fs.n1, width)

    def _forward(self, operands: list, nwc: bool) -> list:
        """Column forwards of each shard's operands, stacked, then the
        forward exchange: (sum of L, n1 / D, n2) blocks of column spectra
        (the mid not applied)."""
        method = "nwc_ntt_fwd" if nwc else "ntt_fwd"
        return self._exchange([self._columns(i, method, *(op[i] for op in operands))
                               for i in range(len(operands[0]))], 2)

    def _inverse(self, blocks: list, nwc: bool) -> list:
        """The inverse exchange of (L, n1 / D, n2) blocks out of the row
        pass, then the column inverses: natural (L, n1, n2 / D) blocks."""
        method = "nwc_ntt_inv" if nwc else "ntt_inv"
        return [self._columns(i, method, y) for i, y in enumerate(self._exchange(blocks, 1))]

    def _rows(self, y: torch.Tensor) -> torch.Tensor:
        return y.reshape(-1, self.fs.n2)

    def _result(self, blocks: list, lead: tuple, spec: tuple) -> ShardedTensor:
        return ShardedTensor(self.mesh, spec, [b.reshape(*lead, *b.shape[-2:])
                                               for b in blocks])

    # -- public transforms ---------------------------------------------------
    def ntt_fwd(self, x: ShardedTensor, batched: bool = True) -> ShardedTensor:
        """Sharded cyclic forward NTT: natural layout -> four-step layout."""
        return self._spectra(x, batched, False)

    def nwc_spectrum(self, x: ShardedTensor, batched: bool = True) -> ShardedTensor:
        """The cacheable negacyclic spectrum (four-step layout, the row
        plan's domain) for ``nwc_poly_mult_cached`` and ``nwc_dot_cached``."""
        return self._spectra(x, batched, True)

    def _spectra(self, x, batched, nwc):
        lead, xs = self._local(x, self.spec_natural(batched))
        pre = "kmid_nwc" if nwc else "kmid"
        out = [self._plan(i).row_k.ntt_fwd_scaled(self._rows(m), self._mid(i, pre), nwc)
               .reshape(m.shape) for i, m in enumerate(self._forward([xs], nwc))]
        return self._result(out, lead, self.spec_fourstep(batched))

    def ntt_inv(self, x: ShardedTensor, batched: bool = True) -> ShardedTensor:
        """Sharded cyclic inverse NTT: four-step layout -> natural layout."""
        lead, xs = self._local(x, self.spec_fourstep(batched))
        rows = [self._plan(i).row_k.ntt_inv_scaled(self._rows(y), self._mid(i, "kmid_inv"))
                .reshape(y.shape) for i, y in enumerate(xs)]
        return self._result(self._inverse(rows, False), lead, self.spec_natural(batched))

    def nwc_poly_mult(self, a: ShardedTensor, b: ShardedTensor,
                      batched: bool = True) -> ShardedTensor:
        """Sharded negacyclic product, natural layout in and out."""
        return self._product(a, b, batched, True)

    def cyclic_poly_mult(self, a: ShardedTensor, b: ShardedTensor,
                         batched: bool = True) -> ShardedTensor:
        """Sharded cyclic product INTT(NTT(a) . NTT(b))."""
        return self._product(a, b, batched, False)

    def _product(self, a, b, batched, nwc):
        spec = self.spec_natural(batched)
        lead, xa = self._local(a, spec)
        _, xb = self._local(b, spec)
        if a.shape != b.shape:
            raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
        pre, post = ("kmid_nwc", "kmid_inv_nwc") if nwc else ("kmid", "kmid_inv")
        rows = []
        for i, m in enumerate(self._forward([xa, xb], nwc)):
            ma, mb = m.chunk(2)
            rows.append(self._plan(i).row_k.cyclic_poly_mult_scaled(
                self._rows(ma), self._rows(mb), self._mid(i, pre), self._mid(i, post))
                .reshape(ma.shape))
        return self._result(self._inverse(rows, nwc), lead, spec)

    def nwc_poly_mult_cached(self, a: ShardedTensor, spectrum: ShardedTensor,
                             batched: bool = True) -> ShardedTensor:
        """Sharded negacyclic product against a cached ``nwc_spectrum``: two
        exchanges instead of three."""
        lead, xa = self._local(a, self.spec_natural(batched))
        _, spec = self._local(spectrum, self.spec_fourstep(batched))
        rows = [self._plan(i).row_k.cyclic_poly_mult_cached_scaled(
                    self._rows(m), self._rows(spec[i]), self._mid(i, "kmid_nwc"),
                    self._mid(i, "kmid_inv_nwc")).reshape(m.shape)
                for i, m in enumerate(self._forward([xa], True))]
        return self._result(self._inverse(rows, True), lead, self.spec_natural(batched))

    def nwc_dot(self, a: ShardedTensor, b: ShardedTensor,
                batched: bool = True) -> ShardedTensor:
        """Sharded fused inner product INTT(sum_k NTT(a_k) . NTT(b_k)): a, b
        are K-stacked natural elements (K, [B,] n1, n2); the ([B,] n1, n2)
        sum of negacyclic products out, one inverse exchange for it."""
        spec = self.spec_natural(batched, stacked=True)
        lead, xa = self._local(a, spec)
        _, xb = self._local(b, spec)
        if a.shape != b.shape:
            raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
        return self._dot(lead, self._forward([xa, xb], True), None, batched)

    def nwc_dot_cached(self, a: ShardedTensor, spectra: ShardedTensor,
                       batched: bool = True) -> ShardedTensor:
        """The sharded dot against K-stacked ``nwc_spectrum`` outputs
        (four-step layout, split by ``spec_fourstep(batched, stacked=True)``)."""
        lead, xa = self._local(a, self.spec_natural(batched, stacked=True))
        _, xs = self._local(spectra, self.spec_fourstep(batched, stacked=True))
        return self._dot(lead, self._forward([xa], True), xs, batched)

    def _dot(self, lead, m, spectra, batched):
        if not lead or lead[0] < 1:
            raise ValueError("the dot needs K >= 1 stacked terms")
        terms, n2, out = lead[0], self.fs.n2, []
        for i, mi in enumerate(m):  # a's K blocks, then b's where fresh
            parts = mi.reshape(1 if spectra else 2, terms, -1, n2)
            b = spectra[i].reshape(terms, -1, n2) if spectra else parts[1]
            c = self._plan(i).row_k.dot_scaled(parts[0], b, self._mid(i, "kmid_nwc"),
                                               self._mid(i, "kmid_inv_nwc"),
                                               bool(spectra))
            out.append(c.reshape(-1, *mi.shape[1:]))
        return self._result(self._inverse(out, True), lead[1:], self.spec_natural(batched))

    def jit_nwc_poly_mult(self, batched: bool = True):
        """The sharded product as a closure (JAX's jitted one: there is
        nothing to compile here)."""
        return functools.partial(self.nwc_poly_mult, batched=batched)

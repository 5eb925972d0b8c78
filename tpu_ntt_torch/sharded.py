"""The four-step (Bailey) decomposition of a large-n transform, on one device.

The single-device half of ``tpu_ntt.sharded``, under its names:
``default_split``, ``FourStepPlan``, ``KernelFourStep`` and the functions
``fourstep_fwd_kernel``, ``fourstep_inv_kernel`` and
``fourstep_nwc_poly_mult_kernel``.  The mesh-sharded half (``ShardedNtt``
and its all-to-all, kernel K6) needs more than one card: ROADMAP.md Q1.11.

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
``nwc_ntt_fwd``/``ntt_fwd`` (``SubPlan64`` on ``csrc/nwc64.cu``'s
``nwc64_forward`` at 30 < width <= 62, ``GoldilocksSubPlan64`` on
``csrc/gl64.cu``'s ``gl64_forward`` at the Goldilocks q) on the columns,
which torch transposes into rows and back around it, as JAX moves the axis
in XLA around its kernel (tpu_ntt/sharded.py:419-442).  The mid table rides
the row kernel as its entry scale: ``ntt_fwd_scaled``, ``ntt_inv_scaled``
and, for a product, ``cyclic_poly_mult_scaled`` with pre = the forward mid
and post = the inverse mid (K1a's ``_cyclic_scaled_kernel``,
tpu_ntt/sharded.py:527-562), so no pass of its own runs between the two.
That holds for both families: JAX folds the mids into its row kernel only
below q = 2^62 and multiplies them in XLA for Goldilocks (``row_scales`` is
``None`` there, tpu_ntt/sharded.py:444-460, :557-560); the port's Goldilocks
row kernels take them as plain tables, one phi-fold product each.

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
    tables, built on first use in the ring's twiddle form on ``device``."""

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

    def to_cols(self, *xs: torch.Tensor) -> torch.Tensor:
        """(R, n) natural rows -> (len(xs) * R * n2, n1): each column of each
        row's (n1, n2) matrix as a contiguous row, the xs stacked."""
        rows = xs[0].numel() // self.p.n
        out = xs[0].new_empty((len(xs), rows, self.n2, self.n1))
        for dst, x in zip(out, xs):
            dst.copy_(x.reshape(rows, self.n1, self.n2).transpose(1, 2))
        return out.reshape(len(xs) * rows * self.n2, self.n1)

    def from_cols(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse of ``to_cols``: (R * n2, n1) -> (R, n)."""
        rows = y.numel() // self.p.n
        return (y.reshape(rows, self.n2, self.n1).transpose(1, 2)
                .contiguous().reshape(rows, self.p.n))

    def as_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(R, n) -> (R * n1, n2): the rows of each polynomial's matrix."""
        return x.reshape(x.numel() // self.n2, self.n2)


def _run(plan, method: str, plain: bool, *args):
    """A sub-plan's method, or with ``plain`` its plain version on any
    device (the chain's plain version, which chip_smoke.py compares)."""
    return getattr(plan, method + "_plain" if plain else method)(*args)


def column_fwd(fs: KernelFourStep, nwc: bool, plain: bool, *xs: torch.Tensor) -> torch.Tensor:
    """The column pass of (R, n) natural rows, several stacked: the column
    transforms (negacyclic with ``nwc``) between the transposes, out as the
    (len(xs) * R * n1, n2) rows the row kernels take."""
    col = _run(fs.col_k, "nwc_ntt_fwd" if nwc else "ntt_fwd", plain, fs.to_cols(*xs))
    return fs.as_rows(fs.from_cols(col))


def column_inv(fs: KernelFourStep, y: torch.Tensor, nwc: bool, plain: bool) -> torch.Tensor:
    """The inverse column pass of (R * n1, n2) rows out of a row kernel:
    (R, n) natural rows."""
    return fs.from_cols(_run(fs.col_k, "nwc_ntt_inv" if nwc else "ntt_inv", plain,
                             fs.to_cols(y)))


def fourstep_fwd_kernel(fs: KernelFourStep, x: torch.Tensor, nwc: bool = False,
                        cacheable: bool = False, plain: bool = False) -> torch.Tensor:
    """Forward four-step of (R, n) natural rows, bit-reversed spectra out:
    cyclic, or with ``nwc`` negacyclic (the outer twist in the column pass
    and the mid table); ``cacheable`` multiplies by the row plan's domain
    factor in the row kernel (the cached-spectrum domain: 2^64 mod q, or 1
    for Goldilocks)."""
    pre = fs.kmid_nwc if nwc else fs.kmid
    y = _run(fs.row_k, "ntt_fwd_scaled", plain, column_fwd(fs, nwc, plain, x), pre, cacheable)
    return y.reshape(x.shape)


def fourstep_inv_kernel(fs: KernelFourStep, x: torch.Tensor, nwc: bool = False,
                        plain: bool = False) -> torch.Tensor:
    """Inverse of ``fourstep_fwd_kernel``: (R, n) bit-reversed spectra in,
    natural rows out, n^-1 (and with ``nwc`` the untwist) applied."""
    post = fs.kmid_inv_nwc if nwc else fs.kmid_inv
    y = _run(fs.row_k, "ntt_inv_scaled", plain, fs.as_rows(x), post)
    return column_inv(fs, y, nwc, plain).reshape(x.shape)


def fourstep_nwc_poly_mult_kernel(fs: KernelFourStep, a: torch.Tensor,
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

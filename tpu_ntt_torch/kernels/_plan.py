"""The twelve ops of a fused NTT kernel family, shared by its word sizes.

``KernelPlan`` is what ``mxu.MxuPlan`` (int32 residues, q < 2^24,
``csrc/nwc32.cu``), ``mxu64.MxuPlan64`` (int64 residues, 30 < width <= 62,
``csrc/nwc64.cu``) and ``gl64.GoldilocksPlan64`` (wrapped int64 residues of
q = 2^64 - 2^32 + 1, ``csrc/gl64.cu``) have in common; they differ in the
dtype, the word (32 or 64 bits, which sets the Montgomery and Shoup scales),
the spectrum domain, the CUDA library and the (n, q) window.  Each source
has the same six C entry points, with the same meanings and argument order:
``<lib>_product``, ``_cached``, ``_forward``, ``_inverse``, ``_dot`` and
``_matvec``.  The Shoup families pass each twiddle table as (w, w') and
each scale as (w, w') with q and q' = -q^-1 mod 2^word; the Goldilocks
family, whose q is fixed and has no Shoup form, passes w alone.

Each op launches its kernel for a CUDA tensor and runs its plain version,
the ``*_plain`` method beside it, for a CPU tensor; any other device raises.
Nothing falls back.  ``launches`` counts the launches of each kernel in this
process, over all plans of the family; a caller that must show a run went
through a kernel sets its count to 0 first.

Spectra (the layout contract of tpu_ntt/dispatch.py:51-56):

* ``ntt_fwd`` and ``nwc_ntt_fwd`` return the plain spectrum in bit-reversed
  order: position j holds X[bitrev(j)], where X is the natural-order
  spectrum tpu_ntt's plan returns after ``fourstep_to_natural``.
  ``bitrev_to_natural_perm`` is the map; ``ntt_inv``/``nwc_ntt_inv`` take
  that order back.
* ``nwc_spectrum`` (and each block of ``nwc_matvec_spectra``) is the
  negacyclic spectrum times the family's domain factor mod q, in the same
  bit-reversed order: the domain of tpu_ntt's cached spectra (2^32 for
  ``MxuPlan``, the Montgomery-64 domain 2^64 of ``MxuPlan64`` and
  ``SolinasPlan64``, the plain domain, factor 1, of ``GoldilocksPlan64``:
  tpu_ntt/kernels/gl64.py:75-77), so ``convert`` only permutes them.
  ``nwc_poly_mult_cached``, ``nwc_dot_cached`` and ``nwc_matvec_cached``
  take it.
* ``nwc_matvec_spectra`` returns (k, l, n), not tpu_ntt's (k, l, rows, 128)
  blocks tiled over the polynomials of an MXU group: the tiling is the
  TPU's (``convert`` undoes it).

``ScaledKernelPlan`` adds the four-step's row pass (``sharded``), six more
C entry points of the same source, ``<lib>_*_scaled``: ``MxuPlan64`` and
``GoldilocksPlan64`` are such plans, their tables (w, w') or (w,).
``ColumnPassPlan`` adds its column pass, ``<lib>_forward_cols`` and
``<lib>_inverse_cols``, to the sub-plans of both (``SubPlan64``,
``GoldilocksSubPlan64``).

``bind``, ``launch``, ``check`` and ``runs_plain`` serve ``kyber.KyberPlan``
too, whose fixed ring has other ops than these twelve.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import ntt, reference
from ..params import NttParams, Reduction
from . import _build

MAX_TERMS = 8  # K of the dot, k and l of the matvec (mxu.py:777, mxu64.py:2240)


def bind(lib_name: str, argtypes: dict) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<lib_name>.cu``; type each entry
    point ``<lib_name>_<suffix>`` with ``argtypes[suffix]``, returning its
    CUDA error code."""
    lib = _build.load(lib_name)
    for suffix, types in argtypes.items():
        fn = getattr(lib, f"{lib_name}_{suffix}")
        fn.argtypes = types
        fn.restype = ctypes.c_int
    error_string = getattr(lib, f"{lib_name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load(lib_name: str, word_bits: int) -> ctypes.CDLL:
    """``bind`` the six entry points of an NTT family's source, typed with
    ``word_bits``-bit moduli and scales."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    word = ctypes.c_uint32 if word_bits == 32 else ctypes.c_uint64
    return bind(lib_name, {
        "product": [ptr] * 7 + [i32] * 2 + [word] * 4 + [ptr],
        "cached": [ptr] * 7 + [i32] * 2 + [word] * 4 + [ptr],
        "forward": [ptr] * 4 + [i32] * 2 + [word] * 3 + [ptr],
        "inverse": [ptr] * 4 + [i32] * 2 + [word] * 3 + [ptr],
        "dot": [ptr] * 7 + [i32] * 3 + [word] * 4 + [i32, ptr],
        "matvec": [ptr] * 5 + [i32] * 4 + [word] * 4 + [ptr],
    })


def launch(lib_name: str, lib: ctypes.CDLL, entry: str, launches: dict,
           out: torch.Tensor, *args) -> torch.Tensor:
    """Launch the kernel ``<lib_name>_<entry>`` of ``lib`` on the current
    stream of out's device, tensors passed by address, and count it in
    ``launches``; raise if the launch was refused."""
    kernel = f"{lib_name}_{entry}"
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(out.device):
        err = getattr(lib, kernel)(
            *args, torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        message = getattr(lib, f"{lib_name}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {message}")
    launches[kernel] += 1
    return out


def check(t: torch.Tensor, name: str, dims: int, dtype: torch.dtype, n: int,
          device: torch.device) -> None:
    """Raise unless t is a contiguous ``dtype`` tensor on ``device`` with
    ``dims`` dimensions, the last n: TypeError for the dtype, ValueError
    for the rest."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} residues, got {t.dtype}")
    if t.dim() != dims or t.shape[-1] != n:
        raise ValueError(f"{name} must have {dims} dimensions, the last "
                         f"{n}; got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the plan on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def runs_plain(x: torch.Tensor) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA
    tensor (launch the kernel); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


class KernelPlan:
    """Every op of one kernel family for one parameter set on one device.

    A subclass sets ``name``, ``lib_name``, ``dtype``, ``word_bits`` and its
    own ``launches`` dict (keyed ``<lib_name>_<entry point>``), and defines
    ``covers(n, q)`` and ``_refusal(p)``; the Goldilocks plan also replaces
    the hooks that shape the C arguments (``_domain_factor``,
    ``_scale_args``, ``_q_args``, ``_lib``)."""

    name: str
    lib_name: str
    dtype: torch.dtype
    word_bits: int
    launches: dict

    @staticmethod
    def covers(n: int, q: int) -> bool:
        raise NotImplementedError

    def _refusal(self, p: NttParams) -> str:
        raise NotImplementedError

    def __init__(self, p: NttParams, device=None):
        """Tables on ``device``: by default the current CUDA device."""
        if not self.covers(p.n, p.q):
            raise ValueError(self._refusal(p))
        self.p = p
        self.device = ntt.resolve_device(device)
        self.plan = ntt.NttPlan(p, Reduction.SHOUP, self.device)
        self.ring = self.plan.ring
        word = 1 << self.word_bits
        q, r = p.q, self._domain_factor()
        self._q_prime = (-pow(q, -1, word)) % word
        # the spectrum domain (times r) and the way back, for the plain
        # versions; the kernels' scales: a REDC of two fresh spectra leaves
        # r^-1, of a fresh one with a cached one nothing
        self._r_tw = self.ring.encode_tw([r], self.device)
        self._r_inv_tw = self.ring.encode_tw([pow(r, -1, q)], self.device)
        self._scale_fresh = self._scale_args(p.n_inv * r % q)
        self._scale_cached = self._scale_args(p.n_inv)
        self._scale_spectrum = self._scale_args(r)
        self._scale_one = self._scale_args(1)
        self._perm = torch.tensor(reference.bit_reverse_permutation(p.n),
                                  dtype=torch.int64)

    def _domain_factor(self) -> int:
        """The factor of a cached spectrum: 2^word mod q, the Montgomery
        domain of the word."""
        return (1 << self.word_bits) % self.p.q

    def _scale_args(self, w: int) -> tuple[int, ...]:
        """A kernel scale: w and its Shoup companion floor(w * 2^word / q),
        Python ints for the C call."""
        return w, (w << self.word_bits) // self.p.q

    def _q_args(self, with_prime: bool) -> tuple[int, ...]:
        """The modulus arguments of a C call: q, and q' = -q^-1 mod 2^word
        for the entry points with a Montgomery slot product."""
        return (self.p.q, self._q_prime) if with_prime else (self.p.q,)

    def _lib(self) -> ctypes.CDLL:
        return load(self.lib_name, self.word_bits)

    def _ring_tw(self, table: tuple):
        """A scale table as the ring's ``mul_tw`` takes it: a Shoup family's
        (w, w') pair as it is."""
        return table

    #: the C entry points (``<lib>_<entry>``) that read their twiddles in
    #: the per-pass layout of ``_transform_table``: the radix-8 core's; every
    #: other entry point reads the flat tables
    pass_entries: frozenset = frozenset()

    def _transform_table(self, flat):
        """The per-pass layout of a flat table (stage s's group g at entry
        2^s + g) for the entry points of ``pass_entries``: here, with none,
        the flat table itself."""
        return flat

    def _table_of(self, entry: str, flat) -> tuple:
        """A twiddle table as the C arguments of ``entry``: the per-pass
        layout for an entry of ``pass_entries``, else the flat table."""
        return _table(self._transform_table(flat) if entry in self.pass_entries else flat)

    # ------------------------------------------------------------------
    # Layout map
    # ------------------------------------------------------------------

    def bitrev_to_natural_perm(self) -> np.ndarray:
        """perm such that natural_spectrum = spectrum[..., perm] (an
        involution, so it also maps natural order to the port's)."""
        return self._perm.numpy().copy()

    def bitrev_to_natural(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self._perm.to(x.device)]

    natural_to_bitrev = bitrev_to_natural

    # ------------------------------------------------------------------
    # Products
    # ------------------------------------------------------------------

    def nwc_poly_mult(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b mod (x^n + 1, q) for (B, n) residues, natural order."""
        self._check_like(a, b)
        if self._runs_plain(a):
            return self.nwc_poly_mult_plain(a, b)
        return self._product("product", a, b, self.plan.merged_flat,
                             self.plan.merged_inv_flat, self._scale_fresh)

    def nwc_poly_mult_plain(self, a, b):
        return ntt.nwc_poly_mult_merged(self.plan, a, b)

    def cyclic_poly_mult(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """INTT(NTT(a) . NTT(b)): a * b mod (x^n - 1, q)."""
        self._check_like(a, b)
        if self._runs_plain(a):
            return self.cyclic_poly_mult_plain(a, b)
        return self._product("product", a, b, self.plan.cyclic_flat,
                             self.plan.cyclic_inv_flat, self._scale_fresh)

    def cyclic_poly_mult_plain(self, a, b):
        fa = ntt.ntt_fwd_bitrev(self.plan, a)
        fb = ntt.ntt_fwd_bitrev(self.plan, b)
        return ntt.ntt_inv_bitrev(self.plan, self.ring.mul(fa, fb))

    def nwc_poly_mult_cached(self, a: torch.Tensor,
                             spectrum: torch.Tensor) -> torch.Tensor:
        """The product of a with the operand whose ``nwc_spectrum`` is given:
        one forward transform instead of two."""
        self._check_like(a, spectrum)
        if self._runs_plain(a):
            return self.nwc_poly_mult_cached_plain(a, spectrum)
        return self._product("cached", a, spectrum, self.plan.merged_flat,
                             self.plan.merged_inv_flat, self._scale_cached)

    def nwc_poly_mult_cached_plain(self, a, spectrum):
        c = self.ring.mul(ntt.nwc_fwd_merged(self.plan, a), spectrum)
        return ntt.nwc_inv_merged(self.plan, self.ring.mul_tw(c, self._r_inv_tw))

    # ------------------------------------------------------------------
    # Transforms
    # ------------------------------------------------------------------

    def ntt_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Cyclic forward NTT, bit-reversed spectrum out."""
        self._check(x, "x", 2)
        if self._runs_plain(x):
            return self.ntt_fwd_plain(x)
        return self._forward(x, self.plan.cyclic_flat, self._scale_one)

    def ntt_fwd_plain(self, x):
        return ntt.ntt_fwd_bitrev(self.plan, x)

    def ntt_inv(self, x: torch.Tensor) -> torch.Tensor:
        """Cyclic inverse NTT of ``ntt_fwd``'s layout, natural order out."""
        self._check(x, "x", 2)
        if self._runs_plain(x):
            return self.ntt_inv_plain(x)
        return self._inverse(x, self.plan.cyclic_inv_flat)

    def ntt_inv_plain(self, x):
        return ntt.ntt_inv_bitrev(self.plan, x)

    def nwc_ntt_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Negacyclic forward (psi-twist + NTT), bit-reversed spectrum out."""
        self._check(x, "x", 2)
        if self._runs_plain(x):
            return self.nwc_ntt_fwd_plain(x)
        return self._forward(x, self.plan.merged_flat, self._scale_one)

    def nwc_ntt_fwd_plain(self, x):
        return ntt.nwc_fwd_merged(self.plan, x)

    def nwc_ntt_inv(self, x: torch.Tensor) -> torch.Tensor:
        """Negacyclic inverse (untwist and n^-1 folded in) of ``nwc_ntt_fwd``'s
        layout, natural-order coefficients out."""
        self._check(x, "x", 2)
        if self._runs_plain(x):
            return self.nwc_ntt_inv_plain(x)
        return self._inverse(x, self.plan.merged_inv_flat)

    def nwc_ntt_inv_plain(self, x):
        return ntt.nwc_inv_merged(self.plan, x)

    def nwc_spectrum(self, x: torch.Tensor) -> torch.Tensor:
        """The cacheable operand spectrum: the negacyclic spectrum times
        2^word mod q, bit-reversed order."""
        self._check(x, "x", 2)
        if self._runs_plain(x):
            return self.nwc_spectrum_plain(x)
        return self._forward(x, self.plan.merged_flat, self._scale_spectrum)

    def nwc_spectrum_plain(self, x):
        return self.ring.mul_tw(ntt.nwc_fwd_merged(self.plan, x), self._r_tw)

    # ------------------------------------------------------------------
    # Dot and matvec
    # ------------------------------------------------------------------

    def nwc_dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """sum_k a_k * b_k mod (x^n + 1, q) for (K, B, n) stacks, K <= 8: one
        inverse transform per output row."""
        return self._dot(a, b, cached=False)

    def nwc_dot_cached(self, a: torch.Tensor, spectra: torch.Tensor) -> torch.Tensor:
        """The dot against a (K, B, n) stack of ``nwc_spectrum`` outputs:
        K forwards and one inverse per output row."""
        return self._dot(a, spectra, cached=True)

    def nwc_dot_plain(self, a, b):
        c = self._spectral_sum(ntt.nwc_fwd_merged(self.plan, a),
                               ntt.nwc_fwd_merged(self.plan, b))
        return ntt.nwc_inv_merged(self.plan, c)

    def nwc_dot_cached_plain(self, a, spectra):
        c = self._spectral_sum(ntt.nwc_fwd_merged(self.plan, a), spectra)
        return ntt.nwc_inv_merged(self.plan, self.ring.mul_tw(c, self._r_inv_tw))

    def nwc_matvec_spectra(self, A: torch.Tensor) -> torch.Tensor:
        """Cached spectra of a fixed (k, l, n) polynomial matrix for
        ``nwc_matvec_cached``: ``nwc_spectrum`` of each entry, (k, l, n)."""
        self._check(A, "A", 3)
        if self._runs_plain(A):
            return self.nwc_matvec_spectra_plain(A)
        return self._forward(A, self.plan.merged_flat, self._scale_spectrum)

    def nwc_matvec_spectra_plain(self, A):
        return self.nwc_spectrum_plain(A)

    def nwc_matvec_cached(self, s: torch.Tensor, spectra: torch.Tensor) -> torch.Tensor:
        """A @ s over Z_q[x]/(x^n + 1): s is (l, B, n), spectra the (k, l, n)
        ``nwc_matvec_spectra`` of A; returns (k, B, n), out[i] = sum_j
        A[i, j] * s[j].  l + k transforms for k * l products: the l forwards
        of s go to a scratch tensor, then one accumulate-and-inverse kernel
        runs per (row of the batch, row of A)."""
        self._check(s, "s", 3)
        self._check(spectra, "spectra", 3)
        k, l = spectra.shape[0], spectra.shape[1]
        if s.shape[0] != l:
            raise ValueError(f"s has {s.shape[0]} rows, A has l={l} columns")
        if not (1 <= l <= MAX_TERMS and 1 <= k <= MAX_TERMS):
            raise ValueError(f"nwc_matvec supports 1 <= k, l <= 8, got k={k}, l={l}")
        if self._runs_plain(s):
            return self.nwc_matvec_cached_plain(s, spectra)
        if s.shape[1] == 0:
            return s.new_empty((k, 0, self.p.n))
        return self._matvec(self._forward(s, self.plan.merged_flat, self._scale_one), spectra)

    def nwc_matvec_cached_plain(self, s, spectra):
        fs = ntt.nwc_fwd_merged(self.plan, s)
        outs = []
        for i in range(spectra.shape[0]):
            c = self._spectral_sum(fs, spectra[i].unsqueeze(1))
            outs.append(ntt.nwc_inv_merged(self.plan,
                                           self.ring.mul_tw(c, self._r_inv_tw)))
        return torch.stack(outs)

    # ------------------------------------------------------------------
    # Checks and launches
    # ------------------------------------------------------------------

    def _spectral_sum(self, fx, spectra):
        """sum_k of the slotwise products fx[k] * spectra[k], kept canonical
        after each add."""
        c = self.ring.mul(fx, spectra)
        acc = c[0]
        for k in range(1, c.shape[0]):
            acc = self.ring.add(acc, c[k])
        return acc

    def _matvec(self, fs, spectra):
        """The matvec's accumulate-and-inverse kernel alone: (k, B, n) out of
        the (l, B, n) plain spectra fs of s (``nwc_ntt_fwd``) and the
        (k, l, n) cached spectra of A."""
        (k, l), batch = spectra.shape[:2], fs.shape[1]
        out = fs.new_empty((k, batch, self.p.n))
        return self._launch(
            "matvec", out, fs, spectra, out,
            *self._table_of("matvec", self.plan.merged_inv_flat),
            k, l, batch, self.p.log_n, *self._q_args(True), *self._scale_cached)

    def _dot(self, a, b, cached: bool):
        self._check_like(a, b, 3)
        if not 1 <= a.shape[0] <= MAX_TERMS:
            raise ValueError(f"nwc_dot supports 1 <= K <= 8 pairs, got {a.shape[0]}")
        if self._runs_plain(a):
            return (self.nwc_dot_cached_plain if cached else self.nwc_dot_plain)(a, b)
        terms, batch = a.shape[0], a.shape[1]
        out = a.new_empty((batch, self.p.n))
        if batch == 0:
            return out
        scale = self._scale_cached if cached else self._scale_fresh
        return self._launch(
            "dot", out, a, b, out, *self._table_of("dot", self.plan.merged_flat),
            *self._table_of("dot", self.plan.merged_inv_flat), terms, batch, self.p.log_n,
            *self._q_args(True), *scale, int(cached))

    def _check(self, t: torch.Tensor, name: str, dims: int) -> None:
        check(t, name, dims, self.dtype, self.p.n, self.device)

    def _check_like(self, a: torch.Tensor, b: torch.Tensor, dims: int = 2) -> None:
        self._check(a, "a", dims)
        self._check(b, "b", dims)
        if a.shape != b.shape:
            raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")

    _runs_plain = staticmethod(runs_plain)

    def _product(self, entry, a, b, tw, itw, scale):
        out = torch.empty_like(a)
        if a.shape[0] == 0:
            return out
        return self._launch(entry, out, a, b, out, *self._table_of(entry, tw),
                            *self._table_of(entry, itw), a.shape[0], self.p.log_n,
                            *self._q_args(True), *scale)

    def _forward(self, x, tw, scale):
        out = torch.empty_like(x)
        rows = x.numel() // self.p.n
        if rows == 0:
            return out
        return self._launch("forward", out, x, out, *self._table_of("forward", tw),
                            rows, self.p.log_n, *self._q_args(False), *scale)

    def _inverse(self, x, itw):
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        return self._launch("inverse", out, x, out, *self._table_of("inverse", itw),
                            x.shape[0], self.p.log_n, *self._q_args(False),
                            *self._scale_cached)

    def _launch(self, entry: str, out: torch.Tensor, *args) -> torch.Tensor:
        return launch(self.lib_name, self._lib(), entry, self.launches, out, *args)


class ScaledKernelPlan(KernelPlan):
    """A ``KernelPlan`` with the four-step's row pass (``sharded``): K1a's
    ``_cyclic_scaled_kernel`` and its halves, the row passes of the cached
    product, the dot and the matvec, each a kernel beside its plain
    version.  Row r of a launch is scaled at entry and/or exit by row
    r % P of (P, n) tables given in the family's scale form; the C entry
    points ``<lib>_cyclic_scaled``, ``_cached_scaled``, ``_forward_scaled``,
    ``_inverse_scaled``, ``_dot_scaled`` and ``_matvec_scaled`` take the
    same arguments as the six flat ones plus the tables and P."""

    def cyclic_poly_mult_scaled(self, a: torch.Tensor, b: torch.Tensor,
                                pre: tuple, post: tuple) -> torch.Tensor:
        """post . INTT(NTT(pre . a) o NTT(pre . b)) on (B, n) rows, cyclic:
        ``pre`` and ``post`` are (P, n) scale tables on the plan's device
        (Shoup pairs (w, w'), or (w,) for Goldilocks), and row r takes
        their row r % P.  B must be a multiple of P, so a launch holds
        whole polynomials of the four-step's P rows."""
        self._check_like(a, b)
        period = self._check_scales(a, pre, post)
        if self._runs_plain(a):
            return self.cyclic_poly_mult_scaled_plain(a, b, pre, post)
        out = torch.empty_like(a)
        if a.shape[0] == 0:
            return out
        return self._launch(
            "cyclic_scaled", out, a, b, out, *self._cyclic_tables("cyclic_scaled"), *pre,
            *post, period, a.shape[0], self.p.log_n, *self._q_args(True), *self._scale_fresh)

    def cyclic_poly_mult_scaled_plain(self, a, b, pre, post):
        c = ntt.cyclic_poly_mult(self.plan, self._rows_times(a, pre),
                                 self._rows_times(b, pre))
        return self._rows_times(c, post)

    def cyclic_poly_mult_cached_scaled(self, a: torch.Tensor, spectrum: torch.Tensor,
                                       pre: tuple, post: tuple) -> torch.Tensor:
        """post . INTT(NTT(pre . a) o S) on (B, n) rows, where S holds the
        rows of a cached spectrum (``ntt_fwd_scaled`` with ``cacheable``),
        used as they are: one forward a row instead of two."""
        self._check_like(a, spectrum)
        period = self._check_scales(a, pre, post)
        if self._runs_plain(a):
            return self.cyclic_poly_mult_cached_scaled_plain(a, spectrum, pre, post)
        out = torch.empty_like(a)
        if a.shape[0] == 0:
            return out
        return self._launch(
            "cached_scaled", out, a, spectrum, out, *self._cyclic_tables("cached_scaled"),
            *pre, *post, period, a.shape[0], self.p.log_n, *self._q_args(True),
            *self._scale_cached)

    def cyclic_poly_mult_cached_scaled_plain(self, a, spectrum, pre, post):
        c = self.ring.mul(ntt.ntt_fwd_bitrev(self.plan, self._rows_times(a, pre)), spectrum)
        return self._unscaled_inverse(c, post)

    def dot_scaled(self, a: torch.Tensor, b: torch.Tensor, pre: tuple, post: tuple,
                   cached: bool = False) -> torch.Tensor:
        """post . INTT(sum_k NTT(pre . a_k) o NTT(pre . b_k)) for (K, B, n)
        stacks of rows, (B, n) out; with ``cached``, b holds the rows of
        cached spectra, used as they are."""
        self._check_like(a, b, 3)
        if a.shape[0] < 1:
            raise ValueError("the dot needs K >= 1 terms")
        period = self._check_scales(a, pre, post)
        if self._runs_plain(a):
            return self.dot_scaled_plain(a, b, pre, post, cached)
        terms, batch = a.shape[0], a.shape[1]
        out = a.new_empty((batch, self.p.n))
        if batch == 0:
            return out
        scale = self._scale_cached if cached else self._scale_fresh
        return self._launch(
            "dot_scaled", out, a, b, out, *self._cyclic_tables("dot_scaled"), *pre, *post,
            period, terms, batch, self.p.log_n, *self._q_args(True), *scale, int(cached))

    def dot_scaled_plain(self, a, b, pre, post, cached=False):
        fa = ntt.ntt_fwd_bitrev(self.plan, self._rows_times(a, pre))
        fb = b if cached else ntt.ntt_fwd_bitrev(self.plan, self._rows_times(b, pre))
        c = self._spectral_sum(fa, fb)
        if cached:
            return self._unscaled_inverse(c, post)
        return self._rows_times(ntt.ntt_inv_bitrev(self.plan, c), post)

    def matvec_scaled(self, spectra: torch.Tensor, mat: torch.Tensor,
                      post: tuple) -> torch.Tensor:
        """out[i] = post . INTT(sum_j S_j o A_ij): ``spectra`` the (l, B, n)
        rows of the plain spectra of s (``ntt_fwd_scaled``), ``mat`` the
        (k, l, P, n) rows of A's cached spectra, row r of S meeting A's row
        r % P; (k, B, n) out."""
        self._check(spectra, "spectra", 3)
        self._check(mat, "mat", 4)
        k, l = mat.shape[0], mat.shape[1]
        period = self._check_scales(spectra, post)
        if spectra.shape[0] != l or mat.shape[2] != period:
            raise ValueError(f"spectra {tuple(spectra.shape)} and mat {tuple(mat.shape)} "
                             f"do not match at period {period}")
        if not 1 <= k <= 65535 or l < 1:
            raise ValueError(f"the matvec needs 1 <= k <= 65535 and l >= 1, got {k}, {l}")
        if self._runs_plain(spectra):
            return self.matvec_scaled_plain(spectra, mat, post)
        batch = spectra.shape[1]
        out = spectra.new_empty((k, batch, self.p.n))
        if batch == 0:
            return out
        return self._launch(
            "matvec_scaled", out, spectra, mat, out,
            *self._table_of("matvec_scaled", self.plan.cyclic_inv_flat), *post, period, k, l,
            batch, self.p.log_n, *self._q_args(True),
            *self._scale_cached)

    def matvec_scaled_plain(self, spectra, mat, post):
        l, batch, n = spectra.shape
        period = mat.shape[2]
        fs = spectra.reshape(l, batch // period, period, n)
        return torch.stack([
            self._unscaled_inverse(self._spectral_sum(fs, mat[i].unsqueeze(1)),
                                   post).reshape(batch, n)
            for i in range(mat.shape[0])])

    def ntt_fwd_scaled(self, x: torch.Tensor, pre: tuple,
                       cacheable: bool = False) -> torch.Tensor:
        """NTT(pre . x), bit-reversed out, as ``cyclic_poly_mult_scaled``
        scales its rows; with ``cacheable``, times the domain factor (the
        domain of a cached spectrum: 2^64 mod q, or 1 for Goldilocks)."""
        self._check(x, "x", 2)
        period = self._check_scales(x, pre)
        if self._runs_plain(x):
            return self.ntt_fwd_scaled_plain(x, pre, cacheable)
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        scale = self._scale_spectrum if cacheable else self._scale_one
        return self._launch(
            "forward_scaled", out, x, out, *self._table_of("forward_scaled", self.plan.cyclic_flat),
            *pre, period, x.shape[0], self.p.log_n, *self._q_args(False), *scale)

    def ntt_fwd_scaled_plain(self, x, pre, cacheable=False):
        y = ntt.ntt_fwd_bitrev(self.plan, self._rows_times(x, pre))
        return self.ring.mul_tw(y, self._r_tw) if cacheable else y

    def ntt_inv_scaled(self, x: torch.Tensor, post: tuple) -> torch.Tensor:
        """post . INTT(x) for a bit-reversed spectrum x, natural out."""
        self._check(x, "x", 2)
        period = self._check_scales(x, post)
        if self._runs_plain(x):
            return self.ntt_inv_scaled_plain(x, post)
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        return self._launch(
            "inverse_scaled", out, x, out,
            *self._table_of("inverse_scaled", self.plan.cyclic_inv_flat), *post,
            period, x.shape[0], self.p.log_n, *self._q_args(False),
            *self._scale_cached)

    def ntt_inv_scaled_plain(self, x, post):
        return self._rows_times(ntt.ntt_inv_bitrev(self.plan, x), post)

    def _cyclic_tables(self, entry: str) -> tuple:
        """The cyclic forward and inverse tables as the C arguments of
        ``entry``."""
        return (*self._table_of(entry, self.plan.cyclic_flat),
                *self._table_of(entry, self.plan.cyclic_inv_flat))

    def _check_scales(self, x: torch.Tensor, *tables) -> int:
        """Check (P, n) scale tables against the (..., B, n) rows x; return P."""
        period = tables[0][0].shape[0]
        for table in tables:
            for t in table:
                self._check(t, "a scale table", 2)
                if t.shape[0] != period:
                    raise ValueError("the scale tables differ in rows")
        if period < 1 or x.shape[-2] % period:
            raise ValueError(f"{x.shape[-2]} rows are not whole periods of {period}")
        return period

    def _rows_times(self, x, table):
        """Row r of the (..., B, n) x times row r % P of the (P, n) table."""
        period = table[0].shape[0]
        rows = x.numel() // (period * self.p.n)
        y = self.ring.mul_tw(x.reshape(rows, period, self.p.n), self._ring_tw(table))
        return y.reshape(x.shape)

    def _unscaled_inverse(self, c, post):
        """post . INTT(c / r): the inverse after products against a cached
        spectrum (times the domain factor r)."""
        c = self.ring.mul_tw(c, self._r_inv_tw)
        return self._rows_times(ntt.ntt_inv_bitrev(self.plan, c), post)


class ColumnPassPlan:
    """The four-step's column pass on a ``ScaledKernelPlan`` of its
    sub-sizes (``mxu64.SubPlan64``, ``gl64.GoldilocksSubPlan64``): each
    transform down every column of (R, n, width) natural rows, the layout
    ``from_cols(transform(to_cols(x)))`` gives (``sharded.FourStepPlan``),
    read and written once by the column entry points ``<lib>_forward_cols``
    and ``<lib>_inverse_cols`` of the radix-8 core; the plain version of
    each is that transpose route.  The family's differences stay in its
    hooks (``_transform_table``, ``_q_args``, ``_scale_args``).  ``out``,
    if given, is a contiguous tensor of x's size that receives the
    result."""

    def ntt_fwd_cols(self, x, width, out=None):
        """``ntt_fwd`` down every column: bit-reversed down each column."""
        return self._cols("forward_cols", x, width, out, self.plan.cyclic_flat,
                          self._scale_one, self.ntt_fwd_plain)

    def ntt_fwd_cols_plain(self, x, width, out=None):
        return self._cols_plain(self.ntt_fwd_plain, x, width, out)

    def nwc_ntt_fwd_cols(self, x, width, out=None):
        return self._cols("forward_cols", x, width, out, self.plan.merged_flat,
                          self._scale_one, self.nwc_ntt_fwd_plain)

    def nwc_ntt_fwd_cols_plain(self, x, width, out=None):
        return self._cols_plain(self.nwc_ntt_fwd_plain, x, width, out)

    def ntt_inv_cols(self, x, width, out=None):
        """``ntt_inv`` down every column of bit-reversed columns."""
        return self._cols("inverse_cols", x, width, out, self.plan.cyclic_inv_flat,
                          self._scale_cached, self.ntt_inv_plain)

    def ntt_inv_cols_plain(self, x, width, out=None):
        return self._cols_plain(self.ntt_inv_plain, x, width, out)

    def nwc_ntt_inv_cols(self, x, width, out=None):
        return self._cols("inverse_cols", x, width, out, self.plan.merged_inv_flat,
                          self._scale_cached, self.nwc_ntt_inv_plain)

    def nwc_ntt_inv_cols_plain(self, x, width, out=None):
        return self._cols_plain(self.nwc_ntt_inv_plain, x, width, out)

    def _cols(self, entry, x, width, out, flat, scale, plain):
        matrices = self._check_cols(x, width, out)
        if self._runs_plain(x):
            return self._cols_plain(plain, x, width, out)
        out = torch.empty_like(x) if out is None else out
        if matrices == 0:
            return out
        return self._launch(entry, out, x, out, *self._table_of(entry, flat),
                            matrices, self.p.log_n, width, *self._q_args(False), *scale)

    def _cols_plain(self, transform, x, width, out):
        """The transpose route: each column a row, the row transform, back."""
        n, matrices = self.p.n, x.numel() // (self.p.n * width)
        cols = x.reshape(matrices, n, width).transpose(1, 2).reshape(-1, n)
        y = transform(cols).reshape(matrices, width, n).transpose(1, 2)
        if out is None:
            return y.reshape(x.shape)
        out.view(matrices, n, width).copy_(y)
        return out

    def _check_cols(self, x, width, out) -> int:
        """Check x (and out) as whole natural (n, width) matrices; return
        how many."""
        if width < 1 or x.numel() % (self.p.n * width):
            raise ValueError(f"{tuple(x.shape)} is not whole ({self.p.n}, {width}) "
                             "matrices")
        check(x, "x", x.dim(), self.dtype, x.shape[-1], self.device)
        if out is not None:
            check(out, "out", out.dim(), self.dtype, out.shape[-1], self.device)
            if out.numel() != x.numel():
                raise ValueError(f"out holds {out.numel()} words, x {x.numel()}")
        return x.numel() // (self.p.n * width)


def _table(tw) -> tuple:
    """A twiddle table as C arguments: a Shoup (w, w') pair, or w alone."""
    return tw if isinstance(tw, tuple) else (tw,)

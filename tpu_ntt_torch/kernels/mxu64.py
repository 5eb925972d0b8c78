"""The 60-bit family on the card: every op of ``tpu_ntt.kernels.mxu64.MxuPlan64``.

``MxuPlan64`` serves any q of 31 to 62 bits (the JAX plan's band, kernel
K1) at 256 <= n <= 8192, n a power of two: the twelve ops of ``mxu.MxuPlan``
on (B, n) ``torch.int64`` residues in [0, q), natural order; an int32 tensor
raises ``TypeError``.  ``sol64.SolinasPlan64`` is the same plan for the
trinomial moduli the JAX policy routes to its Solinas kernel; the port's
kernels need no fold, so it differs only in name and coverage.

The ops, their plain versions (``ntt.py`` over ``modmath.Ring64``), the
launch counts and the spectrum layout are ``_plan.KernelPlan``'s; the
kernels are those of ``csrc/nwc64.cu``.  A cached spectrum is the
negacyclic spectrum times 2^64 mod q in bit-reversed order: the
Montgomery-64 domain of tpu_ntt's ``MxuPlan64`` and ``SolinasPlan64``
spectra (mxu64.py:30-34, sol64.py:298-306), so one port spectrum serves both
classes and ``convert.spectra64_from_jax`` only permutes.

Above n = 8192 the rows outgrow a block's 227 KB, and the four-step of
``fourstep64.FourStepPlan64`` serves the twelve ops on the sub-transforms of
``SubPlan64``: this class's kernels at 32 <= n <= 8192, and its row passes,
each a kernel beside its plain version: ``cyclic_poly_mult_scaled`` and its
halves ``ntt_fwd_scaled`` and ``ntt_inv_scaled`` (the port of K1a's
``_cyclic_scaled_kernel``), ``cyclic_poly_mult_cached_scaled`` (against a
cached spectrum), ``dot_scaled`` and ``matvec_scaled``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import ntt
from ..params import NttParams
from ._plan import KernelPlan, bind, load

MIN_N, MAX_N = 256, 8192  # the dot's three rows of n int64 fit 227 KB at 8192
SUB_MIN_N = 32  # the least sub-transform the four-step may ask of the kernels
MIN_WIDTH, MAX_WIDTH = 31, 62

#: the C entry points of csrc/nwc64.cu, each with its own launch count
KERNELS = ("nwc64_product", "nwc64_cached", "nwc64_forward", "nwc64_inverse",
           "nwc64_dot", "nwc64_matvec", "nwc64_cyclic_scaled",
           "nwc64_forward_scaled", "nwc64_inverse_scaled", "nwc64_cached_scaled",
           "nwc64_dot_scaled", "nwc64_matvec_scaled")


@functools.lru_cache(maxsize=None)
def load_scaled() -> ctypes.CDLL:
    """``csrc/nwc64.cu`` with the six entry points of every family and the
    six of the four-step's row pass typed as declared there."""
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    load("nwc64", 64)
    return bind("nwc64", {
        "cyclic_scaled": [ptr] * 11 + [i32] * 3 + [u64] * 4 + [ptr],
        "cached_scaled": [ptr] * 11 + [i32] * 3 + [u64] * 4 + [ptr],
        "forward_scaled": [ptr] * 6 + [i32] * 3 + [u64] * 3 + [ptr],
        "inverse_scaled": [ptr] * 6 + [i32] * 3 + [u64] * 3 + [ptr],
        "dot_scaled": [ptr] * 11 + [i32] * 4 + [u64] * 4 + [i32, ptr],
        "matvec_scaled": [ptr] * 7 + [i32] * 5 + [u64] * 4 + [ptr],
    })


class MxuPlan64(KernelPlan):
    """Every K1 op for one parameter set with 30 < width <= 62 on one device."""

    name = "cuda-mxu64"
    lib_name = "nwc64"
    dtype = torch.int64
    word_bits = 64
    #: launches of each kernel in this process, over all plans of this class
    #: and its subclass; a caller that must show a run went through a kernel
    #: zeroes its count first
    launches = dict.fromkeys(KERNELS, 0)

    @staticmethod
    def covers(n: int, q: int) -> bool:
        """30 < width <= 62 and 256 <= n <= 8192, n a power of two: the JAX
        plan's band (tpu_ntt/kernels/__init__.py:75-78) up to the n one
        block's shared memory holds."""
        return (MIN_WIDTH <= q.bit_length() <= MAX_WIDTH and MIN_N <= n <= MAX_N
                and not n & (n - 1))

    def _refusal(self, p: NttParams) -> str:
        return (f"{type(self).__name__} covers 30 < width <= 62 at "
                f"{MIN_N} <= n <= {MAX_N}; got n={p.n}, a {p.width}-bit q={p.q}")

    def _lib(self) -> ctypes.CDLL:
        return load_scaled()

    # ------------------------------------------------------------------
    # The four-step's row pass: K1a's _cyclic_scaled_kernel and its halves
    # ------------------------------------------------------------------

    def cyclic_poly_mult_scaled(self, a: torch.Tensor, b: torch.Tensor,
                                pre: tuple, post: tuple) -> torch.Tensor:
        """post . INTT(NTT(pre . a) o NTT(pre . b)) on (B, n) rows, cyclic:
        ``pre`` and ``post`` are (P, n) Shoup tables (w, w') on the plan's
        device, and row r takes their row r % P.  B must be a multiple of
        P, so a launch holds whole polynomials of the four-step's P rows."""
        self._check_like(a, b)
        period = self._check_scales(a, pre, post)
        if self._runs_plain(a):
            return self.cyclic_poly_mult_scaled_plain(a, b, pre, post)
        out = torch.empty_like(a)
        if a.shape[0] == 0:
            return out
        return self._launch(
            "cyclic_scaled", out, a, b, out, *self.plan.cyclic_flat,
            *self.plan.cyclic_inv_flat, *pre, *post, period, a.shape[0],
            self.p.log_n, *self._q_args(True), *self._scale_fresh)

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
            "cached_scaled", out, a, spectrum, out, *self.plan.cyclic_flat,
            *self.plan.cyclic_inv_flat, *pre, *post, period, a.shape[0],
            self.p.log_n, *self._q_args(True), *self._scale_cached)

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
            "dot_scaled", out, a, b, out, *self.plan.cyclic_flat,
            *self.plan.cyclic_inv_flat, *pre, *post, period, terms, batch,
            self.p.log_n, *self._q_args(True), *scale, int(cached))

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
            "matvec_scaled", out, spectra, mat, out, *self.plan.cyclic_inv_flat,
            *post, period, k, l, batch, self.p.log_n, *self._q_args(True),
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
        scales its rows; with ``cacheable``, times 2^64 mod q (the domain
        of a cached spectrum)."""
        self._check(x, "x", 2)
        period = self._check_scales(x, pre)
        if self._runs_plain(x):
            return self.ntt_fwd_scaled_plain(x, pre, cacheable)
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        scale = self._scale_spectrum if cacheable else self._scale_one
        return self._launch(
            "forward_scaled", out, x, out, *self.plan.cyclic_flat, *pre, period,
            x.shape[0], self.p.log_n, *self._q_args(False), *scale)

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
            "inverse_scaled", out, x, out, *self.plan.cyclic_inv_flat, *post,
            period, x.shape[0], self.p.log_n, *self._q_args(False),
            *self._scale_cached)

    def ntt_inv_scaled_plain(self, x, post):
        return self._rows_times(ntt.ntt_inv_bitrev(self.plan, x), post)

    def _check_scales(self, x: torch.Tensor, *tables) -> int:
        """Check (P, n) Shoup tables against the (..., B, n) rows x; return P."""
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
        y = self.ring.mul_tw(x.reshape(rows, period, self.p.n), table)
        return y.reshape(x.shape)

    def _unscaled_inverse(self, c, post):
        """post . INTT(c * 2^-64): the inverse after products against a
        cached spectrum (times 2^64)."""
        c = self.ring.mul_tw(c, self._r_inv_tw)
        return self._rows_times(ntt.ntt_inv_bitrev(self.plan, c), post)


class SubPlan64(MxuPlan64):
    """``MxuPlan64`` at the sub-sizes of the four-step
    (``sharded.KernelFourStep``), 32 <= n <= 8192: the column and row
    transforms of n up to 2^20.  ``kernels.covers`` never returns it, so the
    public window stays 256 <= n <= 8192; its launches count in
    ``MxuPlan64.launches``."""

    name = "cuda-mxu64-sub"

    @staticmethod
    def covers(n: int, q: int) -> bool:
        return (MIN_WIDTH <= q.bit_length() <= MAX_WIDTH
                and SUB_MIN_N <= n <= MAX_N and not n & (n - 1))

    def _refusal(self, p: NttParams) -> str:
        return (f"SubPlan64 covers 30 < width <= 62 at {SUB_MIN_N} <= n <= "
                f"{MAX_N}; got n={p.n}, a {p.width}-bit q={p.q}")

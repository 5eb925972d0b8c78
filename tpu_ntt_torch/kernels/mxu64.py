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
``SubPlan64``: this class's kernels at 32 <= n <= 8192, and its row passes
(``_plan.ScaledKernelPlan``), each a kernel beside its plain version:
``cyclic_poly_mult_scaled`` and its halves ``ntt_fwd_scaled`` and
``ntt_inv_scaled`` (the port of K1a's ``_cyclic_scaled_kernel``),
``cyclic_poly_mult_cached_scaled`` (against a cached spectrum),
``dot_scaled`` and ``matvec_scaled``, on (P, n) Shoup scale tables (w, w').
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..params import NttParams
from ._plan import ScaledKernelPlan, bind, load

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


class MxuPlan64(ScaledKernelPlan):
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

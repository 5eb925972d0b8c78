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

n = 16384 and 32768 (the JAX plan's upper window) need more than a block's
227 KB for two rows of int64: ROADMAP.md Q1.7.
"""

from __future__ import annotations

import torch

from ..params import NttParams
from ._plan import KernelPlan

MIN_N, MAX_N = 256, 8192  # the dot's three rows of n int64 fit 227 KB at 8192
MIN_WIDTH, MAX_WIDTH = 31, 62

#: the C entry points of csrc/nwc64.cu, each with its own launch count
KERNELS = ("nwc64_product", "nwc64_cached", "nwc64_forward", "nwc64_inverse",
           "nwc64_dot", "nwc64_matvec")


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

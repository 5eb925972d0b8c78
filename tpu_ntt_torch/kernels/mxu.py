"""The 24-bit family on the card: every op of ``tpu_ntt.kernels.mxu.MxuPlan``.

``MxuPlan`` serves q < 2^24 at 256 <= n <= 16384, n % 128 == 0 (the window
of the JAX plan, kernel K3): the negacyclic and cyclic products, the cyclic
and negacyclic forward and inverse transforms, the cacheable spectrum and
the product against it, the dot of K <= 8 pairs, against fresh or cached
spectra, and the k x l matrix-vector product against cached spectra.
Residues are (B, n) ``torch.int32`` in [0, q), natural order; an int64
tensor raises ``TypeError``.

The ops, their plain versions, the launch counts and the spectrum layout
(bit-reversed; cached spectra times 2^32 mod q, tpu_ntt's domain) are
``_plan.KernelPlan``'s; the kernels are those of ``csrc/nwc32.cu``.
``nwc32_forward`` (the forwards, the spectrum, and the matvec's transform
of s) and ``nwc32_inverse`` (both inverses) run that file's radix-16 core,
passes of four stages in registers, and ``nwc32_product`` (the negacyclic
and cyclic products), ``nwc32_cached``, ``nwc32_dot`` (fresh and cached)
and ``nwc32_matvec`` (the matvec's accumulate-and-inverse) are fused on it:
all six read the per-pass layout of ``mxu64.pass_table`` with ``RADIX``
stages a pass (``MxuPlan.pass_entries``).
"""

from __future__ import annotations

import torch

from ..params import NttParams
from ._plan import KernelPlan
from .mxu64 import cached_pass_table

MIN_N, MAX_N = 256, 16384  # the JAX window; the dot's 3 rows of n int32 fit 227 KB
MAX_WIDTH = 24
RADIX = 4  # stages a pass of nwc32.cu's radix-16 core

#: the C entry points of csrc/nwc32.cu, each with its own launch count
KERNELS = ("nwc32_product", "nwc32_cached", "nwc32_forward", "nwc32_inverse",
           "nwc32_dot", "nwc32_matvec")


class MxuPlan(KernelPlan):
    """Every K3 op for one parameter set with q < 2^24 on one device."""

    name = "cuda-mxu"
    lib_name = "nwc32"
    dtype = torch.int32
    word_bits = 32
    #: launches of each kernel in this process, over all plans; a caller that
    #: must show a run went through a kernel zeroes its count first
    launches = dict.fromkeys(KERNELS, 0)

    @staticmethod
    def covers(n: int, q: int) -> bool:
        """The JAX plan's window: width <= 24 and 256 <= n <= 16384, n % 128
        == 0 (tpu_ntt/kernels/__init__.py:69-72)."""
        return q.bit_length() <= MAX_WIDTH and not n % 128 and MIN_N <= n <= MAX_N

    def _refusal(self, p: NttParams) -> str:
        if p.width > MAX_WIDTH:
            return f"MxuPlan requires width <= 24, q < 2^24 (got {p.width}-bit q)"
        return f"n={p.n} must be a multiple of 128 in [256, 16384]"

    pass_entries = frozenset({"forward", "inverse", "product", "cached", "dot", "matvec"})

    def _transform_table(self, flat: tuple) -> tuple:
        """The per-pass layout of the flat table (w, w') for the radix-16
        core's entry points: pairs of 32-bit words, a warp's 8-byte loads
        of consecutive groups contiguous."""
        return cached_pass_table(self, flat, RADIX)

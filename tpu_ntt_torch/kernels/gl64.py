"""Kernel K2 on the card: every op of ``tpu_ntt.kernels.gl64.GoldilocksPlan64``.

``GoldilocksPlan64`` serves q = 2^64 - 2^32 + 1 at 256 <= n <= 8192, n a
power of two: the twelve ops of ``_plan.KernelPlan`` on (B, n) ``torch.int64``
tensors that hold the 64-bit patterns of residues in [0, q), natural order
(a residue >= 2^63 is a negative int64; ``modmath``'s docstring states the
format).  On a CUDA tensor each op launches its kernel of ``csrc/gl64.cu``;
on a CPU tensor it runs its plain version (``ntt.py`` over
``modmath.GoldilocksRing``), whose integers it matches bit for bit.

A cached spectrum is in the plain domain, bit-reversed: tpu_ntt's gl64
spectra are plain too (``_domain_scales`` returns ones, gl64.py:75-77), so
``convert.spectra64_from_jax`` only permutes them.  Twiddles and scales are
plain values with no Shoup companion (Shoup needs q < 2^63), so the C entry
points take one pointer a table and one word a scale, and no q.

n = 16384 and 32768 (the JAX plan's upper window) need more than a block's
227 KB for two rows, so from there on the four-step of
``fourstep64.FourStepPlan64`` serves Goldilocks, as it serves the 60-bit
family, on the sub-transforms of ``GoldilocksSubPlan64``: this class's
kernels at 32 <= n <= 8192 and its row passes (``_plan.ScaledKernelPlan``:
``gl64_cyclic_scaled``, ``gl64_cached_scaled``, ``gl64_forward_scaled``,
``gl64_inverse_scaled``, ``gl64_dot_scaled``, ``gl64_matvec_scaled``), whose
scale tables are 1-tuples (w,) of plain values; the entry and exit scales
are one phi-fold product each; and its column pass, the ``*_cols`` methods
of ``_plan.ColumnPassPlan`` (``gl64_forward_cols``, ``gl64_inverse_cols``)
on every column of natural (R, n, width) rows, with no transposes.

``gl64_forward`` and ``gl64_inverse`` (and their column entry points) run
the radix-8 core of ``csrc/gl64.cu``: passes of three stages in registers,
twiddles in the per-pass layout of ``mxu64.pass_table``; so do the
four-step's row forward ``gl64_forward_scaled`` and row inverse
``gl64_inverse_scaled``.  The products fused on that core, both forwards,
the slot product and the inverse in one kernel, are K2's flat product
(``gl64_product``, ``gl64_cached``) and the four-step's row pass
(``gl64_cyclic_scaled``, ``gl64_cached_scaled``); the dots, K2's flat
``gl64_dot`` and with the scales the four-step's row pass
``gl64_dot_scaled``, run a forward a loop step on it, the sum in shared
memory, and one inverse; the four-step's row pass of the matvec
``gl64_matvec_scaled`` sums the slot products of the spectra of s and A a
loop step, then runs one inverse.  These thirteen read the per-pass tables
(``GoldilocksPlan64.pass_entries``); the last kernel, ``gl64_matvec``,
runs the first core on the flat tables.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..modmath import GOLDILOCKS_Q
from ..params import NttParams
from . import _plan
from .mxu64 import MAX_N, MIN_N, SUB_MIN_N, cached_pass_table

#: the C entry points of csrc/gl64.cu, each with its own launch count
KERNELS = ("gl64_product", "gl64_cached", "gl64_forward", "gl64_inverse",
           "gl64_dot", "gl64_matvec", "gl64_cyclic_scaled", "gl64_forward_scaled",
           "gl64_inverse_scaled", "gl64_cached_scaled", "gl64_dot_scaled",
           "gl64_matvec_scaled", "gl64_forward_cols", "gl64_inverse_cols")


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load ``csrc/gl64.cu``, its fourteen entry points
    typed as declared there."""
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    return _plan.bind("gl64", {
        "product": [ptr] * 5 + [i32] * 2 + [u64, ptr],
        "cached": [ptr] * 5 + [i32] * 2 + [u64, ptr],
        "forward": [ptr] * 3 + [i32] * 2 + [u64, ptr],
        "inverse": [ptr] * 3 + [i32] * 2 + [u64, ptr],
        "dot": [ptr] * 5 + [i32] * 3 + [u64, i32, ptr],
        "matvec": [ptr] * 4 + [i32] * 4 + [u64, ptr],
        "cyclic_scaled": [ptr] * 7 + [i32] * 3 + [u64, ptr],
        "cached_scaled": [ptr] * 7 + [i32] * 3 + [u64, ptr],
        "forward_scaled": [ptr] * 4 + [i32] * 3 + [u64, ptr],
        "inverse_scaled": [ptr] * 4 + [i32] * 3 + [u64, ptr],
        "dot_scaled": [ptr] * 7 + [i32] * 4 + [u64, i32, ptr],
        "matvec_scaled": [ptr] * 5 + [i32] * 5 + [u64, ptr],
        "forward_cols": [ptr] * 3 + [i32] * 3 + [u64, ptr],
        "inverse_cols": [ptr] * 3 + [i32] * 3 + [u64, ptr],
    })


class GoldilocksPlan64(_plan.ScaledKernelPlan):
    """Every K2 op for the Goldilocks prime at one n on one device."""

    name = "cuda-gl64"
    lib_name = "gl64"
    dtype = torch.int64
    word_bits = 64
    #: launches of each kernel in this process, over all plans of this
    #: class and its subclass; a caller that must show a run went through
    #: a kernel zeroes its count first
    launches = dict.fromkeys(KERNELS, 0)

    @staticmethod
    def covers(n: int, q: int) -> bool:
        """q = 2^64 - 2^32 + 1 at 256 <= n <= 8192, n a power of two: the
        JAX plan's window (tpu_ntt/kernels/__init__.py:73-74) up to the n
        one block's shared memory holds."""
        return q == GOLDILOCKS_Q and MIN_N <= n <= MAX_N and not n & (n - 1)

    def _refusal(self, p: NttParams) -> str:
        return (f"{type(self).__name__} covers q = 2^64 - 2^32 + 1 at "
                f"{MIN_N} <= n <= {MAX_N}; got n={p.n}, q={p.q}")

    def _domain_factor(self) -> int:
        return 1  # plain spectra: the phi-fold divides by nothing

    def _scale_args(self, w: int) -> tuple[int, ...]:
        return (w,)

    def _q_args(self, with_prime: bool) -> tuple[int, ...]:
        return ()  # the kernels know q

    def _lib(self) -> ctypes.CDLL:
        return load()

    def _ring_tw(self, table: tuple):
        return table[0]  # GoldilocksRing.mul_tw takes the plain values

    pass_entries = frozenset({"forward", "inverse", "forward_cols", "inverse_cols",
                              "forward_scaled", "product", "cached", "cyclic_scaled",
                              "cached_scaled", "dot", "dot_scaled", "inverse_scaled",
                              "matvec_scaled"})

    def _transform_table(self, flat) -> tuple:
        """The per-pass layout of the flat table w for the radix-8 core's
        entry points (``pass_entries``): the 1-tuple (w,)."""
        return cached_pass_table(self, flat)


class GoldilocksSubPlan64(_plan.ColumnPassPlan, GoldilocksPlan64):
    """``GoldilocksPlan64`` at the sub-sizes of the four-step
    (``sharded.KernelFourStep``), 32 <= n <= 8192: the column and row
    transforms of n up to 2^20.  ``kernels.covers`` never returns it, so the
    flat window stays 256 <= n <= 8192; its launches count in
    ``GoldilocksPlan64.launches``.  Its column pass
    (``_plan.ColumnPassPlan``) runs ``gl64_forward_cols`` and
    ``gl64_inverse_cols``."""

    name = "cuda-gl64-sub"

    @staticmethod
    def covers(n: int, q: int) -> bool:
        return q == GOLDILOCKS_Q and SUB_MIN_N <= n <= MAX_N and not n & (n - 1)

    def _refusal(self, p: NttParams) -> str:
        return (f"GoldilocksSubPlan64 covers q = 2^64 - 2^32 + 1 at {SUB_MIN_N} "
                f"<= n <= {MAX_N}; got n={p.n}, q={p.q}")

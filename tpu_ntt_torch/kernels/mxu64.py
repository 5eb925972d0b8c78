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
``dot_scaled`` and ``matvec_scaled``, on (P, n) Shoup scale tables (w, w');
and its column pass, ``SubPlan64``'s ``*_cols`` methods
(``_plan.ColumnPassPlan``) on every column of natural (R, n, width) rows, in
place of torch transposes around a row transform.

``nwc64_forward`` and ``nwc64_inverse`` (and their column entry points) run
the radix-8 core of ``csrc/nwc64.cu``: passes of three stages in registers
(``passes``), twiddles in a per-pass layout built here from the flat tables
(``pass_table``); ``nwc64_product`` and ``nwc64_cached`` run both forwards,
the slot product and the inverse fused on that core, the four-step's row
passes ``nwc64_cyclic_scaled``, ``nwc64_cached_scaled`` and
``nwc64_dot_scaled`` the same between their scale tables, its row forward
``nwc64_forward_scaled`` the entry scale and one forward, its row inverse
``nwc64_inverse_scaled`` one inverse and the exit scale, the flat dot
``nwc64_dot`` the dot's row pass without scales, and the matvec's
``nwc64_matvec`` the row inverse from a sum of slot products, all on the
same per-pass tables (``MxuPlan64.pass_entries``); the last kernel,
``nwc64_matvec_scaled``, reads the flat tables.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..params import NttParams
from ._plan import ColumnPassPlan, ScaledKernelPlan, bind, load

MIN_N, MAX_N = 256, 8192  # the dot's three rows of n int64 fit 227 KB at 8192
SUB_MIN_N = 32  # the least sub-transform the four-step may ask of the kernels
MIN_WIDTH, MAX_WIDTH = 31, 62

#: the C entry points of csrc/nwc64.cu, each with its own launch count
KERNELS = ("nwc64_product", "nwc64_cached", "nwc64_forward", "nwc64_inverse",
           "nwc64_dot", "nwc64_matvec", "nwc64_cyclic_scaled",
           "nwc64_forward_scaled", "nwc64_inverse_scaled", "nwc64_cached_scaled",
           "nwc64_dot_scaled", "nwc64_matvec_scaled", "nwc64_forward_cols",
           "nwc64_inverse_cols")


def passes(log_n: int, radix: int = 3) -> list[tuple[int, int]]:
    """A radix core's passes in forward order, (first stage, stages): the
    first takes log_n mod ``radix`` stages (``radix`` where that is 0),
    every later one ``radix``; 3 in the radix-8 cores of nwc64.cu and
    gl64.cu, 4 in the radix-16 core of nwc32.cu.  The inverse runs them in
    reverse order."""
    first = log_n - radix * ((log_n - 1) // radix)
    return [(0, first)] + [(s, radix) for s in range(first, log_n, radix)]


def pass_indices(log_n: int, radix: int = 3) -> np.ndarray:
    """The flat-table index of each word of ``pass_table`` for the passes
    of ``passes(log_n, radix)``."""
    return schedule_indices(tuple(passes(log_n, radix)))


@functools.lru_cache(maxsize=None)
def schedule_indices(schedule: tuple) -> np.ndarray:
    """The flat-table index of each word of the per-pass layout of the
    passes ``schedule``, ((first stage, stages), ...) in forward order.  Pass (s, r)
    holds 2^(r - 1) columns of 2^s pairs, the pair of column c and group
    hi at words 2 * (c * 2^s + hi) and + 1 after the earlier passes' words:
    word 2c + h of a group is stage s's twiddle for h = c = 0 (then a pad,
    entry 0, never read), else stage s + d's u-th twiddle of the group,
    flat entry 2^(s + d) + hi * 2^d + u, with 2c + h = 2^d + u."""
    idx = []
    for s, r in schedule:
        col, hi, half = np.meshgrid(np.arange(1 << (r - 1)), np.arange(1 << s),
                                    np.arange(2), indexing="ij")
        word = 2 * col + half
        d = np.maximum(np.floor(np.log2(np.maximum(word, 1))).astype(np.int64), 0)
        u = word - (1 << d)
        flat = np.where(word == 0, (1 << s) + hi,
                        np.where(word == 1, 0, (1 << (s + d)) + hi * (1 << d) + u))
        idx.append(flat.reshape(-1))
    return np.concatenate(idx)


def pass_table(flat, radix: int = 3, schedule: tuple | None = None) -> tuple:
    """The flat twiddle table of a transform of n points (stage s's group g
    at entry 2^s + g), a Shoup pair (w, w') or the plain w of Goldilocks,
    in a radix core's per-pass layout (``radix`` stages a pass, or the
    passes ``schedule``, as ``schedule_indices`` takes them): a tuple of
    contiguous tensors on its device, each stage's twiddles of a group in
    pairs (16 bytes of 64-bit words, 8 of 32-bit ones), a warp's loads
    contiguous (csrc/nwc64.cu, csrc/gl64.cu, csrc/nwc32.cu, kyber.cu's
    dot)."""
    flat = flat if isinstance(flat, tuple) else (flat,)
    log_n = flat[0].shape[0].bit_length() - 1
    idx = schedule_indices(schedule) if schedule else pass_indices(log_n, radix)
    idx = torch.from_numpy(idx).to(flat[0].device)
    return tuple(t[idx].contiguous() for t in flat)


def cached_pass_table(plan, flat, radix: int = 3) -> tuple:
    """``pass_table(flat, radix)`` for a plan's ``_transform_table``, built
    once a table (keyed by the table object, which the cache keeps alive)."""
    cache = plan.__dict__.setdefault("_pass_tables", {})
    if id(flat) not in cache:
        cache[id(flat)] = (flat, pass_table(flat, radix))
    return cache[id(flat)][1]


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
        "forward_cols": [ptr] * 4 + [i32] * 3 + [u64] * 3 + [ptr],
        "inverse_cols": [ptr] * 4 + [i32] * 3 + [u64] * 3 + [ptr],
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

    pass_entries = frozenset({"forward", "inverse", "forward_cols", "inverse_cols",
                              "product", "cached", "cyclic_scaled", "cached_scaled",
                              "dot_scaled", "forward_scaled", "inverse_scaled", "dot",
                              "matvec"})

    def _transform_table(self, flat: tuple) -> tuple:
        """The per-pass layout of the flat table (w, w') for the radix-8
        core's entry points (``pass_entries``)."""
        return cached_pass_table(self, flat)


class SubPlan64(ColumnPassPlan, MxuPlan64):
    """``MxuPlan64`` at the sub-sizes of the four-step
    (``sharded.KernelFourStep``), 32 <= n <= 8192: the column and row
    transforms of n up to 2^20.  ``kernels.covers`` never returns it, so the
    public window stays 256 <= n <= 8192; its launches count in
    ``MxuPlan64.launches``.  Its column pass (``_plan.ColumnPassPlan``)
    runs ``nwc64_forward_cols`` and ``nwc64_inverse_cols``."""

    name = "cuda-mxu64-sub"

    @staticmethod
    def covers(n: int, q: int) -> bool:
        return (MIN_WIDTH <= q.bit_length() <= MAX_WIDTH
                and SUB_MIN_N <= n <= MAX_N and not n & (n - 1))

    def _refusal(self, p: NttParams) -> str:
        return (f"SubPlan64 covers 30 < width <= 62 at {SUB_MIN_N} <= n <= "
                f"{MAX_N}; got n={p.n}, a {p.width}-bit q={p.q}")

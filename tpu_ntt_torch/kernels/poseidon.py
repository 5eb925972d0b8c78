"""Kernels K5a and K5b on the card: the Poseidon2-GL permutation and sponge.

``permute`` launches ``poseidon_permute`` of ``csrc/poseidon.cu`` (K5a,
tpu_ntt/kernels/poseidon.py:193 ``_compiled``, ``permute_kernel`` :324) on a
(width, B) int64 state, lane-major so that neighbouring threads load
neighbouring words; ``sponge`` launches ``poseidon_sponge`` (K5b, :218
``_compiled_sponge``, ``hash_rows_kernel`` :243) on (B, L) rows and returns
the (4, B) digest.  Both take a ``poseidon.Poseidon2GL``, whose
``constants_table`` holds its round constants and internal diagonal on the
card, so ``constants=`` holds in the kernels too.  Each wrapper counts its
launches in ``launches`` and raises if the launch was refused; the plain
versions are ``Poseidon2GL.permute_plain`` and ``hash_rows_plain``, which
the hasher runs for a CPU tensor.

``field_probe`` launches ``poseidon_field_probe``, which applies the
kernels' arithmetic core (lazy adds, products, folds, canonicalization,
one external and one internal layer) to any 64-bit words it is given;
``field_probe_want`` computes its rows in Python integers mod q.  Only
checks launch it (chip_smoke.py, the ``cuda`` test): no path of the
library does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..modmath import GOLDILOCKS_Q
from . import _plan

#: the C entry points of csrc/poseidon.cu, each with its own launch count
KERNELS = ("poseidon_permute", "poseidon_sponge")
#: the C entry point that checks the arithmetic core on given operands
PROBE = "poseidon_field_probe"
#: rows of its output (csrc/poseidon.cu's probe_kernel lists them), and the
#: rows it leaves lazy: any 64-bit word congruent to the value
PROBE_ROWS, PROBE_LAZY_ROWS = 10 + 2 * (8 + 12), (0, 2, 4, 6)
#: launches of each kernel in this process; a caller that must show a run
#: went through a kernel zeroes its count first
launches = dict.fromkeys(KERNELS + (PROBE,), 0)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load ``csrc/poseidon.cu``, its three entry points
    typed as declared there."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return _plan.bind("poseidon", {
        "permute": [ptr] * 3 + [i32] * 4 + [ptr],
        "sponge": [ptr] * 3 + [i32] * 5 + [ptr],
        "field_probe": [ptr] * 4 + [i32, ptr],
    })


def _check(hasher, t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int64 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D int64 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels run on CUDA tensors")


def permute(hasher, state: torch.Tensor) -> torch.Tensor:
    """The permutation of each column of a (width, B) state."""
    _check(hasher, state, "state")
    if state.shape[0] != hasher.width:
        raise ValueError(f"state needs {hasher.width} lanes, got {state.shape[0]}")
    out = torch.empty_like(state)
    if state.shape[1] == 0:
        return out
    return _plan.launch("poseidon", load(), "permute", launches, out, state, out,
                        hasher.constants_table(state.device), hasher.width,
                        hasher.rf, hasher.rp, state.shape[1])


def sponge(hasher, rows: torch.Tensor) -> torch.Tensor:
    """The rate-4 sponge of each row of (B, L) rows: a (4, B) digest."""
    _check(hasher, rows, "rows")
    batch, length = rows.shape
    out = rows.new_empty((4, batch))
    if batch == 0:
        return out
    return _plan.launch("poseidon", load(), "sponge", launches, out, rows, out,
                        hasher.constants_table(rows.device), hasher.width,
                        hasher.rf, hasher.rp, batch, length)


def field_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The (PROBE_ROWS, n) rows of ``poseidon_field_probe`` on three (n,)
    int64 CUDA tensors of 64-bit words, any patterns."""
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
        if t.device != a.device or t.shape != a.shape:
            raise ValueError(f"{name} must match a's shape and device")
    if a.device.type != "cuda" or a.numel() == 0:
        raise ValueError("the probe runs on a non-empty CUDA tensor")
    out = a.new_empty((PROBE_ROWS, a.numel()))
    return _plan.launch("poseidon", load(), "field_probe", launches, out, a, b, c, out,
                        a.numel())


def field_probe_want(a, b, c) -> list:
    """The probe's rows in Python integers mod q, for operands a, b, c given
    as sequences of ints in [0, 2^64): row k of the kernel's output must be
    congruent to row k here, and equal to it but in ``PROBE_LAZY_ROWS``."""
    from ..poseidon import M4  # that module imports this one

    q = GOLDILOCKS_Q
    x, y, z = (np.array([int(v) for v in t], dtype=object) for t in (a, b, c))
    core = [(x + y) % q, x * y % q, (x * (y % q) + x + z) % q, (x + y % q) % q]
    rows = [r for r in core for _ in (0, 1)] + [x % q, np.array(
        [pow(int(v), 7, q) for v in x], dtype=object)]
    for width in (8, 12):
        lanes = np.stack([np.roll((x, y, z)[j // 4], -(j % 4)) for j in range(width)])
        d = np.stack([np.roll(z, -j) % q for j in range(width)])
        mat = np.kron(np.eye(width // 4, dtype=np.int64) + 1, M4).astype(object)
        rows += list((mat.dot(lanes) + d) % q)
        rows += list((lanes.sum(axis=0) + d * lanes) % q)
    return rows

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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _plan

#: the C entry points of csrc/poseidon.cu, each with its own launch count
KERNELS = ("poseidon_permute", "poseidon_sponge")
#: launches of each kernel in this process; a caller that must show a run
#: went through a kernel zeroes its count first
launches = dict.fromkeys(KERNELS, 0)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load ``csrc/poseidon.cu``, its two entry points
    typed as declared there."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return _plan.bind("poseidon", {
        "permute": [ptr] * 3 + [i32] * 4 + [ptr],
        "sponge": [ptr] * 3 + [i32] * 5 + [ptr],
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

"""Device-side timing on a CUDA card.

``device_seconds_per_call`` times ``fn(*args)`` between two CUDA events, the
same inputs in every call, and takes the slope between two call counts so
that the fixed cost of a run cancels: the method of
``tpu_ntt.benchlib.device_seconds_per_iter`` without its chaining.  The JAX
version feeds each output into the next call so that XLA cannot hoist or
drop a call; PyTorch runs eagerly, so every call launches, and the port's
kernels do the same work whatever the values.  A tensor that is not on a
CUDA device is refused: a time from the CPU is not a device time.
"""

from __future__ import annotations

from typing import Callable

import torch


def device_seconds_per_call(
    fn: Callable,
    *args: torch.Tensor,
    iters: tuple[int, int] = (4, 20),
    repeats: int = 3,
    min_delta_s: float = 0.05,
) -> float:
    """Seconds per ``fn(*args)`` call, measured on the device of args[0].

    The high call count doubles until the two runs differ by
    ``min_delta_s``; each count keeps the best of ``repeats`` runs."""
    x = args[0]
    if x.device.type != "cuda":
        raise ValueError(f"device timing needs a CUDA tensor, got {x.device}")
    lo, hi = iters

    def run(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def timed(k: int) -> float:
        return min(run(k) for _ in range(repeats))

    with torch.cuda.device(x.device):
        run(lo)  # warm: first-launch costs, allocator growth
        t_lo = timed(lo)
        for _ in range(12):
            t_hi = timed(hi)
            if t_hi - t_lo >= min_delta_s:
                break
            hi *= 2
    return max((t_hi - t_lo) / (hi - lo), 1e-12)

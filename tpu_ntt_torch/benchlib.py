"""Device-side timing on a CUDA card.

``device_seconds_per_iter`` times ``x <- fn(x, *rest)`` between two CUDA
events, chaining each iteration's output into the next so that no launch can
be skipped, and takes the slope between two iteration counts so that the
fixed cost of a run cancels: the method of
``tpu_ntt.benchlib.device_seconds_per_iter``.  PyTorch runs eagerly, so no
compiler can hoist work on ``rest`` out of the loop.  A tensor that is not on
a CUDA device is refused: a time from the CPU is not a device time.
"""

from __future__ import annotations

from typing import Callable

import torch


def device_seconds_per_iter(
    fn: Callable,
    x: torch.Tensor,
    *rest,
    iters: tuple[int, int] = (4, 20),
    repeats: int = 3,
    min_delta_s: float = 0.05,
) -> float:
    """Seconds per ``x <- fn(x, *rest)`` iteration, measured on the device.

    fn must map x to a tensor of the same shape (chainable).  The high
    iteration count doubles until the two runs differ by ``min_delta_s``;
    each count keeps the best of ``repeats`` runs."""
    if x.device.type != "cuda":
        raise ValueError(f"device timing needs a CUDA tensor, got {x.device}")
    lo, hi = iters

    def run(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        y = x
        start.record()
        for _ in range(k):
            y = fn(y, *rest)
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

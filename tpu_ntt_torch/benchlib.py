"""Device-side timing on a CUDA card.

``device_seconds_per_call`` times ``fn(*args)`` between two CUDA events, the
same inputs in every call, and takes the slope between two call counts so
that the fixed cost of a run cancels: the method of
``tpu_ntt.benchlib.device_seconds_per_iter`` without its chaining.  The JAX
version feeds each output into the next call so that XLA cannot hoist or
drop a call; PyTorch runs eagerly, so every call launches, and the port's
kernels do the same work whatever the values.  A tensor that is not on a
CUDA device is refused: a time from the CPU is not a device time.

Each call costs host time too (the Python wrapper, its checks, the
allocation, the launch), and a kernel shorter than that leaves the device
idle between calls, so the events then time the host.
``graph_seconds_per_call`` takes the host out: it captures the calls in a
CUDA graph and times its replays, the device's time alone.
``host_seconds_per_call`` is the host's share: the time to enqueue a call.
"""

from __future__ import annotations

import time
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


def graph_seconds_per_call(
    fn: Callable,
    *args: torch.Tensor,
    calls: tuple[int, int] = (4, 20),
    repeats: int = 5,
) -> float:
    """Device seconds per ``fn(*args)`` call with no host time between calls:
    ``calls[i]`` calls captured in one CUDA graph each, each graph replayed
    between two events, the slope of the two counts, the best of
    ``repeats`` replays."""
    x = args[0]
    if x.device.type != "cuda":
        raise ValueError(f"device timing needs a CUDA tensor, got {x.device}")
    with torch.cuda.device(x.device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)  # warm outside the capture: first-launch costs
        torch.cuda.current_stream().wait_stream(side)
        graphs = {}
        for k in calls:
            graphs[k] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[k], capture_error_mode="relaxed"):
                for _ in range(k):
                    fn(*args)

        def replay(k: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[k].replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        lo, hi = calls
        replay(lo), replay(hi)  # warm the graphs
        t_lo = min(replay(lo) for _ in range(repeats))
        t_hi = min(replay(hi) for _ in range(repeats))
    return max((t_hi - t_lo) / (hi - lo), 1e-12)


def host_seconds_per_call(fn: Callable, *args: torch.Tensor, calls: int = 50) -> float:
    """Host seconds to enqueue one ``fn(*args)`` call: ``calls`` calls
    between two host clocks, after a synchronize, before the next."""
    x = args[0]
    if x.device.type != "cuda":
        raise ValueError(f"host timing of a launch needs a CUDA tensor, got {x.device}")
    fn(*args)
    torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize(x.device)
    return (t1 - t0) / calls

#!/usr/bin/env python3
"""Where the radix-8 core of nwc64.cu spends its time: variants of the source,
some deliberately wrong, built and timed beside it on the card.

    python3 tools/nwc64_variants.py

Each variant edits lines of ``tpu_ntt_torch/kernels/csrc/nwc64.cu``
(``VARIANTS``) and is built by nvcc with the kernels' own flags
(``kernels/_build.FLAGS``) into a temporary directory; then
``nwc64_forward`` and ``nwc64_inverse`` at P60_4096, B = 2048, and
``nwc64_forward_cols`` and ``nwc64_inverse_cols`` at the column shapes of
p60_32768 (256 x 128, B = 256) and p60_1048576 (1024 x 1024, B = 4) run
under every variant in turns, each timed by CUDA events: the best of three
runs of 50 launches, over two rounds.  A variant marked wrong computes other
integers: its time says what the work it drops costs, nothing else.  Needs
a CUDA device and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tpu_ntt_torch.kernels import _build  # noqa: E402
from tpu_ntt_torch.kernels.mxu64 import SubPlan64  # noqa: E402
from tpu_ntt_torch.params import P60_4096, make_params  # noqa: E402

HIGH = "  return a * w - __umul64hi(a, ws) * q;"
SWIZZLE = "  return a ^ ((a >> 3) & 15);"
#: name -> (what it changes, [(line, replacement)], computes the right integers)
VARIANTS = {
    "base": ("the source as it is", [], True),
    "six-instruction swizzle": (
        "the first swizzle: bits 4 to 6 into bits 0 to 3", [
            (SWIZZLE, "  return a ^ (((a >> 3) & 6) | (((a >> 6) & 1) * 9));")], True),
    "no swizzle": ("bank conflicts left in", [(SWIZZLE, "  return a;")], True),
    "no high product": ("wrong: the Shoup product without its 64-bit high half",
                        [(HIGH, "  return a * w - ws * q;")], False),
    "columns of 4 at n = 1024": (
        "a 32-byte tile row at n = 1024, 512 threads a block",
        [("  const int least = 1024 / n > 8 ? 1024 / n : 8;",
          "  const int least = n == 1024 ? 4 : 1024 / n > 8 ? 1024 / n : 8;")], True),
    "device memory only": (
        "wrong: the loads and stores, no pass between them", [
            ("    run_pass<0, first_stages(kLogN), false, true>(x, pt.w, pt.w_shoup, 0, q);\n"
             "    forward_passes<kLogN, kCols, 1>(x, smem, pt.w, pt.w_shoup, g, t, q);", ""),
            ("    run_pass<kS, 3, true>(x, pt.w + kOff, pt.w_shoup + kOff, group<kLogN, kS>(t), q);\n"
             "    inverse_passes<kLogN, kCols, kLast - 1>(x, smem, pt.w, pt.w_shoup, g, t, q);",
             "")], False),
    "passes only": (
        "wrong: the passes on zeros, no load or store of the rows",
        [("  const bool live = tg < transforms;",
          "  const bool live = tg < transforms && transforms < 0;")], False),
    "one block an SM": (
        "__launch_bounds__ with one block an SM: up to 128 registers",
        [("                                  1024 / block_threads(kLogN, kCols))",
          "                                  1)")], True),
}
ENTRIES = {"forward": 2, "inverse": 2, "forward_cols": 3, "inverse_cols": 3}  # int arguments


def build(source: str, out: Path, prefix: str = "nwc64", argtypes=None) -> ctypes.CDLL:
    """Build ``source`` with the kernels' flags into ``out`` and load it;
    type each entry point ``<prefix>_<entry>`` of ``argtypes`` (by default
    nwc64.cu's radix entries); its ``summary`` is the registers and spills
    of ``transform_kernel<12, 0, 0>``."""
    path = out.with_suffix(".cu")
    path.write_text(source)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(out), str(path)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path.name}:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry" in line and "transform_kernelILi12ELb0ELb0EE" in line)
    spill = next(line.strip() for line in lines[at:] if "spill" in line)
    regs = next(re.search(r"Used (\d+) registers", line).group(1) for line in lines[at:]
                if "registers" in line)
    lib = ctypes.CDLL(str(out))
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    if argtypes is None:
        argtypes = {entry: [ptr] * 4 + [i32] * ints + [u64] * 3 + [ptr]
                    for entry, ints in ENTRIES.items()}
    for entry, types in argtypes.items():
        fn = getattr(lib, f"{prefix}_{entry}")
        fn.argtypes = types
        fn.restype = ctypes.c_int
    lib.summary = f"{regs} registers, {spill}"
    return lib


def best_ms(call, iters: int = 50) -> float:
    call()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("nwc64_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    source = (_build.CSRC / "nwc64.cu").read_text()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, (name, (what, edits, right)) in enumerate(VARIANTS.items()):
            text = source
            for line, new in edits:
                if line not in text:
                    raise RuntimeError(f"variant {name!r}: its line is not in nwc64.cu")
                text = text.replace(line, new)
            libs[name] = build(text, Path(tmp) / f"libvariant{k}.so")
            print(f"variant {name}: {what}{'' if right else ' (other integers)'}; "
                  f"transform_kernel<12, 0, 0>: {libs[name].summary}")
        device = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        cases = []
        plan = SubPlan64(P60_4096, device)
        x = torch.from_numpy(rng.integers(0, plan.p.q, size=(2048, 4096),
                                          dtype=np.int64)).to(device)
        for entry, flat in (("forward", plan.plan.merged_flat),
                            ("inverse", plan.plan.merged_inv_flat)):
            cases.append((f"nwc64_{entry} P60_4096 B=2048", plan, entry, x, flat, 2048, ()))
        for n1, width, batch in ((256, 128, 256), (1024, 1024, 4)):
            col = SubPlan64(make_params(n1, 576460752308273153), device)
            xc = torch.from_numpy(rng.integers(0, col.p.q, size=(batch, n1 * width),
                                               dtype=np.int64)).to(device)
            for entry, flat in (("forward_cols", col.plan.merged_flat),
                                ("inverse_cols", col.plan.merged_inv_flat)):
                cases.append((f"nwc64_{entry} {n1} x {width} B={batch}", col, entry, xc, flat,
                              batch, (width,)))
        times = {}
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):
            for label, p, entry, xx, flat, batch, extra in cases:
                tw, out = p._transform_table(flat), torch.empty_like(xx)
                scale = p._scale_one if entry.startswith("forward") else p._scale_cached
                args = (xx.data_ptr(), out.data_ptr(), tw[0].data_ptr(), tw[1].data_ptr(),
                        batch, p.p.log_n, *extra, p.p.q, *scale, stream)
                for name, lib in libs.items():
                    fn = getattr(lib, f"nwc64_{entry}")
                    if fn(*args):
                        raise RuntimeError(f"{label} under {name!r}: the launch failed")
                    t = best_ms(lambda fn=fn: fn(*args))
                    times[label, name] = min(t, times.get((label, name), t))
        for label, *_ in cases:
            print(f"{label} (ms, CUDA events): "
                  + "; ".join(f"{name} {times[label, name]:.4f}" for name in libs))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the radix-16 core of nwc32.cu spends its time: variants of the source,
some deliberately wrong, built and timed beside it on the card.

    python3 tools/nwc32_variants.py [--against OLD/nwc32.cu] [--build-only] [--only A,B]

Each variant edits lines of ``tpu_ntt_torch/kernels/csrc/nwc32.cu``
(``VARIANTS``) and is built as ``tools/nwc64_variants.py`` builds its own;
then ``nwc32_forward`` on merged tables at P24_4096, B = 2048 (scale 1 and
2^32 mod q, the spectrum's), at DILITHIUM_256 on the 32768 rows of the
4 x 4 matvec's s (B = 8192), at FALCON_1024 and at n = 16384
(q = 16580609), B = 2048, runs under every variant in turns, each timed by
CUDA events: the best of three runs of 50 launches, over two rounds.  A
variant marked wrong computes other integers: its time says what the work
it drops costs, nothing else; every other variant must give the base's
integers.  ``--against`` builds an earlier nwc32.cu beside them (its
``nwc32_forward`` reading the flat tables: the first core's), times it in
the same turns, holds it to the base's integers and counts the
instructions its first-core forward issues after its first barrier.
``--build-only`` and ``--only`` as there.  Needs a CUDA device and nvcc;
prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from nwc64_variants import (best_ms, build, build_all, chosen, count_against,  # noqa: E402
                            parse_args)
from tpu_ntt_torch.kernels import _build  # noqa: E402
from tpu_ntt_torch.kernels.mxu import MxuPlan  # noqa: E402
from tpu_ntt_torch.params import DILITHIUM_256, FALCON_1024, P24_4096, make_params  # noqa: E402

TILE = "  return log_n >= 11 ? 1 : 2048 >> log_n;"
WORD = "  return g * (1 << kLogN) + i;"
BOUNDS = "__launch_bounds__(block_threads(kLogN), 1024 / block_threads(kLogN))"
PASSES = ("  run_pass<0, kR0, true>(x, pt.w, pt.w_shoup, 0, q);\n"
          "  forward_passes<kLogN, 1>(x, smem, pt, g, t, q);\n")
#: name -> (what it changes, [(text, replacement)], computes the right integers)
VARIANTS = {
    "base": ("the source as it is", [], True),
    "1024 threads a block": (
        "a block of 16384 / n rows, 1024 threads at every n (64 rows of 256), not at least 128",
        [(TILE, "  return 16384 >> log_n;")], True),
    "swizzle": ("the tile's word a at a ^ ((a >> 4) & 31): no bank conflict, no 16-byte "
                "accesses", [(WORD, "  const int a = g * (1 << kLogN) + i;\n"
                                    "  return a ^ ((a >> 4) & 31);")], True),
    "one block an SM": ("__launch_bounds__ with one block an SM: up to 128 registers",
                        [(BOUNDS, "__launch_bounds__(block_threads(kLogN), 1)")], True),
    "device memory only": ("wrong: the loads and stores, no pass between them",
                           [(PASSES, "")], False),
    "passes only": ("wrong: the passes on zeros, no load or store of the rows",
                    [("  const bool live = row < rows;\n  const size_t at",
                      "  const bool live = row < rows && rows < 0;\n  const size_t at")], False),
}
KERNELS = ("radix_forward_kernelILi8EE", "radix_forward_kernelILi12EE",
           "radix_forward_kernelILi14EE")
FUSED = "radix_forward_kernelILi"
ARGTYPES = {"forward": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_uint32] * 3
            + [ctypes.c_void_p]}


def forward_trips(log_n: int) -> tuple:
    """The loop trips of the first core's forward after its first barrier:
    its butterfly and stage loops (n / 4 threads, at most 1024), then its
    store loop, unrolled by 4, and the remainder's."""
    n = 1 << log_n
    threads = min(n // 4, 1024)
    return (n // 2 // threads, log_n, n // threads // 4, n // threads % 4)


def main() -> int:
    opts = parse_args("nwc32.cu")
    if not torch.cuda.is_available():
        print("nwc32_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    source = (_build.CSRC / "nwc32.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(source, chosen(VARIANTS, opts.only), Path(tmp), "nwc32.cu", "nwc32",
                         ARGTYPES, KERNELS, FUSED)
        if opts.build_only:
            return 0
        if opts.against:
            path = Path(tmp) / "libagainst.so"
            libs["against"] = build(opts.against.read_text(), path, "nwc32", ARGTYPES, (),
                                    FUSED)
            count_against(path, {"forward_kernel": {l: forward_trips(l) for l in (8, 12, 14)}},
                          lambda log_n: min((1 << log_n) // 4, 1024))
        device = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        stream = torch.cuda.current_stream().cuda_stream
        cases = []  # (label, out, C arguments, --against's C arguments, the tensors they use)
        for p, rows in ((P24_4096, 2048), (DILITHIUM_256, 4 * 8192), (FALCON_1024, 2048),
                        (make_params(16384, 16580609), 2048)):
            plan = MxuPlan(p, device)
            x = torch.from_numpy(rng.integers(0, p.q, size=(rows, p.n), dtype=np.int64)
                                 .astype(np.int32)).to(device)
            flat = plan.plan.merged_flat
            tw = plan._transform_table(flat)
            scales = (plan._scale_one, plan._scale_spectrum) if p is P24_4096 else (
                plan._scale_one,)
            for scale in scales:
                out = torch.empty_like(x)
                call = [(x.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in tables), rows,
                         p.log_n, p.q, *scale, stream) for tables in (tw, flat)]
                cases.append((f"nwc32_forward {p.name} B={rows} scale {scale[0]}", out, *call,
                              (x, tw, flat)))
        times, want = {}, {}
        for _ in range(2):
            for label, out, call, flat_call, _keep in cases:
                for name, lib in libs.items():
                    args = flat_call if name == "against" else call
                    if lib.nwc32_forward(*args):
                        raise RuntimeError(f"{label} under {name!r}: the launch failed")
                    torch.cuda.synchronize()
                    if name == "against" or VARIANTS[name][2]:  # the base's integers
                        want.setdefault(label, out.clone())
                        if not torch.equal(out, want[label]):
                            raise AssertionError(f"{label} under {name!r} differs from base")
                    t = best_ms(lambda lib=lib, args=args: lib.nwc32_forward(*args))
                    times[label, name] = min(t, times.get((label, name), t))
        for label, *_ in cases:
            print(f"{label} (ms, CUDA events): "
                  + "; ".join(f"{name} {times[label, name]:.4f}" for name in libs))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

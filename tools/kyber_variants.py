#!/usr/bin/env python3
"""Where kyber.cu's radix-16 dot spends its time: variants of the source built
and timed beside it on the card.

    python3 tools/kyber_variants.py [--against OLD/kyber.cu] [--build-only] [--only A,B]

Each variant edits lines of ``tpu_ntt_torch/kernels/csrc/kyber.cu``
(``VARIANTS``) and is built as ``tools/nwc64_variants.py`` builds its own;
then ``kyber_dot`` at ML-KEM-768's K = 3 on B = 16384 rows (bench.py's
ML-KEM batch) and on B = 2048, fresh and cached, K = 8 at B = 2048,
fresh, and beside them ``kyber_product`` and ``kyber_forward`` at
B = 16384 (the first design, which no variant edits), run under every
variant in turns, each timed by CUDA events: the best of three runs of 50
launches, over two rounds.  Every variant must give the base's integers.
``--against`` builds an earlier kyber.cu beside them (its ``kyber_dot``
reading the flat tables of ``AGAINST_FLAT``: the first design's), times it
in the same turns and holds it to the base's integers.  ``--build-only``
and ``--only`` as there.  Needs a CUDA device and nvcc; prints the card's
name and power limit.
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

from nwc64_variants import best_ms, build, build_all, chosen, parse_args  # noqa: E402
from tpu_ntt_torch.kernels import _build  # noqa: E402
from tpu_ntt_torch.kernels.kyber import KyberPlan  # noqa: E402

Q, N = 3329, 256
DOT_BOUNDS = "__launch_bounds__(kThreads, 1024 / kThreads)\n    dot_kernel("
# the dot's sum in a private tile of shared memory (word w of thread i at
# w * 128 + i), not in sixteen registers
SUM_IN_TILE = [
    ("  uint32_t x[kWords], sum[kWords];\n#pragma unroll\n  for (int w = 0; w < kWords; ++w) {\n"
     "    sum[w] = 0;\n",
     "  __shared__ uint32_t sum_tile[kWords * kThreads];\n"
     "  uint32_t x[kWords];\n#pragma unroll\n  for (int w = 0; w < kWords; ++w) {\n"
     "    sum_tile[own(w)] = 0;\n"),
    ("          sum[w] += x[w] * y[2 * j] + x[w + 1] * b1g;  // c0: below 30 q^2 a term\n"
     "          sum[w + 1] += x[w] * y[2 * j + 1] + x[w + 1] * y[2 * j];  // c1\n",
     "          sum_tile[own(w)] += x[w] * y[2 * j] + x[w + 1] * b1g;\n"
     "          sum_tile[own(w + 1)] += x[w] * y[2 * j + 1] + x[w + 1] * y[2 * j];\n"),
    ("    x[w] = shoup_lazy(sum[w], scale, scale_shoup, q);",
     "    x[w] = shoup_lazy(sum_tile[own(w)], scale, scale_shoup, q);")]
#: name -> (what it changes, [(text, replacement)], computes the right integers)
VARIANTS = {
    "base": ("the source as it is", [], True),
    "sum in a tile": ("the dot's sum in a private tile of shared memory, not in 16 registers",
                      SUM_IN_TILE, True),
    "512 threads an SM": ("the dot at 512 threads an SM (128 registers a thread), not 1024",
                          [(DOT_BOUNDS, DOT_BOUNDS.replace("1024 / kThreads", "512 / kThreads"))],
                          True),
    "block barrier": ("the exchanges' and the steps' barriers the block's (__syncthreads), "
                      "not the warp's",
                      [("__device__ __forceinline__ void row_sync() { __syncwarp(); }",
                        "__device__ __forceinline__ void row_sync() { __syncthreads(); }")],
                      True),
}
#: the entry points an --against source runs on the flat tables
AGAINST_FLAT = ("dot",)
KERNELS = ("dot_kernelILb0EE", "dot_kernelILb1EE")
FUSED = ("dot_kernelILb",)
ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
PRODUCT_TYPES = [ptr] * 8 + [i32] + [u32] * 4 + [ptr]
ARGTYPES = {"product": PRODUCT_TYPES, "forward": [ptr] * 4 + [i32] + [u32] * 3 + [ptr],
            "dot": [ptr] * 8 + [i32] * 2 + [u32] * 4 + [i32, ptr]}


def main() -> int:
    opts = parse_args("kyber.cu")
    if not torch.cuda.is_available():
        print("kyber_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    source = (_build.CSRC / "kyber.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(source, chosen(VARIANTS, opts.only), Path(tmp), "kyber.cu", "kyber",
                         ARGTYPES, KERNELS, FUSED)
        if opts.build_only:
            return 0
        if opts.against:
            libs["against"] = build(opts.against.read_text(), Path(tmp) / "libagainst.so",
                                    "kyber", ARGTYPES, (), FUSED)
        device = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        stream = torch.cuda.current_stream().cuda_stream
        kp = KyberPlan(device)
        cases = []  # (label, entry, out, C arguments, --against's, tensors they use)

        def residues(shape):
            return torch.from_numpy(rng.integers(0, Q, size=shape, dtype=np.int64)
                                    .astype(np.int32)).to(device)

        for terms, batch, kinds in ((3, 16384, (0, 1)), (3, 2048, (0, 1)), (8, 2048, (0,))):
            a, b = residues((terms, batch, N)), residues((terms, batch, N))
            spectra = kp.spectrum(b.reshape(-1, N)).reshape(b.shape)
            out = torch.empty((batch, N), dtype=torch.int32, device=device)
            for cached in kinds:
                z = spectra if cached else b
                # the first design's dot: flat tables, and its Montgomery base
                # case's scales (128^-1 2^32 fresh, 128^-1 cached)
                flat_scale = kp._scale_cached if cached else kp._scale_fresh
                call = [(a.data_ptr(), z.data_ptr(), out.data_ptr(),
                         *(t.data_ptr() for t in tables), terms, batch, Q, kp._q_prime, *scale,
                         cached, stream)
                        for tables, scale in ((kp._dot_tables, kp._dot_scales[cached]),
                                              (kp._tables(), flat_scale))]
                cases.append((f"kyber_dot K={terms} B={batch}" + (" cached" if cached else ""),
                              "dot", out, *call, (a, z)))
        x, y = residues((16384, N)), residues((16384, N))
        for entry, args in (("product", (x, y)), ("forward", (x,))):
            out = torch.empty_like(x)
            tables = kp._tables() if entry == "product" else kp.plan.merged_flat
            scale = kp._scale_fresh if entry == "product" else kp._scale_one
            q_args = (Q, kp._q_prime) if entry == "product" else (Q,)
            call = (*(t.data_ptr() for t in args), out.data_ptr(),
                    *(t.data_ptr() for t in tables), 16384, *q_args, *scale, stream)
            cases.append((f"kyber_{entry} B=16384", entry, out, call, call, args))
        times, want = {}, {}
        for _ in range(2):
            for label, entry, out, call, flat_call, _keep in cases:
                for name, lib in libs.items():
                    fn = getattr(lib, f"kyber_{entry}")
                    args = flat_call if name == "against" and entry in AGAINST_FLAT else call
                    if fn(*args):
                        raise RuntimeError(f"{label} under {name!r}: the launch failed")
                    torch.cuda.synchronize()
                    want.setdefault(label, out.clone())
                    if not torch.equal(out, want[label]):
                        raise AssertionError(f"{label} under {name!r} differs from base")
                    t = best_ms(lambda fn=fn, args=args: fn(*args))
                    times[label, name] = min(t, times.get((label, name), t))
        for label, *_ in cases:
            print(f"{label} (ms, CUDA events): "
                  + "; ".join(f"{name} {times[label, name]:.4f}" for name in libs))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

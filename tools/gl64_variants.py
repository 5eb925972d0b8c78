#!/usr/bin/env python3
"""Where the radix-8 core of gl64.cu spends its time: variants of the source,
some deliberately wrong, built and timed beside it on the card.

    python3 tools/gl64_variants.py

Each variant edits lines of ``tpu_ntt_torch/kernels/csrc/gl64.cu``
(``VARIANTS``) and is built as ``tools/nwc64_variants.py`` builds its own;
then ``gl64_forward`` and ``gl64_inverse`` at goldilocks_4096, B = 2048, and
``gl64_forward_cols`` and ``gl64_inverse_cols`` at the column shapes of
goldilocks_32768 (256 x 128, B = 256) and Goldilocks 2^20 (1024 x 1024,
B = 4) run under every variant in turns, each timed by CUDA events: the
best of three runs of 50 launches, over two rounds.  A variant marked wrong
computes other integers: its time says what the work it drops costs,
nothing else.  Needs a CUDA device and nvcc; prints the card's name and
power limit.
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

from nwc64_variants import best_ms, build  # noqa: E402
from tpu_ntt_torch.kernels import _build  # noqa: E402
from tpu_ntt_torch.kernels.gl64 import GoldilocksSubPlan64  # noqa: E402
from tpu_ntt_torch.params import GOLDILOCKS_4096, make_params  # noqa: E402

Q = GOLDILOCKS_4096.q
GS = ("  x = add_any(u, v);                // any word\n"
      "  y = mul_lazy(sub_any(u, v), w);   // any word\n")
PRODUCT = "  uint32_t r0, r1, r2, r3, m0, m1, m2;\n"
#: name -> (what it changes, [(text, replacement)], computes the right integers)
VARIANTS = {
    "base": ("the source as it is", [], True),
    "canonical inverse": (
        "the GS butterfly on canonical lanes: the first core's gl_add, gl_sub, gl_mul",
        [(GS, "  x = gl_add(u, v);\n  y = gl_mul(gl_sub(u, v), w);\n")], True),
    "C product": ("the product as the first core's gl_mul (a * b, __umul64hi, the "
                  "phi-fold in C, its compare kept) in place of the PTX chains",
                  [(PRODUCT, "  return gl_mul(a, b);\n" + PRODUCT)], True),
    "no product": ("wrong: a ^ b in place of every product and its fold",
                   [(PRODUCT, "  return a ^ b;\n" + PRODUCT)], False),
    "device memory only": (
        "wrong: the loads and stores, no pass between them", [
            ("    run_pass<0, first_stages(kLogN), false>(x, pt, 0);\n"
             "    forward_passes<kLogN, kCols, 1>(x, smem, pt, g, t);\n", ""),
            ("    run_pass<kS, 3, true>(x, pt + kOff, group<kLogN, kS>(t));\n"
             "    inverse_passes<kLogN, kCols, kLast - 1>(x, smem, pt, g, t);\n", "")], False),
    "passes only": (
        "wrong: the passes on zeros, no load or store of the rows",
        [("  const bool live = tg < transforms;",
          "  const bool live = tg < transforms && transforms < 0;")], False),
    "one block an SM": (
        "__launch_bounds__ with one block an SM: up to 128 registers",
        [("                                  1024 / block_threads(kLogN, kCols))",
          "                                  1)")], True),
}
PTR, I32, U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
ARGTYPES = {"forward": [PTR] * 3 + [I32] * 2 + [U64, PTR],
            "inverse": [PTR] * 3 + [I32] * 2 + [U64, PTR],
            "forward_cols": [PTR] * 3 + [I32] * 3 + [U64, PTR],
            "inverse_cols": [PTR] * 3 + [I32] * 3 + [U64, PTR]}


def residues(shape, rng) -> torch.Tensor:
    x = rng.integers(0, Q, size=shape, dtype=np.uint64)
    return torch.from_numpy(x.view(np.int64)).to(torch.device("cuda", 0))


def main() -> int:
    if not torch.cuda.is_available():
        print("gl64_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    source = (_build.CSRC / "gl64.cu").read_text()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, (name, (what, edits, right)) in enumerate(VARIANTS.items()):
            text = source
            for line, new in edits:
                if line not in text:
                    raise RuntimeError(f"variant {name!r}: its line is not in gl64.cu")
                text = text.replace(line, new)
            libs[name] = build(text, Path(tmp) / f"libvariant{k}.so", "gl64", ARGTYPES)
            print(f"variant {name}: {what}{'' if right else ' (other integers)'}; "
                  f"transform_kernel<12, 0, 0>: {libs[name].summary}")
        device = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        plan = GoldilocksSubPlan64(GOLDILOCKS_4096, device)
        x = residues((2048, 4096), rng)
        cases = [(f"gl64_{entry} goldilocks_4096 B=2048", plan, entry, x, flat, 2048, ())
                 for entry, flat in (("forward", plan.plan.merged_flat),
                                     ("inverse", plan.plan.merged_inv_flat))]
        for n1, width, batch in ((256, 128, 256), (1024, 1024, 4)):
            col = GoldilocksSubPlan64(make_params(n1, Q), device)
            xc = residues((batch, n1 * width), rng)
            cases += [(f"gl64_{entry} {n1} x {width} B={batch}", col, entry, xc, flat, batch,
                       (width,)) for entry, flat in (("forward_cols", col.plan.merged_flat),
                                                     ("inverse_cols", col.plan.merged_inv_flat))]
        times, want = {}, {}
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):
            for label, p, entry, xx, flat, batch, extra in cases:
                (tw,), out = p._transform_table(flat), torch.empty_like(xx)
                scale = p._scale_one if entry.startswith("forward") else p._scale_cached
                args = (xx.data_ptr(), out.data_ptr(), tw.data_ptr(), batch, p.p.log_n,
                        *extra, *scale, stream)
                for name, lib in libs.items():
                    fn = getattr(lib, f"gl64_{entry}")
                    if fn(*args):
                        raise RuntimeError(f"{label} under {name!r}: the launch failed")
                    torch.cuda.synchronize()
                    if VARIANTS[name][2]:  # a right variant gives the base's integers
                        want.setdefault(label, out.clone())
                        if not torch.equal(out, want[label]):
                            raise AssertionError(f"{label} under {name!r} differs from base")
                    t = best_ms(lambda fn=fn: fn(*args))
                    times[label, name] = min(t, times.get((label, name), t))
        for label, *_ in cases:
            print(f"{label} (ms, CUDA events): "
                  + "; ".join(f"{name} {times[label, name]:.4f}" for name in libs))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

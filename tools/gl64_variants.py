#!/usr/bin/env python3
"""Where the radix-8 core of gl64.cu spends its time: variants of the source,
some deliberately wrong, built and timed beside it on the card.

    python3 tools/gl64_variants.py [--against OLD/gl64.cu] [--build-only] [--only A,B]

Each variant edits lines of ``tpu_ntt_torch/kernels/csrc/gl64.cu``
(``VARIANTS``) and is built as ``tools/nwc64_variants.py`` builds its own;
then ``gl64_forward`` and ``gl64_inverse`` at goldilocks_4096, B = 2048,
``gl64_forward_cols`` and ``gl64_inverse_cols`` at the column shapes of
goldilocks_32768 (256 x 128, B = 256) and Goldilocks 2^20 (1024 x 1024,
B = 4), the fused flat ``gl64_product`` and ``gl64_cached`` at
goldilocks_4096, B = 2048, on merged tables, the flat dot ``gl64_dot`` at
goldilocks_4096, K = 4, B = 512, fresh and cached, and the four-step's row
kernels at the row shapes of both (65536 rows of 128 at period 256; 4096
rows of 1024 at period 1024): the fused row pass ``gl64_cyclic_scaled`` at
both, ``gl64_cached_scaled`` at the first, and the row forward
``gl64_forward_scaled`` at both, on random tables, and the dot's row pass
``gl64_dot_scaled`` at K = 4 on goldilocks_32768's 16384 rows of 128 at
period 256, fresh and cached, and on 4096 rows of 1024 at period 1024,
the row inverse ``gl64_inverse_scaled`` at both row shapes, and the
matvec's row pass ``gl64_matvec_scaled`` at 4 x 4 on goldilocks_32768's
16384 rows of 128 (B = 64) at period 256 and on 4096 rows of 1024 (B = 4)
at period 1024, run under every variant in turns, each timed by CUDA
events: the best of three runs of 50 launches, over two rounds.  A
variant marked wrong computes other integers: its time says what the work
it drops costs, nothing else; every other variant must give the base's
integers.  ``--against`` builds an earlier
gl64.cu beside them (its entry points of ``AGAINST_FLAT`` reading the flat
tables: the first core's), times it in the same turns, holds it to the
base's integers and counts the instructions its first-core matvec row
pass issues after its first barrier at n = 128 and 1024, as
tools/nwc64_variants.py counts its own.  ``--build-only`` and
``--only`` as there.  Needs a CUDA device and nvcc; prints the card's name
and power limit.
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
                            inverse_trips, parse_args)
from tpu_ntt_torch.kernels import _build  # noqa: E402
from tpu_ntt_torch.kernels.gl64 import GoldilocksSubPlan64  # noqa: E402
from tpu_ntt_torch.params import GOLDILOCKS_4096, make_params  # noqa: E402

Q = GOLDILOCKS_4096.q
GS = ("  x = add_any(u, v);                // any word\n"
      "  y = mul_lazy(sub_any(u, v), w);   // any word\n")
PRODUCT = "  uint32_t r0, r1, r2, r3, m0, m1, m2;\n"
REGISTERS = "constexpr bool kSpectrumInRegisters = true;"
SLOT = "    x[r] = mul_lazy(mul_lazy(x[r], y[r]), scale);"
PHASES = "  return log_n == 13 || (!cached && !spectrum_in_registers(log_n, scaled));"
OPAQUE_TW = "  const uint64_t* const twa = kOpaque ? opaque(tw) : tw;"
FUSED_SMEM = ("  constexpr int kSmem = kTile * (1 << kLogN) * static_cast<int>(sizeof(uint64_t));\n"
              "  auto kernel = cyclic_scaled_kernel<kLogN, kCached, kScaled>;")
BLOCKS = "  return threads > 384 ? 1 : 640 / threads;"
FLAT_B = "  return scaled && kSpectrumInRegisters && block_threads(log_n, false) < 1024;"
FORWARD_BOUNDS = ("                                  1024 / block_threads(kLogN, false))\n"
                  "    forward_scaled_kernel(")
DOT_BOUNDS = ("__launch_bounds__(block_threads(kLogN, false), dot_blocks(kLogN, kScaled))\n"
              "    dot_kernel(")
DOT_AT_512 = DOT_BOUNDS.replace("dot_blocks(kLogN, kScaled)",
                                "block_threads(kLogN, false) > 256 ? 1 : "
                                "512 / block_threads(kLogN, false)")
INVERSE_BOUNDS = ("                                  block_threads(kLogN, false) > 256\n"
                  "                                      ? 1\n"
                  "                                      : 512 / block_threads(kLogN, false))\n"
                  "    inverse_scaled_kernel(")
DOT_ROW_BLOCKS = "  return !scaled ? 1024 / threads : threads > 256 ? 1 : 512 / threads;"
DOT_B = "        spectrum[r * kThreads] = x[r];"
MATVEC_BLOCKS = ("                                  1024 / block_threads(kLogN, false))\n"
                 "    radix_matvec_kernel(")
MATVEC_ORDER = ("  const int r = live ? o / rows : 0, i = live ? o % rows : 0;  "
                "// batch row, row of A")
MATVEC_ZERO = "  uint64_t x[kWords];\n#pragma unroll\n  for (int w = 0; w < kWords; ++w) {\n    x[w] = 0;\n"
MATVEC_ADD = "      x[w] = add_any(x[w], mul_lazy(s[w], a[w]));"
MATVEC_SCALE = ("#pragma unroll\n  for (int w = 0; w < kWords; ++w) {  // any words\n"
                "    x[w] = mul_lazy(x[w], scale);")
MATVEC_SMEM = ("  auto kernel = radix_matvec_kernel<kLogN>;\n"
               "  const cudaError_t err = allow_smem(kernel, kTile << kLogN);")
MATVEC_LAUNCH = "(kTile << kLogN) * sizeof(uint64_t), stream>>>(\n      words(spectra)"
TILE_WORD = "sum[w * block_threads(kLogN, false)]"
DOT_SLOT_B = "kCached ? y[r] : spectrum[r * kThreads]"
#: name -> (what it changes, [(text, replacement)], computes the right integers)
VARIANTS = {
    "base": ("the source as it is", [], True),
    "canonical inverse": (
        "the GS butterfly on canonical lanes: the first core's gl_add, gl_sub, gl_mul "
        "(the fused row pass's slot made canonical for it)",
        [(GS, "  x = gl_add(u, v);\n  y = gl_mul(gl_sub(u, v), w);\n"),
         (SLOT, "    x[r] = canonical(mul_lazy(mul_lazy(x[r], y[r]), scale));")], True),
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
    # the fused row pass: where b's spectrum waits, and the slot's reduction
    "row b in the output row": (
        "the row pass's b spectrum in the output row, not in registers",
        [(REGISTERS, REGISTERS.replace("true", "false"))], True),
    "opaque phases at every n": (
        "every fused kernel computes its addresses anew in each phase, at every log n",
        [(PHASES, "  return true;")], True),
    "no opaque phases": (
        "no fused kernel's phases take opaque indices and twiddles: the compiler free to "
        "keep earlier addresses live", [(PHASES, "  return false;")], True),
    "opaque phases at n = 8192 only": (
        "the flat product's phases free to keep earlier addresses live below n = 8192, as "
        "the row pass's", [(PHASES, "  return log_n == 13;")], True),
    "no opaque twiddles": (
        "a's forward reads its twiddles through the table pointer b's read, where the phases "
        "are opaque", [(OPAQUE_TW, "  const uint64_t* const twa = tw;")], True),
    "768 threads an SM": (
        "the fused row pass's launch bounds at 768 threads an SM below n = 2048 (80 "
        "registers), not 640 (96)", [(BLOCKS, BLOCKS.replace("640", "768"))], True),
    "512 threads an SM": (
        "the fused row pass's launch bounds at 512 threads an SM (128 registers)",
        [(BLOCKS, BLOCKS.replace("640", "512"))], True),
    "canonical slot": ("the slot's two products canonical: the first core's gl_mul",
                       [(SLOT, "    x[r] = gl_mul(gl_mul(x[r], y[r]), scale);")], True),
    # the row forward's threads an SM; where the flat product's b spectrum waits
    "row forward at 512 threads an SM": (
        "gl64_forward_scaled at 512 threads an SM (up to 128 registers), not the "
        "transforms' 1024 (64)",
        [(FORWARD_BOUNDS, FORWARD_BOUNDS.replace("1024 / block_threads(kLogN, false)",
                                                 "block_threads(kLogN, false) > 256 ? 1 : "
                                                 "512 / block_threads(kLogN, false)"))], True),
    "flat product b in registers": (
        "the flat product's fresh b spectrum in eight registers a thread below n = 8192, as "
        "the row pass's (640 threads an SM; one block of 512 at n = 4096), not in the output "
        "row (1024: two blocks)",
        [(FLAT_B, FLAT_B.replace("scaled && ", ""))], True),
    "b in a second shared tile": (
        "where b's spectrum does not wait in registers, it waits in a second tile of shared "
        "memory at the words this thread wrote, not in the output row", [
            ("      store<kLogN, false, kLast>(y, out, at, 1, t, live);  // words 8t ... 8t + 7",
             "      to_shared<kLogN, false, kLast>(y, smem + kTile * kN, g, t);"),
            ("    load<kLogN, false, kLast>(y, out, at, 1, ta, live);  // this thread's own words",
             "    from_shared<kLogN, false, kLast>(y, smem + kTile * kN, ga, ta);"),
            (FUSED_SMEM, FUSED_SMEM.replace(
                "kTile * (1 << kLogN)",
                "(kCached || spectrum_in_registers(kLogN, kScaled) ? 1 : 2) * kTile * (1 << kLogN)"))],
        True),
    # the flat dot: where a fresh b's spectrum waits, the private tiles' layout,
    # the threads an SM
    "dot b in the output row": (
        "the flat dot's fresh b spectrum in the output row at the thread's own words (from "
        "L2), not in a third shared tile (two tiles a block)",
        [(DOT_B, "        if (live) out[at + kWords * ts + r] = x[r];"),
         (DOT_SLOT_B, "kCached ? y[r] : out[at + kWords * ts + r]"),
         ("constexpr int dot_tiles(bool cached) { return cached ? 2 : 3; }",
          "constexpr int dot_tiles(bool cached) { return 2; }")], True),
    "dot b in registers at 512 threads an SM": (
        "the flat dot's fresh b spectrum in eight registers a thread across the loop's steps, "
        "at 512 threads an SM (128 registers)",
        [(DOT_B, "        held[r] = x[r];"), (DOT_SLOT_B, "kCached ? y[r] : held[r]"),
         ("  const int steps = kCached ? terms : 2 * terms;",
          "  uint64_t held[kWords];\n  const int steps = kCached ? terms : 2 * terms;"),
         (DOT_BOUNDS, DOT_AT_512)], True),
    "dot swizzled tiles": (
        "the flat dot's sum and b spectrum at the exchange tile's swizzled words 8t ... 8t + 7 "
        "(nwc64.cu's), not word r of thread i at r * threads + i",
        [("  uint64_t* const sum = smem + kTile * kN + threadIdx.x;",
          "  uint64_t* const sum = smem + kTile * kN;"),
         ("sum[r * kThreads]", "sum[tile_word<kLogN, false>(g, kWords * t + r)]"),
         ("spectrum[r * kThreads]", "spectrum[tile_word<kLogN, false>(g, kWords * t + r)]")],
        True),
    "dot at 512 threads an SM": (
        "the flat dot's launch bounds, as the row-pass dot's, at 512 threads an SM (128 "
        "registers)", [(DOT_BOUNDS, DOT_AT_512)], True),
    "row-pass dot at 1024 threads an SM": (
        "gl64_dot_scaled's launch bounds at 1024 threads an SM (64 registers), the flat dot's, "
        "not 512", [(DOT_ROW_BLOCKS, "  return 1024 / threads;")], True),
    # the row inverse's threads an SM
    "row inverse at 1024 threads an SM": (
        "gl64_inverse_scaled at the transforms' 1024 threads an SM (64 registers), not 512",
        [(INVERSE_BOUNDS, "                                  1024 / block_threads(kLogN, false))\n"
                          "    inverse_scaled_kernel(")], True),
    # the matvec's row pass: where its sum waits, its threads an SM and the
    # order of its output rows
    "matvec sum in a private tile": (
        "gl64_matvec_scaled's sum in a tile of shared memory private to each thread (word w "
        "of thread i at w * threads + i), nwc64.cu's, not in eight registers",
        [(MATVEC_ZERO, "  uint64_t* const sum = smem + kTile * kN + threadIdx.x;\n#pragma unroll\n"
                       f"  for (int w = 0; w < kWords; ++w) {{\n    {TILE_WORD} = 0;\n"),
         (MATVEC_ADD, f"      {TILE_WORD} = add_any({TILE_WORD}, mul_lazy(s[w], a[w]));"),
         (MATVEC_SCALE, "  uint64_t x[kWords];\n" + MATVEC_SCALE.replace("x[w], scale",
                                                                     f"{TILE_WORD}, scale")),
         (MATVEC_SMEM, MATVEC_SMEM.replace("kTile << kLogN", "2 * kTile << kLogN")),
         (MATVEC_LAUNCH, MATVEC_LAUNCH.replace("(kTile", "(2 * kTile"))], True),
    "matvec at 512 threads an SM": (
        "gl64_matvec_scaled at the row passes' 512 threads an SM (up to 128 registers), not "
        "the transforms' 1024",
        [(MATVEC_BLOCKS, MATVEC_BLOCKS.replace("1024 / block_threads(kLogN, false)",
                                               "block_threads(kLogN, false) > 256 ? 1 : "
                                               "512 / block_threads(kLogN, false)"))], True),
    "matvec batch row fastest": (
        "gl64_matvec_scaled's output rows in the first core's order, the batch row fastest "
        "(the k rows of a batch row a batch apart), not the k rows of a batch row adjacent",
        [(MATVEC_ORDER, "  const int r = live ? o % batch : 0, i = live ? o / batch : 0;")],
        True),
}
#: the entry points an --against source runs on the first core's flat tables
AGAINST_FLAT = ("matvec_scaled",)
KERNELS = ("transform_kernelILi12ELb0ELb0EE", "cyclic_scaled_kernelILi12ELb0ELb0EE",
           "cyclic_scaled_kernelILi12ELb1ELb0EE", "cyclic_scaled_kernelILi7ELb0ELb1EE",
           "cyclic_scaled_kernelILi10ELb0ELb1EE", "forward_scaled_kernelILi7EE",
           "forward_scaled_kernelILi10EE", "dot_kernelILi12ELb0ELb0EE",
           "dot_kernelILi12ELb1ELb0EE", "dot_kernelILi13ELb0ELb0EE", "dot_kernelILi7ELb0ELb1EE",
           "dot_kernelILi7ELb1ELb1EE", "inverse_scaled_kernelILi7EE",
           "inverse_scaled_kernelILi10EE", "radix_matvec_kernelILi7EE",
           "radix_matvec_kernelILi10EE")
FUSED = ("cyclic_scaled_kernelILi", "forward_scaled_kernelILi", "dot_kernelILi",
         "inverse_scaled_kernelILi", "radix_matvec_kernelILi")
PTR, I32, U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
ARGTYPES = {"forward": [PTR] * 3 + [I32] * 2 + [U64, PTR],
            "inverse": [PTR] * 3 + [I32] * 2 + [U64, PTR],
            "forward_cols": [PTR] * 3 + [I32] * 3 + [U64, PTR],
            "inverse_cols": [PTR] * 3 + [I32] * 3 + [U64, PTR],
            "product": [PTR] * 5 + [I32] * 2 + [U64, PTR],
            "cached": [PTR] * 5 + [I32] * 2 + [U64, PTR],
            "forward_scaled": [PTR] * 4 + [I32] * 3 + [U64, PTR],
            "inverse_scaled": [PTR] * 4 + [I32] * 3 + [U64, PTR],
            "cyclic_scaled": [PTR] * 7 + [I32] * 3 + [U64, PTR],
            "cached_scaled": [PTR] * 7 + [I32] * 3 + [U64, PTR],
            "dot": [PTR] * 5 + [I32] * 3 + [U64, I32, PTR],
            "dot_scaled": [PTR] * 7 + [I32] * 4 + [U64, I32, PTR],
            "matvec_scaled": [PTR] * 5 + [I32] * 5 + [U64, PTR]}


def residues(shape, rng) -> torch.Tensor:
    x = rng.integers(0, Q, size=shape, dtype=np.uint64)
    return torch.from_numpy(x.view(np.int64)).to(torch.device("cuda", 0))


def main() -> int:
    opts = parse_args("gl64.cu")
    if not torch.cuda.is_available():
        print("gl64_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    source = (_build.CSRC / "gl64.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(source, chosen(VARIANTS, opts.only), Path(tmp), "gl64.cu", "gl64",
                         ARGTYPES, KERNELS, FUSED)
        if opts.build_only:
            return 0
        if opts.against:
            path = Path(tmp) / "libagainst.so"
            libs["against"] = build(opts.against.read_text(), path, "gl64", ARGTYPES,
                                    KERNELS[:1], FUSED)
            print(f"against {opts.against}: {libs['against'].summary}")
            count_against(path, {"matvec_scaled_kernel": {l: inverse_trips(l) for l in (7, 10)}})
        device = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        stream = torch.cuda.current_stream().cuda_stream
        cases = []  # (label, entry, out, C arguments, the tensors they point into)
        plan = GoldilocksSubPlan64(GOLDILOCKS_4096, device)
        x = residues((2048, 4096), rng)
        for entry, flat in (("forward", plan.plan.merged_flat),
                            ("inverse", plan.plan.merged_inv_flat)):
            (tw,), out = plan._transform_table(flat), torch.empty_like(x)
            scale = plan._scale_one if entry == "forward" else plan._scale_cached
            cases.append((f"gl64_{entry} goldilocks_4096 B=2048", entry, out,
                          (x.data_ptr(), out.data_ptr(), tw.data_ptr(), 2048, plan.p.log_n,
                           *scale, stream), (x, tw)))
        for n1, width, batch in ((256, 128, 256), (1024, 1024, 4)):
            col = GoldilocksSubPlan64(make_params(n1, Q), device)
            xc = residues((batch, n1 * width), rng)
            for entry, flat in (("forward_cols", col.plan.merged_flat),
                                ("inverse_cols", col.plan.merged_inv_flat)):
                (tw,), out = col._transform_table(flat), torch.empty_like(xc)
                scale = col._scale_one if entry == "forward_cols" else col._scale_cached
                cases.append((f"gl64_{entry} {n1} x {width} B={batch}", entry, out,
                              (xc.data_ptr(), out.data_ptr(), tw.data_ptr(), batch,
                               col.p.log_n, width, *scale, stream), (xc, tw)))
        # the flat product at goldilocks_4096, B = 2048, merged tables, fresh
        # and cached
        y = residues((2048, 4096), rng)
        spectrum = plan.nwc_spectrum_plain(y)
        merged = (plan.plan.merged_flat, plan.plan.merged_inv_flat)  # what --against reads
        for entry, z, scale in (("product", y, plan._scale_fresh),
                                ("cached", spectrum, plan._scale_cached)):
            out = torch.empty_like(x)
            call = [(x.data_ptr(), z.data_ptr(), out.data_ptr(),
                     *(w.data_ptr() for w in tables), 2048, plan.p.log_n, *scale, stream)
                    for tables in ([plan._transform_table(t)[0] for t in merged], merged)]
            cases.append((f"gl64_{entry} goldilocks_4096 B=2048", entry, out, call[0],
                          (x, z, merged, call[1])))
        # the flat dot at goldilocks_4096, K = 4, B = 512, merged tables,
        # fresh and cached
        a3, b3 = residues((4, 512, 4096), rng), residues((4, 512, 4096), rng)
        spectra = plan.nwc_spectrum_plain(b3.reshape(-1, 4096)).reshape(b3.shape)
        for z, cached, scale in ((b3, 0, plan._scale_fresh), (spectra, 1, plan._scale_cached)):
            out = torch.empty_like(a3[0])
            call = [(a3.data_ptr(), z.data_ptr(), out.data_ptr(),
                     *(w.data_ptr() for w in tables), 4, 512, plan.p.log_n, *scale, cached,
                     stream)
                    for tables in ([plan._transform_table(t)[0] for t in merged], merged)]
            cases.append((f"gl64_dot goldilocks_4096 K=4 B=512{' cached' if cached else ''}",
                          "dot", out, call[0], (a3, z, merged, call[1])))
        # the row pass of goldilocks_32768 (256 x 128, B = 256) and of 2^20
        # (1024 x 1024, B = 4): rows of n2 at period n1
        for n1, n2, batch, entries in ((256, 128, 256, ("cyclic_scaled", "cached_scaled")),
                                       (1024, 1024, 4, ("cyclic_scaled",))):
            row = GoldilocksSubPlan64(make_params(n2, Q), device)
            a, b = residues((batch * n1, n2), rng), residues((batch * n1, n2), rng)
            pre, post = residues((n1, n2), rng), residues((n1, n2), rng)
            spectrum = row.ntt_fwd_scaled_plain(b, (pre,), True)
            flat = (row.plan.cyclic_flat, row.plan.cyclic_inv_flat)  # what --against reads
            for entry in entries:
                z, scale = (b, row._scale_fresh) if entry == "cyclic_scaled" else (
                    spectrum, row._scale_cached)
                out = torch.empty_like(a)
                call = [(a.data_ptr(), z.data_ptr(), out.data_ptr(),
                         *(w.data_ptr() for w in tables), pre.data_ptr(), post.data_ptr(), n1,
                         batch * n1, row.p.log_n, *scale, stream)
                        for tables in (row._cyclic_tables(entry), flat)]
                cases.append((f"gl64_{entry} {batch * n1} rows of {n2}, period {n1}", entry,
                              out, call[0], (a, z, pre, post, row._cyclic_tables(entry), flat,
                                             call[1])))
            fout = torch.empty_like(a)  # the row forward of a, at scale 1
            call = [(a.data_ptr(), fout.data_ptr(), tw.data_ptr(), pre.data_ptr(), n1,
                     batch * n1, row.p.log_n, *row._scale_one, stream)
                    for tw in (row._transform_table(flat[0])[0], flat[0])]
            cases.append((f"gl64_forward_scaled {batch * n1} rows of {n2}, period {n1}",
                          "forward_scaled", fout, call[0],
                          (a, pre, flat, row._transform_table(flat[0]), call[1])))
            iout = torch.empty_like(a)  # the row inverse of a, taken as spectra, at n^-1
            call = [(a.data_ptr(), iout.data_ptr(), itw.data_ptr(), post.data_ptr(), n1,
                     batch * n1, row.p.log_n, *row._scale_cached, stream)
                    for itw in (row._transform_table(flat[1])[0], flat[1])]
            cases.append((f"gl64_inverse_scaled {batch * n1} rows of {n2}, period {n1}",
                          "inverse_scaled", iout, call[0],
                          (a, post, flat, row._transform_table(flat[1]), call[1])))
        # the dot's row pass at K = 4: goldilocks_32768's 16384 rows of 128 at
        # period 256, and 4096 rows of 1024 at period 1024, fresh and cached
        for n1, n2, rows in ((256, 128, 16384), (1024, 1024, 4096)):
            row = GoldilocksSubPlan64(make_params(n2, Q), device)
            a3, b3 = residues((4, rows, n2), rng), residues((4, rows, n2), rng)
            pre, post = residues((n1, n2), rng), residues((n1, n2), rng)
            spectra = row.ntt_fwd_scaled_plain(b3.reshape(-1, n2), (pre,), True).reshape(b3.shape)
            flat = (row.plan.cyclic_flat, row.plan.cyclic_inv_flat)  # what --against reads
            out = torch.empty_like(a3[0])
            for z, cached, scale in ((b3, 0, row._scale_fresh),
                                     (spectra, 1, row._scale_cached)):
                call = [(a3.data_ptr(), z.data_ptr(), out.data_ptr(),
                         *(w.data_ptr() for w in tables), pre.data_ptr(), post.data_ptr(), n1, 4,
                         rows, row.p.log_n, *scale, cached, stream)
                        for tables in (row._cyclic_tables("dot_scaled"), flat)]
                cases.append((f"gl64_dot_scaled {rows} rows of {n2}, period {n1}, K=4"
                              + (" cached" if cached else ""), "dot_scaled", out, call[0],
                              (a3, z, pre, post, row._cyclic_tables("dot_scaled"), flat,
                               call[1])))
        # the matvec's row pass at 4 x 4: goldilocks_32768's 16384 rows of 128
        # (B = 64) at period 256, and 4096 rows of 1024 (B = 4) at period 1024
        for n1, n2, rows in ((256, 128, 16384), (1024, 1024, 4096)):
            row = GoldilocksSubPlan64(make_params(n2, Q), device)
            s4, mat = residues((4, rows, n2), rng), residues((4, 4, n1, n2), rng)
            post = residues((n1, n2), rng)
            itw = row.plan.cyclic_inv_flat  # what --against reads
            out = torch.empty_like(s4)
            call = [(s4.data_ptr(), mat.data_ptr(), out.data_ptr(), table.data_ptr(),
                     post.data_ptr(), n1, 4, 4, rows, row.p.log_n, *row._scale_cached, stream)
                    for table in (row._transform_table(itw)[0], itw)]
            cases.append((f"gl64_matvec_scaled 4x4, {rows} rows of {n2}, period {n1}",
                          "matvec_scaled", out, call[0],
                          (s4, mat, post, itw, row._transform_table(itw), call[1])))
        times, want = {}, {}
        for _ in range(2):
            for label, entry, out, call, keep in cases:
                for name, lib in libs.items():
                    fn = getattr(lib, f"gl64_{entry}")
                    args = keep[-1] if name == "against" and entry in AGAINST_FLAT else call
                    if fn(*args):
                        raise RuntimeError(f"{label} under {name!r}: the launch failed")
                    torch.cuda.synchronize()
                    if name == "against" or VARIANTS[name][2]:  # the base's integers
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

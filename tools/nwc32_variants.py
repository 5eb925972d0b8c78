#!/usr/bin/env python3
"""Where the radix-16 core of nwc32.cu spends its time: variants of the source,
some deliberately wrong, built and timed beside it on the card.

    python3 tools/nwc32_variants.py [--against OLD/nwc32.cu] [--build-only] [--only A,B]

Each variant edits lines of ``tpu_ntt_torch/kernels/csrc/nwc32.cu``
(``VARIANTS``) and is built as ``tools/nwc64_variants.py`` builds its own;
then ``nwc32_forward`` on merged tables at P24_4096, B = 2048 (scale 1 and
2^32 mod q, the spectrum's), at DILITHIUM_256 on the 32768 rows of the
4 x 4 matvec's s (B = 8192), at FALCON_1024 and at n = 16384
(q = 16580609), B = 2048; ``nwc32_inverse`` on merged tables at n^-1 at
the same four shapes; the fused ``nwc32_product`` and ``nwc32_cached``
at the same four shapes (DILITHIUM_256 at B = 8192); and the fused
``nwc32_dot`` at K = 4, fresh and cached, at P24_4096 (B = 512),
DILITHIUM_256 (B = 2048) and n = 16384 (B = 128), and the matvec's
accumulate-and-inverse ``nwc32_matvec`` at 4 x 4 on the spectra of s at
DILITHIUM_256 (B = 8192, the main path's), P24_4096 (B = 256) and
n = 16384 (B = 64), run under every variant in turns, each timed by CUDA events: the best of three runs of 50
launches, over two rounds.  A variant marked wrong computes other
integers: its time says what the work it drops costs, nothing else; every
other variant must give the base's integers.  ``--against`` builds an
earlier nwc32.cu beside them (its entry points of ``AGAINST_FLAT`` reading
the flat tables: the first core's), times it in the same turns, holds it
to the base's integers and counts the instructions its first-core matvec
issues after its first barrier at n = 256, 4096 and 16384.
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
INVERSE_BOUNDS = BOUNDS + "\n    radix_inverse_kernel("
PASSES = ("  run_pass<0, kR0, false, true>(x, pt.w, pt.w_shoup, 0, q);\n"
          "  forward_passes<kLogN, 1>(x, smem, pt, g, t, q);\n")
FUSED_BLOCKS = "  return 1024 / block_threads(log_n);"
OPAQUE = ("  return dot ? cached && log_n == 13 : log_n == 13 || (cached && (log_n == 9 || "
          "log_n == 14));")
HALF_BLOCKS = "(fused_blocks(kLogN) + 1) / 2"  # 512 threads an SM (1024 at n = 16384)
PRODUCT_BOUNDS = ("__launch_bounds__(block_threads(kLogN), fused_blocks(kLogN))\n"
                  "    product_kernel(")
DOT_BOUNDS = "__launch_bounds__(block_threads(kLogN), fused_blocks(kLogN))\n    dot_kernel("
# where a fresh b's spectrum waits in the product: the private tile's
# store after b's forward, and its words read at the slot
B_STORE = ("  uint32_t x[kWords];\n"
           "  if constexpr (!kCached) {\n"
           "    forward_row<kLogN>(x, b, at, smem, tw, g, t, live, q);\n"
           "#pragma unroll\n"
           "    for (int r = 0; r < kWords; ++r) {  // [0, 4q) -> [0, 2q): the slot's lane\n"
           "      spectrum[own<kLogN>(r)] = csub(x[r], 2 * q);\n"
           "    }\n")
B_READ = "    spectrum_words<kLogN, kCached>(y, b, spectrum, ai, ti, m, live);\n"
B_IN_REGISTERS = [
    (B_STORE, B_STORE.replace("  uint32_t x[kWords];", "  uint32_t x[kWords], z[kWords];")
     .replace("spectrum[own<kLogN>(r)] =", "z[r] =")),
    (B_READ, "    if constexpr (kCached) {\n"
             "      spectrum_words<kLogN, kCached>(y, b, spectrum, ai, ti, m, live);\n"
             "    } else {\n"
             "#pragma unroll\n"
             "      for (int i = 0; i < 4; ++i) {\n"
             "        y[i] = z[4 * m + i];\n"
             "      }\n"
             "    }\n")]
B_IN_OUTPUT_ROW = [
    (B_STORE + "    __syncthreads();",
     B_STORE.replace("spectrum[own<kLogN>(r)] =", "x[r] =")
     + "    store_words(x, out, at, t, live);  // words 16t ... 16t + 15\n    __syncthreads();"),
    (B_READ, "    spectrum_words<kLogN, true>(y, kCached ? b : out, spectrum, ai, ti, m, live);\n")]
# the matvec's first version in this core: a REDC and a compare a word and
# term, the 32-bit sum below 2q in a private tile (word w of thread i at
# w * threads + i, the launch's second tile), all sixteen words a step
MATVEC_LOOP = (
    '  uint32_t x[kWords];\n'
    '#pragma unroll\n'
    '  for (int h = 0; h < 2; ++h) {  // words 16t + 8h ... 16t + 8h + 7\n'
    '    uint64_t sum[kHalf];\n'
    '#pragma unroll\n'
    '    for (int w = 0; w < kHalf; ++w) {\n'
    '      sum[w] = 0;\n'
    '    }\n'
    '#pragma unroll 1\n'
    '    for (int j = 0; j < cols; ++j) {\n'
    '      const uint4* s = reinterpret_cast<const uint4*>(\n'
    '          spectra + (static_cast<size_t>(j) * batch + r) * kN + kWords * t + kHalf * h);\n'
    '      const uint4* a = reinterpret_cast<const uint4*>(\n'
    '          mat + (static_cast<size_t>(i) * cols + j) * kN + kWords * t + kHalf * h);\n'
    '#pragma unroll\n'
    '      for (int m = 0; m < 2; ++m) {\n'
    '        const uint4 sv = live ? s[m] : make_uint4(0, 0, 0, 0);  // [0, q)\n'
    '        const uint4 av = live ? a[m] : make_uint4(0, 0, 0, 0);  // [0, q), times 2^32\n'
    '        uint64_t* const z = sum + 4 * m;  // below 8 q^2 < 2^63 after eight terms\n'
    '        z[0] += static_cast<uint64_t>(sv.x) * av.x;\n'
    '        z[1] += static_cast<uint64_t>(sv.y) * av.y;\n'
    '        z[2] += static_cast<uint64_t>(sv.z) * av.z;\n'
    '        z[3] += static_cast<uint64_t>(sv.w) * av.w;\n'
    '      }\n'
    '    }\n'
    '#pragma unroll\n'
    '    for (int w = 0; w < kHalf; ++w) {  // below 3q -> [0, 2q)\n'
    '      x[kHalf * h + w] = shoup_lazy(redc64(sum[w], q, q_prime), scale, scale_shoup, q);\n'
    '    }\n'
    '  }\n')
MATVEC_MONTGOMERY = [
    (MATVEC_LOOP,
     "  uint32_t* const sum = smem + kTile * kN;\n#pragma unroll\n"
     "  for (int w = 0; w < kWords; ++w) {\n    sum[own<kLogN>(w)] = 0;\n  }\n"
     "#pragma unroll 1\n  for (int j = 0; j < cols; ++j) {\n"
     "    uint32_t s[kWords], a[kWords];\n"
     "    load_words(s, spectra, (static_cast<size_t>(j) * batch + r) * kN, t, live);\n"
     "    load_words(a, mat, (static_cast<size_t>(i) * cols + j) * kN, t, live);\n"
     "#pragma unroll\n    for (int w = 0; w < kWords; ++w) {\n"
     "      const int e = own<kLogN>(w);\n"
     "      sum[e] = csub(sum[e] + mont_lazy(s[w], a[w], q, q_prime), 2 * q);\n    }\n  }\n"
     "  uint32_t x[kWords];\n#pragma unroll\n  for (int w = 0; w < kWords; ++w) {\n"
     "    x[w] = shoup_lazy(sum[own<kLogN>(w)], scale, scale_shoup, q);\n  }\n"),
    ("    return launch_rows<L>(radix_matvec_kernel<L>, 1, rows * batch,",
     "    return launch_rows<L>(radix_matvec_kernel<L>, 2, rows * batch,")]
MATVEC_BOUNDS = ("__launch_bounds__(block_threads(kLogN), fused_blocks(kLogN))\n"
                 "    radix_matvec_kernel(")
MATVEC_ROWS = "  const int r = live ? o / rows : 0, i = live ? o % rows : 0;  // batch row, row of A"
# the dot's sum in sixteen registers, not in its private tile
SUM_IN_REGISTERS = [
    ("  uint32_t x[kWords];\n#pragma unroll\n  for (int r = 0; r < kWords; ++r) {\n"
     "    sum[own<kLogN>(r)] = 0;\n",
     "  uint32_t x[kWords], acc[kWords];\n#pragma unroll\n  for (int r = 0; r < kWords; ++r) {\n"
     "    acc[r] = 0;\n"),
    ("          const int e = own<kLogN>(4 * m + i);\n"
     "          sum[e] = csub(sum[e] + slot<kCached>(x[4 * m + i], y[i], q, q_prime), 2 * q);\n",
     "          const int e = 4 * m + i;\n"
     "          acc[e] = csub(acc[e] + slot<kCached>(x[e], y[i], q, q_prime), 2 * q);\n"),
    ("    x[r] = shoup_lazy(sum[own<kLogN>(r)], scale, scale_shoup, q);",
     "    x[r] = shoup_lazy(acc[r], scale, scale_shoup, q);")]
#: name -> (what it changes, [(text, replacement)], computes the right integers)
VARIANTS = {
    "base": ("the source as it is", [], True),
    "b in registers": ("the fused product's fresh b spectrum in 16 registers, not in a private "
                       "tile of shared memory", B_IN_REGISTERS, True),
    "b in registers at 512": (
        "the same, the product at 512 threads an SM (128 registers a thread)",
        B_IN_REGISTERS + [(PRODUCT_BOUNDS, PRODUCT_BOUNDS.replace("fused_blocks(kLogN)",
                                                                  HALF_BLOCKS))], True),
    "b in the output row": ("the fused product's fresh b spectrum in the output row at the "
                            "thread's own words (16-byte vectors, read back mostly from L2)",
                            B_IN_OUTPUT_ROW, True),
    "sum in registers": ("the dot's sum in 16 registers, not in a private tile",
                         SUM_IN_REGISTERS, True),
    "sum in registers at 512": (
        "the same, the dot at 512 threads an SM", SUM_IN_REGISTERS + [
            (DOT_BOUNDS, DOT_BOUNDS.replace("fused_blocks(kLogN)", HALF_BLOCKS))], True),
    "matvec Montgomery": ("the matvec's first version: a REDC and a compare a word and term, "
                          "the sum below 2q in a private tile, not 64-bit sums of plain "
                          "products in two halves", MATVEC_MONTGOMERY, True),
    "matvec steps unrolled": ("the matvec's loop over j unrolled twice (two terms' loads in "
                              "flight)", [("#pragma unroll 1\n    for (int j = 0; j < cols; ++j) {",
                                           "#pragma unroll 2\n    for (int j = 0; j < cols; ++j) {")],
                              True),
    "matvec at 512": ("the matvec at 512 threads an SM (1024 at n = 16384; 128 registers a "
                      "thread), not 1024",
                      [(MATVEC_BOUNDS, MATVEC_BOUNDS.replace("fused_blocks(kLogN)", HALF_BLOCKS))],
                      True),
    "matvec batch row fastest": (
        "the matvec's output row o = i * B + r (the batch row fastest), not r * k + i (the k "
        "rows of a batch row adjacent)",
        [(MATVEC_ROWS, "  const int r = live ? o % batch : 0, i = live ? o / batch : 0;")], True),
    "no opaque": ("no fused kernel's phase takes its thread indices and row anew",
                  [(OPAQUE, "  return false;")], True),
    "opaque everywhere": ("every fused kernel's phases take their thread indices and row anew",
                          [(OPAQUE, "  return true;")], True),
    "512 threads an SM": ("the fused product and dot at 512 threads an SM, not 1024 (128 "
                          "registers a thread)",
                          [(FUSED_BLOCKS, "  return (1024 / block_threads(log_n) + 1) / 2;")],
                          True),
    "1024 threads a block": (
        "a block of 16384 / n rows, 1024 threads at every n (64 rows of 256), not at least 128",
        [(TILE, "  return 16384 >> log_n;")], True),
    "swizzle": ("the tile's word a at a ^ ((a >> 4) & 31): no bank conflict, no 16-byte "
                "accesses", [(WORD, "  const int a = g * (1 << kLogN) + i;\n"
                                    "  return a ^ ((a >> 4) & 31);")], True),
    "one block an SM": ("the forward's and the inverse's __launch_bounds__ with one block an "
                        "SM: up to 128 registers",
                        [(BOUNDS, "__launch_bounds__(block_threads(kLogN), 1)")], True),
    "inverse at 512 threads an SM": (
        "nwc32_inverse at 512 threads an SM (1024 at n = 16384; up to 128 registers a "
        "thread), not 1024",
        [(INVERSE_BOUNDS, INVERSE_BOUNDS.replace("1024 / block_threads(kLogN)",
                                                 "(1024 / block_threads(kLogN) + 1) / 2"))],
        True),
    "device memory only": ("wrong: the loads and stores, no forward pass between them",
                           [(PASSES, "")], False),
    "passes only": ("wrong: the passes on zeros, no load or store of the rows (forward, "
                    "inverse, product)",
                    [("  const bool live = row < rows;\n  const size_t at",
                      "  const bool live = row < rows && rows < 0;\n  const size_t at")], False),
}
#: the entry points an --against source runs on the first core's flat tables
AGAINST_FLAT = ("matvec",)
KERNELS = ("radix_forward_kernelILi12EE", "radix_inverse_kernelILi12EE",
           "product_kernelILi12ELb0EE", "product_kernelILi12ELb1EE", "dot_kernelILi12ELb0EE",
           "dot_kernelILi12ELb1EE", "radix_matvec_kernelILi8EE")
FUSED = ("radix_forward_kernelILi", "radix_inverse_kernelILi", "product_kernelILi",
         "dot_kernelILi", "radix_matvec_kernelILi")
ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
PRODUCT_TYPES = [ptr] * 7 + [i32] * 2 + [u32] * 4 + [ptr]
ARGTYPES = {"forward": [ptr] * 4 + [i32] * 2 + [u32] * 3 + [ptr],
            "inverse": [ptr] * 4 + [i32] * 2 + [u32] * 3 + [ptr], "product": PRODUCT_TYPES,
            "cached": PRODUCT_TYPES, "dot": [ptr] * 7 + [i32] * 3 + [u32] * 4 + [i32, ptr],
            "matvec": [ptr] * 5 + [i32] * 4 + [u32] * 4 + [ptr]}


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
            libs["against"] = build(opts.against.read_text(), path, "nwc32", ARGTYPES, (), FUSED)
            # the first core's matvec: n / 4 threads a row (at most 1024),
            # after its accumulation (its first barrier) the inverse's
            # butterfly and stage loops, then its store loop
            def threads(log_n):
                return min(1 << (log_n - 2), 1024)

            count_against(path, {"matvec_kernel": {
                l: ((1 << l) // 2 // threads(l), l, (1 << l) // threads(l)) for l in (8, 12, 14)}},
                threads)
        device = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        stream = torch.cuda.current_stream().cuda_stream
        cases = []  # (label, entry, out, C arguments, --against's C arguments, tensors they use)

        def residues(p, shape):
            return torch.from_numpy(rng.integers(0, p.q, size=shape, dtype=np.int64)
                                    .astype(np.int32)).to(device)

        shapes = ((P24_4096, 2048, 512), (DILITHIUM_256, 4 * 8192, 2048), (FALCON_1024, 2048, 0),
                  (make_params(16384, 16580609), 2048, 128))
        for p, rows, dot_rows in shapes:
            plan = MxuPlan(p, device)
            x = residues(p, (rows, p.n))
            flat = plan.plan.merged_flat
            tw = plan._transform_table(flat)
            scales = (plan._scale_one, plan._scale_spectrum) if p is P24_4096 else (
                plan._scale_one,)
            for scale in scales:
                out = torch.empty_like(x)
                call = (x.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in tw), rows,
                        p.log_n, p.q, *scale, stream)
                cases.append((f"nwc32_forward {p.name} B={rows} scale {scale[0]}", "forward",
                              out, call, call, (x, tw)))
            # the inverse of x taken as spectra, merged tables, n^-1
            iflat = plan.plan.merged_inv_flat  # what --against reads
            out = torch.empty_like(x)
            call = [(x.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in itw), rows, p.log_n,
                     p.q, *plan._scale_cached, stream)
                    for itw in (plan._transform_table(iflat), iflat)]
            cases.append((f"nwc32_inverse {p.name} B={rows}", "inverse", out, *call,
                          (x, iflat, plan._transform_table(iflat))))
            # the fused products at B = 8192 at DILITHIUM_256 (its matvec's batch)
            rows = min(rows, 8192)
            a, b = x[:rows], residues(p, (rows, p.n))
            spectrum = plan.nwc_spectrum_plain(b)
            flats = (plan.plan.merged_flat, plan.plan.merged_inv_flat)  # what --against reads
            tables = tuple(plan._transform_table(t) for t in flats)
            out = torch.empty_like(a)
            for entry, z, scale in (("product", b, plan._scale_fresh),
                                    ("cached", spectrum, plan._scale_cached)):
                call = [(a.data_ptr(), z.data_ptr(), out.data_ptr(),
                         *(w.data_ptr() for t in tt for w in t), rows, p.log_n,
                         *plan._q_args(True), *scale, stream) for tt in (tables, flats)]
                cases.append((f"nwc32_{entry} {p.name} B={rows}", entry, out, *call,
                              (a, z, tables, flats)))
            if not dot_rows:
                continue
            a4, b4 = residues(p, (4, dot_rows, p.n)), residues(p, (4, dot_rows, p.n))
            s4 = plan.nwc_spectrum_plain(b4.reshape(-1, p.n)).reshape(b4.shape)
            out = torch.empty((dot_rows, p.n), dtype=torch.int32, device=device)
            for z, scale, cached in ((b4, plan._scale_fresh, 0), (s4, plan._scale_cached, 1)):
                call = [(a4.data_ptr(), z.data_ptr(), out.data_ptr(),
                         *(w.data_ptr() for t in tt for w in t), 4, dot_rows, p.log_n,
                         *plan._q_args(True), *scale, cached, stream) for tt in (tables, flats)]
                cases.append((f"nwc32_dot {p.name} K=4 B={dot_rows}"
                              + (" cached" if cached else ""), "dot", out, *call,
                              (a4, z, tables, flats)))
        # the matvec's accumulate-and-inverse at 4 x 4 on the spectra of s
        for p, batch in ((DILITHIUM_256, 8192), (P24_4096, 256),
                         (make_params(16384, 16580609), 64)):
            plan = MxuPlan(p, device)
            s_mv, mat = residues(p, (4, batch, p.n)), residues(p, (4, 4, p.n))
            fs = plan.nwc_ntt_fwd(s_mv.reshape(-1, p.n)).reshape(s_mv.shape)
            spectra = plan.nwc_matvec_spectra(mat)
            iflat = plan.plan.merged_inv_flat  # what --against reads
            itw = plan._transform_table(iflat)
            out = torch.empty((4, batch, p.n), dtype=torch.int32, device=device)
            call = [(fs.data_ptr(), spectra.data_ptr(), out.data_ptr(),
                     *(w.data_ptr() for w in tt), 4, 4, batch, p.log_n, *plan._q_args(True),
                     *plan._scale_cached, stream) for tt in (itw, iflat)]
            cases.append((f"nwc32_matvec {p.name} 4x4 B={batch}", "matvec", out, *call,
                          (fs, spectra, itw, iflat)))
        times, want = {}, {}
        for _ in range(2):
            for label, entry, out, call, flat_call, _keep in cases:
                for name, lib in libs.items():
                    fn = getattr(lib, f"nwc32_{entry}")
                    args = flat_call if name == "against" and entry in AGAINST_FLAT else call
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

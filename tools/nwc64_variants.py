#!/usr/bin/env python3
"""Where the radix-8 core of nwc64.cu spends its time: variants of the source,
some deliberately wrong, built and timed beside it on the card.

    python3 tools/nwc64_variants.py [--against OLD/nwc64.cu] [--build-only] [--only A,B]

Each variant edits lines of ``tpu_ntt_torch/kernels/csrc/nwc64.cu``
(``VARIANTS``) and is built by nvcc with the kernels' own flags
(``kernels/_build.FLAGS``) into a temporary directory; then
``nwc64_forward`` and ``nwc64_inverse`` at P60_4096, B = 2048,
``nwc64_forward_cols`` and ``nwc64_inverse_cols`` at the column shapes of
p60_32768 (256 x 128, B = 256) and p60_1048576 (1024 x 1024, B = 4), the
fused ``nwc64_product`` and ``nwc64_cached`` at P60_4096, B = 2048, and the
four-step's fused row passes ``nwc64_cyclic_scaled`` and
``nwc64_cached_scaled`` at p60_32768's rows (65536 of 128, period 256) and
p60_1048576's (4096 of 1024, period 1024), ``nwc64_dot_scaled`` at
K = 4 on 16384 rows of 128, fresh and cached, the row forward
``nwc64_forward_scaled`` and the row inverse ``nwc64_inverse_scaled`` at
the same two row shapes, the flat dot ``nwc64_dot`` at P60_4096, K = 4,
B = 512, fresh and cached, and the matvec's accumulate-and-inverse
``nwc64_matvec`` at P60_4096, 4 x 4, B = 256, run under every variant in
turns, each timed by CUDA events: the best of three runs
of 50 launches, over two rounds.  A variant marked wrong computes other
integers: its time says what the work it drops costs, nothing else; every
other variant must give the base's integers.  ``--against`` builds an
earlier nwc64.cu beside them (whose entry points of ``AGAINST_FLAT`` read
the flat tables: the first core's), times it in the same turns, holds it
to the base's integers, and counts the instructions its first-core
matvec issues after its first barrier (cuobjdump, chip_smoke.py's count).  ``--build-only`` stops after the builds' reports
of registers and spills; ``--only`` builds the named variants and the
base.  Needs a CUDA device and nvcc; prints the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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
REGISTERS = "constexpr bool kSpectrumInRegisters = true;"
SLOT_Y = "      y[r] = csub(y[r], 2 * q);"
SLOT = "    x[r] = mont_lazy(kCached ? x[r] : csub(x[r], 2 * q), y[r], q, q_prime);"
PASSES = "constexpr bool opaque_passes(int log_n) { return log_n == 13; }"
PHASES = "  return cached || log_n == 13;"
BLOCKS = "  return threads > 384 ? 1 : 512 / threads;"
ROW_THREADS = "constexpr int kRowThreads = 512;"
FORWARD_BOUNDS = ("__launch_bounds__(block_threads(kLogN, false), scaled_blocks(kLogN))\n"
                  "    forward_scaled_kernel(")
INVERSE_BOUNDS = ("__launch_bounds__(block_threads(kLogN, false), scaled_blocks(kLogN))\n"
                  "    inverse_scaled_kernel(")
FORWARD_HALVES = "  scaled_forward<kLogN, tight(kLogN) ? 2 : 1>(x, in, at,"
# the dot's loop: a step's slot into the sum, the sum read for the inverse
DOT_SUM_STEP = (
    "      uint64_t y[kWords], acc[kWords];\n"
    "      if constexpr (kCached) {\n"
    "        load<kLogN, false, kLast>(y, b, ak, 1, ts, live);  // [0, q), times 2^64\n"
    "      } else {\n"
    "        from_shared<kLogN, false, kLast>(y, spectrum, gs, ts);  // [0, 2q)\n"
    "      }\n"
    "      from_shared<kLogN, false, kLast>(acc, sum, gs, ts);\n"
    "#pragma unroll\n"
    "      for (int r = 0; r < kWords; ++r) {  // [0, 2q) + [0, 2q) < 4q -> [0, 2q)\n"
    "        acc[r] = csub(acc[r] + slot<kCached>(x[r], y[r], q, q_prime), 2 * q);\n"
    "      }\n"
    "      to_shared<kLogN, false, kLast>(acc, sum, gs, ts);\n")
DOT_SUM_START = "  to_shared<kLogN, false, kLast>(x, sum, g, t);\n  const int steps"
DOT_SUM_END = "  from_shared<kLogN, false, kLast>(x, sum, gi, ti);\n"
DOT_BLOCKS = ("  return scaled || log_n < 7 ? scaled_blocks(log_n) : "
              "1024 / block_threads(log_n, false);")
TIGHT = "constexpr int kTightFrom = 1024;"
STORE = ("  for (int r = 0; r < kWords; ++r) {  // [0, 2q) -> [0, q), n^-1 (and 2^64) folded in\n"
         "    x[r] = csub(shoup_lazy(x[r], scale, scale_shoup, q), q);")
# the fresh row pass's forwards, its b spectrum's wait and its scale
ROW_B_FORWARD = (
    "  uint64_t y[kWords];\n"
    "  if constexpr (!kCached) {\n"
    "    scaled_forward<kLogN, kHalves>(y, b, at, pre, srow, smem, tw, g, t, live, q);")
ROW_A_FORWARD = (
    "  scaled_forward<kLogN, kHalves>(x, a, at, pre, kCached ? srow : opaque_row(srow), smem,\n"
    "                                 kTight ? opaque_table(tw) : tw, ga, ta, live, q);")
PRE_WORDS = (
    "  uint64_t w[kWords], ws[kWords];  // pre's words at the first pass's positions, kept\n"
    "  if constexpr (!kCached) {\n"
    "#pragma unroll\n"
    "    for (int r = 0; r < kWords; ++r) {\n"
    "      const size_t e = srow + element<kLogN, 0, first_stages(kLogN)>(t, r);\n"
    "      w[r] = __ldg(pre.w + e);\n"
    "      ws[r] = __ldg(pre.w_shoup + e);\n"
    "    }\n"
    "  }\n")


def kept_pre_forward(v: str, src: str, t: str, g: str, tw: str) -> str:
    """A forward of the row ``src`` into ``v`` entered by the pre words w,
    ws that PRE_WORDS keeps."""
    return (f"    load<kLogN, false, 0>({v}, {src}, at, 1, {t}, live);\n"
            "#pragma unroll\n"
            "    for (int r = 0; r < kWords; ++r) {\n"
            f"      {v}[r] = shoup_lazy({v}[r], w[r], ws[r], q);\n"
            "    }\n"
            f"    run_pass<0, first_stages(kLogN), false, true>({v}, {tw}.w, {tw}.w_shoup, 0, q);\n"
            f"    forward_passes<kLogN, false, 1>({v}, smem, {tw}.w, {tw}.w_shoup, {g}, {t}, q);")


ROW_B_STORE = "    }\n    store<kLogN, false, kLast>(y, out, at, 1, t, live);"
ROW_B_LOAD = "  } else {\n    load<kLogN, false, kLast>(y, out, at, 1, ta, live);"
MATVEC_BLOCKS = ("__host__ __device__ constexpr int matvec_blocks(int log_n) {\n"
                 "  return 1024 / block_threads(log_n, false);")
MATVEC_ORDER = "  const int r = live ? o / rows : 0, i = live ? o % rows : 0;  // batch row, row of A"
MATVEC_OPAQUE = "  constexpr bool kOpaque = opaque_passes(kLogN);"
MATVEC_STEP = "    const int tj = opaque_passes(kLogN) ? opaque(t) : t;  // the step's words 8t ... 8t + 7"
MATVEC_ZERO = ("  uint64_t* const sum = smem + kTile * kN + threadIdx.x;  // word w at sum[w * kThreads]\n"
               "#pragma unroll\n  for (int w = 0; w < kWords; ++w) {\n    sum[w * kThreads] = 0;\n"
               "  }\n")
MATVEC_ADD = ("      sum[w * kThreads] = csub(sum[w * kThreads] + mont_lazy(s[w], a[w], q, q_prime), "
              "2 * q);")
MATVEC_SCALE = ("  uint64_t x[kWords];\n#pragma unroll\n  for (int w = 0; w < kWords; ++w) {  "
                "// [0, 2q) -> [0, 2q)\n    x[w] = shoup_lazy(sum[w * kThreads], scale, scale_shoup, "
                "q);")
MATVEC_LAUNCH = "    return launch_rows<L>(matvec_kernel<L>, 2, rows * batch,"
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
    # the fused product: where b's spectrum waits, and the slot's reduction
    "spectrum in device memory": (
        "the product's b spectrum in the output row, not in registers",
        [(REGISTERS, REGISTERS.replace("true", "false"))], True),
    "one canonical slot lane": (
        "two compares on the fresh product's y lane (canonical) for one on each lane", [
            (SLOT_Y, "      y[r] = csub(csub(y[r], 2 * q), q);"),
            (SLOT, "    x[r] = mont_lazy(x[r], y[r], q, q_prime);")], True),
    "no opaque indices": (
        "at n = 8192 the core's passes and the fused product's phases (and the cached "
        "product's at every n) free to keep "
        "earlier shared-memory addresses live", [(PASSES, PASSES.replace("log_n == 13", "false")),
                                                  (PHASES, "  return false;")], True),
    "opaque phases at every n": (
        "every log n's fused product computes its addresses anew in each phase",
        [(PHASES, "  return true;")], True),
    "768 threads an SM": (
        "the fused product's launch bounds at 768 threads an SM below n = 4096 (80 "
        "registers), not 512 (128)", [(BLOCKS, BLOCKS.replace("512", "768"))], True),
    "canonical slot": (
        "the first core's slot: both lanes canonical, a canonical REDC and the "
        "scale's Shoup product at the slot, one compare at the store", [
            (SLOT_Y, "      y[r] = csub(csub(y[r], 2 * q), q);"),
            (SLOT, "    x[r] = shoup_mul(mont_mul(csub(csub(x[r], 2 * q), q), y[r], q, q_prime),\n"
                   "                     scale, scale_shoup, q);"),
            (STORE, "  for (int r = 0; r < kWords; ++r) {\n    x[r] = csub(x[r], q);")], True),
    # the fused row passes: where pre's words and the scale go, the dot's threads
    "pre in registers": (
        "the fresh row passes keep pre's 16 words a thread from b's entry to a's, not read again",
        [(ROW_B_FORWARD, PRE_WORDS + ROW_B_FORWARD.rsplit("\n", 1)[0] + "\n"
          + kept_pre_forward("y", "b", "t", "g", "tw")),
         (ROW_A_FORWARD, "  if constexpr (kCached) {\n" + ROW_A_FORWARD + "\n  } else {\n"
          + "    const Table ta_tw = kTight ? opaque_table(tw) : tw;\n"
          + kept_pre_forward("x", "a", "ta", "ga", "ta_tw") + "\n  }")], True),
    "tight row passes at every n": (
        "the row passes' 64-register schedule (scales in halves, opaque phases and tables) "
        "at every n, at 512 threads an SM",
        [(TIGHT, TIGHT.replace("1024", "0"))], True),
    "row passes at 768 threads an SM": (
        "the row passes' launch bounds at 768 threads an SM below n = 8192 (80 registers), "
        "not 512 (128)", [(ROW_THREADS, ROW_THREADS.replace("512", "768"))], True),
    "row b in registers": (
        "the fresh row passes' b spectrum in eight registers a thread below n = 8192, not in "
        "the output row", [
            (ROW_B_STORE, ROW_B_STORE.replace(
                "    store<kLogN, false, kLast>(y, out, at, 1, t, live);",
                "    if constexpr (!spectrum_in_registers(kLogN)) {\n"
                "      store<kLogN, false, kLast>(y, out, at, 1, t, live);\n    }")),
            (ROW_B_LOAD, ROW_B_LOAD.replace("} else {",
                                            "} else if constexpr (!spectrum_in_registers(kLogN)) {"))],
        True),
    "row passes at 1024 threads an SM": (
        "the row passes at 1024 threads an SM below n = 8192 (64 registers, tight)",
        [(ROW_THREADS, ROW_THREADS.replace("512", "1024"))], True),
    # the row forward's threads an SM, the flat dot's sum and threads an SM
    "row forward at 1024 threads an SM": (
        "nwc64_forward_scaled at the transforms' 1024 threads an SM (64 registers, pre's "
        "words in two halves), not the fused row passes' 512",
        [(FORWARD_BOUNDS, FORWARD_BOUNDS.replace("scaled_blocks(kLogN)",
                                                 "1024 / block_threads(kLogN, false)")),
         (FORWARD_HALVES, FORWARD_HALVES.replace("tight(kLogN) ? 2 : 1", "2"))], True),
    "row inverse at 1024 threads an SM": (
        "nwc64_inverse_scaled at the transforms' 1024 threads an SM (64 registers), not the "
        "fused row passes' 512",
        [(INVERSE_BOUNDS, INVERSE_BOUNDS.replace("scaled_blocks(kLogN)",
                                                 "1024 / block_threads(kLogN, false)"))], True),
    # the matvec: its threads an SM and the order of its output rows
    "matvec at 512 threads an SM": (
        "nwc64_matvec at the row passes' 512 threads an SM (up to 128 registers), not the "
        "transforms' 1024 (64)",
        [(MATVEC_BLOCKS, MATVEC_BLOCKS.replace("1024 / block_threads(log_n, false)",
                                               "scaled_blocks(log_n)"))], True),
    "matvec opaque at every n": (
        "nwc64_matvec's steps and inverse take their thread indices and table anew (opaque) "
        "at every n, not at n = 8192 alone",
        [(MATVEC_STEP, "    const int tj = opaque(t);"),
         (MATVEC_OPAQUE, "  constexpr bool kOpaque = true;")], True),
    "matvec sum in registers": (
        "nwc64_matvec's sum in eight registers a thread, not in a shared tile private to "
        "each thread (one tile a block)",
        [(MATVEC_ZERO, "  uint64_t x[kWords];\n#pragma unroll\n  for (int w = 0; w < kWords; ++w) {\n"
                       "    x[w] = 0;\n  }\n"),
         (MATVEC_ADD, "      x[w] = csub(x[w] + mont_lazy(s[w], a[w], q, q_prime), 2 * q);"),
         (MATVEC_SCALE, "#pragma unroll\n  for (int w = 0; w < kWords; ++w) {\n"
                        "    x[w] = shoup_lazy(x[w], scale, scale_shoup, q);"),
         (MATVEC_LAUNCH, MATVEC_LAUNCH.replace(", 2, ", ", 1, "))], True),
    "matvec batch row fastest": (
        "nwc64_matvec's output rows in the first core's order, the batch row fastest (the k "
        "rows that read one row of S B rows apart), not the k rows of a batch row adjacent",
        [(MATVEC_ORDER, "  const int r = live ? o % batch : 0, i = live ? o / batch : 0;")],
        True),
    "dot sum in registers": (
        "where not tight the dots' sum in eight registers a thread across the loop, not in "
        "a tile of shared memory", [
            (DOT_SUM_START, "  uint64_t total[kWords] = {};\n" + DOT_SUM_START),
            (DOT_SUM_STEP, DOT_SUM_STEP.replace("y[kWords], acc[kWords]", "y[kWords]")
             .replace("      from_shared<kLogN, false, kLast>(acc, sum, gs, ts);\n", "")
             .replace("      to_shared<kLogN, false, kLast>(acc, sum, gs, ts);\n", "")
             .replace("acc[r]", "total[r]")),
            (DOT_SUM_END, "  if constexpr (kTight) {\n  " + DOT_SUM_END + "  } else {\n"
             "#pragma unroll\n    for (int r = 0; r < kWords; ++r) {\n"
             "      x[r] = total[r];\n    }\n  }\n")], True),
    "flat dot at 512 threads an SM": (
        "the flat dot at the row passes' 512 threads an SM (up to 128 registers, one block at "
        "n = 4096) at every n, the sum's words read eight at a time below n = 8192, not at "
        "1024 (64 registers, tight) from n = 128", [(DOT_BLOCKS, "  return scaled_blocks(log_n);")],
        True),
}
#: the entry points an --against source runs on the first core's flat tables
AGAINST_FLAT = ("matvec",)
ENTRIES = {"forward": 2, "inverse": 2, "forward_cols": 3, "inverse_cols": 3}  # int arguments
PRODUCT_TYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_uint64] * 4 + [
    ctypes.c_void_p]
SCALED_TYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_uint64] * 4 + [
    ctypes.c_void_p]
DOT_TYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_uint64] * 4 + [
    ctypes.c_int, ctypes.c_void_p]
FLAT_DOT_TYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_uint64] * 4 + [
    ctypes.c_int, ctypes.c_void_p]
FORWARD_SCALED_TYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_uint64] * 3 + [
    ctypes.c_void_p]  # nwc64_inverse_scaled's too
MATVEC_TYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_uint64] * 4 + [
    ctypes.c_void_p]
#: the instantiations whose registers and spills each build reports, and the
#: fused kernels (mangled prefixes) whose every instantiation it scans for spills
SUMMARY = ("transform_kernelILi12ELb0ELb0EE", "product_kernelILi12ELb0EE",
           "cyclic_scaled_kernelILi7ELb0EE", "dot_scaled_kernelILi7ELb0ELb1EE",
           "forward_scaled_kernelILi7EE", "dot_scaled_kernelILi12ELb0ELb0EE",
           "inverse_scaled_kernelILi7EE", "matvec_kernelILi12EE")
FUSED = ("product_kernelILi", "cyclic_scaled_kernelILi", "dot_scaled_kernelILi",
         "forward_scaled_kernelILi", "inverse_scaled_kernelILi", "matvec_kernelILi")


def build(source: str, out: Path, prefix: str = "nwc64", argtypes=None, kernels=SUMMARY,
          fused=FUSED) -> ctypes.CDLL:
    """Build ``source`` with the kernels' flags into ``out`` and load it;
    type each entry point ``<prefix>_<entry>`` of ``argtypes`` (by default
    nwc64.cu's radix and fused entries); its ``summary`` is the registers
    and spills of each of ``kernels`` (mangled names: by default
    ``SUMMARY``, the last two skipped where the source has none) and which
    instantiations of the fused kernels (their mangled prefixes, one or a
    tuple) spill."""
    path = out.with_suffix(".cu")
    path.write_text(source)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(out), str(path)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path.name}:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    summary = []
    for kernel in kernels:
        at = next((i for i, line in enumerate(lines)
                   if "Compiling entry" in line and kernel in line), None)
        if at is None:
            continue
        spill = next(line.strip() for line in lines[at:] if "spill" in line)
        regs = next(re.search(r"Used (\d+) registers", line).group(1) for line in lines[at:]
                    if "registers" in line)
        summary.append(f"{kernel}: {regs} registers, {spill}")
    text = "\n".join(lines)
    spilling = [f"{m.group(1)}<{', '.join([m.group(2), *re.findall(r'Lb(\d)E', m.group(3))])}>: "
                f"{m.group(4)}/{m.group(5)} bytes"
                for prefix_ in ((fused,) if isinstance(fused, str) else fused)
                for m in re.finditer(
                    "(" + prefix_ + r")(\d+)E((?:Lb\dE)*)E\S*\n[^\n]*?(\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads", text) if m.group(4) != "0" or m.group(5) != "0"]
    summary.append(f"fused kernels spilling (stores/loads): {spilling or 'none'}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    if argtypes is None:
        argtypes = {entry: [ptr] * 4 + [i32] * ints + [u64] * 3 + [ptr]
                    for entry, ints in ENTRIES.items()}
        argtypes.update(product=PRODUCT_TYPES, cached=PRODUCT_TYPES, cyclic_scaled=SCALED_TYPES,
                        cached_scaled=SCALED_TYPES, dot_scaled=DOT_TYPES, dot=FLAT_DOT_TYPES,
                        forward_scaled=FORWARD_SCALED_TYPES,
                        inverse_scaled=FORWARD_SCALED_TYPES, matvec=MATVEC_TYPES)
    for entry, types in argtypes.items():
        fn = getattr(lib, f"{prefix}_{entry}")
        fn.argtypes = types
        fn.restype = ctypes.c_int
    lib.summary = "; ".join(summary)
    return lib


def build_all(source: str, variants: dict, tmp: Path, name: str, *args) -> dict:
    """Every variant of ``source`` built (``build(text, path, *args)``), six
    nvcc at a time; prints each one's summary; name -> library, in order."""
    texts = []
    for variant, (what, edits, right) in variants.items():
        text = source
        for line, new in edits:
            if line not in text:
                raise RuntimeError(f"variant {variant!r}: its line is not in {name}")
            text = text.replace(line, new)
        texts.append(text)
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        built = list(pool.map(lambda k: build(texts[k], tmp / f"libvariant{k}.so", *args),
                              range(len(texts))))
    for (variant, (what, _, right)), lib in zip(variants.items(), built):
        print(f"variant {variant}: {what}{'' if right else ' (other integers)'}; {lib.summary}")
    return dict(zip(variants, built))


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


def first_core_threads(log_n: int) -> int:
    """A first-core kernel's threads a row (nwc64.cu's threads_for)."""
    n = 1 << log_n
    return min(max(n // 8, min(n // 2, 32)), 1024)


def first_core_trips(log_n: int) -> tuple:
    """The loop trips of the first core's product after its first barrier
    (the forward's butterfly and stage loops, the slot loop, the inverse's
    two, the store loop)."""
    n, threads = 1 << log_n, first_core_threads(log_n)
    return (n // 2 // threads, log_n, n // threads) * 2


def inverse_trips(log_n: int) -> tuple:
    """The same for the first core's row inverse, and for its matvec after
    its accumulation: its butterfly and stage loops, then its store loop."""
    n, threads = 1 << log_n, first_core_threads(log_n)
    return (n // 2 // threads, log_n, n // threads)


def count_against(lib: Path, kernels: dict, row_threads=first_core_threads) -> None:
    """Print the instructions a thread of each first-core kernel of the
    library ``lib`` issues after its first barrier at each log n (kernel ->
    {log n: its loops' trips}), and a row's (times its threads at log n,
    ``row_threads``), by chip_smoke.py's count."""
    import chip_smoke

    listing = chip_smoke.sass_listing(lib)
    for kernel, logs in kernels.items():
        if kernel not in listing:
            print(f"against: no {kernel} in that source")
            continue
        for log_n, trips in logs.items():
            issued = chip_smoke.issued_per_thread(listing[kernel], trips)
            threads = row_threads(log_n)
            print(f"against: {kernel} at n = {1 << log_n}, loop trips {trips}: a thread "
                  f"issues {issued} after its first barrier, a row of {threads} threads "
                  f"{issued * threads if issued else None}"
                  + ("" if issued else f"; its loops {chip_smoke.sass_loops(listing[kernel])}"))


def chosen(variants: dict, only: str | None) -> dict:
    """The base and the variants ``--only`` names (all without it)."""
    names = only.split(",") if only else list(variants)
    return {name: v for name, v in variants.items() if name == "base" or name in names}


def parse_args(name: str):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help=f"an earlier {name} to build, count and time beside the variants "
                        "(its fused entries read the flat tables)")
    parser.add_argument("--build-only", action="store_true",
                        help="build every variant and report its registers and spills, no timing")
    parser.add_argument("--only", default=None,
                        help="comma-separated variant names to build (base always)")
    return parser.parse_args()


def main() -> int:
    opts = parse_args("nwc64.cu")
    if not torch.cuda.is_available():
        print("nwc64_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    source = (_build.CSRC / "nwc64.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(source, chosen(VARIANTS, opts.only), Path(tmp), "nwc64.cu")
        if opts.build_only:
            return 0
        if opts.against:
            path = Path(tmp) / "libagainst.so"
            libs["against"] = build(opts.against.read_text(), path,
                                    kernels=("transform_kernelILi12ELb0ELb0EE",))
            print(f"against {opts.against}: {libs['against'].summary}")
            count_against(path, {"matvec_kernel": {12: inverse_trips(12)}})
        device = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        stream = torch.cuda.current_stream().cuda_stream
        cases = []  # (label, entry, out, C arguments, the tensors they point into)

        def residues(p, shape):
            return torch.from_numpy(rng.integers(0, p.p.q, size=shape, dtype=np.int64)).to(device)

        plan = SubPlan64(P60_4096, device)
        x = residues(plan, (2048, 4096))
        for entry, flat in (("forward", plan.plan.merged_flat),
                            ("inverse", plan.plan.merged_inv_flat)):
            tw, out = plan._transform_table(flat), torch.empty_like(x)
            scale = plan._scale_one if entry == "forward" else plan._scale_cached
            cases.append((f"nwc64_{entry} P60_4096 B=2048", entry, out,
                          (x.data_ptr(), out.data_ptr(), tw[0].data_ptr(), tw[1].data_ptr(),
                           2048, plan.p.log_n, plan.p.q, *scale, stream), (x, tw)))
        for n1, width, batch in ((256, 128, 256), (1024, 1024, 4)):
            col = SubPlan64(make_params(n1, 576460752308273153), device)
            xc = residues(col, (batch, n1 * width))
            for entry, flat in (("forward_cols", col.plan.merged_flat),
                                ("inverse_cols", col.plan.merged_inv_flat)):
                tw, out = col._transform_table(flat), torch.empty_like(xc)
                scale = col._scale_one if entry == "forward_cols" else col._scale_cached
                cases.append((f"nwc64_{entry} {n1} x {width} B={batch}", entry, out,
                              (xc.data_ptr(), out.data_ptr(), tw[0].data_ptr(),
                               tw[1].data_ptr(), batch, col.p.log_n, width, col.p.q, *scale,
                               stream), (xc, tw)))
        y = residues(plan, (2048, 4096))
        spectrum = plan.nwc_spectrum_plain(y)
        tw = plan._transform_table(plan.plan.merged_flat)
        itw = plan._transform_table(plan.plan.merged_inv_flat)
        flat = (plan.plan.merged_flat, plan.plan.merged_inv_flat)  # what --against reads
        for entry, z, scale in (("product", y, plan._scale_fresh),
                                ("cached", spectrum, plan._scale_cached)):
            out = torch.empty_like(x)
            call = [(x.data_ptr(), z.data_ptr(), out.data_ptr(),
                     *(w.data_ptr() for t in tables for w in t), 2048, plan.p.log_n,
                     *plan._q_args(True), *scale, stream) for tables in ((tw, itw), flat)]
            cases.append((f"nwc64_{entry} P60_4096 B=2048", entry, out, call[0],
                          (x, z, tw, itw, flat, call[1])))
        # the four-step's row passes: p60_32768's (256 x 128, B = 256) and
        # p60_1048576's (1024 x 1024, B = 4) rows of n2 at period n1, and the
        # dot's at K = 4 on p60_32768's 64 polynomials (16384 rows of 128)
        for n1, n2, rows, terms in ((256, 128, 65536, 0), (1024, 1024, 4096, 0),
                                    (256, 128, 16384, 4)):
            row = SubPlan64(make_params(n2, 576460752308273153), device)
            shape = (terms, rows, n2) if terms else (rows, n2)
            a, b = residues(row, shape), residues(row, shape)
            pre, post = (tuple(t.reshape(n1, n2) for t in row.ring.encode_tw(
                rng.integers(0, row.p.q, size=n1 * n2).tolist(), device)) for _ in range(2))
            spectrum = row.ntt_fwd_scaled_plain(b.reshape(-1, n2), pre, True).reshape(shape)
            flat = (row.plan.cyclic_flat, row.plan.cyclic_inv_flat)  # what --against reads
            out = torch.empty((rows, n2), dtype=torch.int64, device=device)
            entries = (("dot_scaled", b, row._scale_fresh, (terms, 0)),
                       ("dot_scaled", spectrum, row._scale_cached, (terms, 1))) if terms else (
                ("cyclic_scaled", b, row._scale_fresh, ()),
                ("cached_scaled", spectrum, row._scale_cached, ()))
            for entry, z, scale, dot in entries:
                call = [(a.data_ptr(), z.data_ptr(), out.data_ptr(),
                         *(w.data_ptr() for t in tables for w in t),
                         *(w.data_ptr() for w in pre + post), n1, *dot[:1], rows, row.p.log_n,
                         *row._q_args(True), *scale, *dot[1:], stream)
                        for tables in ((row._transform_table(flat[0]),
                                        row._transform_table(flat[1])), flat)]
                label = (f"nwc64_{entry} {rows} rows of {n2}, period {n1}"
                         + (f", K={terms}" + (" cached" if dot[1] else "") if terms else ""))
                keep = (a, z, pre, post, flat, [row._transform_table(t) for t in flat], call[1])
                cases.append((label, entry, out, call[0], keep))
            if not terms:  # the row forward of a, at scale 1, and the row inverse
                fout = torch.empty_like(a)
                call = [(a.data_ptr(), fout.data_ptr(), *(w.data_ptr() for w in tw),
                         *(w.data_ptr() for w in pre), n1, rows, row.p.log_n, row.p.q,
                         *row._scale_one, stream)
                        for tw in (row._transform_table(flat[0]), flat[0])]
                cases.append((f"nwc64_forward_scaled {rows} rows of {n2}, period {n1}",
                              "forward_scaled", fout, call[0],
                              (a, fout, pre, flat, row._transform_table(flat[0]), call[1])))
                iout = torch.empty_like(a)
                call = [(a.data_ptr(), iout.data_ptr(), *(w.data_ptr() for w in itw),
                         *(w.data_ptr() for w in post), n1, rows, row.p.log_n, row.p.q,
                         *row._scale_cached, stream)
                        for itw in (row._transform_table(flat[1]), flat[1])]
                cases.append((f"nwc64_inverse_scaled {rows} rows of {n2}, period {n1}",
                              "inverse_scaled", iout, call[0],
                              (a, iout, post, flat, row._transform_table(flat[1]), call[1])))
        # the flat dot at P60_4096, K = 4, B = 512, fresh and cached
        a4, b4 = residues(plan, (4, 512, 4096)), residues(plan, (4, 512, 4096))
        s4 = plan.nwc_spectrum_plain(b4.reshape(-1, 4096)).reshape(b4.shape)
        out = torch.empty((512, 4096), dtype=torch.int64, device=device)
        merged = (plan.plan.merged_flat, plan.plan.merged_inv_flat)  # what --against reads
        for z, scale, cached in ((b4, plan._scale_fresh, 0), (s4, plan._scale_cached, 1)):
            call = [(a4.data_ptr(), z.data_ptr(), out.data_ptr(),
                     *(w.data_ptr() for t in tables for w in t), 4, 512, plan.p.log_n,
                     *plan._q_args(True), *scale, cached, stream)
                    for tables in ((plan._transform_table(merged[0]),
                                    plan._transform_table(merged[1])), merged)]
            cases.append(("nwc64_dot P60_4096 K=4 B=512" + (" cached" if cached else ""), "dot",
                          out, call[0],
                          (a4, z, merged, [plan._transform_table(t) for t in merged], call[1])))
        # the matvec's accumulate-and-inverse at P60_4096, 4 x 4, B = 256, on
        # the plain spectra of s (the wrapper's forward) and A's cached ones
        s4 = residues(plan, (4, 256, 4096))
        fs4 = plan.nwc_ntt_fwd_plain(s4.reshape(-1, 4096)).reshape(s4.shape)
        mat4 = plan.nwc_matvec_spectra_plain(residues(plan, (4, 4, 4096)))
        mout = torch.empty((4, 256, 4096), dtype=torch.int64, device=device)
        inv = plan.plan.merged_inv_flat  # what --against reads
        call = [(fs4.data_ptr(), mat4.data_ptr(), mout.data_ptr(), *(w.data_ptr() for w in t), 4,
                 4, 256, plan.p.log_n, *plan._q_args(True), *plan._scale_cached, stream)
                for t in (plan._transform_table(inv), inv)]
        cases.append(("nwc64_matvec P60_4096 4x4 B=256", "matvec", mout, call[0],
                      (fs4, mat4, inv, plan._transform_table(inv), call[1])))
        times, want = {}, {}
        for _ in range(2):
            for label, entry, out, call, keep in cases:
                for name, lib in libs.items():
                    fn = getattr(lib, f"nwc64_{entry}")
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

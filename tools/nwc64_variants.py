#!/usr/bin/env python3
"""Where the radix-8 core of nwc64.cu spends its time: variants of the source,
some deliberately wrong, built and timed beside it on the card.

    python3 tools/nwc64_variants.py [--against OLD/nwc64.cu]

Each variant edits lines of ``tpu_ntt_torch/kernels/csrc/nwc64.cu``
(``VARIANTS``) and is built by nvcc with the kernels' own flags
(``kernels/_build.FLAGS``) into a temporary directory; then
``nwc64_forward`` and ``nwc64_inverse`` at P60_4096, B = 2048,
``nwc64_forward_cols`` and ``nwc64_inverse_cols`` at the column shapes of
p60_32768 (256 x 128, B = 256) and p60_1048576 (1024 x 1024, B = 4), and
the fused ``nwc64_product`` and ``nwc64_cached`` at P60_4096, B = 2048, run
under every variant in turns, each timed by CUDA events: the best of three
runs of 50 launches, over two rounds.  A variant marked wrong computes other
integers: its time says what the work it drops costs, nothing else; every
other variant must give the base's integers.  ``--against`` builds an
earlier nwc64.cu beside them (whose product and cached entries read the
flat tables: the first core's), times it in the same turns, holds it to the
base's integers, and counts the instructions its first-core product issues
(cuobjdump, chip_smoke.py's count).  Needs a CUDA device and nvcc; prints
the card's name and power limit.
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
STORE = ("  for (int r = 0; r < kWords; ++r) {  // [0, 2q) -> [0, q), n^-1 (and 2^64) folded in\n"
         "    x[r] = csub(shoup_lazy(x[r], scale, scale_shoup, q), q);")
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
}
ENTRIES = {"forward": 2, "inverse": 2, "forward_cols": 3, "inverse_cols": 3}  # int arguments
PRODUCT_TYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_uint64] * 4 + [
    ctypes.c_void_p]


def build(source: str, out: Path, prefix: str = "nwc64", argtypes=None,
          kernels=("transform_kernelILi12ELb0ELb0EE", "product_kernelILi12ELb0EE"),
          fused="product_kernelILi") -> ctypes.CDLL:
    """Build ``source`` with the kernels' flags into ``out`` and load it;
    type each entry point ``<prefix>_<entry>`` of ``argtypes`` (by default
    nwc64.cu's radix and fused entries); its ``summary`` is the registers
    and spills of each of ``kernels`` (mangled names: by default
    ``transform_kernel<12, 0, 0>`` and ``product_kernel<12, 0>``) and
    which instantiations of the fused kernel (its mangled prefix) spill."""
    path = out.with_suffix(".cu")
    path.write_text(source)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(out), str(path)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path.name}:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    summary = []
    for kernel in kernels:
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and kernel in line)
        spill = next(line.strip() for line in lines[at:] if "spill" in line)
        regs = next(re.search(r"Used (\d+) registers", line).group(1) for line in lines[at:]
                    if "registers" in line)
        summary.append(f"{kernel}: {regs} registers, {spill}")
    text = "\n".join(lines)
    spilling = [f"<{m.group(1)}, {m.group(2)}>: {m.group(3)}/{m.group(4)} bytes" for m in re.finditer(
        fused + r"(\d+)ELb(\d)EE\S*\n[^\n]*?(\d+) bytes spill stores, (\d+) bytes spill loads",
        text) if m.group(3) != "0" or m.group(4) != "0"]
    summary.append(f"fused kernels spilling (stores/loads): {spilling or 'none'}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    if argtypes is None:
        argtypes = {entry: [ptr] * 4 + [i32] * ints + [u64] * 3 + [ptr]
                    for entry, ints in ENTRIES.items()}
        argtypes.update(product=PRODUCT_TYPES, cached=PRODUCT_TYPES)
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


def first_core_trips(log_n: int) -> tuple:
    """The loop trips of the first core's product after its first barrier
    (the forward's butterfly and stage loops, the slot loop, the inverse's
    two, the store loop) at threads_for(log n) threads a row."""
    n = 1 << log_n
    threads = min(max(n // 8, min(n // 2, 32)), 1024)
    return (n // 2 // threads, log_n, n // threads) * 2


def count_against(lib: Path, kernels: dict) -> None:
    """Print the instructions a thread of each first-core kernel of the
    library ``lib`` issues after its first barrier at each log n (kernel ->
    log n's), and a row's (times its threads), by chip_smoke.py's count."""
    import chip_smoke

    listing = chip_smoke.sass_listing(lib)
    for kernel, logs in kernels.items():
        for log_n in logs:
            trips = first_core_trips(log_n)
            issued = chip_smoke.issued_per_thread(listing[kernel], trips)
            threads = (1 << log_n) // trips[2]
            print(f"against: {kernel} at n = {1 << log_n}, loop trips {trips}: a thread "
                  f"issues {issued} after its first barrier, a row of {threads} threads "
                  f"{issued * threads if issued else None}")


def parse_args(name: str):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help=f"an earlier {name} to build, count and time beside the variants "
                        "(its fused entries read the flat tables)")
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
        libs = build_all(source, VARIANTS, Path(tmp), "nwc64.cu")
        if opts.against:
            path = Path(tmp) / "libagainst.so"
            libs["against"] = build(opts.against.read_text(), path,
                                    kernels=("transform_kernelILi12ELb0ELb0EE",))
            print(f"against {opts.against}: {libs['against'].summary}")
            count_against(path, {"product_kernel<0>": (12,), "product_kernel<1>": (12,)})
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
        times, want = {}, {}
        for _ in range(2):
            for label, entry, out, call, keep in cases:
                for name, lib in libs.items():
                    fn = getattr(lib, f"nwc64_{entry}")
                    args = keep[-1] if name == "against" and entry in ("product", "cached") \
                        else call
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

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port, ``tpu_ntt_torch``.

Run it from the root of a checkout on a machine with an NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

It drives the port's two paths: the 60-bit product (P60_4096,
``kernels/csrc/nwc64.cu``) and the 24-bit family on every op (P24_4096 and
the ML-DSA-44-shaped DILITHIUM_256 4 x 4 matvec, ``kernels/csrc/nwc32.cu``).
Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi), its SM count and
   top SM clock;
2. build: nvcc builds both CUDA sources from csrc/, in parallel; ptxas's
   registers and spills;
3. kernel vs plain: each kernel function equals its plain PyTorch version
   bit for bit on the card, with boundary rows of 0, 1 and q - 1: nwc64 at
   B = 2048 for n = 4096, 256 and 8192; every K3a entry at P24_4096,
   B = 2048; the product at FALCON_1024 and at n = 16384 (q = 16580609),
   B = 2048; the dot and the cached dot at P24_4096, K = 4, B = 512; the
   matvec spectra and the 4 x 4 matvec at DILITHIUM_256, B = 8192;
4. oracle: c(x) == a(x) * b(x) mod q at x = psi^(2k+1), a root of x^n + 1,
   by Python-int Horner evaluation, and one row against the golden model,
   at P60_4096 and at P24_4096; inv(fwd(x)) == x, cyclic and negacyclic;
5. main path: ``dispatch.best_nwc_poly_mult(P60_4096)``, then
   ``dispatch.best(P24_4096, op)`` for each of the twelve ops, then
   ``dispatch.best_nwc_matvec(DILITHIUM_256)``, each run with the launch
   counts set to 0 just before it and read just after: each goes through
   its kernel and returns what its plain version returns;
6. timing: each kernel function, through the main path, and its plain
   version by CUDA events, in turns plain, kernel, kernel, plain; the plain
   versions with few iterations.  Products, forward transforms and matvecs
   per second for the three headline rows.

The line before the last lists each kernel with its launches on the main
path, its largest difference from its plain version, its time, its plain
version's time and its bound: the larger of its bytes over 3.35 TB/s and its
32-bit multiplies over the card's IMAD rate (132 SMs x 64 a clock x the top
SM clock), counting no multiply for a product by q where q's form makes it
shifts and adds.  The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result.  pytest cannot run on a machine without JAX
(tests/conftest.py imports it), so this script is the check of the port on
the card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np

BATCH = 2048  # bench.py's full batch for the p60_4096 and p24_4096 rows
DOT_TERMS, DOT_BATCH = 4, 512
MATVEC_BATCH = 8192  # bench.py's batch for the dilithium_256 matvec row
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
IMAD_PER_SM_CLOCK = 64  # 32-bit integer multiplies a clock, compute capability 9.0
# 32-bit multiplies (IMADs) in one modular product, before its product by q:
# Shoup-32 a*w and hi(a*w'); Montgomery-32 the wide a*b (two words) and
# m = lo*q'.  The 64-bit forms build a wide product from four 32 x 32 ones:
# Shoup-64 lo64(a*w) (4) and hi64(a*w') (8); Montgomery-64 a*b (8) and
# lo64(m) (4).
MULS = {"shoup32": 2, "mont32": 3, "shoup64": 12, "mont64": 12}
# The product by q: Shoup's lo(t*q), REDC's hi(m*q).
MULS_BY_Q = {"shoup32": 1, "mont32": 1, "shoup64": 4, "mont64": 8}


def naf_weight(q: int) -> int:
    """Nonzero digits of q in signed binary (non-adjacent form)."""
    weight = 0
    while q:
        if q & 1:
            q -= 2 - (q & 3)  # the digit +1 or -1 that leaves q even
            weight += 1
        q >>= 1
    return weight


def muls(form: str, q: int) -> int:
    """The 32-bit multiplies one modular product of ``form`` needs at q.  A
    product by a q of at most three signed binary digits, such as
    2^23 - 2^13 + 1 or 2^60 - 2^14 + 1, is shifts and adds: no multiply."""
    return MULS[form] + (MULS_BY_Q[form] if naf_weight(q) > 3 else 0)


SOURCES = {"nwc64": "tpu_ntt_torch/kernels/csrc/nwc64.cu",
           "nwc32": "tpu_ntt_torch/kernels/csrc/nwc32.cu"}
#: the TPU kernel body each function replaces
REPLACES = {
    "nwc64": "tpu_ntt/kernels/mxu64.py:1442",  # MxuPlan64._nwc_kernel (SolinasPlan64)
    "nwc32_product": "tpu_ntt/kernels/mxu.py:480",  # _nwc_kernel, K3a
    "nwc32_cached": "tpu_ntt/kernels/mxu.py:596",  # _nwc_cached_kernel, K3a
    "nwc32_forward": "tpu_ntt/kernels/mxu.py:615",  # _nwc_fwd_kernel (+ :584), K3a
    "nwc32_inverse": "tpu_ntt/kernels/mxu.py:627",  # _nwc_inv_kernel, K3a
    "nwc32_dot": "tpu_ntt/kernels/mxu.py:506",  # _make_dot_kernel, K3b
    "nwc32_matvec": "tpu_ntt/kernels/mxu.py:544",  # _make_matvec_kernel, K3c
}
#: which kernel each dispatch op of the 24-bit path launches
OP_KERNEL = {
    "nwc": "nwc32_product", "cyclic": "nwc32_product", "fwd": "nwc32_forward",
    "inv": "nwc32_inverse", "nwc_fwd": "nwc32_forward", "nwc_inv": "nwc32_inverse",
    "spectrum": "nwc32_forward", "cached": "nwc32_cached", "dot": "nwc32_dot",
    "dot_cached": "nwc32_dot", "matvec_spectra": "nwc32_forward",
    "matvec": "nwc32_matvec",
}


def operands(q: int, n: int, rows: int, rng: np.random.Generator, dtype=np.int64):
    """Random (rows, n) residues with boundary rows: a's rows 0-3 are all
    0, all 1, all q - 1 and [0, 1, q - 1] cycled; b holds the same rows in
    reverse order at 0-3 and again at 4-7, against random a rows."""
    a = rng.integers(0, q, size=(rows, n), dtype=np.int64)
    b = rng.integers(0, q, size=(rows, n), dtype=np.int64)
    edge = np.stack([np.zeros(n, np.int64), np.ones(n, np.int64),
                     np.full(n, q - 1, np.int64),
                     np.resize(np.array([0, 1, q - 1], np.int64), n)])
    a[:4] = edge
    b[:4] = edge[::-1]
    b[4:8] = edge
    return a.astype(dtype), b.astype(dtype)


def horner(coeffs, x: int, q: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % q
    return acc


def check_evaluations(name: str, p, a_rows, b_rows, c_rows, rng) -> None:
    """c(x) == a(x) b(x) at x = psi^(2k+1), three k for each row."""
    for row, (av, bv, cv) in enumerate(zip(a_rows, b_rows, c_rows)):
        for k in rng.integers(0, p.n, size=3).tolist():
            x = pow(p.psi, 2 * k + 1, p.q)  # x^n = psi^(n(2k+1)) = -1
            if horner(cv, x, p.q) != horner(av, x, p.q) * horner(bv, x, p.q) % p.q:
                raise AssertionError(f"{name}: c(x) != a(x) b(x) at row {row}, k={k}")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from tpu_ntt_torch import dispatch, reference
    from tpu_ntt_torch.benchlib import device_seconds_per_call
    from tpu_ntt_torch.kernels import _build
    from tpu_ntt_torch.kernels.mxu import KERNELS, MxuPlan
    from tpu_ntt_torch.kernels.sol64 import SolinasPlan64
    from tpu_ntt_torch.params import (DILITHIUM_256, FALCON_1024, P24_4096,
                                      P60_4096, make_params)

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    imad_per_s = sms * IMAD_PER_SM_CLOCK * sm_mhz * 1e6
    print(f"device: {kind}; count {torch.cuda.device_count()}; {sms} SMs, top SM "
          f"clock {sm_mhz:.0f} MHz, {imad_per_s:.4e} IMAD/s; nvidia-smi name, "
          "power.limit on the next line")
    print(card)

    # 2. build, one nvcc for each source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {name}: {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    ptxas: {line.strip()}")

    # 3. kernel vs plain version, bit for bit
    rng = np.random.default_rng(args.seed)
    errs: dict[str, int] = {}

    def compare(name: str, label: str, got, want) -> None:
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errs[name] = max(errs.get(name, 0), err)
        ok = torch.equal(got, want)
        print(f"kernel vs plain: {name} {label} equal={ok} max_abs_err={err}")
        if not ok:
            raise AssertionError(f"{name} differs from its plain version at {label}")

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in arrays]

    q60 = P60_4096.q
    for p in (P60_4096, make_params(256, q60), make_params(8192, q60)):
        a_np, b_np = operands(q60, p.n, BATCH, rng)
        a, b = on_card(a_np, b_np)
        plan = SolinasPlan64(p, device)
        got = plan.nwc_poly_mult(a, b)
        compare("nwc64", f"n={p.n} B={BATCH}", got, plan.nwc_poly_mult_plain(a, b))
        if p is P60_4096:
            plan60, a60, b60, c60, a60_np, b60_np = plan, a, b, got, a_np, b_np

    p24 = MxuPlan(P24_4096, device)
    q24, n24 = P24_4096.q, P24_4096.n
    a_np, b_np = operands(q24, n24, BATCH, rng, np.int32)
    a, b = on_card(a_np, b_np)
    spec_b = p24.nwc_spectrum(b)
    label = f"P24_4096 B={BATCH}"
    for name, op, method, inputs in (
            ("nwc32_product", "nwc", "nwc_poly_mult", (a, b)),
            ("nwc32_product", "cyclic", "cyclic_poly_mult", (a, b)),
            ("nwc32_forward", "fwd", "ntt_fwd", (a,)),
            ("nwc32_inverse", "inv", "ntt_inv", (a,)),
            ("nwc32_forward", "nwc_fwd", "nwc_ntt_fwd", (a,)),
            ("nwc32_inverse", "nwc_inv", "nwc_ntt_inv", (a,)),
            ("nwc32_forward", "spectrum", "nwc_spectrum", (b,)),
            ("nwc32_cached", "cached", "nwc_poly_mult_cached", (a, spec_b))):
        got = getattr(p24, method)(*inputs)
        compare(name, f"{op} {label}", got, getattr(p24, method + "_plain")(*inputs))
        if op == "nwc":
            c24 = got
    for p in (FALCON_1024, make_params(16384, 16580609)):
        plan = MxuPlan(p, device)
        x, y = on_card(*operands(p.q, p.n, BATCH, rng, np.int32))
        compare("nwc32_product", f"nwc {p.name} B={BATCH}", plan.nwc_poly_mult(x, y),
                plan.nwc_poly_mult_plain(x, y))
    a3, b3 = (t.reshape(DOT_TERMS, DOT_BATCH, n24) for t in on_card(
        *operands(q24, n24, DOT_TERMS * DOT_BATCH, rng, np.int32)))
    spec3 = p24.nwc_spectrum(b3.reshape(-1, n24)).reshape(b3.shape)
    label = f"K={DOT_TERMS} B={DOT_BATCH}"
    compare("nwc32_dot", f"dot {label}", p24.nwc_dot(a3, b3), p24.nwc_dot_plain(a3, b3))
    compare("nwc32_dot", f"dot_cached {label}", p24.nwc_dot_cached(a3, spec3),
            p24.nwc_dot_cached_plain(a3, spec3))
    pdil = MxuPlan(DILITHIUM_256, device)
    s_np, mat_np = operands(DILITHIUM_256.q, 256, 4 * MATVEC_BATCH, rng, np.int32)
    s_dil, mat_dil = on_card(s_np.reshape(4, MATVEC_BATCH, 256),
                             mat_np[:16].reshape(4, 4, 256))
    spec_dil = pdil.nwc_matvec_spectra(mat_dil)
    compare("nwc32_forward", "matvec_spectra DILITHIUM_256 4x4", spec_dil,
            pdil.nwc_matvec_spectra_plain(mat_dil))
    mv_dil = pdil.nwc_matvec_cached(s_dil, spec_dil)
    compare("nwc32_matvec", f"matvec DILITHIUM_256 4x4 B={MATVEC_BATCH}", mv_dil,
            pdil.nwc_matvec_cached_plain(s_dil, spec_dil))

    # 4. independent oracle: evaluation at roots of x^n + 1, and the golden
    for name, p, av, bv, cv in (
            ("P60_4096", P60_4096, a60_np, b60_np, c60),
            ("P24_4096", P24_4096, a_np.astype(np.int64), b_np.astype(np.int64), c24)):
        c_rows = cv[:8].cpu().tolist()
        check_evaluations(name, p, av[2:6].tolist(), bv[2:6].tolist(), c_rows[2:6], rng)
        if reference.nwc_poly_mult(av[4].tolist(), bv[4].tolist(), p) != c_rows[4]:
            raise AssertionError(f"{name}: row 4 differs from reference.nwc_poly_mult")
        print(f"oracle: {name} c(x) == a(x) b(x) at x = psi^(2k+1), rows 2-5, 3 k "
              "each; row 4 equals reference.nwc_poly_mult")
    for fwd, inv in (("nwc_ntt_fwd", "nwc_ntt_inv"), ("ntt_fwd", "ntt_inv")):
        if not torch.equal(getattr(p24, inv)(getattr(p24, fwd)(a)), a):
            raise AssertionError(f"{inv}({fwd}(x)) != x at P24_4096")
    print(f"oracle: nwc_ntt_inv(nwc_ntt_fwd(x)) == x and ntt_inv(ntt_fwd(x)) == x, "
          f"P24_4096 B={BATCH}")

    # 5. main paths, through the entry points a user calls
    name = dispatch.impl_name(P60_4096)
    mult60 = dispatch.best_nwc_poly_mult(P60_4096)
    SolinasPlan64.launches = 0
    c = mult60(a60, b60)
    torch.cuda.synchronize()
    launches = {"nwc64": SolinasPlan64.launches}
    if name != SolinasPlan64.name or launches["nwc64"] < 1:
        raise AssertionError(f"main path ran {name!r} with {launches['nwc64']} launches")
    if c.shape != (BATCH, P60_4096.n) or not torch.equal(c, c60):
        raise AssertionError("main path result differs from the checked product")
    print(f"main path: best_nwc_poly_mult(P60_4096) via {name}, {launches['nwc64']} "
          "launch(es), equal to the checked product")

    def drive(label, p, fn, inputs, plain, expect):
        """Run fn with the counts at 0, read them, check against plain."""
        for k in KERNELS:
            MxuPlan.launches[k] = 0
        out = fn(*inputs)
        torch.cuda.synchronize()
        counts = dict(MxuPlan.launches)
        if any(counts[k] < 1 for k in expect):
            raise AssertionError(f"main path {label} did not launch {expect}: {counts}")
        if not torch.equal(out, plain(*inputs)):
            raise AssertionError(f"main path {label} differs from its plain version")
        if not bool(((out >= 0) & (out < p.q)).all()):
            raise AssertionError(f"main path {label} leaves [0, q)")
        for k in KERNELS:
            launches[k] = launches.get(k, 0) + counts[k]
        print(f"main path: {label} via {dispatch.impl_name(p)}, launches "
              f"{ {k: v for k, v in counts.items() if v} }, shape {tuple(out.shape)}")
        return out

    mat24 = a3[:, :4].permute(1, 0, 2).contiguous()  # a 4 x 4 matrix of rows
    spec_mat24 = p24.nwc_matvec_spectra(mat24)
    main_inputs = {
        "nwc": (a, b), "cyclic": (a, b), "fwd": (a,), "inv": (a,), "nwc_fwd": (a,),
        "nwc_inv": (a,), "spectrum": (b,), "cached": (a, spec_b), "dot": (a3, b3),
        "dot_cached": (a3, spec3), "matvec_spectra": (mat24,),
        "matvec": (b3, spec_mat24),
    }
    best24 = {}
    for op in dispatch.OPS:
        if dispatch.impl_name(P24_4096, op) != MxuPlan.name:
            raise AssertionError(f"{op} at P24_4096 is not served by {MxuPlan.name}")
        best24[op] = dispatch.best(P24_4096, op)
        drive(f"best(P24_4096, {op!r})", P24_4096, best24[op], main_inputs[op],
              getattr(p24, dispatch.METHODS[op] + "_plain"), [OP_KERNEL[op]])
    spectra_fn = dispatch.best_nwc_matvec_spectra(DILITHIUM_256)
    matvec_fn = dispatch.best_nwc_matvec(DILITHIUM_256)
    drive("best_nwc_matvec_spectra(DILITHIUM_256)", DILITHIUM_256, spectra_fn,
          (mat_dil,), pdil.nwc_matvec_spectra_plain, ["nwc32_forward"])
    out = drive(f"best_nwc_matvec(DILITHIUM_256) 4x4 B={MATVEC_BATCH}", DILITHIUM_256,
                matvec_fn, (s_dil, spec_dil), pdil.nwc_matvec_cached_plain,
                ["nwc32_forward", "nwc32_matvec"])
    if not torch.equal(out, mv_dil):
        raise AssertionError("the DILITHIUM_256 matvec differs from the checked one")

    # 6. timing, in turns: plain, kernel (through the main path), kernel, plain
    n, t24 = P24_4096.n, P24_4096.log_n * P24_4096.n // 2  # butterflies a row
    t60 = P60_4096.log_n * P60_4096.n // 2
    tdil = DILITHIUM_256.log_n * 256 // 2
    shoup, mont = muls("shoup32", P24_4096.q), muls("mont32", P24_4096.q)
    shoup_dil, mont_dil = muls("shoup32", DILITHIUM_256.q), muls("mont32", DILITHIUM_256.q)
    shoup64, mont64 = muls("shoup64", P60_4096.q), muls("mont64", P60_4096.q)
    # name: (kernel, plain, inputs, plain iters, bytes, 32-bit multiplies)
    timed = {
        "nwc64": (mult60, plan60.nwc_poly_mult_plain, (a60, b60), (2, 6),
                  3 * BATCH * n * 8,
                  BATCH * (3 * t60 * shoup64 + n * (mont64 + shoup64))),
        "nwc32_product": (best24["nwc"], p24.nwc_poly_mult_plain, (a, b), (1, 3),
                          3 * BATCH * n * 4, BATCH * (3 * t24 * shoup + n * (mont + shoup))),
        "nwc32_forward": (best24["nwc_fwd"], p24.nwc_ntt_fwd_plain, (a,), (1, 3),
                          2 * BATCH * n * 4, BATCH * t24 * shoup),
        "nwc32_inverse": (best24["nwc_inv"], p24.nwc_ntt_inv_plain, (a,), (1, 3),
                          2 * BATCH * n * 4, BATCH * (t24 + n) * shoup),
        "nwc32_cached": (best24["cached"], p24.nwc_poly_mult_cached_plain, (a, spec_b),
                         (1, 3), 3 * BATCH * n * 4,
                         BATCH * (2 * t24 * shoup + n * (mont + shoup))),
        "nwc32_dot": (best24["dot"], p24.nwc_dot_plain, (a3, b3), (1, 3),
                      (2 * DOT_TERMS + 1) * DOT_BATCH * n * 4,
                      DOT_BATCH * (2 * DOT_TERMS * t24 * shoup + DOT_TERMS * n * mont
                                   + (t24 + n) * shoup)),
        # the whole op: the forward of s and the accumulate-and-inverse
        "nwc32_matvec": (matvec_fn, pdil.nwc_matvec_cached_plain, (s_dil, spec_dil),
                         (1, 3), (4 + 4) * MATVEC_BATCH * 256 * 4 + 16 * 256 * 4,
                         MATVEC_BATCH * (4 * tdil * shoup_dil
                                         + 4 * (4 * 256 * mont_dil
                                                + (tdil + 256) * shoup_dil))),
    }
    rows = []
    for name, (kernel, plain, inputs, plain_iters, nbytes, imads) in timed.items():
        times = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kernel if which == "kernel" else plain
            iters = (4, 20) if which == "kernel" else plain_iters
            times[which].append(device_seconds_per_call(fn, *inputs, iters=iters))
        t_kernel, t_plain = min(times["kernel"]), min(times["plain"])
        t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, imads / imad_per_s
        print(f"timing {name} (s/call): kernel {times['kernel']} plain {times['plain']}; "
              f"bound: {nbytes} bytes {t_bytes:.4e} s, {imads} IMADs {t_ops:.4e} s")
        source = SOURCES["nwc64" if name == "nwc64" else "nwc32"]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,  # no PyTorch call computes an NTT product mod q
        })
    per_s = {r["name"]: 1e3 / r["ms"] for r in rows}
    print(f"nwc_poly_mult_p60_4096_per_sec: {BATCH * per_s['nwc64']:.1f}; "
          f"nwc_poly_mult_p24_4096_per_sec: {BATCH * per_s['nwc32_product']:.1f}; "
          f"fwd_ntt_p24_4096_per_sec: {BATCH * per_s['nwc32_forward']:.1f}; "
          f"dilithium_256_matvec_4x4_per_sec: {MATVEC_BATCH * per_s['nwc32_matvec']:.1f}; "
          f"B={BATCH} (matvec B={MATVEC_BATCH}); card {card}")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port, ``tpu_ntt_torch``.

Run it from the root of a checkout on a machine with an NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

It drives the port's three kernel families on every op: the 60-bit family
(``kernels/csrc/nwc64.cu``: P60_4096, a trinomial q on ``SolinasPlan64``,
and the generic prime 576460752308273153 at n = 4096 on ``MxuPlan64``), the
24-bit family (``kernels/csrc/nwc32.cu``: P24_4096 and the
ML-DSA-44-shaped DILITHIUM_256 4 x 4 matvec) and ML-KEM
(``kernels/csrc/kyber.cu``: every ``tpu_ntt_torch.kyber`` entry point at
ML-KEM-768's shapes, B = 16384).  Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi), its SM count and
   top SM clock;
2. build: nvcc builds the three CUDA sources from csrc/, in parallel;
   ptxas's registers and spills;
3. kernel vs plain: each kernel function equals its plain PyTorch version
   bit for bit on the card, with boundary rows of 0, 1 and q - 1: every op
   at P60_4096, B = 2048 (the dot at K = 4, B = 512, the matvec 4 x 4 at
   B = 256), the product, forward and inverse at n = 256 and 8192, the dot
   at n = 8192 (three rows of shared memory), every op at the generic q;
   every K3a entry at P24_4096, B = 2048; the product at FALCON_1024 and at
   n = 16384 (q = 16580609), B = 2048; the dot and the cached dot at
   P24_4096, K = 4, B = 512; the matvec spectra and the 4 x 4 matvec at
   DILITHIUM_256, B = 8192; every ``kyber_*`` function at B = 16384 (the
   dot at K = 3, fresh and cached; the matvec 3 x 3 from ``matvec_spectra``
   and from ``ntt_domain_blocks``), and the 2 x 2 and 4 x 4 matvecs of
   ML-KEM-512 and -1024 at B = 2048;
4. oracle: c(x) == a(x) * b(x) mod q at x = psi^(2k+1), a root of x^n + 1,
   by Python-int Horner evaluation, and one row against the golden model,
   at P60_4096, the generic q and P24_4096; inv(fwd(x)) == x, cyclic and
   negacyclic, at P60_4096 and P24_4096; one P60_4096 dot row equal to the
   sum of its golden products; ML-KEM rows equal to the FIPS-203 goldens
   (``reference.kyber_ntt``, ``kyber_intt``, ``kyber_poly_mult``, a 3 x 3
   matvec row as a sum of golden products), one product row equal to
   ``reference.schoolbook_negacyclic``, and intt(ntt(x)) == x at B = 16384;
5. main path: ``dispatch.best(p, op)`` for each of the twelve ops at
   P60_4096, at the generic q and at P24_4096, then
   ``dispatch.best_nwc_matvec`` at P60_4096 (4 x 4, B = 256) and at
   DILITHIUM_256, then the eleven ``tpu_ntt_torch.kyber`` entry points at
   B = 16384, each run with the launch counts set to 0 just before it and
   read just after: each goes through its kernel (``basemul`` and
   ``ntt_domain_blocks``, elementwise, through none), stays in [0, q) and
   returns what its plain version returns;
6. timing: each kernel function, through the main path, in turns plain,
   kernel, kernel, plain: its device time by the replay of its calls
   captured in a CUDA graph (``benchlib.graph_seconds_per_call``, the
   line's ``ms``), its time per call back to back by CUDA events, host
   time included, and the host's time to enqueue a call; the plain version
   by CUDA events, with few iterations.  Products, forward transforms and
   matvecs per second for the headline rows, and ML-KEM products, forward
   NTTs and 3 x 3 matvecs per second at B = 16384, from the back-to-back
   times: what a caller of the entry point gets.

The line before the last lists each kernel with its launches on the main
path, its largest difference from its plain version, its device time, its
plain version's time and its bound (``tpu_ntt_torch/bounds.py``): the larger of
its bytes over 3.35 TB/s and its 32-bit multiplies over the card's IMAD rate
(its SMs x 64 a clock x its top SM clock).  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the package beside it, the script exits
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
DOT_BATCH = 512  # the dot runs K = bounds.DOT_TERMS = 4 terms
DOT_BATCH_8192 = 256
MATVEC_BATCH = 8192  # bench.py's batch for the dilithium_256 matvec row
MATVEC_BATCH_60 = 256  # bench.py:153, the p60_4096 matvec row
Q_GENERIC = 576460752308273153  # bench.py:35: a 60-bit prime, not a trinomial
KYBER_SMALL_BATCH = 2048  # the ML-KEM-512 and -1024 matvecs, checked only
SOURCES = {"nwc64": "tpu_ntt_torch/kernels/csrc/nwc64.cu",
           "nwc32": "tpu_ntt_torch/kernels/csrc/nwc32.cu",
           "kyber": "tpu_ntt_torch/kernels/csrc/kyber.cu"}
#: the TPU kernel body each function replaces
REPLACES = {
    "nwc64_product": "tpu_ntt/kernels/mxu64.py:1442",  # _nwc_kernel (+ _cyclic_kernel :1474), K1a
    "nwc64_cached": "tpu_ntt/kernels/mxu64.py:1691",  # _nwc_cached_kernel, K1a
    "nwc64_forward": "tpu_ntt/kernels/mxu64.py:1715",  # _nwc_fwd_kernel (+ :1544, :1675), K1a
    "nwc64_inverse": "tpu_ntt/kernels/mxu64.py:1733",  # _nwc_inv_kernel (+ _inv_kernel :1559), K1a
    "nwc64_dot": "tpu_ntt/kernels/mxu64.py:1599",  # _make_dot_kernel, K1b
    "nwc64_matvec": "tpu_ntt/kernels/mxu64.py:1639",  # _make_matvec_kernel, K1c
    "nwc32_product": "tpu_ntt/kernels/mxu.py:480",  # _nwc_kernel, K3a
    "nwc32_cached": "tpu_ntt/kernels/mxu.py:596",  # _nwc_cached_kernel, K3a
    "nwc32_forward": "tpu_ntt/kernels/mxu.py:615",  # _nwc_fwd_kernel (+ :584), K3a
    "nwc32_inverse": "tpu_ntt/kernels/mxu.py:627",  # _nwc_inv_kernel, K3a
    "nwc32_dot": "tpu_ntt/kernels/mxu.py:506",  # _make_dot_kernel, K3b
    "nwc32_matvec": "tpu_ntt/kernels/mxu.py:544",  # _make_matvec_kernel, K3c
    "kyber_forward": "tpu_ntt/kernels/kyber.py:388",  # _transform_kernel (+ :291), K4a
    "kyber_inverse": "tpu_ntt/kernels/kyber.py:388",  # _transform_kernel (intt), K4a
    "kyber_product": "tpu_ntt/kernels/kyber.py:277",  # _poly_mult_kernel_v2, K4b
    "kyber_cached": "tpu_ntt/kernels/kyber.py:301",  # _cached_kernel_v2, K4b
    "kyber_dot": "tpu_ntt/kernels/kyber.py:311",  # _make_dot_kernel_v2, K4c
    "kyber_matvec": "tpu_ntt/kernels/kyber.py:336",  # _make_matvec_kernel_v2, K4d
}
#: which entry points of its family's source each dispatch op launches
OP_ENTRIES = {
    "nwc": ["product"], "cyclic": ["product"], "fwd": ["forward"],
    "inv": ["inverse"], "nwc_fwd": ["forward"], "nwc_inv": ["inverse"],
    "spectrum": ["forward"], "cached": ["cached"], "dot": ["dot"],
    "dot_cached": ["dot"], "matvec_spectra": ["forward"],
    "matvec": ["forward", "matvec"],
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
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from tpu_ntt_torch import dispatch, kyber, reference
    from tpu_ntt_torch.benchlib import (device_seconds_per_call, graph_seconds_per_call,
                                        host_seconds_per_call)
    from tpu_ntt_torch.bounds import (DOT_TERMS, IMAD_PER_SM_CLOCK, KYBER_BATCH,
                                      KYBER_K, seconds, work)
    from tpu_ntt_torch.kernels import _build
    from tpu_ntt_torch.kernels.kyber import KyberPlan
    from tpu_ntt_torch.kernels.mxu import MxuPlan
    from tpu_ntt_torch.kernels.mxu64 import MxuPlan64
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
        print(f"kernel vs plain: {name} {label} shape {tuple(got.shape)} equal={ok} "
              f"max_abs_err={err}")
        if not ok:
            raise AssertionError(f"{name} differs from its plain version at {label}")

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in arrays]

    def check_op(plan, op: str, label: str, inputs):
        """One op of a plan, kernel against plain; returns the kernel's."""
        method = dispatch.METHODS[op]
        got = getattr(plan, method)(*inputs)
        kernel = f"{plan.lib_name}_{OP_ENTRIES[op][-1]}"
        compare(kernel, f"{op} {label}", got, getattr(plan, method + "_plain")(*inputs))
        return got

    def op_inputs(plan, a, b, a3, b3, s, mat):
        """Inputs of every op: (B, n) a and b, (K, B, n) a3 and b3, and the
        (l, B, n) s of the matvec against the (k, l, n) matrix mat; the
        spectra come from the kernels (each checked against its plain)."""
        return {
            "nwc": (a, b), "cyclic": (a, b), "fwd": (a,), "inv": (a,),
            "nwc_fwd": (a,), "nwc_inv": (a,), "spectrum": (b,),
            "cached": (a, plan.nwc_spectrum(b)), "dot": (a3, b3),
            "dot_cached": (a3, plan.nwc_spectrum(b3.reshape(-1, plan.p.n))
                           .reshape(b3.shape)),
            "matvec_spectra": (mat,), "matvec": (s, plan.nwc_matvec_spectra(mat)),
        }

    def family_operands(p, dtype, batch, dot_batch, mv_batch):
        a, b = on_card(*operands(p.q, p.n, batch, rng, dtype))
        a3, b3 = (t.reshape(DOT_TERMS, dot_batch, p.n) for t in on_card(
            *operands(p.q, p.n, DOT_TERMS * dot_batch, rng, dtype)))
        s_np, m_np = operands(p.q, p.n, 4 * mv_batch, rng, dtype)
        s, mat = on_card(s_np.reshape(4, mv_batch, p.n), m_np[:16].reshape(4, 4, p.n))
        return a, b, a3, b3, s, mat

    # the 60-bit family: every op at P60_4096 (SolinasPlan64) and at the
    # generic q (MxuPlan64), the product, forward, inverse and dot at the
    # ends of its n window
    p_gen = make_params(4096, Q_GENERIC, name="q576460752308273153_4096")
    plan60, plan_gen = SolinasPlan64(P60_4096, device), MxuPlan64(p_gen, device)
    inputs60 = op_inputs(plan60, *family_operands(
        P60_4096, np.int64, BATCH, DOT_BATCH, MATVEC_BATCH_60))
    inputs_gen = op_inputs(plan_gen, *family_operands(
        p_gen, np.int64, BATCH, DOT_BATCH, MATVEC_BATCH_60))
    out60, out_gen = {}, {}
    for plan, inputs, outs, label in (
            (plan60, inputs60, out60, "P60_4096"),
            (plan_gen, inputs_gen, out_gen, f"q={Q_GENERIC} n=4096")):
        for op, x in inputs.items():
            outs[op] = check_op(plan, op, label, x)
    for n in (256, 8192):
        p = make_params(n, P60_4096.q)
        plan = SolinasPlan64(p, device)
        x, y = on_card(*operands(p.q, n, BATCH, rng))
        for op in ("nwc", "nwc_fwd", "nwc_inv"):
            check_op(plan, op, f"n={n} B={BATCH}", (x, y) if op == "nwc" else (x,))
        if n == 8192:
            x3, y3 = (t.reshape(DOT_TERMS, DOT_BATCH_8192, n) for t in on_card(
                *operands(p.q, n, DOT_TERMS * DOT_BATCH_8192, rng)))
            check_op(plan, "dot", f"n=8192 K={DOT_TERMS} B={DOT_BATCH_8192}", (x3, y3))

    # the 24-bit family
    p24 = MxuPlan(P24_4096, device)
    q24, n24 = P24_4096.q, P24_4096.n
    a_np, b_np = operands(q24, n24, BATCH, rng, np.int32)
    a, b = on_card(a_np, b_np)
    spec_b = p24.nwc_spectrum(b)
    label = f"P24_4096 B={BATCH}"
    for op, inputs in (("nwc", (a, b)), ("cyclic", (a, b)), ("fwd", (a,)),
                       ("inv", (a,)), ("nwc_fwd", (a,)), ("nwc_inv", (a,)),
                       ("spectrum", (b,)), ("cached", (a, spec_b))):
        got = check_op(p24, op, label, inputs)
        if op == "nwc":
            c24 = got
    for p in (FALCON_1024, make_params(16384, 16580609)):
        plan = MxuPlan(p, device)
        x, y = on_card(*operands(p.q, p.n, BATCH, rng, np.int32))
        check_op(plan, "nwc", f"{p.name} B={BATCH}", (x, y))
    a3, b3 = (t.reshape(DOT_TERMS, DOT_BATCH, n24) for t in on_card(
        *operands(q24, n24, DOT_TERMS * DOT_BATCH, rng, np.int32)))
    spec3 = p24.nwc_spectrum(b3.reshape(-1, n24)).reshape(b3.shape)
    label = f"K={DOT_TERMS} B={DOT_BATCH}"
    check_op(p24, "dot", label, (a3, b3))
    check_op(p24, "dot_cached", label, (a3, spec3))
    pdil = MxuPlan(DILITHIUM_256, device)
    s_np, mat_np = operands(DILITHIUM_256.q, 256, 4 * MATVEC_BATCH, rng, np.int32)
    s_dil, mat_dil = on_card(s_np.reshape(4, MATVEC_BATCH, 256),
                             mat_np[:16].reshape(4, 4, 256))
    spec_dil = check_op(pdil, "matvec_spectra", "DILITHIUM_256 4x4", (mat_dil,))
    mv_dil = check_op(pdil, "matvec", f"DILITHIUM_256 4x4 B={MATVEC_BATCH}",
                      (s_dil, spec_dil))

    # ML-KEM: every kyber.cu function at ML-KEM-768's shapes, B = 16384
    kp, kq, kb_ = KyberPlan(device), kyber.Q, KYBER_BATCH

    def check_kyber(method: str, entry: str, label: str, inputs):
        got = getattr(kp, method)(*inputs)
        compare(f"kyber_{entry}", f"{method} {label}", got,
                getattr(kp, method + "_plain")(*inputs))
        return got

    def kyber_stack(terms: int, batch: int):
        return [t.reshape(terms, batch, kyber.N) for t in on_card(
            *operands(kq, kyber.N, terms * batch, rng, np.int32))]

    ka, kb = on_card(*operands(kq, kyber.N, kb_, rng, np.int32))
    ka3, kb3 = kyber_stack(KYBER_K, kb_)
    kA, kA_hat = kyber_stack(KYBER_K, KYBER_K)  # A, and a matrix sampled as NTT-domain
    label = f"B={kb_}"
    kout = {
        "ntt": check_kyber("ntt", "forward", label, (ka,)),
        "intt": check_kyber("intt", "inverse", label, (ka,)),
        "spectrum": check_kyber("spectrum", "forward", label, (kb,)),
        "poly_mult": check_kyber("poly_mult", "product", label, (ka, kb)),
    }
    kspec = kout["spectrum"]
    kout["poly_mult_cached"] = check_kyber("poly_mult_cached", "cached", label,
                                           (ka, kspec))
    kspec3 = kp.spectrum(kb3.reshape(-1, kyber.N)).reshape(kb3.shape)
    label = f"K={KYBER_K} B={kb_}"
    kout["dot"] = check_kyber("dot", "dot", label, (ka3, kb3))
    kout["dot_cached"] = check_kyber("dot_cached", "dot", label, (ka3, kspec3))
    kout["matvec_spectra"] = check_kyber("matvec_spectra", "forward",
                                         f"{KYBER_K}x{KYBER_K}", (kA,))
    kblocks = kp.ntt_domain_blocks(kA_hat)
    label = f"{KYBER_K}x{KYBER_K} B={kb_}"
    kout["matvec"] = check_kyber("matvec", "matvec", label,
                                 (ka3, kout["matvec_spectra"]))
    check_kyber("matvec", "matvec", f"{label} from ntt_domain_blocks", (ka3, kblocks))
    for k in (2, 4):  # ML-KEM-512 and ML-KEM-1024
        s_k, b_k = kyber_stack(k, KYBER_SMALL_BATCH)
        A_k = b_k[:, :k].contiguous()
        check_kyber("matvec", "matvec", f"{k}x{k} B={KYBER_SMALL_BATCH}",
                    (s_k, kp.matvec_spectra(A_k)))

    # 4. independent oracle: evaluation at roots of x^n + 1, and the golden
    for name, p, (av, bv), cv in (
            ("P60_4096", P60_4096, inputs60["nwc"], out60["nwc"]),
            (p_gen.name, p_gen, inputs_gen["nwc"], out_gen["nwc"]),
            ("P24_4096", P24_4096, (a, b), c24)):
        a_rows, b_rows = av[:8].long().cpu().tolist(), bv[:8].long().cpu().tolist()
        c_rows = cv[:8].long().cpu().tolist()
        check_evaluations(name, p, a_rows[2:6], b_rows[2:6], c_rows[2:6], rng)
        if reference.nwc_poly_mult(a_rows[4], b_rows[4], p) != c_rows[4]:
            raise AssertionError(f"{name}: row 4 differs from reference.nwc_poly_mult")
        print(f"oracle: {name} c(x) == a(x) b(x) at x = psi^(2k+1), rows 2-5, 3 k "
              "each; row 4 equals reference.nwc_poly_mult")
    for name, plan, x in (("P60_4096", plan60, inputs60["nwc"][0]),
                          ("P24_4096", p24, a)):
        for fwd, inv in (("nwc_ntt_fwd", "nwc_ntt_inv"), ("ntt_fwd", "ntt_inv")):
            if not torch.equal(getattr(plan, inv)(getattr(plan, fwd)(x)), x):
                raise AssertionError(f"{inv}({fwd}(x)) != x at {name}")
        print(f"oracle: nwc_ntt_inv(nwc_ntt_fwd(x)) == x and ntt_inv(ntt_fwd(x)) == x, "
              f"{name} B={BATCH}")
    a3_60, b3_60 = inputs60["dot"]
    row = 5
    want = [0] * P60_4096.n
    for k in range(DOT_TERMS):
        prod = reference.nwc_poly_mult(a3_60[k, row].cpu().tolist(),
                                       b3_60[k, row].cpu().tolist(), P60_4096)
        want = [(u + v) % P60_4096.q for u, v in zip(want, prod)]
    if out60["dot"][row].cpu().tolist() != want:
        raise AssertionError("P60_4096 dot row 5 differs from its golden products")
    print(f"oracle: P60_4096 dot row {row} equals the sum of {DOT_TERMS} "
          "reference.nwc_poly_mult products")
    ka_rows, kb_rows = ka[:6].tolist(), kb[:6].tolist()
    for name, got, want in (
            ("ntt", kout["ntt"], reference.kyber_ntt),
            ("intt", kout["intt"], reference.kyber_intt),
            ("poly_mult", kout["poly_mult"],
             lambda x, r: reference.kyber_poly_mult(x, kb_rows[r]))):
        for r in range(6):
            args = (ka_rows[r], r) if name == "poly_mult" else (ka_rows[r],)
            if got[r].tolist() != want(*args):
                raise AssertionError(f"ML-KEM {name} row {r} differs from the golden")
    if kout["poly_mult"][4].tolist() != reference.schoolbook_negacyclic(
            ka_rows[4], kb_rows[4], kq):
        raise AssertionError("ML-KEM poly_mult row 4 differs from the schoolbook product")
    row, want = 5, []
    for i in range(KYBER_K):
        acc = [0] * kyber.N
        for j in range(KYBER_K):
            prod = reference.kyber_poly_mult(kA[i, j].tolist(), ka3[j, row].tolist())
            acc = [(u + v) % kq for u, v in zip(acc, prod)]
        want.append(acc)
    if kout["matvec"][:, row].tolist() != want:
        raise AssertionError("ML-KEM 3x3 matvec row 5 differs from its golden products")
    if not torch.equal(kp.intt(kout["ntt"]), ka):
        raise AssertionError("ML-KEM intt(ntt(x)) != x")
    print("oracle: ML-KEM rows 0-5 of ntt, intt and poly_mult equal reference.kyber_ntt, "
          "kyber_intt and kyber_poly_mult; poly_mult row 4 equals "
          "reference.schoolbook_negacyclic; 3x3 matvec row 5 equals the sums of its "
          f"golden products; intt(ntt(x)) == x at B={kb_}")

    # 5. main paths, through the entry points a user calls
    counts = (MxuPlan.launches, MxuPlan64.launches, KyberPlan.launches)
    launches: dict[str, int] = {}

    def drive(label, q, via, fn, inputs, plain, expect, want=None):
        """Run fn with the counts at 0, read them, check against plain; with
        no kernel to expect, no kernel may launch."""
        for c in counts:
            for k in c:
                c[k] = 0
        out = fn(*inputs)
        torch.cuda.synchronize()
        seen = {k: v for c in counts for k, v in c.items()}
        if any(seen[k] < 1 for k in expect) or (not expect and any(seen.values())):
            raise AssertionError(f"main path {label} did not launch {expect}: {seen}")
        if not torch.equal(out, plain(*inputs)):
            raise AssertionError(f"main path {label} differs from its plain version")
        if want is not None and not torch.equal(out, want):
            raise AssertionError(f"main path {label} differs from the checked result")
        if not bool(((out >= 0) & (out < q)).all()):
            raise AssertionError(f"main path {label} leaves [0, q)")
        for k, v in seen.items():
            launches[k] = launches.get(k, 0) + v
        print(f"main path: {label} via {via}, launches "
              f"{ {k: v for k, v in seen.items() if v} }, shape {tuple(out.shape)}")
        return out

    mat24 = a3[:, :4].permute(1, 0, 2).contiguous()  # a 4 x 4 matrix of rows
    inputs24 = {
        "nwc": (a, b), "cyclic": (a, b), "fwd": (a,), "inv": (a,), "nwc_fwd": (a,),
        "nwc_inv": (a,), "spectrum": (b,), "cached": (a, spec_b), "dot": (a3, b3),
        "dot_cached": (a3, spec3), "matvec_spectra": (mat24,),
        "matvec": (b3, p24.nwc_matvec_spectra(mat24)),
    }
    best = {}
    for p, plan, inputs, checked in ((P60_4096, plan60, inputs60, out60),
                                     (p_gen, plan_gen, inputs_gen, out_gen),
                                     (P24_4096, p24, inputs24, {})):
        for op in dispatch.OPS:
            if dispatch.impl_name(p, op) != plan.name:
                raise AssertionError(f"{op} at {p.name} is not served by {plan.name}")
            best[p.name, op] = dispatch.best(p, op)
            drive(f"best({p.name}, {op!r})", p.q, plan.name, best[p.name, op], inputs[op],
                  getattr(plan, dispatch.METHODS[op] + "_plain"),
                  [f"{plan.lib_name}_{e}" for e in OP_ENTRIES[op]], checked.get(op))
    drive(f"best_nwc_matvec(P60_4096) 4x4 B={MATVEC_BATCH_60}", P60_4096.q,
          plan60.name, dispatch.best_nwc_matvec(P60_4096), inputs60["matvec"],
          plan60.nwc_matvec_cached_plain, ["nwc64_forward", "nwc64_matvec"],
          out60["matvec"])
    spectra_fn = dispatch.best_nwc_matvec_spectra(DILITHIUM_256)
    matvec_fn = dispatch.best_nwc_matvec(DILITHIUM_256)
    drive("best_nwc_matvec_spectra(DILITHIUM_256)", DILITHIUM_256.q, pdil.name, spectra_fn,
          (mat_dil,), pdil.nwc_matvec_spectra_plain, ["nwc32_forward"], spec_dil)
    drive(f"best_nwc_matvec(DILITHIUM_256) 4x4 B={MATVEC_BATCH}", DILITHIUM_256.q,
          pdil.name, matvec_fn, (s_dil, spec_dil), pdil.nwc_matvec_cached_plain,
          ["nwc32_forward", "nwc32_matvec"], mv_dil)
    kntt_b = kp.ntt(kb)
    kyber_main = {  # entry point: (inputs, plain version, kernels it launches)
        "ntt": ((ka,), kp.ntt_plain, ["kyber_forward"]),
        "intt": ((ka,), kp.intt_plain, ["kyber_inverse"]),
        "basemul": ((kout["ntt"], kntt_b), kp.basemul_plain, []),
        "poly_mult": ((ka, kb), kp.poly_mult_plain, ["kyber_product"]),
        "spectrum": ((kb,), kp.spectrum_plain, ["kyber_forward"]),
        "poly_mult_cached": ((ka, kspec), kp.poly_mult_cached_plain, ["kyber_cached"]),
        "dot": ((ka3, kb3), kp.dot_plain, ["kyber_dot"]),
        "dot_cached": ((ka3, kspec3), kp.dot_cached_plain, ["kyber_dot"]),
        "matvec_spectra": ((kA,), kp.matvec_spectra_plain, ["kyber_forward"]),
        # A's blocks from its plain spectra are those from its coefficients
        "ntt_domain_blocks": ((kp.ntt(kA.reshape(-1, kyber.N)).reshape(kA.shape),),
                              lambda _: kp.matvec_spectra_plain(kA), []),
        "matvec": ((ka3, kout["matvec_spectra"]), kp.matvec_plain, ["kyber_matvec"]),
    }
    for name, (inputs, plain, expect) in kyber_main.items():
        drive(f"kyber.{name} B={kb_}", kq, kyber.impl_name(), getattr(kyber, name),
              inputs, plain, expect, kout.get(name))

    # 6. timing, in turns: plain, kernel (through the main path), kernel, plain
    def nwc_timed(p, op, plan, inputs, out_rows, fn=None):
        """(what is timed, kernel fn, plain fn, inputs, output rows, p, terms)
        of a dispatch op."""
        return (f"{op} at {p.name}", fn or best[p.name, op],
                getattr(plan, dispatch.METHODS[op] + "_plain"), inputs[op],
                out_rows, p, DOT_TERMS)

    def kyber_timed(entry):
        inputs, plain, _ = kyber_main[entry]
        return (f"kyber.{entry} B={kb_}", getattr(kyber, entry), plain, inputs,
                kb_, None, KYBER_K)

    timed = {
        "nwc64_product": nwc_timed(P60_4096, "nwc", plan60, inputs60, BATCH),
        "nwc64_forward": nwc_timed(P60_4096, "nwc_fwd", plan60, inputs60, BATCH),
        "nwc64_inverse": nwc_timed(P60_4096, "nwc_inv", plan60, inputs60, BATCH),
        "nwc64_cached": nwc_timed(P60_4096, "cached", plan60, inputs60, BATCH),
        "nwc64_dot": nwc_timed(P60_4096, "dot", plan60, inputs60, DOT_BATCH),
        "nwc64_matvec": nwc_timed(P60_4096, "matvec", plan60, inputs60, MATVEC_BATCH_60),
        "nwc32_product": nwc_timed(P24_4096, "nwc", p24, inputs24, BATCH),
        "nwc32_forward": nwc_timed(P24_4096, "nwc_fwd", p24, inputs24, BATCH),
        "nwc32_inverse": nwc_timed(P24_4096, "nwc_inv", p24, inputs24, BATCH),
        "nwc32_cached": nwc_timed(P24_4096, "cached", p24, inputs24, BATCH),
        "nwc32_dot": nwc_timed(P24_4096, "dot", p24, inputs24, DOT_BATCH),
        "nwc32_matvec": nwc_timed(DILITHIUM_256, "matvec", pdil,
                                  {"matvec": (s_dil, spec_dil)}, MATVEC_BATCH,
                                  matvec_fn),
        "kyber_forward": kyber_timed("ntt"),
        "kyber_inverse": kyber_timed("intt"),
        "kyber_product": kyber_timed("poly_mult"),
        "kyber_cached": kyber_timed("poly_mult_cached"),
        "kyber_dot": kyber_timed("dot"),
        "kyber_matvec": kyber_timed("matvec"),
        # not a kernel function of its own: the product at the generic q
        "generic-q product": nwc_timed(p_gen, "nwc", plan_gen, inputs_gen, BATCH),
    }

    def time_turns(kernel_fn, plain_fn, inputs, plain_iters, repeats):
        """Turns plain, kernel, kernel, plain; a kernel turn takes the
        device time of the calls by graph replay and the time per call of
        back-to-back calls by events, host time included."""
        times = {"graph": [], "events": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                times["graph"].append(graph_seconds_per_call(kernel_fn, *inputs))
                times["events"].append(device_seconds_per_call(kernel_fn, *inputs,
                                                               iters=(4, 20)))
            else:
                times["plain"].append(device_seconds_per_call(
                    plain_fn, *inputs, iters=plain_iters, repeats=repeats))
        return times

    rows, per_call = [], {}
    for name, (what, fn, plain, inputs, out_rows, p, terms) in timed.items():
        wide = p is not None and p.width > 30  # 60-bit plain versions: ~0.2 s a call
        times = time_turns(fn, plain, inputs, (1, 2) if wide else (1, 3),
                           1 if wide else 3)
        t_kernel, t_plain = min(times["graph"]), min(times["plain"])
        t_host = host_seconds_per_call(fn, *inputs)
        kernel = name if name in REPLACES else "nwc64_product"
        nbytes, imads = work(kernel, p, out_rows, terms)
        t_bytes, t_ops = seconds(nbytes, imads, imad_per_s)
        per_call[name] = min(times["events"])
        print(f"timing {name} ({what}, s/call): kernel by graph replay "
              f"{times['graph']}, by events {times['events']}, host enqueue "
              f"{t_host:.4e}; plain {times['plain']}; bound: {nbytes} bytes "
              f"{t_bytes:.4e} s, {imads} IMADs {t_ops:.4e} s")
        if name not in REPLACES:
            continue
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name.split("_")[0]],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,  # no PyTorch call computes an NTT or its product mod q
        })
    per_s = {name: 1 / t for name, t in per_call.items()}  # back to back, host included
    print(f"nwc_poly_mult_p60_4096_per_sec: {BATCH * per_s['nwc64_product']:.1f}; "
          f"fwd_ntt_p60_4096_per_sec: {BATCH * per_s['nwc64_forward']:.1f}; "
          f"p60_4096_matvec_4x4_per_sec: {MATVEC_BATCH_60 * per_s['nwc64_matvec']:.1f}; "
          f"nwc_poly_mult_q576460752308273153_4096_per_sec: "
          f"{BATCH * per_s['generic-q product']:.1f}; "
          f"nwc_poly_mult_p24_4096_per_sec: {BATCH * per_s['nwc32_product']:.1f}; "
          f"fwd_ntt_p24_4096_per_sec: {BATCH * per_s['nwc32_forward']:.1f}; "
          f"dilithium_256_matvec_4x4_per_sec: {MATVEC_BATCH * per_s['nwc32_matvec']:.1f}; "
          f"B={BATCH} (p60 matvec B={MATVEC_BATCH_60}, dilithium matvec "
          f"B={MATVEC_BATCH}); mlkem_3329_poly_mult_per_sec: "
          f"{kb_ * per_s['kyber_product']:.1f}; mlkem_3329_ntt_per_sec: "
          f"{kb_ * per_s['kyber_forward']:.1f}; mlkem_768_matvec_3x3_per_sec: "
          f"{kb_ * per_s['kyber_matvec']:.1f}; B={kb_}; card {card}")
    print(f"wall time: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

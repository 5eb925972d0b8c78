#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port, ``tpu_ntt_torch``.

Run it from the root of a checkout on a machine with an NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernel of the main path from csrc/;
3. kernel vs plain: the kernel equals its plain PyTorch version bit for bit
   on the card, at the full batch of 2048 rows for n = 4096, 256 and 8192,
   with boundary rows of 0, 1 and q - 1;
4. oracle: c(x) == a(x) * b(x) mod q at x = psi^(2k+1), a root of x^n + 1,
   by Python-int Horner evaluation, and one row against the golden model;
5. main path: ``dispatch.best_nwc_poly_mult(P60_4096)`` on the batch goes
   through the kernel (its launch count rises) and returns the checked result;
6. timing: the kernel and the plain version at B = 2048, n = 4096, by CUDA
   events, as seconds per batch and products per second.

The line before the last lists each kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.  pytest
cannot run on a machine without JAX (tests/conftest.py imports it), so this
script is the check of the port on the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

BATCH = 2048  # bench.py's full batch for the p60_4096 row
KERNEL_SOURCE = "tpu_ntt_torch/kernels/csrc/nwc64.cu"
REPLACES = "tpu_ntt/kernels/mxu64.py:1442"  # MxuPlan64._nwc_kernel under SolinasPlan64


def operands(q: int, n: int, batch: int, rng: np.random.Generator):
    """Random (batch, n) residues with boundary rows: a's rows 0-3 are all
    0, all 1, all q - 1 and [0, 1, q - 1] cycled; b holds the same rows in
    reverse order at 0-3 and again at 4-7, against random a rows."""
    a = rng.integers(0, q, size=(batch, n), dtype=np.int64)
    b = rng.integers(0, q, size=(batch, n), dtype=np.int64)
    edge = np.stack([np.zeros(n, np.int64), np.ones(n, np.int64),
                     np.full(n, q - 1, np.int64),
                     np.resize(np.array([0, 1, q - 1], np.int64), n)])
    a[:4] = edge
    b[:4] = edge[::-1]
    b[4:8] = edge
    return a, b


def horner(coeffs, x: int, q: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % q
    return acc


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from tpu_ntt_torch import dispatch, reference
    from tpu_ntt_torch.benchlib import device_seconds_per_iter
    from tpu_ntt_torch.kernels import _build
    from tpu_ntt_torch.kernels.sol64 import SolinasPlan64
    from tpu_ntt_torch.params import P60_4096, make_params

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; count {torch.cuda.device_count()}; "
          "nvidia-smi name, power.limit on the next line")
    print(card)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build("nwc64")
    print(f"build: nwc64 in {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version, bit for bit
    rng = np.random.default_rng(args.seed)
    q = P60_4096.q
    max_err = 0
    main_case = None
    for p in (P60_4096, make_params(256, q), make_params(8192, q)):
        a_np, b_np = operands(q, p.n, BATCH, rng)
        a = torch.from_numpy(a_np).to(device)
        b = torch.from_numpy(b_np).to(device)
        plan = SolinasPlan64(p, device)
        got = plan.nwc_poly_mult(a, b)
        want = plan.nwc_poly_mult_plain(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        ok = torch.equal(got, want)
        print(f"kernel vs plain: n={p.n} B={BATCH} equal={ok} max_abs_err={err}")
        if not ok:
            raise AssertionError(f"kernel differs from its plain version at n={p.n}")
        if p is P60_4096:
            main_case = (plan, a, b, got, a_np, b_np)
    plan, a, b, want, a_np, b_np = main_case

    # 4. independent oracle: evaluation at roots of x^n + 1, and the golden
    c_rows = want[:8].cpu().tolist()
    n = P60_4096.n
    for row in (2, 3, 4, 5):
        av, bv, cv = a_np[row].tolist(), b_np[row].tolist(), c_rows[row]
        for k in rng.integers(0, n, size=3).tolist():
            x = pow(P60_4096.psi, 2 * k + 1, q)  # x^n = psi^(n(2k+1)) = -1
            if horner(cv, x, q) != horner(av, x, q) * horner(bv, x, q) % q:
                raise AssertionError(f"c(x) != a(x) b(x) at row {row}, k={k}")
    print("oracle: c(x) == a(x) b(x) at x = psi^(2k+1), rows 2-5, 3 k each")
    if reference.nwc_poly_mult(a_np[4].tolist(), b_np[4].tolist(), P60_4096) != c_rows[4]:
        raise AssertionError("row 4 differs from reference.nwc_poly_mult")
    print("oracle: row 4 equals reference.nwc_poly_mult")

    # 5. main path, through the entry point a user calls
    name = dispatch.impl_name(P60_4096)
    mult = dispatch.best_nwc_poly_mult(P60_4096)
    SolinasPlan64.launches = 0
    c = mult(a, b)
    torch.cuda.synchronize()
    launches = SolinasPlan64.launches
    if name != SolinasPlan64.name or launches < 1:
        raise AssertionError(f"main path ran {name!r} with {launches} kernel launches")
    if c.shape != (BATCH, n) or not torch.equal(c, want):
        raise AssertionError("main path result differs from the checked product")
    if not bool(((c >= 0) & (c < q)).all()):
        raise AssertionError("main path result leaves [0, q)")
    print(f"main path: best_nwc_poly_mult(P60_4096) via {name}, {launches} launch(es), "
          f"shape {tuple(c.shape)}, equal to the checked product")

    # 6. timing, in turns: plain, kernel (through the main path), kernel, plain
    times = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = mult if which == "kernel" else plan.nwc_poly_mult_plain
        iters = (4, 20) if which == "kernel" else (2, 6)
        times[which].append(device_seconds_per_iter(fn, a, b, iters=iters))
    t_kernel, t_plain = min(times["kernel"]), min(times["plain"])
    print(f"timing runs (s/batch): kernel {times['kernel']} plain {times['plain']}")
    print(f"nwc_poly_mult_p60_4096_per_sec: kernel {BATCH / t_kernel:.1f} "
          f"({t_kernel:.6e} s/batch), plain {BATCH / t_plain:.1f} "
          f"({t_plain:.6e} s/batch); B={BATCH} n={n}; card {card}")

    print(json.dumps({"kernels": [{
        "name": "nwc64", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

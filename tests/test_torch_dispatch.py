"""The port's main path end to end, and what it refuses.

``tpu_ntt_torch.dispatch.best_nwc_poly_mult(P60_4096)`` on CPU tensors must
equal ``tpu_ntt.ntt.nwc_poly_mult_merged`` (bit-identical to the JAX
dispatch's Pallas kernel by that package's contract) and the golden model,
on operands from ``numpy.random.default_rng`` with boundary rows of 0, 1 and
q - 1.  Every op and every (n, q) outside the slice raises
NotImplementedError naming its ROADMAP item.  Importing the port leaves JAX
out.  Tolerance: none — exact integer equality.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_ntt.dispatch as jdispatch
import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
import tpu_ntt.reference as jref
from tpu_ntt_torch import dispatch
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.params import P60_4096, PRESETS, make_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q60 = P60_4096.q


def test_best_nwc_poly_mult_matches_jax_and_golden_at_p60_4096():
    rng = np.random.default_rng(60)
    q, n = Q60, P60_4096.n
    a = rng.integers(0, q, size=(2, n), dtype=np.int64)
    b = rng.integers(0, q, size=(2, n), dtype=np.int64)
    a[0] = np.resize(np.array([0, 1, q - 1], np.int64), n)
    b[0] = q - 1
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = dispatch.best_nwc_poly_mult(P60_4096)(ta, tb)
    assert got.dtype == torch.int64 and got.shape == (2, n)
    jplan = jntt.NttPlan(jparams.P60_4096)
    out = jntt.nwc_poly_mult_merged(jplan, int64_to_pairs(ta), int64_to_pairs(tb))
    assert torch.equal(got, pairs_to_int64(np.asarray(out[0]), np.asarray(out[1])))
    assert got[0].tolist() == jref.nwc_poly_mult(a[0].tolist(), b[0].tolist(),
                                                  jparams.P60_4096)


def test_surface_matches_jax_dispatch():
    assert dispatch.OPS == jdispatch.OPS
    assert dispatch.impl_name(P60_4096) == "cuda-sol64"
    assert dispatch.takes_pairs(P60_4096) is False
    with pytest.raises(ValueError):
        dispatch.best(P60_4096, "no_such_op")


@pytest.mark.parametrize("op", dispatch.OPS[1:])
def test_ops_outside_the_slice_raise(op):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Q1.5"):
        dispatch.best(P60_4096, op)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dispatch.impl_name(P60_4096, op)


@pytest.mark.parametrize("p,item", [
    (PRESETS["p24_4096"], "Q1.4"),
    (PRESETS["dilithium_256"], "Q1.4"),
    (PRESETS["goldilocks_4096"], "Q1.6"),
    (make_params(16384, 4611686018427322369), "Q1.7"),  # 2^62 - 2^16 + 1
    (make_params(4096, 576460752308273153), "Q1.5"),    # not a trinomial
    (make_params(128, Q60), "Q1.5"),
])
def test_params_outside_the_slice_raise(p, item):
    for call in (dispatch.best_nwc_poly_mult, dispatch.impl_name, dispatch.takes_pairs):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            call(p)


def test_import_leaves_out_jax_and_tpu_ntt():
    code = (
        "import sys, chip_smoke, tpu_ntt_torch, tpu_ntt_torch.benchlib, "
        "tpu_ntt_torch.convert, tpu_ntt_torch.kernels._build, "
        "tpu_ntt_torch.kernels.sol64\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_ntt')]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout

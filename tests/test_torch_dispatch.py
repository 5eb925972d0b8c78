"""The port's main path end to end, and what it refuses.

``tpu_ntt_torch.dispatch.best_nwc_poly_mult(P60_4096)`` on CPU tensors must
equal ``tpu_ntt.ntt.nwc_poly_mult_merged`` (bit-identical to the JAX
dispatch's Pallas kernel by that package's contract) and the golden model,
on operands from ``numpy.random.default_rng`` with boundary rows of 0, 1 and
q - 1.  Every op at P60_4096 is served by ``cuda-sol64``, a generic 60-bit
q by ``cuda-mxu64``, 30 < width <= 62 and Goldilocks above n = 8192 by
``cuda-fourstep-64``,
every (n, q) outside the ported windows raises NotImplementedError naming
its ROADMAP item, and a modulus above 62 bits that is not Goldilocks raises
the ValueError JAX raises.  Importing the port leaves JAX out.  Tolerance:
none — exact integer equality.
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
from tpu_ntt_torch import modmath as tt_modmath
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels.sol64 import SolinasPlan64
from tpu_ntt_torch.modmath import GOLDILOCKS_Q
from tpu_ntt_torch.params import P60_4096, PRESETS, make_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q60 = P60_4096.q
Q_2ADIC22 = 576460752475389953  # 2^22 * 137438953511 + 1, a 60-bit prime
Q63 = 9223372036854497281  # a 63-bit prime = 1 mod 8192, not Goldilocks


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
    """Once outside the first slice, each op at P60_4096 is now served by
    the Solinas plan, through a method the plan has."""
    assert dispatch.impl_name(P60_4096, op) == SolinasPlan64.name
    assert callable(getattr(SolinasPlan64, dispatch.METHODS[op]))
    assert callable(dispatch.best(P60_4096, op))


@pytest.mark.parametrize("p,item", [
    (make_params(4096, 998244353), "Q1.4b"),  # 30-bit: above the K3 window
    (make_params(32768, 65537), "Q1.4b"),     # 17-bit, n above the K3 window
    (make_params(16384, GOLDILOCKS_Q), None),          # Goldilocks above 8192: four-step
    (make_params(16384, 4611686018427322369), None),    # 2^62 - 2^16 + 1: four-step
    (make_params(4096, 576460752308273153), None),      # not a trinomial: served
    (make_params(128, Q60), "Q1.4c"),                   # n < 256
    (PRESETS["goldilocks_4096"], None),                 # served by cuda-gl64
    (make_params(128, GOLDILOCKS_Q), "Q1.4c"),          # Goldilocks at n < 256
    (make_params(1 << 21, Q_2ADIC22), "Q1.8"),          # n above 2^20
])
def test_params_outside_the_slice_raise(p, item):
    if item is None:
        want = ("cuda-fourstep-64" if p.n > 8192 else
                "cuda-gl64" if p.q == GOLDILOCKS_Q else "cuda-mxu64")
        assert dispatch.impl_name(p) == want
        assert all(dispatch.impl_name(p, op) == want for op in dispatch.OPS)
        assert dispatch.takes_pairs(p) is False
        assert callable(dispatch.best_nwc_poly_mult(p))
        return
    for call in (dispatch.best_nwc_poly_mult, dispatch.impl_name, dispatch.takes_pairs):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            call(p)


def test_wide_non_goldilocks_modulus_raises_value_error_as_jax_does():
    """A 63-bit q that is not Goldilocks: JAX's ``best`` raises ValueError
    (its ``make_ring``), and so do the port's dispatch and ``make_ring``;
    no NTT path will ever serve it (RNS channels do)."""
    jp = jparams.make_params(4096, Q63)
    with pytest.raises(ValueError) as jax_err:
        jdispatch.best(jp, "nwc")
    p = make_params(4096, Q63)
    for call in (lambda: dispatch.best(p, "nwc"), lambda: dispatch.impl_name(p),
                 lambda: dispatch.takes_pairs(p), lambda: tt_modmath.make_ring(p)):
        with pytest.raises(type(jax_err.value), match="RNS"):
            call()


def test_import_leaves_out_jax_and_tpu_ntt():
    code = (
        "import sys, chip_smoke, tpu_ntt_torch, tpu_ntt_torch.benchlib, "
        "tpu_ntt_torch.convert, tpu_ntt_torch.kernels._build, "
        "tpu_ntt_torch.kernels.sol64, tpu_ntt_torch.kernels.mxu, "
        "tpu_ntt_torch.kernels.mxu64, tpu_ntt_torch.kyber, "
        "tpu_ntt_torch.kernels.kyber, tpu_ntt_torch.kernels.gl64, "
        "tpu_ntt_torch.kernels.poseidon, tpu_ntt_torch.poseidon, "
        "tpu_ntt_torch.stark, tpu_ntt_torch.bounds, tpu_ntt_torch.sharded, "
        "tpu_ntt_torch.kernels.fourstep64, tpu_ntt_torch.kernels.a2a\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_ntt')]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout

"""The port's Solinas kernel module against tpu_ntt's.

On the CPU ``SolinasPlan64.nwc_poly_mult`` runs the kernel's plain version;
it must equal the JAX Pallas kernel in interpret mode (n = 256), the JAX
merged-psi product and the golden model (n = 4096).  ``covers_q`` must agree
with the JAX plan's on every trinomial.  The CUDA kernel itself is compared
with the plain version only where a CUDA device is present (marker
``cuda``); on the card that check is ``chip_smoke.py``.  Operands come from
``numpy.random.default_rng`` with boundary rows of 0, 1 and q - 1.
Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
import tpu_ntt.reference as jref
from tpu_ntt.kernels.sol64 import SolinasPlan64 as JaxSolinasPlan64
from tpu_ntt.kernels.sol64 import solinas_exponents as jax_solinas_exponents
from tpu_ntt_torch import kernels
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels.sol64 import SolinasPlan64, solinas_exponents
from tpu_ntt_torch.params import P60_4096, make_params

Q60 = P60_4096.q


def operands(n: int, batch: int, seed: int, q: int = Q60):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, q, size=(batch, n), dtype=np.int64)
    b = rng.integers(0, q, size=(batch, n), dtype=np.int64)
    a[0] = np.resize(np.array([0, 1, q - 1], np.int64), n)
    b[0] = q - 1
    b[1] = np.resize(np.array([1, 0, q - 1, q - 1], np.int64), n)
    return torch.from_numpy(a), torch.from_numpy(b)


def from_pairs(out):
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def test_plain_matches_jax_pallas_kernel_interpret():
    p = make_params(256, Q60)
    jp = jparams.make_params(256, Q60)
    mp = JaxSolinasPlan64(jp)
    mp.groups_per_step = 1  # keep interpret-mode cost down
    a, b = operands(256, batch=4, seed=1)
    want = from_pairs(mp.nwc_poly_mult(int64_to_pairs(a), int64_to_pairs(b), interpret=True))
    assert torch.equal(SolinasPlan64(p).nwc_poly_mult(a, b), want)


def test_plain_matches_jax_merged_and_golden_at_p60_4096():
    plan = SolinasPlan64(P60_4096)
    a, b = operands(4096, batch=2, seed=2)
    got = plan.nwc_poly_mult(a, b)
    jplan = jntt.NttPlan(jparams.P60_4096)
    want = from_pairs(jntt.nwc_poly_mult_merged(jplan, int64_to_pairs(a), int64_to_pairs(b)))
    assert torch.equal(got, want)
    golden = jref.nwc_poly_mult(a[0].tolist(), b[0].tolist(), jparams.P60_4096)
    assert got[0].tolist() == golden


def test_covers_q_matches_jax_on_every_trinomial():
    for a in range(31, 63):
        for b in range(1, a):
            q = (1 << a) - (1 << b) + 1
            assert solinas_exponents(q) == jax_solinas_exponents(q) == (a, b)
            for n in (256, 8192):
                assert SolinasPlan64.covers_q(q, n) == JaxSolinasPlan64.covers_q(q, n), (a, b, n)
    for q in (998244353, 576460752308273153, (1 << 64) - (1 << 32) + 1):
        assert SolinasPlan64.covers_q(q, 4096) == JaxSolinasPlan64.covers_q(q, 4096)


@pytest.mark.parametrize("n,q,covered", [
    (256, Q60, True), (8192, Q60, True), (4096, 576460752303415297, True),
    (128, Q60, False), (16384, 4611686018427322369, False),  # outside the kernel's n
    (4096, 576460752308273153, False),                # not a trinomial
    (4096, 8380417, False),                           # 24-bit
])
def test_kernel_coverage(n, q, covered):
    assert (kernels.covers(n, q) is SolinasPlan64) == covered
    p = make_params(n, q)
    assert isinstance(kernels.plan_for(p), SolinasPlan64) == covered
    if not covered:
        with pytest.raises(ValueError):
            SolinasPlan64(p)


def test_cpu_tensor_runs_plain_without_a_launch():
    plan = SolinasPlan64(make_params(256, Q60))
    a, b = operands(256, batch=2, seed=3)
    before = SolinasPlan64.launches
    assert torch.equal(plan.nwc_poly_mult(a, b), plan.nwc_poly_mult_plain(a, b))
    assert SolinasPlan64.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "width", "strided", "mismatch", "device"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    plan = SolinasPlan64(make_params(256, Q60))
    a, b = operands(256, batch=2, seed=4)
    if bad == "dtype":
        a = a.to(torch.int32)
    elif bad == "shape":
        a = a[0]
    elif bad == "width":
        a, b = a[:, :128], b[:, :128]
    elif bad == "strided":
        a = torch.cat([a, a], dim=1)[:, ::2]
    elif bad == "mismatch":
        b = b[:1]
    else:
        a = a.to("meta")
    with pytest.raises((TypeError, ValueError)):
        plan.nwc_poly_mult(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 4096, 8192])
def test_cuda_kernel_matches_plain(cuda_device, n):
    p = P60_4096 if n == 4096 else make_params(n, Q60)
    plan = SolinasPlan64(p, cuda_device)
    a, b = (x.to(cuda_device) for x in operands(n, batch=8, seed=n))
    before = SolinasPlan64.launches
    got = plan.nwc_poly_mult(a, b)
    torch.cuda.synchronize()
    assert SolinasPlan64.launches == before + 1
    assert torch.equal(got, plan.nwc_poly_mult_plain(a, b))

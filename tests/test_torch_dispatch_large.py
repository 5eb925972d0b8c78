"""Dispatch of the 60-bit family above n = 8192: every op on the four-step.

``tpu_ntt_torch.dispatch.best(p, op)`` at 30 < width <= 62 and
8192 < n <= 2^20 is ``kernels.fourstep64.FourStepPlan64``; on CPU tensors
it runs its plain chain.  The product at n = 16384 and 65536 must equal
``tpu_ntt.native.nwc_fast`` (the reference package's independent C++
O(n log n) oracle: JAX's own paths at these sizes are Pallas kernels that
take minutes in interpret mode, and ``tpu_ntt.dispatch.best`` is never
called here); every other op at 16384 is held to what it must equal: its
inverse (round trips), ``native.nwc_fast`` on the same rows (cached, dot,
matvec), big-int Horner
evaluation of the spectra (natural position k, through the plan's
``bitrev_to_natural``, is the value at omega^k, or psi^(2k + 1)
negacyclic).  n = 2^20 is a ``slow`` test.  The card's kernels are held to these plain chains by
``chip_smoke.py`` (and the ``cuda`` test here where a card and JAX meet).
Operands come from ``numpy.random.default_rng`` with rows of 0, 1 and
q - 1.  Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

from tpu_ntt import native
from tpu_ntt_torch import dispatch, kernels
from tpu_ntt_torch.kernels.fourstep64 import FourStepPlan64
from tpu_ntt_torch.kernels.mxu64 import MxuPlan64
from tpu_ntt_torch.modmath import GOLDILOCKS_Q
from tpu_ntt_torch.params import make_params

Q = 576460752308273153  # bench.py:35 (p60_32768), 2-adicity 17
Q_1M = 576460752364240897  # bench.py:40 (p60_1048576), 2-adicity 21
P16 = make_params(16384, Q)


def residues(q: int, shape, seed: int) -> torch.Tensor:
    """(..., n) residues; the first rows are [0, 1, q - 1] cycled, all
    q - 1 and all 1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, size=shape, dtype=np.int64)
    rows = x.reshape(-1, shape[-1])
    edge = [np.resize(np.array([0, 1, q - 1], np.int64), shape[-1]),
            np.full(shape[-1], q - 1), np.ones(shape[-1], np.int64)]
    for r in range(min(3, rows.shape[0])):
        rows[r] = edge[(r + seed) % 3]
    return torch.from_numpy(x)


def horner(coeffs, x: int, q: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % q
    return acc


def best(op: str):
    return dispatch.best(P16, op)


def nwc_rows(a: torch.Tensor, b: torch.Tensor, q: int, psi: int) -> list:
    return [native.nwc_fast(x, y, q, psi) for x, y in zip(a.tolist(), b.tolist())]


@pytest.mark.parametrize("n", [16384, 65536])
def test_nwc_matches_the_native_oracle(n):
    p = make_params(n, Q)
    assert all(dispatch.impl_name(p, op) == FourStepPlan64.name for op in dispatch.OPS)
    assert dispatch.takes_pairs(p) is False
    a, b = residues(Q, (2, n), 1), residues(Q, (2, n), 2)
    got = dispatch.best_nwc_poly_mult(p)(a, b)
    assert got.dtype == torch.int64 and got.shape == (2, n)
    assert got.tolist() == nwc_rows(a, b, Q, p.psi)


def spectrum_at(spectra, row, coeffs, point, q, picks):
    """The natural-order spectrum of ``spectra[row]`` (the plan's layout map)
    holds coeffs evaluated at point(k) for each k in picks."""
    plan = kernels.plan_for(P16, "cpu")
    natural = plan.bitrev_to_natural(spectra)
    assert torch.equal(plan.natural_to_bitrev(natural), spectra)
    return all(int(natural[row, k]) == horner(coeffs, point(k), q) for k in picks)


CHECKS = {}


def check(*ops):
    def register(fn):
        for op in ops:
            CHECKS[op] = fn
        return fn
    return register


@check("fwd", "inv")
def _cyclic_transforms(a, b, q):
    x = best("fwd")(a)
    assert spectrum_at(x, 1, a[1].tolist(), lambda k: pow(P16.omega, k, q), q,
                       (0, 1, 77, P16.n - 1))
    assert torch.equal(best("inv")(x), a)


@check("nwc_fwd", "nwc_inv")
def _negacyclic_transforms(a, b, q):
    x = best("nwc_fwd")(a)
    assert spectrum_at(x, 0, a[0].tolist(), lambda k: pow(P16.psi, 2 * k + 1, q), q,
                       (0, 5, 1000, P16.n - 1))
    assert torch.equal(best("nwc_inv")(x), a)


@check("cyclic")
def _cyclic_product(a, b, q):
    c = best("cyclic")(a, b)
    for k in (0, 3, 9000):
        x = pow(P16.omega, k, q)
        assert horner(c[1].tolist(), x, q) == (
            horner(a[1].tolist(), x, q) * horner(b[1].tolist(), x, q) % q)


def oracle(a, b, q):
    """a * b mod (x^n + 1, q) row by row, by ``native.nwc_fast``."""
    return torch.tensor(nwc_rows(a, b, q, P16.psi))


@check("nwc", "spectrum", "cached")
def _cached_product(a, b, q):
    s = best("spectrum")(b)
    plain = best("nwc_fwd")(b)
    assert s[1].tolist() == [v * ((1 << 64) % q) % q for v in plain[1].tolist()]
    want = oracle(a, b, q)
    assert torch.equal(best("cached")(a, s), want)
    assert torch.equal(best("nwc")(a, b), want)


@check("dot", "dot_cached")
def _dot(a, b, q):
    a3, b3 = a.reshape(2, 1, -1), b.reshape(2, 1, -1)
    c = oracle(a, b, q)
    want = (c[0] + c[1]) % q
    assert best("dot")(a3, b3)[0].tolist() == want.tolist()
    s3 = best("spectrum")(b).reshape(b3.shape)
    assert best("dot_cached")(a3, s3)[0].tolist() == want.tolist()


@check("matvec_spectra", "matvec")
def _matvec(a, b, q):
    A = torch.stack([b, b.flip(0)])  # (2, 2, n)
    spectra = best("matvec_spectra")(A)
    assert torch.equal(spectra, best("spectrum")(A.reshape(4, -1)).reshape(A.shape))
    s = a.reshape(2, 1, -1)
    out = best("matvec")(s, spectra)
    for i in range(2):
        c = oracle(A[i], a, q)  # A[i, j] * s[j] for j = 0, 1
        assert torch.equal(out[i, 0], (c[0] + c[1]) % q)


@pytest.mark.parametrize("op", dispatch.OPS)
def test_every_op_at_16384_holds_its_relation(op):
    """One relation for each op (its registered check), on CPU tensors; no
    kernel launches."""
    before = dict(MxuPlan64.launches)
    a, b = residues(Q, (2, P16.n), 3), residues(Q, (2, P16.n), 4)
    CHECKS[op](a, b, Q)
    assert MxuPlan64.launches == before


def test_plan_checks_and_empty_batches():
    plan = kernels.plan_for(P16, "cpu")
    assert isinstance(plan, FourStepPlan64) and plan.name == "cuda-fourstep-64"
    assert plan.launches is MxuPlan64.launches
    empty = torch.zeros((0, P16.n), dtype=torch.int64)
    assert plan.nwc_poly_mult(empty, empty).shape == (0, P16.n)
    assert plan.nwc_ntt_inv(plan.nwc_ntt_fwd(empty)).shape == (0, P16.n)
    a = residues(Q, (2, P16.n), 5)
    with pytest.raises(TypeError):
        plan.nwc_poly_mult(a.to(torch.int32), a.to(torch.int32))
    with pytest.raises(ValueError):
        plan.nwc_poly_mult(a, a[:1])
    with pytest.raises(ValueError):
        plan.nwc_dot(a[None, :0], a[None, :0][:0])
    with pytest.raises(ValueError):
        plan.nwc_matvec_cached(a.reshape(2, 1, -1), a.reshape(1, 2, -1)[:, :1])
    with pytest.raises(ValueError):
        FourStepPlan64(make_params(8192, Q), "cpu")  # the flat plans' n


@pytest.mark.parametrize("p,item", [
    (make_params(1 << 21, GOLDILOCKS_Q), "Q1.8"),
    (make_params(1 << 21, 576460752475389953), "Q1.8"),
    (make_params(16384, 998244353), "Q1.4b"),
])
def test_large_n_outside_the_four_step_names_its_roadmap_item(p, item):
    assert not FourStepPlan64.covers(p.n, p.q)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        dispatch.best_nwc_poly_mult(p)


@pytest.mark.slow
def test_nwc_at_2_20_matches_the_native_oracle():
    p = make_params(1 << 20, Q_1M)
    a, b = residues(Q_1M, (1, p.n), 6), residues(Q_1M, (1, p.n), 7)
    assert dispatch.best_nwc_poly_mult(p)(a, b).tolist() == nwc_rows(a, b, Q_1M, p.psi)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_fourstep_matches_plain(cuda_device):
    plan = FourStepPlan64(P16, cuda_device)
    a, b = (residues(Q, (4, P16.n), s).to(cuda_device) for s in (8, 9))
    a3, b3 = a.reshape(2, 2, -1), b.reshape(2, 2, -1)
    for method, args in (("nwc_poly_mult", (a, b)), ("cyclic_poly_mult", (a, b)),
                         ("ntt_fwd", (a,)), ("nwc_ntt_inv", (a,)),
                         ("nwc_poly_mult_cached", (a, plan.nwc_spectrum(b))),
                         ("nwc_dot", (a3, b3)),
                         ("nwc_matvec_cached", (a3, plan.nwc_matvec_spectra(b3)))):
        assert torch.equal(getattr(plan, method)(*args),
                           getattr(plan, method + "_plain")(*args)), method

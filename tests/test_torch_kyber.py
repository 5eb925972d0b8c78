"""The port's ML-KEM surface, ``tpu_ntt_torch.kyber``, against ``tpu_ntt.kyber``.

Each of the eleven entry points, on CPU tensors (the plain versions), must
equal the JAX package's entry point of the same name on the same inputs:
its Pallas kernel in interpret mode (``KyberPlan``, parity-matrix layout)
or, for ``basemul`` and ``ntt_domain_blocks``, its XLA function.  Cached
spectra and matvec blocks are each package's own; JAX's, carried over by
``convert``, must give JAX's products.  The port's FIPS-203 goldens must
equal ``tpu_ntt.reference``'s, and batches of 0, 1 and 130 rows are held
against the goldens.  Operands come from ``numpy.random.default_rng`` with
rows of 0, 1 and q - 1; interpret-mode calls stay at B <= 4.  Tolerance:
none — exact integer equality.
"""

import inspect

import numpy as np
import pytest
import torch

import tpu_ntt.kyber as jkyber
import tpu_ntt.reference as jref
import tpu_ntt_torch.kyber as kyber
from tpu_ntt_torch import reference
from tpu_ntt_torch.convert import (int32_to_uint32, kyber_blocks_from_jax,
                                   kyber_spectra_from_jax, uint32_to_int32)
from tpu_ntt_torch.kernels.kyber import KyberPlan

Q, N = kyber.Q, kyber.N


def residues(shape, seed: int) -> np.ndarray:
    """uint32 residues of shape (..., 256); the first rows all 0, all 1,
    all q - 1 and [0, 1, q - 1] cycled (reversed for an even seed)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint32)
    edge = np.stack([np.zeros(N), np.ones(N), np.full(N, Q - 1),
                     np.resize([0, 1, Q - 1], N)]).astype(np.uint32)
    rows = x.reshape(-1, N)
    k = min(4, rows.shape[0])
    rows[:k] = edge[:k] if seed % 2 else edge[::-1][:k]
    return x


def t(x) -> torch.Tensor:
    return uint32_to_int32(x)


def same(got: torch.Tensor, want) -> bool:
    return np.array_equal(int32_to_uint32(got), np.asarray(want))


def test_goldens_match_tpu_ntt_reference():
    assert (reference.KYBER_Q, reference.KYBER_N, reference.KYBER_ZETA) == (
        jref.KYBER_Q, jref.KYBER_N, jref.KYBER_ZETA)
    assert [reference._br7(i) for i in range(128)] == [jref._br7(i) for i in range(128)]
    a, b = residues((4, N), 1).tolist(), residues((4, N), 2).tolist()
    for x, y in zip(a, b):
        assert reference.kyber_ntt(x) == jref.kyber_ntt(x)
        assert reference.kyber_intt(x) == jref.kyber_intt(x)
        assert reference.kyber_basemul(x, y) == jref.kyber_basemul(x, y)
        assert reference.kyber_poly_mult(x, y) == jref.kyber_poly_mult(x, y)
    assert reference.kyber_poly_mult(a[3], b[3]) == reference.schoolbook_negacyclic(
        a[3], b[3], Q)
    assert kyber.gamma_table() == jkyber.gamma_table()
    assert (kyber.HALF_PARAMS.n, kyber.HALF_PARAMS.q, kyber.HALF_PARAMS.psi) == (
        jkyber.HALF_PARAMS.n, jkyber.HALF_PARAMS.q, jkyber.HALF_PARAMS.psi)


def run_both(entry: str, terms: int = 3, k: int = 3):
    """(port output, JAX output) of one entry point on the same inputs; for
    the spectrum makers the port's output in JAX's layout map."""
    a, b = residues((3, N), 3), residues((3, N), 4)
    a3, b3 = residues((terms, 2, N), 5), residues((terms, 2, N), 6)
    A = residues((k, terms, N), 7)
    if entry in ("ntt", "intt", "spectrum"):
        args = (a,)
    elif entry in ("basemul", "poly_mult"):
        args = (a, b)
    elif entry in ("dot", "dot_cached"):
        args = (a3, b3)
    else:
        args = (A,)
    if entry == "poly_mult_cached":
        jspec = np.asarray(jkyber.spectrum(b))
        got = kyber.poly_mult_cached(t(a), kyber.spectrum(t(b)))
        assert torch.equal(got, kyber.poly_mult_cached(t(a), kyber_spectra_from_jax(jspec)))
        return got, jkyber.poly_mult_cached(a, jspec)
    if entry == "dot_cached":
        jspec = np.asarray(jkyber.spectrum(b3.reshape(-1, N))).reshape(b3.shape)
        spec = kyber.spectrum(t(b3).reshape(-1, N)).reshape(b3.shape)
        got = kyber.dot_cached(t(a3), spec)
        assert torch.equal(got, kyber.dot_cached(t(a3), kyber_spectra_from_jax(jspec)))
        return got, jkyber.dot_cached(a3, jspec)
    if entry == "matvec":
        blocks = jkyber.matvec_spectra(A)
        got = kyber.matvec(t(a3), kyber.matvec_spectra(t(A)))
        assert torch.equal(got, kyber.matvec(t(a3), kyber_blocks_from_jax(blocks)))
        return got, jkyber.matvec(a3, blocks)
    got = getattr(kyber, entry)(*map(t, args))
    want = getattr(jkyber, entry)(*args)
    if entry == "spectrum":
        want = int32_to_uint32(kyber_spectra_from_jax(want))
    elif entry in ("matvec_spectra", "ntt_domain_blocks"):
        want = int32_to_uint32(kyber_blocks_from_jax(want))
    return got, want


@pytest.mark.parametrize("entry", ["ntt", "intt", "basemul", "poly_mult", "spectrum",
                                   "poly_mult_cached", "matvec_spectra",
                                   "ntt_domain_blocks"])
def test_entry_point_matches_tpu_ntt_kyber(entry):
    got, want = run_both(entry)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.shape == np.asarray(want).shape and same(got, want), entry


@pytest.mark.parametrize("entry", ["dot", "dot_cached"])
def test_dot_matches_tpu_ntt_kyber_at_k_2_and_3(entry):
    for terms in (2, 3):
        got, want = run_both(entry, terms=terms)
        assert got.shape == (2, N) and same(got, want), (entry, terms)


def test_matvec_matches_tpu_ntt_kyber_2x3_and_3x3():
    for k in (2, 3):
        got, want = run_both("matvec", terms=3, k=k)
        assert got.shape == (k, 2, N) and same(got, want), k


def test_matvec_from_ntt_domain_blocks_matches_tpu_ntt_kyber():
    """K-PKE's shape: A_hat sampled in the NTT domain, s in coefficients."""
    A_hat, s = residues((3, 3, N), 8), residues((3, 2, N), 9)
    want = jkyber.matvec(s, jkyber.ntt_domain_blocks(A_hat))
    got = kyber.matvec(t(s), kyber.ntt_domain_blocks(t(A_hat)))
    assert same(got, want)
    # the same matrix through its coefficients
    A = kyber.intt(t(A_hat).reshape(-1, N)).reshape(3, 3, N)
    assert torch.equal(kyber.matvec(t(s), kyber.matvec_spectra(A)), got)


@pytest.mark.parametrize("batch", [0, 1, 130])
def test_batch_sizes_against_the_goldens(batch):
    a, b = residues((batch, N), 10), residues((batch, N), 11)
    fa = kyber.ntt(t(a))
    c = kyber.poly_mult(t(a), t(b))
    assert fa.shape == c.shape == (batch, N)
    assert torch.equal(kyber.intt(fa), t(a))
    assert torch.equal(kyber.poly_mult_cached(t(a), kyber.spectrum(t(b))), c)
    for r in range(batch):
        x, y = a[r].tolist(), b[r].tolist()
        assert fa[r].tolist() == reference.kyber_ntt(x)
        assert c[r].tolist() == reference.kyber_poly_mult(x, y)
    d = kyber.dot(t(a)[None], t(b)[None])
    assert torch.equal(d, c)


def test_surface_matches_tpu_ntt_kyber():
    public = [n for n, f in vars(jkyber).items()
              if inspect.isfunction(f) and not n.startswith("_")
              and f.__module__ == jkyber.__name__ and not n.endswith("_xla")]
    assert sorted(public) == sorted(n for n in kyber.__all__ if n.islower()), public
    assert kyber.impl_name() == KyberPlan.name == "cuda-kyber"
    assert (kyber.Q, kyber.N, kyber.ZETA) == (jkyber.Q, jkyber.N, jkyber.ZETA)


def test_entry_points_refuse_what_they_cannot_take():
    a = t(residues((2, N), 12))
    with pytest.raises(TypeError):
        kyber.ntt(residues((2, N), 12))  # a numpy array, not a tensor
    with pytest.raises(TypeError):
        kyber.poly_mult(a.long(), a.long())
    with pytest.raises(ValueError):
        kyber.ntt(a.to("meta"))
    with pytest.raises(ValueError):
        kyber.matvec(a[None], a[None])  # s has 1 polynomial, A 2 columns
    with pytest.raises(ValueError):
        kyber.dot(a.new_zeros((9, 1, N)), a.new_zeros((9, 1, N)))


@pytest.mark.cuda
def test_cuda_entry_points_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    dev = torch.device("cuda", torch.cuda.current_device())
    a, b = (uint32_to_int32(residues((8, N), s), dev) for s in (13, 14))
    cpu = {"a": a.cpu(), "b": b.cpu()}
    for entry in ("ntt", "intt", "spectrum"):
        assert torch.equal(getattr(kyber, entry)(a).cpu(),
                           getattr(kyber, entry)(cpu["a"])), entry
    for entry in ("basemul", "poly_mult"):
        assert torch.equal(getattr(kyber, entry)(a, b).cpu(),
                           getattr(kyber, entry)(cpu["a"], cpu["b"])), entry
    a3, b3 = a.reshape(2, 4, N), b.reshape(2, 4, N)
    assert torch.equal(kyber.dot(a3, b3).cpu(), kyber.dot(a3.cpu(), b3.cpu()))
    A = b3[:, :2].contiguous()
    assert torch.equal(kyber.matvec(a3, kyber.matvec_spectra(A)).cpu(),
                       kyber.matvec(a3.cpu(), kyber.matvec_spectra(A.cpu())))

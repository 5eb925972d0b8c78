"""The port's 60-bit dot and matvec against tpu_ntt's (kernels K1b, K1c).

On the CPU ``tpu_ntt_torch.kernels.mxu64.MxuPlan64.nwc_dot``,
``nwc_dot_cached``, ``nwc_matvec_spectra`` and ``nwc_matvec_cached`` run
their plain versions; each must equal ``tpu_ntt.kernels.mxu64.MxuPlan64`` in
Pallas interpret mode at n = 256 and the generic prime 576460752308273153:
the dot at K = 2, fresh and against cached spectra, and the 2 x 2 matvec.
JAX's cached spectra and matvec blocks, carried over by
``convert.spectra64_from_jax`` and ``convert.matvec_spectra64_from_jax``,
must equal the port's and give JAX's results.  Each result must also equal
the sum of the port's own products.  Operands come from
``numpy.random.default_rng`` with rows of 0, 1 and q - 1.
Tolerance: none — exact integer equality.
"""

import functools

import numpy as np
import pytest
import torch

import tpu_ntt.params as jparams
from tpu_ntt.kernels.mxu64 import MxuPlan64 as JaxMxuPlan64
from tpu_ntt_torch.convert import (int64_to_pairs, matvec_spectra64_from_jax,
                                   pairs_to_int64, spectra64_from_jax)
from tpu_ntt_torch.kernels.mxu64 import MxuPlan64
from tpu_ntt_torch.params import make_params

N = 256
Q = 576460752308273153  # bench.py:35, 60 bits, not a trinomial


def operands(shape, seed: int) -> torch.Tensor:
    """Residues of the given shape, (..., B, n); the first rows are all 0,
    all 1, all q - 1 and [0, 1, q - 1] cycled."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.int64)
    edge = np.stack([np.zeros(N), np.ones(N), np.full(N, Q - 1),
                     np.resize([0, 1, Q - 1], N)]).astype(np.int64)
    rows = x.reshape(-1, N)
    k = min(4, rows.shape[0])
    rows[:k] = edge[:k] if seed % 2 else edge[:k][::-1]
    return torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def plans():
    jm = JaxMxuPlan64(jparams.make_params(N, Q))
    jm.groups_per_step = 1  # keep interpret-mode cost down
    return MxuPlan64(make_params(N, Q), "cpu"), jm


def from_jax(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def summed_products(tm, xs, ys) -> torch.Tensor:
    """sum_k xs[k] * ys[k] through the port's product, mod q."""
    acc = torch.zeros_like(xs[0])
    for x, y in zip(xs, ys):
        acc = (acc + tm.nwc_poly_mult(x, y)) % Q
    return acc


@pytest.mark.parametrize("cached", [False, True])
def test_dot_matches_jax_interpret(cached):
    tm, jm = plans()
    a, b = operands((2, 3, N), seed=1), operands((2, 3, N), seed=2)
    if cached:
        jspec = jm.nwc_spectrum(int64_to_pairs(b.reshape(-1, N)), interpret=True)
        jspec = tuple(np.asarray(w).reshape(b.shape) for w in jspec)
        spectra = spectra64_from_jax(*jspec)
        assert torch.equal(spectra, tm.nwc_spectrum(b.reshape(-1, N)).reshape(b.shape))
        want = jm.nwc_dot_cached(int64_to_pairs(a), jspec, interpret=True)
        got = tm.nwc_dot_cached(a, spectra)
    else:
        want = jm.nwc_dot(int64_to_pairs(a), int64_to_pairs(b), interpret=True)
        got = tm.nwc_dot(a, b)
    assert torch.equal(got, from_jax(want))
    assert torch.equal(got, summed_products(tm, a, b))


def test_matvec_matches_jax_and_the_bridge():
    tm, jm = plans()
    A, s = operands((2, 2, N), seed=3), operands((2, 3, N), seed=4)
    blocks = jm.nwc_matvec_spectra(int64_to_pairs(A), interpret=True)
    spectra = tm.nwc_matvec_spectra(A)
    assert torch.equal(matvec_spectra64_from_jax(blocks, N), spectra)
    want = jm.nwc_matvec_cached(int64_to_pairs(s), blocks, interpret=True)
    got = tm.nwc_matvec_cached(s, spectra)
    assert got.shape == (2, 3, N)
    assert torch.equal(got, from_jax(want))
    for i in range(2):
        rows = [A[i, j].expand(3, N).contiguous() for j in range(2)]
        assert torch.equal(got[i], summed_products(tm, rows, s)), i

"""The 60-bit slice end to end at P60_4096: every op of
``tpu_ntt_torch.dispatch`` against ``tpu_ntt``'s XLA merged functions.

At n = 4096 the JAX Pallas kernels are far too slow to interpret, so the
reference is ``tpu_ntt.ntt`` over a JAX ``NttPlan`` (Ring64, (hi, lo)
pairs), to which that package holds its kernels bit for bit.  Each op gets
B = 2 rows from ``numpy.random.default_rng`` with rows of 0, 1 and q - 1 (the
dot K = 2 pairs, the matvec a 2 x 2 matrix).  Spectra are compared in
natural order; the port's cached spectra are the negacyclic spectrum times
2^64 mod q, which the reference side multiplies in with Python integers.
Tolerance: none — exact integer equality.
"""

import functools

import numpy as np
import pytest
import torch

import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
from tpu_ntt_torch import dispatch, kernels
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels.sol64 import SolinasPlan64
from tpu_ntt_torch.params import P60_4096

P = P60_4096
N, Q = P.n, P.q
R = (1 << 64) % Q  # the port's spectrum domain


def residues(shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.int64)
    rows = x.reshape(-1, N)
    rows[0] = np.roll(np.resize(np.array([0, 1, Q - 1], np.int64), N), seed)
    rows[1] = Q - 1 if seed % 2 else 0
    return torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def jax_plan():
    return jntt.NttPlan(jparams.P60_4096)


@functools.lru_cache(maxsize=None)
def port_plan() -> SolinasPlan64:
    return kernels.plan_for(P, "cpu")


def xla(fn, *xs) -> torch.Tensor:
    """A tpu_ntt.ntt function of int64 tensors, through (hi, lo) pairs."""
    out = fn(jax_plan(), *(int64_to_pairs(x) for x in xs))
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def xla_dot(a, b) -> torch.Tensor:
    """sum_k a[k] * b[k] mod (x^n + 1, q), one merged product a term."""
    acc = torch.zeros_like(a[0])
    for x, y in zip(a, b):
        acc = (acc + xla(jntt.nwc_poly_mult_merged, x, y)) % Q
    return acc


def natural(x: torch.Tensor) -> torch.Tensor:
    """A bit-reversed spectrum (the port's, or nwc_fwd_merged's) in natural
    order."""
    return port_plan().bitrev_to_natural(x)


def to_domain(x: torch.Tensor) -> torch.Tensor:
    """x * 2^64 mod q, elementwise, in Python integers."""
    return torch.tensor([[v * R % Q for v in row] for row in x.reshape(-1, N).tolist()],
                        dtype=torch.int64).reshape(x.shape)


def run_both(op: str):
    """(port result, reference) for one op at P60_4096, comparable order."""
    best = dispatch.best(P, op)
    a, b = residues((2, N), 1), residues((2, N), 2)
    a3, b3 = residues((2, 2, N), 3), residues((2, 2, N), 4)
    if op == "nwc":
        return best(a, b), xla(jntt.nwc_poly_mult_merged, a, b)
    if op == "cyclic":
        return best(a, b), xla(jntt.cyclic_poly_mult, a, b)
    if op == "fwd":
        return natural(best(a)), xla(jntt.ntt_fwd, a)
    if op == "inv":
        return best(port_plan().natural_to_bitrev(a)), xla(jntt.ntt_inv, a)
    if op == "nwc_fwd":
        return natural(best(a)), natural(xla(jntt.nwc_fwd_merged, a))
    if op == "nwc_inv":
        return best(a), xla(jntt.nwc_inv_merged, a)
    if op == "spectrum":
        return natural(best(a)), natural(to_domain(xla(jntt.nwc_fwd_merged, a)))
    if op == "cached":
        return best(a, dispatch.best(P, "spectrum")(b)), xla(jntt.nwc_poly_mult_merged, a, b)
    if op == "dot":
        return best(a3, b3), xla_dot(a3, b3)
    if op == "dot_cached":
        spectra = dispatch.best(P, "spectrum")(b3.reshape(-1, N)).reshape(b3.shape)
        return best(a3, spectra), xla_dot(a3, b3)
    A = a3  # a 2 x 2 matrix of polynomials
    if op == "matvec_spectra":
        # row by row: the (2, n) shape the other ops compiled for
        want = torch.stack([to_domain(xla(jntt.nwc_fwd_merged, A[i])) for i in range(2)])
        return natural(best(A)), natural(want)
    assert op == "matvec"
    got = best(b3, dispatch.best(P, "matvec_spectra")(A))
    want = torch.stack([xla_dot([A[i, j].expand(2, N).contiguous() for j in range(2)], b3)
                        for i in range(2)])
    return got, want


@pytest.mark.parametrize("op", dispatch.OPS)
def test_best_matches_jax_merged_at_p60_4096(op):
    assert dispatch.impl_name(P, op) == SolinasPlan64.name
    got, want = run_both(op)
    assert got.shape == want.shape and torch.equal(got, want), op

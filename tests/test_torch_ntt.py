"""The port's ntt, reference and convert modules against tpu_ntt's.

The same operands, made with ``numpy.random.default_rng``, go through each
``tpu_ntt.ntt`` function (eagerly, on (hi, lo) uint32 pairs) and its
``tpu_ntt_torch.ntt`` counterpart (int64 residues) at make_params(256, Q60)
and at P60_4096, B = 2; row 0 cycles the boundary values 0, 1 and q - 1.
``convert.tables_from_jax`` must reproduce the port's own tables.
Tolerance: none — exact integer equality.
"""

import functools

import numpy as np
import pytest
import torch

import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
import tpu_ntt.reference as jref
import tpu_ntt_torch.ntt as tntt
import tpu_ntt_torch.params as tparams
import tpu_ntt_torch.reference as tref
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64, tables_from_jax

Q60 = jparams.P60_4096.q
SIZES = [256, 4096]


def params_pair(n: int):
    if n == 4096:
        return jparams.P60_4096, tparams.P60_4096
    return jparams.make_params(n, Q60), tparams.make_params(n, Q60)


@functools.lru_cache(maxsize=None)
def plans(n: int, red: str = "shoup"):
    jp, tp = params_pair(n)
    return (jntt.NttPlan(jp, jparams.Reduction(red)),
            tntt.NttPlan(tp, tparams.Reduction(red)))


def operands(n: int, seed: int, q: int = Q60):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, q, size=(2, n), dtype=np.int64)
    b = rng.integers(0, q, size=(2, n), dtype=np.int64)
    a[0] = np.resize(np.array([0, 1, q - 1], np.int64), n)
    b[0] = np.resize(np.array([q - 1, 1, q - 1, 0], np.int64), n)
    return torch.from_numpy(a), torch.from_numpy(b)


def run_jax(fn, plan, *xs):
    out = fn(plan, *(int64_to_pairs(x) for x in xs))
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


UNARY = ["ntt_fwd", "ntt_inv", "twist", "untwist", "nwc_fwd_merged", "nwc_inv_merged"]
BINARY = ["pointwise_mul", "cyclic_poly_mult", "nwc_poly_mult", "nwc_poly_mult_merged"]


@pytest.mark.parametrize("fn", UNARY + BINARY)
def test_ntt_function_matches_jax(fn):
    for n in SIZES:
        jplan, tplan = plans(n)
        xs = operands(n, seed=n + len(fn))[: 1 if fn in UNARY else 2]
        assert torch.equal(getattr(tntt, fn)(tplan, *xs),
                           run_jax(getattr(jntt, fn), jplan, *xs)), n


@pytest.mark.parametrize("red", ["montgomery", "barrett"])
def test_merged_product_matches_jax_other_reductions(red):
    jplan, tplan = plans(256, red)
    a, b = operands(256, seed=9)
    assert torch.equal(tntt.nwc_poly_mult_merged(tplan, a, b),
                       run_jax(jntt.nwc_poly_mult_merged, jplan, a, b))


def _same(x, y):
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(map(_same, x, y))
    return torch.equal(x, y)


@pytest.mark.parametrize("n", SIZES)
def test_tables_from_jax_match_port_tables(n):
    for red in ("shoup", "montgomery", "barrett"):
        jplan, tplan = plans(n, red)
        for name, table in tables_from_jax(jplan).items():
            assert _same(table, getattr(tplan, name)), (red, name)


def test_round_trips_and_inverses_at_p60_4096():
    _, tplan = plans(4096)
    a, _ = operands(4096, seed=4)
    assert torch.equal(tntt.ntt_inv(tplan, tntt.ntt_fwd(tplan, a)), a)
    assert torch.equal(tntt.nwc_inv_merged(tplan, tntt.nwc_fwd_merged(tplan, a)), a)


def test_convert_round_trip_full_range():
    rng = np.random.default_rng(2)
    u = rng.integers(0, 1 << 64, size=(3, 17), dtype=np.uint64)
    u[0, :3] = [0, (1 << 63), (1 << 64) - 1]
    hi = (u >> np.uint64(32)).astype(np.uint32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    t = pairs_to_int64(hi, lo)
    assert t.dtype == torch.int64 and t.shape == (3, 17)
    assert np.array_equal(t.numpy().view(np.uint64), u)
    back = int64_to_pairs(t)
    assert np.array_equal(back[0], hi) and np.array_equal(back[1], lo)


@pytest.mark.parametrize("n,q", [(16, 97), (64, Q60)])
def test_reference_matches_jax(n, q):
    jp, tp = jparams.make_params(n, q), tparams.make_params(n, q)
    rng = np.random.default_rng(n)
    a = [int(v) for v in rng.integers(0, q, size=n)]
    b = [int(v) for v in rng.integers(0, q, size=n)]
    a[:3] = [0, 1, q - 1]
    assert tref.bit_reverse_permutation(n) == jref.bit_reverse_permutation(n)
    assert tref.cg_ntt(a, tp.omega, q) == jref.cg_ntt(a, jp.omega, q)
    assert tref.cg_intt(a, tp.omega, q) == jref.cg_intt(a, jp.omega, q)
    assert tref.cyclic_poly_mult(a, b, tp) == jref.cyclic_poly_mult(a, b, jp)
    assert tref.nwc_poly_mult(a, b, tp) == jref.nwc_poly_mult(a, b, jp)
    assert (tref.schoolbook_negacyclic(a, b, q)
            == jref.schoolbook_negacyclic(a, b, q)
            == tref.nwc_poly_mult(a, b, tp))

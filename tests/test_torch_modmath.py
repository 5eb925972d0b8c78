"""The port's Ring64 (int64 residues) against tpu_ntt.modmath.Ring64 ((hi, lo)
uint32 pairs) on the same operands.

Operands are random residues from ``numpy.random.default_rng`` plus every
pair of the boundary values 0, 1 and q - 1; every op runs under SHOUP,
MONTGOMERY and BARRETT.  Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

import tpu_ntt.modmath as jmod
import tpu_ntt.params as jparams
import tpu_ntt_torch.modmath as tmod
import tpu_ntt_torch.params as tparams
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64

Q60 = jparams.P60_4096.q
QS = {
    "q60_trinomial": Q60,
    "q62_max_width": 4611686018427322369,      # 2^62 - 2^16 + 1
    "q59_generic": 576460752308273153,         # 2-adicity 17, not a trinomial
    "q31": 2013265921,                         # 15 * 2^27 + 1: R = 2^64 anyway
}
REDUCTIONS = ["shoup", "montgomery", "barrett"]


def operands(q: int, seed: int, size: int = 300):
    """a, b as int64 arrays: all nine boundary pairs, then random residues."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, q - 1], dtype=np.int64)
    a = np.concatenate([np.repeat(edge, 3), rng.integers(0, q, size, dtype=np.int64)])
    b = np.concatenate([np.tile(edge, 3), rng.integers(0, q, size, dtype=np.int64)])
    return a, b


def rings(key: str, red: str):
    p = jparams.make_params(256, QS[key])
    tp = tparams.make_params(256, QS[key])
    return (jmod.Ring64(p, jparams.Reduction(red)),
            tmod.Ring64(tp, tparams.Reduction(red)))


def to_pair(x: np.ndarray):
    return int64_to_pairs(torch.from_numpy(x))


def from_pair(pair) -> torch.Tensor:
    return pairs_to_int64(np.asarray(pair[0]), np.asarray(pair[1]))


@pytest.mark.parametrize("red", REDUCTIONS)
@pytest.mark.parametrize("op", ["add", "sub", "mul", "mul_tw"])
def test_ring64_op_matches_jax(op, red):
    for key, q in QS.items():
        jring, tring = rings(key, red)
        a, b = operands(q, seed=len(op) + 10 * len(key))
        if op == "mul_tw":
            want = from_pair(jring.mul_tw(to_pair(a), jring.encode_tw(b.tolist())))
            got = tring.mul_tw(torch.from_numpy(a), tring.encode_tw(b.tolist()))
        else:
            want = from_pair(getattr(jring, op)(to_pair(a), to_pair(b)))
            got = getattr(tring, op)(torch.from_numpy(a), torch.from_numpy(b))
        assert torch.equal(got, want), key
        if op in ("mul", "mul_tw"):
            assert got.tolist() == [int(x) * int(y) % q for x, y in zip(a, b)], key


@pytest.mark.parametrize("red", REDUCTIONS)
def test_encode_tw_matches_jax(red):
    for key, q in QS.items():
        jring, tring = rings(key, red)
        values = operands(q, seed=3)[0].tolist()
        want, got = jring.encode_tw(values), tring.encode_tw(values)
        if red == "shoup":
            assert torch.equal(got[0], pairs_to_int64(*want[0])), key
            # companions >= 2^63 come out as their wrapped int64
            assert torch.equal(got[1], pairs_to_int64(*want[1])), key
        else:
            assert torch.equal(got, pairs_to_int64(*want)), key


def test_select_matches_where():
    _, tring = rings("q60_trinomial", "shoup")
    a, b = (torch.from_numpy(x) for x in operands(Q60, seed=5))
    pred = a > b
    assert torch.equal(tring.select(pred, a, b), torch.maximum(a, b))


def test_word_products_match_python_ints():
    """mul32/mullo32/mul64_full/mul64_lo over the full 64-bit range,
    including values >= 2^63 stored as wrapped int64."""
    rng = np.random.default_rng(11)
    u = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    v = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    u[:4] = [0, 1, (1 << 64) - 1, 1 << 63]
    v[:4] = [(1 << 64) - 1, (1 << 64) - 1, (1 << 64) - 1, 1 << 63]
    tu, tv = (torch.from_numpy(x.view(np.int64)) for x in (u, v))
    wu, wv = tmod.split64(tu), tmod.split64(tv)
    full = tmod.mul64_full(wu, wv)
    lo = tmod.mul64_lo(wu, wv)
    hi32, lo32 = tmod.mul32(wu[1], wv[1])
    low32 = tmod.mullo32(wu[0], wv[1])
    for i, (x, y) in enumerate(zip(u.tolist(), v.tolist())):
        prod = x * y
        assert [int(w[i]) for w in full] == [(prod >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)]
        assert (int(lo[0][i]) << 32 | int(lo[1][i])) == prod % (1 << 64)
        assert (int(hi32[i]) << 32 | int(lo32[i])) == (x & 0xFFFFFFFF) * (y & 0xFFFFFFFF)
        assert int(low32[i]) == ((x >> 32) * (y & 0xFFFFFFFF)) & 0xFFFFFFFF


def test_ring64_rejects_q_above_62_bits():
    with pytest.raises(ValueError):
        tmod.Ring64(tparams.GOLDILOCKS_4096)

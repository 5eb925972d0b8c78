"""The port's Ring32 (int32 residues) against tpu_ntt.modmath.Ring32 (uint32).

Operands are random residues from ``numpy.random.default_rng`` plus every
pair of the boundary values 0, 1 and q - 1, at the ML-DSA modulus 8380417,
the Falcon modulus 12289 and the 30-bit 998244353 (the largest width the
single-word ring takes); every op runs under SHOUP, MONTGOMERY and BARRETT.
Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

import tpu_ntt.modmath as jmod
import tpu_ntt.params as jparams
import tpu_ntt_torch.modmath as tmod
import tpu_ntt_torch.params as tparams
from tpu_ntt_torch.convert import int32_to_uint32, uint32_to_int32

QS = {"q23_mldsa": 8380417, "q14_falcon": 12289, "q30": 998244353}
REDUCTIONS = ["shoup", "montgomery", "barrett"]


def operands(q: int, seed: int, size: int = 300):
    """a, b as uint32 arrays: all nine boundary pairs, then random residues."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, q - 1], dtype=np.uint32)
    a = np.concatenate([np.repeat(edge, 3), rng.integers(0, q, size, dtype=np.uint32)])
    b = np.concatenate([np.tile(edge, 3), rng.integers(0, q, size, dtype=np.uint32)])
    return a, b


def rings(q: int, red: str):
    jp, tp = jparams.make_params(256, q), tparams.make_params(256, q)
    return (jmod.Ring32(jp, jparams.Reduction(red)),
            tmod.Ring32(tp, tparams.Reduction(red)))


@pytest.mark.parametrize("red", REDUCTIONS)
@pytest.mark.parametrize("op", ["add", "sub", "mul", "mul_tw"])
def test_ring32_op_matches_jax(op, red):
    for key, q in QS.items():
        jring, tring = rings(q, red)
        a, b = operands(q, seed=len(op) + 10 * len(key))
        if op == "mul_tw":
            want = jring.mul_tw(a, jring.encode_tw(b.tolist()))
            got = tring.mul_tw(uint32_to_int32(a), tring.encode_tw(b.tolist()))
        else:
            want = getattr(jring, op)(a, b)
            got = getattr(tring, op)(uint32_to_int32(a), uint32_to_int32(b))
        assert got.dtype == torch.int32, key
        assert np.array_equal(int32_to_uint32(got), np.asarray(want)), key
        if op in ("mul", "mul_tw"):
            assert got.tolist() == [int(x) * int(y) % q for x, y in zip(a, b)], key


@pytest.mark.parametrize("red", REDUCTIONS)
def test_encode_tw_matches_jax(red):
    for key, q in QS.items():
        jring, tring = rings(q, red)
        values = operands(q, seed=3)[0].tolist()
        want, got = jring.encode_tw(values), tring.encode_tw(values)
        if red == "shoup":
            # companions >= 2^31 come out as their wrapped int32
            for w, g in zip(want, got):
                assert g.dtype == torch.int32
                assert np.array_equal(int32_to_uint32(g), np.asarray(w)), key
        else:
            assert np.array_equal(int32_to_uint32(got), np.asarray(want)), key


def test_primitives_match_python_ints():
    """The single-word products against Python ints at the top of their
    range, q just under 2^30 and operands q - 1."""
    q = 1073741789  # the largest prime below 2^30
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.integers(0, q, 500)).to(torch.int32) for _ in "ab")
    a[:3], b[:3] = q - 1, torch.tensor([q - 1, 0, 1], dtype=torch.int32)
    want = [int(x) * int(y) % q for x, y in zip(a.tolist(), b.tolist())]
    k = q.bit_length()
    assert tmod.barrett_mul32(a, b, q, k, (1 << 2 * k) // q).tolist() == want
    ws = tmod.encode32([(int(v) << 32) // q for v in b.tolist()])
    assert tmod.shoup_mul32(a, b, ws, q).tolist() == want
    qp, r2 = (-pow(q, -1, 1 << 32)) % (1 << 32), (1 << 64) % q
    assert tmod.mont_mul32(tmod.mont_mul32(a, b, q, qp), r2, q, qp).tolist() == want


def test_make_ring_matches_jax_choice():
    for q in (*QS.values(), jparams.P60_4096.q):
        jp, tp = jparams.make_params(256, q), tparams.make_params(256, q)
        jring, tring = jmod.make_ring(jp), tmod.make_ring(tp)
        assert type(tring).__name__ == type(jring).__name__, q
        assert tring.reduction.value == jring.reduction.value, q
    with pytest.raises(ValueError):
        tmod.Ring32(tparams.P60_4096)
    gl = tmod.make_ring(tparams.GOLDILOCKS_4096)  # ported: Q1.6
    jgl = jmod.make_ring(jparams.GOLDILOCKS_4096)
    assert type(gl).__name__ == type(jgl).__name__ == "GoldilocksRing"
    assert gl.reduction.value == jgl.reduction.value


def test_uint32_bridge_round_trip():
    rng = np.random.default_rng(2)
    u = rng.integers(0, 1 << 32, size=(3, 17), dtype=np.uint64).astype(np.uint32)
    u[0, :3] = [0, 1 << 31, (1 << 32) - 1]
    t = uint32_to_int32(u)
    assert t.dtype == torch.int32 and t.shape == (3, 17)
    assert np.array_equal(int32_to_uint32(t), u)
    residues = u < (1 << 31)  # keep their value, not only their bits
    assert np.array_equal(t.numpy()[residues], u[residues].astype(np.int32))

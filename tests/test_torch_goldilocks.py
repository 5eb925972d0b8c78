"""The port's Goldilocks ring against tpu_ntt's (q = 2^64 - 2^32 + 1).

A Goldilocks residue is one ``torch.int64`` holding its 64-bit pattern (a
residue >= 2^63 is negative there; ``tpu_ntt_torch.modmath``'s docstring).
``GoldilocksRing`` add, sub and mul must equal ``tpu_ntt.modmath``'s
``GoldilocksRing`` on (hi, lo) pairs and big-int arithmetic on every pair
of the operands 0, 1, q - 1, 2^63 - 1, 2^63, 2^64 - 2^32 and numpy-seeded
randoms; the phi-fold must reduce any 128-bit value; ``join64``,
``encode64`` and the ``convert`` bridge must round-trip every pattern; the
plain transforms at n = 4096 must equal JAX's XLA merged and no-gather
functions.  Tolerance: none — exact integer equality.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tpu_ntt.modmath as jmod
import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
from tpu_ntt_torch import modmath as tmod
from tpu_ntt_torch import ntt as tntt
from tpu_ntt_torch import params as tparams
from tpu_ntt_torch import reference
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64, tables_from_jax

Q = tmod.GOLDILOCKS_Q
M64 = (1 << 64) - 1
EDGES = [0, 1, Q - 1, (1 << 63) - 1, 1 << 63, (1 << 64) - (1 << 32)]


def unsigned(t: torch.Tensor) -> list:
    return t.numpy().view(np.uint64).tolist()


def operand_pairs(seed: int = 0):
    """Every ordered pair of the boundary operands and 24 randoms, as
    Python ints and as int64 tensors."""
    rng = np.random.default_rng(seed)
    vals = EDGES + [int(v) for v in rng.integers(0, Q, 24, dtype=np.uint64)]
    a = [x for x in vals for _ in vals]
    b = [y for _ in vals for y in vals]
    return a, b, tmod.encode64(a), tmod.encode64(b)


def test_edges_are_residues():
    assert all(0 <= v < Q for v in EDGES)
    assert (1 << 64) - (1 << 32) == Q - 1


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_ring_ops_match_jax_and_big_int(op):
    a, b, ta, tb = operand_pairs()
    ring = tmod.make_ring(tparams.GOLDILOCKS_4096)
    jring = jmod.make_ring(jparams.GOLDILOCKS_4096)
    got = getattr(ring, op)(ta, tb)
    want = {"add": lambda x, y: (x + y) % Q, "sub": lambda x, y: (x - y) % Q,
            "mul": lambda x, y: x * y % Q}[op]
    assert unsigned(got) == [want(x, y) for x, y in zip(a, b)]
    jout = getattr(jring, op)(int64_to_pairs(ta), int64_to_pairs(tb))
    assert torch.equal(got, pairs_to_int64(np.asarray(jout[0]), np.asarray(jout[1])))


def test_mul_by_constants_and_mul_tw():
    """A Python-int operand (a twiddle word) and an encoded table give the
    same products as big-int arithmetic."""
    a, _, ta, _ = operand_pairs(1)
    ring = tmod.GoldilocksRing(tparams.GOLDILOCKS_4096)
    for c in EDGES[1:]:
        assert unsigned(tmod.goldilocks_mul(ta, c)) == [x * c % Q for x in a]
        tw = ring.encode_tw([c])
        assert unsigned(ring.mul_tw(ta, tw)) == [x * c % Q for x in a]


def test_phi_fold_reduces_any_128_bit_value():
    rng = np.random.default_rng(2)
    words = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    quads = [(w3, w2, w1, w0) for w3 in words for w2 in words
             for w1 in words for w0 in words[::2]]
    quads += [tuple(int(v) for v in rng.integers(0, 1 << 32, 4, dtype=np.uint64))
              for _ in range(64)]
    cols = [torch.tensor([q[i] for q in quads], dtype=torch.int64) for i in range(4)]
    got = unsigned(tmod.goldilocks_reduce128(*cols))
    assert got == [((w3 << 96) | (w2 << 64) | (w1 << 32) | w0) % Q
                   for w3, w2, w1, w0 in quads]


def test_join_split_encode_round_trip_every_pattern():
    patterns = EDGES + [M64, (1 << 64) - 2, 1 << 32, (1 << 32) - 1, 0xFFFFFFFF80000000]
    x = tmod.encode64(patterns)
    assert unsigned(x) == patterns
    hi, lo = tmod.split64(x)
    assert hi.tolist() == [v >> 32 for v in patterns]
    assert lo.tolist() == [v & 0xFFFFFFFF for v in patterns]
    assert torch.equal(tmod.join64((hi, lo)), x)
    assert torch.equal(pairs_to_int64(*int64_to_pairs(x)), x)


def test_make_ring_routes_goldilocks_as_jax_does():
    ring = tmod.make_ring(tparams.GOLDILOCKS_4096)
    jring = jmod.make_ring(jparams.GOLDILOCKS_4096)
    assert type(ring).__name__ == type(jring).__name__ == "GoldilocksRing"
    assert ring.reduction.value == jring.reduction.value
    with pytest.raises(ValueError):
        tmod.GoldilocksRing(tparams.P60_4096)
    with pytest.raises(ValueError):
        tmod.Ring64(tparams.GOLDILOCKS_4096)
    # the twiddle encoding is plain: no Shoup companion exists above 2^63
    assert torch.equal(ring.encode_tw([Q - 1, 7]), tmod.encode64([Q - 1, 7]))


@functools.lru_cache(maxsize=None)
def plans(n: int = 4096):
    p = tparams.make_params(n, Q)
    return tntt.NttPlan(p, device="cpu"), jntt.NttPlan(jparams.make_params(n, Q))


def residues(shape, seed: int) -> torch.Tensor:
    """int64 patterns of residues with the boundary values in row 0."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint64)
    x.reshape(-1, shape[-1])[0] = np.resize(np.array(EDGES, dtype=np.uint64), shape[-1])
    return torch.from_numpy(x.view(np.int64))


def from_jax(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def jax_call(fn, x: torch.Tensor) -> torch.Tensor:
    """fn of JAX's n = 4096 plan, jitted (one compile instead of one per
    primitive and shape), on x's pairs."""
    return from_jax(jax.jit(functools.partial(fn, plans()[1]))(int64_to_pairs(x)))


def test_tables_match_jax():
    tp, jp = plans()
    for name, want in tables_from_jax(jp).items():
        got = getattr(tp, name)
        if isinstance(want, list):
            assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        else:
            assert torch.equal(got, want), name


@pytest.mark.parametrize("kind", ["nwc", "cyclic"])
def test_plain_transforms_match_jax_xla_at_4096(kind):
    tp, jp = plans()
    x = residues((2, 4096), 3 if kind == "nwc" else 4)
    fwd, inv = {"nwc": ((tntt.nwc_fwd_merged, jntt.nwc_fwd_merged),
                        (tntt.nwc_inv_merged, jntt.nwc_inv_merged)),
                "cyclic": ((tntt.ntt_fwd_bitrev, jntt.ntt_fwd_nogather),
                           (tntt.ntt_inv_bitrev, jntt.ntt_inv_nogather))}[kind]
    spec = fwd[0](tp, x)
    assert torch.equal(spec, jax_call(fwd[1], x))
    assert torch.equal(inv[0](tp, spec), x)
    assert torch.equal(inv[0](tp, x), jax_call(inv[1], x))


@pytest.mark.parametrize("n", [256, 4096])
def test_plain_products_match_the_golden(n):
    """The merged negacyclic product and the cyclic one against the
    big-int goldens (tpu_ntt.reference's algorithms, copied)."""
    tp = plans(n)[0]
    a, b = residues((2, n), 5), residues((2, n), 6)
    nwc = unsigned(tntt.nwc_poly_mult_merged(tp, a, b))
    cyc = unsigned(tntt.cyclic_poly_mult(tp, a, b))
    for row in range(2):
        x, y = unsigned(a)[row], unsigned(b)[row]
        assert nwc[row] == reference.nwc_poly_mult(x, y, tp.p)
        assert cyc[row] == reference.cyclic_poly_mult(x, y, tp.p)

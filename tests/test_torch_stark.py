"""The port's STARK commitment path against tpu_ntt.stark: coset LDE and FRI.

At N = 256 (n = 64, blowup 4) over the Goldilocks field, the port's
``LdePlan`` orders ``bitrev`` and ``natural`` must give JAX's integers slot
for slot, and ``kernel`` (whose slots are each package's own layout) the
same evaluations once both are mapped to natural order through
``spectrum_indices`` (JAX's kernel order runs its Pallas gl64 forward in
interpret mode, one call); ``reorder`` from the kernel order to bitrev must
equal a direct bitrev extension; every slot must equal a big-int Horner
evaluation at its coset point.  ``FriProver.prove`` must return JAX's proof
dict for the same codeword: JAX's prover runs its own folds, transcript and
gathers with a hasher backed by JAX's big-int ``PoseidonRef`` (its XLA
Poseidon would compile a program for each of a dozen shapes here), which
the port's Poseidon equals (tests/test_torch_poseidon.py).  ``fri_verify``
of both packages must accept the proof and the port's must reject tampered
ones.  Operands come from ``numpy.random.default_rng``.  Tolerance: none —
exact integer equality.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tpu_ntt.stark as jstark
from tpu_ntt.poseidon import PoseidonRef as JaxPoseidonRef
from tpu_ntt.poseidon import from_pairs, to_pairs
from tpu_ntt_torch import stark
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels import gl64, poseidon
from tpu_ntt_torch.modmath import GOLDILOCKS_Q as Q

SMALL, BLOWUP = 64, 4  # N = 256, the smallest size the kernel order serves
FINAL, QUERIES = 16, 4


def coefficients(rows: int, seed: int, n: int = SMALL, q: int = Q) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(0, q, size=(rows, n), dtype=np.uint64)
    c[0, :5] = [0, 1, q - 1, min(1 << 63, q - 1), min((1 << 63) - 1, q - 2)]
    return c


def as_tensor(c: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(c.view(np.int64))


def from_jax(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def horner(coeffs, x: int, q: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % q
    return acc


@pytest.mark.parametrize("order", ["bitrev", "natural", "kernel"])
def test_lde_orders_match_jax(order):
    c = coefficients(2, seed=1)
    tp = stark.LdePlan(SMALL, Q, BLOWUP, order=order, device="cpu")
    jp = jstark.LdePlan(SMALL, Q, BLOWUP, order=order)
    got = tp.extend(as_tensor(c))
    want = from_jax(jax.jit(jp.extend)(to_pairs(c)))  # one compile, not one an op
    if order == "kernel":  # each package's own slot layout
        got = got[..., np.argsort(tp.spectrum_indices())]
        want = want[..., np.argsort(jp.spectrum_indices())]
    else:
        assert np.array_equal(tp.spectrum_indices(), jp.spectrum_indices())
    assert torch.equal(got, want)
    back = tp.interpolate(tp.extend(as_tensor(c)))
    assert torch.equal(back[..., :SMALL], as_tensor(c))
    assert not back[..., SMALL:].any()


def test_kernel_order_reorders_into_bitrev():
    """The port's kernel layout is bit-reversed, so reorder to bitrev is
    the identity permutation here; it must still equal a direct bitrev
    extension, and go back."""
    pk = stark.LdePlan(SMALL, Q, BLOWUP, order="kernel", device="cpu")
    pb = stark.LdePlan(SMALL, Q, BLOWUP, order="bitrev", device="cpu")
    pn = stark.LdePlan(SMALL, Q, BLOWUP, order="natural", device="cpu")
    x = as_tensor(coefficients(3, seed=2))
    ek = pk.extend(x)
    assert torch.equal(pk.reorder(ek, pb), pb.extend(x))
    assert torch.equal(pk.reorder(ek, pn), pn.extend(x))
    assert torch.equal(pn.reorder(pn.extend(x), pk), ek)
    with pytest.raises(ValueError, match="same domain"):
        pk.reorder(ek, stark.LdePlan(SMALL, Q, 8, order="bitrev", device="cpu"))


@pytest.mark.parametrize("q", [Q, 8380417, 1152921504606830593])
def test_every_slot_is_the_coset_evaluation(q):
    """Horner at shift * w^idx[t] for every slot of the bitrev order, over
    Goldilocks, a 24-bit and a 60-bit field (the plan is ring-generic)."""
    plan = stark.LdePlan(32, q, 8, order="bitrev", device="cpu")
    c = coefficients(1, seed=3, n=32, q=q)
    evals = plan.decode(plan.extend(plan.encode(c.astype(object))))[0]
    idx = plan.spectrum_indices()
    coeffs = [int(v) for v in c[0]]
    for t in range(plan.N):
        x = plan.shift * pow(plan.p.omega, int(idx[t]), q) % q
        assert evals[t] == horner(coeffs, x, q), t


def test_plan_guards():
    with pytest.raises(ValueError, match="power of two"):
        stark.LdePlan(64, Q, 3, device="cpu")
    with pytest.raises(ValueError, match="order"):
        stark.LdePlan(64, Q, 4, order="x", device="cpu")
    with pytest.raises(ValueError, match="unit"):
        stark.LdePlan(64, Q, 4, shift=Q, device="cpu")
    with pytest.raises(ValueError, match="kernel plan"):
        stark.LdePlan(1 << 19, Q, 4, order="kernel", device="cpu")  # N = 2^21: Q1.8
    pb = stark.LdePlan(32, Q, 4, order="bitrev", device="cpu")
    with pytest.raises(ValueError):
        stark.FriProver(stark.LdePlan(32, Q, 4, order="natural", device="cpu"))
    with pytest.raises(ValueError):
        stark.FriProver(pb, final_size=4)  # < 2 * blowup
    with pytest.raises(ValueError):
        stark.FriProver(stark.LdePlan(32, 8380417, 4, order="bitrev", device="cpu"))
    with pytest.raises(ValueError):
        stark.fri_verify(pb, {}, final_size=4)


class RefHasher:
    """JAX's FriProver hasher on JAX's big-int PoseidonRef: the ``hash_rows_j``
    and ``compress_j`` it calls, on (hi, lo) uint32 pairs."""

    def __init__(self):
        self.ref = JaxPoseidonRef()

    def hash_rows_j(self, rows):
        values = from_pairs((np.asarray(rows[0]), np.asarray(rows[1])))
        out = np.array([self.ref.hash_elements([int(v) for v in r]) for r in values],
                       dtype=np.uint64)
        return [to_pairs(out[:, k]) for k in range(4)]

    def compress_j(self, left, right):
        lhs = np.stack([from_pairs(d) for d in left], axis=1)
        rhs = np.stack([from_pairs(d) for d in right], axis=1)
        out = np.array([self.ref.compress([int(v) for v in a], [int(v) for v in b])
                        for a, b in zip(lhs, rhs)], dtype=np.uint64)
        return [to_pairs(out[:, k]) for k in range(4)]


@functools.lru_cache(maxsize=None)
def proven():
    """The port's proof of column 0 of a kernel-order extension, reordered
    to bitrev (the card's path), with its plan and codeword."""
    pk = stark.LdePlan(SMALL, Q, BLOWUP, order="kernel", device="cpu")
    pb = stark.LdePlan(SMALL, Q, BLOWUP, order="bitrev", device="cpu")
    word = pk.reorder(pk.extend(as_tensor(coefficients(1, seed=4))), pb)[0]
    proof = stark.FriProver(pb, final_size=FINAL, num_queries=QUERIES).prove(word)
    return pb, word, proof


def test_fri_proof_equals_jax():
    pb, word, proof = proven()
    jpb = jstark.LdePlan(SMALL, Q, BLOWUP, order="bitrev")
    jproof = jstark.FriProver(jpb, final_size=FINAL, num_queries=QUERIES,
                              hasher=RefHasher()).prove(int64_to_pairs(word))
    assert proof == jproof
    assert jstark.fri_verify(jpb, proof, final_size=FINAL, num_queries=QUERIES)


def test_fri_verify_accepts_the_proof():
    pb, _, proof = proven()
    assert stark.fri_verify(pb, proof, final_size=FINAL, num_queries=QUERIES)
    assert len(proof["roots"]) == 4 and proof["n0"] == 256
    assert len(proof["final"]) == FINAL and len(proof["queries"]) == QUERIES


@pytest.mark.parametrize("tamper", ["root", "pair", "path", "final", "queries",
                                    "final_size"])
def test_fri_verify_rejects_a_tampered_proof(tamper):
    pb, _, proof = proven()
    bad = {k: v for k, v in proof.items()}
    queries = [[dict(layer) for layer in chain] for chain in proof["queries"]]
    bad["queries"] = queries
    if tamper == "root":
        bad["roots"] = [list(r) for r in proof["roots"]]
        bad["roots"][1][0] = (bad["roots"][1][0] + 1) % Q
    elif tamper == "pair":
        a, b = queries[2][1]["pair"]
        queries[2][1]["pair"] = (a, (b + 1) % Q)
    elif tamper == "path":
        path = [list(d) for d in queries[0][0]["path"]]
        path[3][1] = (path[3][1] + 1) % Q
        queries[0][0]["path"] = path
    elif tamper == "final":
        bad["final"] = list(proof["final"])
        bad["final"][5] = (bad["final"][5] + 1) % Q
    elif tamper == "queries":
        bad["queries"] = queries[:-1]
    assert not stark.fri_verify(pb, bad, final_size=FINAL // 2 if tamper == "final_size"
                                else FINAL, num_queries=QUERIES)


def test_cpu_path_launches_nothing():
    before = (dict(gl64.GoldilocksPlan64.launches), dict(poseidon.launches))
    pk = stark.LdePlan(SMALL, Q, BLOWUP, order="kernel", device="cpu")
    pk.extend(as_tensor(coefficients(1, seed=5)))
    proven()
    assert (gl64.GoldilocksPlan64.launches, poseidon.launches) == before


@pytest.mark.cuda
def test_cuda_path_matches_plain_and_verifies():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    dev = torch.device("cuda", torch.cuda.current_device())
    pk = stark.LdePlan(SMALL, Q, BLOWUP, order="kernel", device=dev)
    pb = stark.LdePlan(SMALL, Q, BLOWUP, order="bitrev", device=dev)
    x = as_tensor(coefficients(3, seed=6)).to(dev)
    word = pk.reorder(pk.extend(x), pb)
    assert torch.equal(word, pb.extend(x))
    proof = stark.FriProver(pb, final_size=FINAL, num_queries=QUERIES).prove(word[0])
    plain = stark.FriProver(stark.LdePlan(SMALL, Q, BLOWUP, device="cpu"),
                            final_size=FINAL, num_queries=QUERIES).prove(word[0].cpu())
    assert proof == plain
    assert stark.fri_verify(pb, proof, final_size=FINAL, num_queries=QUERIES)

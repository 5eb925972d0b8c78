"""Goldilocks above n = 8192: every op on the four-step, and the STARK LDE there.

``tpu_ntt_torch.dispatch.best(p, op)`` at q = 2^64 - 2^32 + 1 and
8192 < n <= 2^20 is ``kernels.fourstep64.FourStepPlan64`` on Goldilocks
sub-plans; on CPU tensors it runs its plain chain.  Each op at n = 16384 is
held to what it must equal: ``tpu_ntt.native.nwc_fast`` (the reference
package's independent C++ O(n log n) oracle, valid at the Goldilocks q;
JAX's own paths at these sizes are Pallas kernels that take minutes in
interpret mode) for the products, dot and matvec on the same rows, its
inverse (round trips), and big-int Horner evaluation of the spectra; the
product at 65536 against ``nwc_fast`` (2^20 is a ``slow`` test).

``stark.LdePlan(order="kernel")`` at N = 16384 and 65536 rides the
four-step: reordered to the ``bitrev`` order it equals JAX's bitrev LDE,
computed by JAX's own XLA functions (its ``LdePlan`` scale table and ring,
then its XLA four-step locals, cheaper on the CPU than its ``LdePlan.extend``,
15 to 23 s a call at these N); it equals big-int Horner evaluation at coset
points; ``interpolate`` takes it back; and a small FRI proof over it, on the
plain Poseidon2 hasher, is accepted by ``fri_verify``.

Operands come from ``numpy.random.default_rng`` with rows of 0, 1, q - 1,
2^63 - 1, 2^63 and 2^64 - 2^32.  Tolerance: none — exact integer equality.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_ntt.params as jparams
import tpu_ntt.stark as jstark
from tpu_ntt import native
from tpu_ntt import sharded as jsharded
from tpu_ntt_torch import dispatch, kernels, stark
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels.fourstep64 import FourStepPlan64
from tpu_ntt_torch.kernels.gl64 import GoldilocksPlan64
from tpu_ntt_torch.modmath import GOLDILOCKS_Q as Q
from tpu_ntt_torch.params import make_params
from tpu_ntt_torch.poseidon import Poseidon2GL
from tpu_ntt_torch.reference import bit_reverse_permutation

P16 = make_params(16384, Q)
EDGES = [0, 1, Q - 1, (1 << 63) - 1, 1 << 63, (1 << 64) - (1 << 32)]


def residues(shape, seed: int) -> torch.Tensor:
    """Goldilocks residues as int64 bit patterns; the first rows are the
    boundary values cycled, all 2^63 and all q - 1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint64)
    rows = x.reshape(-1, shape[-1])
    edge = [np.resize(np.array(EDGES, np.uint64), shape[-1]),
            np.full(shape[-1], 1 << 63, np.uint64), np.full(shape[-1], Q - 1, np.uint64)]
    for r in range(min(3, rows.shape[0])):
        rows[r] = edge[(r + seed) % 3]
    return torch.from_numpy(x.view(np.int64))


def ints(x: torch.Tensor) -> list:
    return x.numpy().view(np.uint64).tolist()


def horner(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % Q
    return acc


def best(op: str):
    return dispatch.best(P16, op)


def oracle(a: torch.Tensor, b: torch.Tensor, psi: int = P16.psi) -> list:
    """a * b mod (x^n + 1, q) row by row, by ``native.nwc_fast``."""
    return [native.nwc_fast(x, y, Q, psi) for x, y in zip(ints(a), ints(b))]


def add_rows(u: list, v: list) -> list:
    return [(x + y) % Q for x, y in zip(u, v)]


def spectrum_at(spectra, row, coeffs, point, picks):
    """The natural-order spectrum of ``spectra[row]`` (the plan's layout map)
    holds coeffs evaluated at point(k) for each k in picks."""
    plan = kernels.plan_for(P16, "cpu")
    natural = plan.bitrev_to_natural(spectra)
    assert torch.equal(plan.natural_to_bitrev(natural), spectra)
    values = ints(natural[row])
    return all(values[k] == horner(coeffs, point(k)) for k in picks)


CHECKS = {}


def check(*ops):
    def register(fn):
        for op in ops:
            CHECKS[op] = fn
        return fn
    return register


@check("fwd", "inv")
def _cyclic_transforms(a, b):
    x = best("fwd")(a)
    assert spectrum_at(x, 1, ints(a[1]), lambda k: pow(P16.omega, k, Q), (0, 1, 77, P16.n - 1))
    assert torch.equal(best("inv")(x), a)


@check("nwc_fwd", "nwc_inv")
def _negacyclic_transforms(a, b):
    x = best("nwc_fwd")(a)
    assert spectrum_at(x, 0, ints(a[0]), lambda k: pow(P16.psi, 2 * k + 1, Q),
                       (0, 5, 1000, P16.n - 1))
    assert torch.equal(best("nwc_inv")(x), a)


@check("cyclic")
def _cyclic_product(a, b):
    c = ints(best("cyclic")(a, b))
    for k in (0, 3, 9000):
        x = pow(P16.omega, k, Q)
        assert horner(c[1], x) == horner(ints(a[1]), x) * horner(ints(b[1]), x) % Q


@check("nwc", "spectrum", "cached")
def _cached_product(a, b):
    s = best("spectrum")(b)
    assert torch.equal(s, best("nwc_fwd")(b))  # Goldilocks spectra are plain
    want = oracle(a, b)
    assert ints(best("cached")(a, s)) == want
    assert ints(best("nwc")(a, b)) == want


@check("dot", "dot_cached")
def _dot(a, b):
    a3, b3 = a.reshape(2, 1, -1), b.reshape(2, 1, -1)
    want = add_rows(*oracle(a, b))
    assert ints(best("dot")(a3, b3)[0]) == want
    s3 = best("spectrum")(b).reshape(b3.shape)
    assert ints(best("dot_cached")(a3, s3)[0]) == want


@check("matvec_spectra", "matvec")
def _matvec(a, b):
    A = torch.stack([b, b.flip(0)])  # (2, 2, n)
    spectra = best("matvec_spectra")(A)
    assert torch.equal(spectra, best("spectrum")(A.reshape(4, -1)).reshape(A.shape))
    out = best("matvec")(a.reshape(2, 1, -1), spectra)
    for i in range(2):
        assert ints(out[i, 0]) == add_rows(*oracle(A[i], a))  # A[i, j] * s[j], j = 0, 1


@pytest.mark.parametrize("op", dispatch.OPS)
def test_every_op_at_16384_holds_its_relation(op):
    """One relation for each op (its registered check), on CPU tensors
    through ``dispatch.best``; the four-step serves it; no kernel launches."""
    assert dispatch.impl_name(P16, op) == FourStepPlan64.name
    before = dict(GoldilocksPlan64.launches)
    a, b = residues((2, P16.n), 3), residues((2, P16.n), 4)
    CHECKS[op](a, b)
    assert GoldilocksPlan64.launches == before


def test_nwc_at_65536_matches_the_native_oracle():
    p = make_params(65536, Q)
    assert all(dispatch.impl_name(p, op) == FourStepPlan64.name for op in dispatch.OPS)
    plan = kernels.plan_for(p, "cpu")
    assert plan.launches is GoldilocksPlan64.launches
    assert dispatch.takes_pairs(p) is False
    a, b = residues((1, p.n), 1), residues((1, p.n), 2)
    got = dispatch.best_nwc_poly_mult(p)(a, b)
    assert got.dtype == torch.int64 and got.shape == (1, p.n)
    assert ints(got) == oracle(a, b, p.psi)


@pytest.mark.slow
def test_nwc_at_2_20_matches_the_native_oracle():
    p = make_params(1 << 20, Q)
    a, b = residues((1, p.n), 5), residues((1, p.n), 6)
    assert ints(dispatch.best_nwc_poly_mult(p)(a, b)) == oracle(a, b, p.psi)


def jax_bitrev_lde(x: torch.Tensor, n: int, blowup: int) -> torch.Tensor:
    """JAX's bitrev coset LDE of x's rows: its ``LdePlan``'s scale table on
    its ring, zero-padding, its XLA four-step locals' cyclic forward, read
    in natural order and laid out bit-reversed."""
    jp = jstark.LdePlan(n, Q, blowup, order="bitrev")
    N = jp.N
    hi, lo = int64_to_pairs(x)
    scaled = jp.ring.mul_tw((jax.numpy.asarray(hi), jax.numpy.asarray(lo)), jp.scale_tw)
    padded = tuple(jax.numpy.pad(w, ((0, 0), (0, N - n))) for w in scaled)
    n1 = jsharded.default_split(N)[0]
    jfs = jsharded.FourStepPlan(jparams.make_params(N, Q), n1, N // n1)
    out = jax.jit(lambda v: jsharded.fourstep_fwd_local(jfs, v))(
        tuple(w.reshape(-1, n1, N // n1) for w in padded))
    natural = pairs_to_int64(np.asarray(out[0]), np.asarray(out[1])).reshape(-1, N)
    natural = natural[:, np.argsort(jfs.spectrum_indices().reshape(-1))]
    return natural[:, bit_reverse_permutation(N)]


@pytest.mark.parametrize("n", [2048, 8192])
def test_kernel_order_lde_on_the_four_step(n):
    """At N = 8n = 16384 and 65536 the kernel order runs the four-step:
    reordered to bitrev it equals JAX's bitrev LDE and big-int Horner at
    coset points (4 slots a row), and ``interpolate`` returns the
    coefficients; no plan of N points is built."""
    pk = stark.LdePlan(n, Q, 8, order="kernel", device="cpu")
    pb = stark.LdePlan(n, Q, 8, order="bitrev", device="cpu")
    assert isinstance(pk._kernel, FourStepPlan64)
    x = residues((2, n), 7)
    ek = pk.extend(x)
    assert torch.equal(ek, pk.extend_plain(x))
    eb = pk.reorder(ek, pb)
    assert torch.equal(eb, jax_bitrev_lde(x, n, 8))
    idx, coeffs, values = pb.spectrum_indices(), ints(x), ints(eb)
    for row in range(2):
        for slot in (0, 1, 4097, pb.N - 1):
            point = pb.shift * pow(pb.p.omega, int(idx[slot]), Q) % Q
            assert values[row][slot] == horner(coeffs[row], point), (row, slot)
    back = pk.interpolate(ek)
    assert torch.equal(back[:, :n], x) and not back[:, n:].any()
    assert "big" not in vars(pk) and "big" not in vars(pb)


def test_fri_over_a_four_step_lde_verifies():
    """A degree-< 2048 column extended on the four-step (N = 16384),
    reordered to bitrev and proved by ``FriProver`` on the plain Poseidon2
    hasher (five layers down to 512 values: each Merkle level is a plain
    permutation of some 0.1 s on the CPU): ``fri_verify`` accepts the proof, and
    rejects it with one final value changed."""
    pk = stark.LdePlan(2048, Q, 8, order="kernel", device="cpu")
    pb = stark.LdePlan(2048, Q, 8, order="bitrev", device="cpu")
    evals = pk.reorder(pk.extend(residues((1, 2048), 8)), pb)[0]
    prover = stark.FriProver(pb, final_size=512, num_queries=3, hasher=Poseidon2GL())
    proof = prover.prove(evals)
    assert stark.fri_verify(pb, proof, final_size=512, num_queries=3)
    proof["final"][0] = (proof["final"][0] + 1) % Q
    assert not stark.fri_verify(pb, proof, final_size=512, num_queries=3)


@pytest.mark.cuda
def test_cuda_lde_and_ops_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    dev = torch.device("cuda", torch.cuda.current_device())
    pk = stark.LdePlan(8192, Q, 8, order="kernel", device=dev)
    x = residues((4, 8192), 9).to(dev)
    before = dict(GoldilocksPlan64.launches)
    assert torch.equal(pk.extend(x), pk.extend_plain(x))
    torch.cuda.synchronize()
    assert all(GoldilocksPlan64.launches[k] > before[k]
               for k in ("gl64_forward", "gl64_forward_scaled"))
    plan = FourStepPlan64(P16, dev)
    a, b = (residues((4, P16.n), s).to(dev) for s in (10, 11))
    for method in ("nwc_poly_mult", "cyclic_poly_mult"):
        assert torch.equal(getattr(plan, method)(a, b),
                           getattr(plan, method + "_plain")(a, b)), method

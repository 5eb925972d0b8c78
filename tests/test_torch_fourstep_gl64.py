"""The Goldilocks four-step of the port (kernel K2's large-n bodies) against tpu_ntt's.

* The row passes of ``kernels.gl64.GoldilocksSubPlan64`` (the ports of
  K1a's ``_cyclic_scaled_kernel`` and its halves, and of the cached split
  kernel, K1b and K1c at large n, at q = 2^64 - 2^32 + 1), plain on the
  CPU, against JAX's XLA functions with the same meaning: its
  ``GoldilocksRing.mul_tw`` by the table, ``tpu_ntt.ntt.cyclic_poly_mult``
  (or ``ntt_fwd``/``ntt_inv``), ``mul_tw`` by the exit table, at n2 = 256
  and 128 with periods 2 and 4; the cached product, the dot (fresh and
  cached) and the matvec against sums of those JAX products.
* ``sharded.KernelFourStep`` at the Goldilocks q, explicit small splits,
  against JAX's XLA ``sharded.FourStepPlan`` locals over its
  ``GoldilocksRing``, spectra through both layout maps.
* JAX's natural Goldilocks spectra at n = 16384 (the layout of its flat
  ``GoldilocksPlan64``) and 65536 (its kernel four-step) carried into the
  port's layout by ``convert`` with no domain change, equal to the port's.
* The arguments each row-pass wrapper hands ``csrc/gl64.cu``: one tensor
  where the C function takes a pointer, one int where it takes a number.

JAX's Pallas kernels are never run here (seconds to minutes a call in
interpret mode at these sizes).  Operands come from
``numpy.random.default_rng`` with rows of 0, 1, q - 1, 2^63 - 1, 2^63 and
2^64 - 2^32.  Tolerance: none — exact integer equality.
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch

import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
from tpu_ntt import sharded as jsharded
from tpu_ntt_torch import convert, dispatch, sharded
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels import _build
from tpu_ntt_torch.kernels.fourstep64 import FourStepPlan64
from tpu_ntt_torch.kernels.gl64 import KERNELS, GoldilocksPlan64, GoldilocksSubPlan64
from tpu_ntt_torch.modmath import GOLDILOCKS_Q as Q
from tpu_ntt_torch.params import make_params
from tpu_ntt_torch.reference import bit_reverse_permutation

EDGES = [0, 1, Q - 1, (1 << 63) - 1, 1 << 63, (1 << 64) - (1 << 32)]


def residues(shape, seed: int) -> torch.Tensor:
    """Goldilocks residues of (..., n) shape as int64 bit patterns; row 0
    cycles the boundary values, row 1 is all 2^63 (odd seeds) or all 0."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint64)
    rows = x.reshape(-1, shape[-1])
    rows[0] = np.roll(np.resize(np.array(EDGES, np.uint64), shape[-1]), seed)
    rows[1] = (1 << 63) if seed % 2 else 0
    return torch.from_numpy(x.view(np.int64))


def pairs(x: torch.Tensor):
    hi, lo = int64_to_pairs(x)
    return jax.numpy.asarray(hi), jax.numpy.asarray(lo)


def from_pairs(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def ints(x: torch.Tensor) -> list:
    return x.numpy().view(np.uint64).tolist()


@functools.lru_cache(maxsize=None)
def jax_plan(n: int):
    return jntt.NttPlan(jparams.make_params(n, Q))


def jax_scale(x: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Row r of the (B, n) x times row r % P of the (P, n) values, by JAX's
    GoldilocksRing.mul_tw on its (hi, lo) encoding."""
    period, n = values.shape
    ring = jax_plan(n).ring
    tw = tuple(leaf.reshape(period, n) for leaf in ring.encode_tw(ints(values.reshape(-1))))
    return from_pairs(ring.mul_tw(pairs(x.reshape(-1, period, n)), tw)).reshape(x.shape)


def tables(plan, *values):
    """(P, n) values as the sub-plan's scale tables: 1-tuples (w,)."""
    return [tuple(t.reshape(v.shape) for t in (plan.ring.encode_tw(ints(v.reshape(-1))),))
            for v in values]


@pytest.mark.parametrize("n,period", [(256, 2), (128, 4)])
def test_scaled_row_kernels_match_jax(n, period):
    """``cyclic_poly_mult_scaled`` = post . INTT(NTT(pre . a) o NTT(pre . b))
    and its halves, CPU tensors (the plain versions), against JAX's XLA
    ``ring.mul_tw`` and ``ntt`` functions; no kernel launches."""
    plan = GoldilocksSubPlan64(make_params(n, Q), "cpu")
    a, b = residues((2 * period, n), 1), residues((2 * period, n), 2)
    pre_v, post_v = residues((period, n), 3), residues((period, n), 4)
    pre, post = tables(plan, pre_v, post_v)
    before = dict(GoldilocksPlan64.launches)

    got = plan.cyclic_poly_mult_scaled(a, b, pre, post)
    jp = jax_plan(n)
    want = from_pairs(jntt.cyclic_poly_mult(jp, pairs(jax_scale(a, pre_v)),
                                            pairs(jax_scale(b, pre_v))))
    assert torch.equal(got, jax_scale(want, post_v))

    perm = torch.tensor(bit_reverse_permutation(n))
    spec = plan.ntt_fwd_scaled(a, pre)
    want_spec = from_pairs(jntt.ntt_fwd(jp, pairs(jax_scale(a, pre_v))))
    assert torch.equal(spec[:, perm], want_spec)
    assert torch.equal(plan.ntt_fwd_scaled(a, pre, cacheable=True), spec)  # plain domain
    inv = plan.ntt_inv_scaled(spec, post)
    want_inv = from_pairs(jntt.ntt_inv(jp, pairs(want_spec)))
    assert torch.equal(inv, jax_scale(want_inv, post_v))
    assert GoldilocksPlan64.launches == before


@pytest.mark.parametrize("n,period", [(256, 2), (128, 4)])
def test_cached_dot_and_matvec_row_passes_match_jax(n, period):
    """The row passes of the cached product, the dot and the matvec (plain
    on the CPU) against JAX's scaled products summed: one XLA call for the
    six products they are made of; no kernel launches."""
    plan = GoldilocksSubPlan64(make_params(n, Q), "cpu")
    rows = 2 * period
    s = residues((2, rows, n), 9)  # the dot's a and the matvec's s, K = l = 2
    b = residues((2, rows, n), 10)
    A = residues((2, 2, period, n), 11)  # k = l = 2, one period of rows each
    pre_v, post_v = residues((period, n), 12), residues((period, n), 13)
    pre, post = tables(plan, pre_v, post_v)
    before = dict(GoldilocksPlan64.launches)

    tiled = A.repeat(1, 1, rows // period, 1)  # row r of s meets A's row r % period
    x = torch.cat([s, s, s]).reshape(-1, n)
    y = torch.cat([b, tiled[0], tiled[1]]).reshape(-1, n)
    want = jax_scale(from_pairs(jntt.cyclic_poly_mult(
        jax_plan(n), pairs(jax_scale(x, pre_v)), pairs(jax_scale(y, pre_v)))), post_v)
    prod = [ints(t) for t in want.reshape(6, rows, n)]  # s_k * b_k, s_j * A_0j, s_j * A_1j

    def total(i, j):
        return [[(u + v) % Q for u, v in zip(ru, rv)] for ru, rv in zip(prod[i], prod[j])]

    cached = plan.ntt_fwd_scaled(b.reshape(-1, n), pre, cacheable=True).reshape(b.shape)
    assert ints(plan.cyclic_poly_mult_cached_scaled(s[0], cached[0], pre, post)) == prod[0]
    assert ints(plan.dot_scaled(s, b, pre, post)) == total(0, 1)
    assert ints(plan.dot_scaled(s, cached, pre, post, cached=True)) == total(0, 1)
    spectra = plan.ntt_fwd_scaled(s.reshape(-1, n), pre).reshape(s.shape)
    mat = plan.ntt_fwd_scaled(A.reshape(-1, n), pre, cacheable=True).reshape(A.shape)
    got = plan.matvec_scaled(spectra, mat, post)
    assert [ints(got[0]), ints(got[1])] == [total(2, 3), total(4, 5)]
    assert GoldilocksPlan64.launches == before


def test_scaled_row_kernels_refuse_bad_tables():
    plan = GoldilocksSubPlan64(make_params(128, Q), "cpu")
    a = residues((6, 128), 5)
    (tw,) = tables(plan, residues((4, 128), 6))
    with pytest.raises(ValueError, match="whole periods"):
        plan.cyclic_poly_mult_scaled(a, a, tw, tw)
    with pytest.raises(ValueError, match="differ in rows"):
        plan.dot_scaled(a[None, :4], a[None, :4], tw, (tw[0][:2],))
    with pytest.raises(TypeError):
        plan.ntt_inv_scaled(a[:4], (tw[0].to(torch.int32),))
    with pytest.raises(ValueError, match="do not match"):
        plan.matvec_scaled(a[None, :4], a[:4].reshape(1, 1, 4, 128)[:, :, :2], tw)
    with pytest.raises(ValueError, match="GoldilocksSubPlan64 covers"):
        GoldilocksSubPlan64(make_params(16, Q), "cpu")  # below 32 points
    with pytest.raises(ValueError, match="GoldilocksSubPlan64 covers"):
        GoldilocksSubPlan64(make_params(128, 576460752308273153), "cpu")


@pytest.mark.parametrize("n1,n2", [(32, 32), (64, 32)])
def test_kernel_fourstep_matches_jax_locals(n1, n2):
    """The port's KernelFourStep at the Goldilocks q (plain on the CPU)
    against JAX's XLA FourStepPlan locals over its GoldilocksRing at an
    explicit split: the negacyclic product, at 32 x 32 the spectrum through
    both layout maps, and the round trips."""
    p = make_params(n1 * n2, Q)
    fs = sharded.KernelFourStep(p, n1, n2, "cpu")
    assert isinstance(fs.row_k, GoldilocksSubPlan64) and len(fs.kmid_nwc) == 1
    jfs = jsharded.FourStepPlan(jparams.make_params(p.n, Q), n1, n2)
    a, b = residues((2, p.n), 6), residues((2, p.n), 7)
    mat = lambda x: tuple(t.reshape(2, n1, n2) for t in pairs(x))  # noqa: E731
    flat = lambda out: from_pairs(out).reshape(2, p.n)  # noqa: E731

    got = sharded.fourstep_nwc_poly_mult_kernel(fs, a, b)
    want = flat(jax.jit(lambda u, v: jsharded.fourstep_nwc_poly_mult_local(jfs, u, v))(
        mat(a), mat(b)))
    assert torch.equal(got, want)

    port_to_natural = np.argsort(fs.spectrum_indices().reshape(-1))
    assert (port_to_natural == bit_reverse_permutation(p.n)).all()
    nwc = sharded.fourstep_fwd_kernel(fs, a, nwc=True)
    if n1 == n2:  # the spectrum at one split: each jit compiles for 4 s
        jax_to_natural = np.argsort(jfs.spectrum_indices().reshape(-1))
        twisted = jax.jit(lambda v: jsharded.fourstep_fwd_local(
            jfs, jfs.ring.mul_tw(v, jfs.twist_tw)))(mat(a))
        assert torch.equal(nwc[:, port_to_natural], flat(twisted)[:, jax_to_natural])
    assert torch.equal(sharded.fourstep_inv_kernel(fs, nwc, nwc=True), a)
    cyclic = sharded.fourstep_fwd_kernel(fs, b)
    assert torch.equal(sharded.fourstep_inv_kernel(fs, cyclic), b)


def jax_natural_spectrum(x: torch.Tensor, n1: int) -> torch.Tensor:
    """JAX's natural-order negacyclic spectrum of x's rows, by its XLA
    four-step locals over GoldilocksRing (twist, forward,
    ``spectrum_indices``)."""
    n = x.shape[-1]
    jfs = jsharded.FourStepPlan(jparams.make_params(n, Q), n1, n // n1)
    fwd = jax.jit(lambda v: jsharded.fourstep_fwd_local(jfs, jfs.ring.mul_tw(v, jfs.twist_tw)))
    out = from_pairs(fwd(tuple(t.reshape(-1, n1, n // n1) for t in pairs(x))))
    return out.reshape(x.shape)[:, np.argsort(jfs.spectrum_indices().reshape(-1))]


@pytest.mark.parametrize("n", [16384, 65536])
def test_jax_spectra_through_convert_equal_the_ports(n):
    """JAX's natural Goldilocks spectrum laid out as JAX's plan at n lays
    it out (the flat ``GoldilocksPlan64``'s split layout at 16384, the
    kernel four-step's at 65536), carried over by
    ``convert.large_spectra64_from_jax`` with no domain change (both
    packages' Goldilocks spectra are plain), equals the port's
    ``nwc_ntt_fwd`` and ``nwc_spectrum``."""
    p = make_params(n, Q)
    assert dispatch.impl_name(p, "spectrum") == FourStepPlan64.name
    x = residues((2, n), 8)
    natural = jax_natural_spectrum(x, sharded.default_split(n)[0])
    layout = (convert.split_to_natural_perm(n) if n <= 32768
              else convert.kernel_fourstep_to_natural_perm(n))
    hi, lo = int64_to_pairs(natural[:, np.argsort(layout)].contiguous())
    got = convert.large_spectra64_from_jax(hi, lo, layout)
    assert torch.equal(got, dispatch.best(p, "nwc_fwd")(x))
    assert torch.equal(got, dispatch.best(p, "spectrum")(x))


def test_row_pass_wrappers_hand_gl64_cu_its_c_signatures(monkeypatch):
    """Each of the six row-pass wrappers, made to take its launch path,
    passes ``csrc/gl64.cu``'s entry point a tensor for every pointer and a
    Python int for every number, in the count the C function declares
    (the stream last, added by the launcher)."""
    source = (_build.CSRC / "gl64.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (gl64_\w+)\(([^)]*)\)', source))
    assert sorted(decls) == sorted(KERNELS)
    calls = {}
    plan = GoldilocksSubPlan64(make_params(128, Q), "cpu")
    monkeypatch.setattr(plan, "_runs_plain", lambda x: False)
    monkeypatch.setattr(plan, "_launch", lambda entry, out, *args: calls.update(
        {f"gl64_{entry}": args}) or out)
    a = residues((4, 128), 14)
    (tw,) = tables(plan, residues((2, 128), 15))
    plan.cyclic_poly_mult_scaled(a, a, tw, tw)
    plan.cyclic_poly_mult_cached_scaled(a, a, tw, tw)
    plan.ntt_fwd_scaled(a, tw)
    plan.ntt_inv_scaled(a, tw)
    plan.dot_scaled(a[None], a[None], tw, tw)
    plan.matvec_scaled(a[None], a[:2].reshape(1, 1, 2, 128), tw)
    # the column entry points are the column pass (test_torch_gl64_radix.py)
    assert sorted(calls) == sorted(k for k in KERNELS[6:] if not k.endswith("_cols"))
    for name, args in calls.items():
        params = [q.strip() for q in decls[name].split(",")]
        assert params[-1] == "void* stream", name
        assert len(args) == len(params) - 1, name
        for param, arg in zip(params, args):
            assert isinstance(arg, torch.Tensor) == ("*" in param), (name, param)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_row_kernels_and_fourstep_match_plain(cuda_device):
    p = make_params(16384, Q)
    plan = FourStepPlan64(p, cuda_device)
    rk, pre, post = plan.fs.row_k, plan.fs.kmid_nwc, plan.fs.kmid_inv_nwc
    a, b = (residues((4, p.n), s).to(cuda_device) for s in (16, 17))
    ma, mb = (plan.fs.as_rows(t) for t in (a, b))
    spec = rk.ntt_fwd_scaled(mb, pre, True)
    for method, args in (("cyclic_poly_mult_scaled", (ma, mb, pre, post)),
                         ("cyclic_poly_mult_cached_scaled", (ma, spec, pre, post)),
                         ("ntt_fwd_scaled", (ma, pre)), ("ntt_inv_scaled", (ma, post)),
                         ("dot_scaled", (ma.reshape(2, -1, 128), mb.reshape(2, -1, 128),
                                         pre, post)),
                         ("matvec_scaled", (ma.reshape(2, -1, 128),
                                            spec[:256].reshape(1, 2, 128, 128), post))):
        assert torch.equal(getattr(rk, method)(*args),
                           getattr(rk, method + "_plain")(*args)), method
    a3, b3 = a.reshape(2, 2, -1), b.reshape(2, 2, -1)
    for method, args in (("nwc_poly_mult", (a, b)), ("ntt_fwd", (a,)),
                         ("nwc_ntt_inv", (a,)),
                         ("nwc_poly_mult_cached", (a, plan.nwc_spectrum(b))),
                         ("nwc_dot", (a3, b3)),
                         ("nwc_matvec_cached", (a3, plan.nwc_matvec_spectra(b3)))):
        assert torch.equal(getattr(plan, method)(*args),
                           getattr(plan, method + "_plain")(*args)), method

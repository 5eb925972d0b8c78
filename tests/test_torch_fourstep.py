"""The four-step of the port (kernel K1a's large-n bodies) against tpu_ntt's.

* The scaled row product of ``kernels.mxu64.SubPlan64`` (the port of K1a's
  ``_cyclic_scaled_kernel``) and its halves, plain on the CPU, against
  JAX's XLA functions with the same meaning: ``ring.mul_tw(pre)``,
  ``tpu_ntt.ntt.cyclic_poly_mult`` (or ``ntt_fwd``/``ntt_inv``),
  ``ring.mul_tw(post)``, at n2 = 256 and 128 with periods 2 and 4; the row
  passes of the cached product, the dot (fresh and cached) and the matvec
  against sums of those JAX products.
* ``sharded.KernelFourStep`` at explicit small splits against JAX's XLA
  ``sharded.FourStepPlan`` locals (``fourstep_nwc_poly_mult_local``,
  ``fourstep_fwd_local``), spectra through both layout maps.
* ``convert``'s maps of JAX's large-n layouts against JAX's own code (the
  kernel four-step's ``spectrum_indices``, the flat plan's
  ``nwc_fourstep_to_natural_perm``), and JAX's natural spectrum at n = 16384
  and 65536 carried into the port's layout equal to the port's spectra.
* ``csrc/nwc64.cu``'s C signatures of the six row-pass entry points.

JAX's Pallas kernels are never run here at these sizes (minutes in
interpret mode).  Operands come from ``numpy.random.default_rng`` with rows
of 0, 1 and q - 1.  Tolerance: none — exact integer equality.
"""

import functools
import re
import types

import jax
import numpy as np
import pytest
import torch

import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
from tpu_ntt import sharded as jsharded
from tpu_ntt.kernels.mxu64 import MxuPlan64 as JaxMxuPlan64
from tpu_ntt_torch import convert, dispatch, sharded
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels import _build
from tpu_ntt_torch.kernels import mxu64 as kmxu64
from tpu_ntt_torch.kernels.mxu64 import MxuPlan64, SubPlan64
from tpu_ntt_torch.params import make_params
from tpu_ntt_torch.reference import bit_reverse_permutation

Q = 576460752308273153  # bench.py:35, 60 bits, 2-adicity 17
R = (1 << 64) % Q  # the port's cached-spectrum domain


def residues(shape, seed: int) -> torch.Tensor:
    """Residues of (..., n) shape; row 0 cycles 0, 1, q - 1, row 1 is all
    q - 1 (odd seeds) or all 0."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.int64)
    rows = x.reshape(-1, shape[-1])
    rows[0] = np.roll(np.resize(np.array([0, 1, Q - 1], np.int64), shape[-1]), seed)
    rows[1] = Q - 1 if seed % 2 else 0
    return torch.from_numpy(x)


def pairs(x: torch.Tensor):
    hi, lo = int64_to_pairs(x)
    return jax.numpy.asarray(hi), jax.numpy.asarray(lo)


def from_pairs(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


@functools.lru_cache(maxsize=None)
def jax_plan(n: int):
    return jntt.NttPlan(jparams.make_params(n, Q))


def jax_scale(x: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Row r of the (B, n) x times row r % P of the (P, n) values, by JAX's
    Ring64.mul_tw on its Shoup encoding."""
    period, n = values.shape
    ring = jax_plan(n).ring
    w, ws = ring.encode_tw([int(v) for v in values.reshape(-1)])
    tw = tuple(tuple(leaf.reshape(period, n) for leaf in half) for half in (w, ws))
    xs = pairs(x.reshape(-1, period, n))
    return from_pairs(ring.mul_tw(xs, tw)).reshape(x.shape)


@pytest.mark.parametrize("n,period", [(256, 2), (128, 4)])
def test_scaled_row_kernels_match_jax(n, period):
    """``cyclic_poly_mult_scaled`` = post . INTT(NTT(pre . a) o NTT(pre . b))
    and its halves, CPU tensors (the plain versions), against JAX's XLA
    ``ring.mul_tw`` and ``ntt`` functions; no kernel launches."""
    plan = SubPlan64(make_params(n, Q), "cpu")
    a, b = residues((2 * period, n), 1), residues((2 * period, n), 2)
    pre_v, post_v = residues((period, n), 3), residues((period, n), 4)
    pre, post = (plan.ring.encode_tw(v.reshape(-1).tolist())
                 for v in (pre_v, post_v))
    pre, post = (tuple(t.reshape(period, n) for t in tw) for tw in (pre, post))
    before = dict(MxuPlan64.launches)

    got = plan.cyclic_poly_mult_scaled(a, b, pre, post)
    jp = jax_plan(n)
    want = from_pairs(jntt.cyclic_poly_mult(jp, pairs(jax_scale(a, pre_v)),
                                            pairs(jax_scale(b, pre_v))))
    assert torch.equal(got, jax_scale(want, post_v))

    perm = torch.tensor(bit_reverse_permutation(n))
    spec = plan.ntt_fwd_scaled(a, pre)
    want_spec = from_pairs(jntt.ntt_fwd(jp, pairs(jax_scale(a, pre_v))))
    assert torch.equal(spec[:, perm], want_spec)
    times_r = plan.ntt_fwd_scaled(a, pre, cacheable=True)
    assert times_r[2].tolist() == [v * R % Q for v in want_spec[2, perm].tolist()]
    inv = plan.ntt_inv_scaled(spec, post)
    want_inv = from_pairs(jntt.ntt_inv(jp, pairs(want_spec)))
    assert torch.equal(inv, jax_scale(want_inv, post_v))
    assert MxuPlan64.launches == before


@pytest.mark.parametrize("n,period", [(256, 2), (128, 4)])
def test_cached_dot_and_matvec_row_passes_match_jax(n, period):
    """The row passes of the cached product, the dot and the matvec (plain
    on the CPU) against JAX's scaled products summed: one XLA call for the
    six products they are made of; no kernel launches."""
    plan = SubPlan64(make_params(n, Q), "cpu")
    rows = 2 * period
    s = residues((2, rows, n), 9)  # the dot's a and the matvec's s, K = l = 2
    b = residues((2, rows, n), 10)
    A = residues((2, 2, period, n), 11)  # k = l = 2, one period of rows each
    pre_v, post_v = residues((period, n), 12), residues((period, n), 13)
    pre, post = (tuple(t.reshape(period, n) for t in plan.ring.encode_tw(
        v.reshape(-1).tolist())) for v in (pre_v, post_v))
    before = dict(MxuPlan64.launches)

    tiled = A.repeat(1, 1, rows // period, 1)  # row r of s meets A's row r % period
    x = torch.cat([s, s, s]).reshape(-1, n)
    y = torch.cat([b, tiled[0], tiled[1]]).reshape(-1, n)
    want = jax_scale(from_pairs(jntt.cyclic_poly_mult(
        jax_plan(n), pairs(jax_scale(x, pre_v)), pairs(jax_scale(y, pre_v)))), post_v)
    prod = want.reshape(6, rows, n)  # s_k * b_k, then s_j * A_0j, s_j * A_1j

    cached = plan.ntt_fwd_scaled(b.reshape(-1, n), pre, cacheable=True).reshape(b.shape)
    assert torch.equal(plan.cyclic_poly_mult_cached_scaled(s[0], cached[0], pre, post),
                       prod[0])
    dot = (prod[0] + prod[1]) % Q
    assert torch.equal(plan.dot_scaled(s, b, pre, post), dot)
    assert torch.equal(plan.dot_scaled(s, cached, pre, post, cached=True), dot)
    spectra = plan.ntt_fwd_scaled(s.reshape(-1, n), pre).reshape(s.shape)
    mat = plan.ntt_fwd_scaled(A.reshape(-1, n), pre, cacheable=True).reshape(A.shape)
    got = plan.matvec_scaled(spectra, mat, post)
    assert torch.equal(got, torch.stack([(prod[2] + prod[3]) % Q, (prod[4] + prod[5]) % Q]))
    assert MxuPlan64.launches == before


def test_scaled_row_kernels_refuse_bad_tables():
    plan = SubPlan64(make_params(128, Q), "cpu")
    a = residues((6, 128), 5)
    tw = tuple(t.reshape(4, 128) for t in plan.ring.encode_tw(list(range(512))))
    with pytest.raises(ValueError, match="whole periods"):
        plan.cyclic_poly_mult_scaled(a, a, tw, tw)
    with pytest.raises(ValueError, match="differ in rows"):
        plan.ntt_fwd_scaled(a[:4], (tw[0], tw[1][:2]))
    with pytest.raises(TypeError):
        plan.ntt_inv_scaled(a[:4], tuple(t.to(torch.int32) for t in tw))
    with pytest.raises(ValueError, match="whole periods"):
        plan.dot_scaled(a[None], a[None], tw, tw)
    with pytest.raises(ValueError, match="do not match"):
        plan.matvec_scaled(a[None, :4], a[:4].reshape(1, 1, 4, 128)[:, :, :2], tw)
    with pytest.raises(ValueError):
        SubPlan64(make_params(16, 7681), "cpu")  # below 32 points, 13 bits


@pytest.mark.parametrize("n1,n2", [(32, 32), (64, 32)])
def test_kernel_fourstep_matches_jax_locals(n1, n2):
    """The port's KernelFourStep (plain on the CPU) against JAX's XLA
    FourStepPlan locals at an explicit split: the negacyclic product, the
    negacyclic spectrum (and at 32 x 32 the cyclic one) through both
    layout maps, and the round trips."""
    p = make_params(n1 * n2, Q)
    fs = sharded.KernelFourStep(p, n1, n2, "cpu")
    jfs = jsharded.FourStepPlan(jparams.make_params(p.n, Q), n1, n2)
    a, b = residues((2, p.n), 6), residues((2, p.n), 7)
    mat = lambda x: tuple(t.reshape(2, n1, n2) for t in pairs(x))  # noqa: E731
    flat = lambda out: from_pairs(out).reshape(2, p.n)  # noqa: E731

    got = sharded.fourstep_nwc_poly_mult_kernel(fs, a, b)
    want = flat(jax.jit(lambda u, v: jsharded.fourstep_nwc_poly_mult_local(jfs, u, v))(
        mat(a), mat(b)))
    assert torch.equal(got, want)

    jax_to_natural = np.argsort(jfs.spectrum_indices().reshape(-1))
    port_to_natural = np.argsort(fs.spectrum_indices().reshape(-1))
    assert (port_to_natural == bit_reverse_permutation(p.n)).all()
    if n1 == n2:  # the cyclic spectrum at one split: each jit compiles for 4 s
        fwd = jax.jit(lambda v: jsharded.fourstep_fwd_local(jfs, v))
        cyclic = sharded.fourstep_fwd_kernel(fs, a)
        assert torch.equal(cyclic[:, port_to_natural],
                           flat(fwd(mat(a)))[:, jax_to_natural])
        assert torch.equal(sharded.fourstep_inv_kernel(fs, cyclic), a)
    twisted = jax.jit(lambda v: jsharded.fourstep_fwd_local(
        jfs, jfs.ring.mul_tw(v, jfs.twist_tw)))(mat(a))
    nwc = sharded.fourstep_fwd_kernel(fs, a, nwc=True)
    assert torch.equal(nwc[:, port_to_natural], flat(twisted)[:, jax_to_natural])
    assert torch.equal(sharded.fourstep_inv_kernel(fs, nwc, nwc=True), a)


def test_default_split_is_jax_and_plans_refuse_what_they_cannot_run():
    for n in (1 << k for k in range(10, 22)):
        assert sharded.default_split(n) == jsharded.default_split(n)
    p = make_params(1 << 12, Q)
    assert not sharded.KernelFourStep.supported(p, 256, 16)  # 16 < 32 points
    with pytest.raises(ValueError):
        sharded.KernelFourStep(p, 256, 16, "cpu")
    with pytest.raises(ValueError):
        sharded.FourStepPlan(p, 64, 32, "cpu")  # 64 * 32 != 4096


def split_stub(n: int):
    """A stand-in for JAX's flat MxuPlan64 at n carrying what its layout
    methods read, so that JAX's own ``nwc_fourstep_to_natural_perm`` runs
    without building the plan (9 to 18 s at 32768 and 65536); the depth is
    the one JAX's plan reports there, log2(n) - 14 from 32768 on."""
    stub = types.SimpleNamespace(n1=n // 128, p=types.SimpleNamespace(n=n))
    stub._split_depth = lambda: max(n.bit_length() - 15, 0)
    stub._split_row_perm = lambda: JaxMxuPlan64._split_row_perm(stub)
    stub.fourstep_to_natural_perm = lambda: JaxMxuPlan64.fourstep_to_natural_perm(stub)
    return stub


def test_layout_maps_are_jax_own():
    for n in (1 << k for k in range(14, 20)):
        want = JaxMxuPlan64.nwc_fourstep_to_natural_perm(split_stub(n))
        assert (convert.split_to_natural_perm(n) == want).all(), n
    p = jparams.make_params(65536, Q)
    idx = jsharded.KernelFourStep(p, *jsharded.default_split(p.n)).spectrum_indices()
    assert (convert.kernel_fourstep_to_natural_perm(p.n)
            == np.argsort(idx.reshape(-1))).all()
    assert (convert.split_to_natural_perm(16384)
            == convert.fourstep_to_bitrev_perm(16384)[bit_reverse_permutation(16384)]).all()


def jax_natural_spectrum(x: torch.Tensor, n1: int) -> torch.Tensor:
    """JAX's natural-order negacyclic spectrum of x's rows, by its XLA
    four-step locals (twist, forward, ``spectrum_indices``)."""
    n = x.shape[-1]
    jfs = jsharded.FourStepPlan(jparams.make_params(n, Q), n1, n // n1)
    fwd = jax.jit(lambda v: jsharded.fourstep_fwd_local(jfs, jfs.ring.mul_tw(v, jfs.twist_tw)))
    out = from_pairs(fwd(tuple(t.reshape(-1, n1, n // n1) for t in pairs(x))))
    return out.reshape(x.shape)[:, np.argsort(jfs.spectrum_indices().reshape(-1))]


@pytest.mark.parametrize("n", [16384, 65536])
def test_jax_spectra_through_convert_equal_the_ports(n):
    """JAX's natural spectrum laid out as each of JAX's plans lays it out at
    n, carried over by ``convert``, equals the port's: ``nwc_ntt_fwd`` from
    the flat plan's layout (plain at every n); ``nwc_spectrum`` from the flat
    plan's Montgomery-64 spectra at 16384 (a permutation only) and from the
    kernel four-step's plain ones at 65536 (times 2^64 mod q)."""
    p = make_params(n, Q)
    x = residues((2, n), 8)
    natural = jax_natural_spectrum(x, sharded.default_split(n)[0])

    def jax_layout(values, to_natural):
        return int64_to_pairs(values[:, np.argsort(to_natural)].contiguous())

    split = convert.split_to_natural_perm(n)
    got = convert.large_spectra64_from_jax(*jax_layout(natural, split), split)
    assert torch.equal(got, dispatch.best(p, "nwc_fwd")(x))
    if n == 16384:
        mont = torch.tensor([[v * R % Q for v in row] for row in natural.tolist()])
        got = convert.spectra64_from_jax(*jax_layout(mont, split))
    else:
        layout = convert.kernel_fourstep_to_natural_perm(n)
        got = convert.large_spectra64_from_jax(*jax_layout(natural, layout), layout, q=Q)
    assert torch.equal(got, dispatch.best(p, "spectrum")(x))


C_TYPES = {"int": kmxu64.ctypes.c_int, "uint64_t": kmxu64.ctypes.c_uint64}


def test_load_scaled_binds_the_c_signatures_of_nwc64_cu(monkeypatch):
    """The six entry points ``load_scaled`` types have the C names,
    argument counts and types of ``csrc/nwc64.cu``'s functions."""
    bound = {}
    monkeypatch.setattr(kmxu64, "load", lambda name, bits: None)
    monkeypatch.setattr(kmxu64, "bind", lambda name, argtypes: bound.update(argtypes))
    kmxu64.load_scaled.__wrapped__()
    source = (_build.CSRC / "nwc64.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (nwc64_\w+)\(([^)]*)\)', source))
    assert sorted(decls) == sorted(kmxu64.KERNELS)
    assert sorted(f"nwc64_{k}" for k in bound) == sorted(kmxu64.KERNELS[6:])
    for suffix, types_ in bound.items():
        params = [q.strip() for q in decls[f"nwc64_{suffix}"].split(",")]
        assert len(params) == len(types_), suffix
        for param, ty in zip(params, types_):
            want = (kmxu64.ctypes.c_void_p if "*" in param
                    else C_TYPES[param.rsplit(" ", 1)[0]])
            assert ty is want, (suffix, param)

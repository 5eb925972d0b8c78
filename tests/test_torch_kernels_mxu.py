"""The port's 24-bit kernel module against tpu_ntt's (kernel K3).

On the CPU every ``tpu_ntt_torch.kernels.mxu.MxuPlan`` method runs its plain
version; each must equal ``tpu_ntt.kernels.mxu.MxuPlan`` in Pallas interpret
mode at DILITHIUM_256 and FALCON_512 (the 14-bit corner), on 2 and t + 1
rows, t being the TPU plan's polynomials per MXU group.  Spectra are compared
in natural order through both packages' layout maps, and JAX's cached
spectra and matvec blocks, carried over by ``convert``, must give JAX's
products.  P24_4096 and n = 16384 are held against the JAX merged (XLA)
path.  The CUDA kernels are compared with the plain versions only where a
CUDA device is present (marker ``cuda``); on the card that check is
``chip_smoke.py``.  Operands come from ``numpy.random.default_rng`` with
rows of 0, 1 and q - 1.  Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

import tpu_ntt.kernels as jkernels
import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
from tpu_ntt.kernels.mxu import MxuPlan as JaxMxuPlan
from tpu_ntt_torch import kernels
from tpu_ntt_torch.convert import (int32_to_uint32, matvec_spectra_from_jax,
                                   spectra_from_jax, uint32_to_int32)
from tpu_ntt_torch.kernels.mxu import KERNELS, MxuPlan
from tpu_ntt_torch.params import DILITHIUM_256, FALCON_512, P24_4096, make_params

PAIRS = [(DILITHIUM_256, jparams.DILITHIUM_256), (FALCON_512, jparams.FALCON_512)]


def operands(p, shape, seed: int) -> np.ndarray:
    """Residues of the given shape, (..., B, n); the first rows are all 0,
    all 1, all q - 1 and [0, 1, q - 1] cycled."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, p.q, size=shape, dtype=np.uint32)
    edge = np.stack([np.zeros(p.n), np.ones(p.n), np.full(p.n, p.q - 1),
                     np.resize([0, 1, p.q - 1], p.n)]).astype(np.uint32)
    rows = x.reshape(-1, p.n)
    k = min(4, rows.shape[0])
    rows[:k] = edge[:k] if seed % 2 else edge[:k][::-1]
    return x


def plans(tp, jp):
    jm = JaxMxuPlan(jp)
    jm.groups_per_step = 1  # keep interpret-mode cost down
    return MxuPlan(tp, "cpu"), jm


def same(got: torch.Tensor, want) -> bool:
    return np.array_equal(int32_to_uint32(got), np.asarray(want))


def natural_jax(jm, x):
    return np.asarray(x)[..., jm.fourstep_to_natural_perm()]


@pytest.mark.parametrize("op", ["nwc", "cyclic"])
def test_products_match_jax_interpret(op):
    for tp, jp in PAIRS:
        tm, jm = plans(tp, jp)
        for batch in (2, jm.t + 1):
            a = operands(tp, (batch, tp.n), seed=1)
            b = operands(tp, (batch, tp.n), seed=2)
            method = {"nwc": "nwc_poly_mult", "cyclic": "cyclic_poly_mult"}[op]
            want = getattr(jm, method)(a, b, interpret=True)
            got = getattr(tm, method)(uint32_to_int32(a), uint32_to_int32(b))
            assert same(got, want), (tp.name, batch)


@pytest.mark.parametrize("kind", ["cyclic", "nwc"])
def test_transforms_match_jax_through_layout_maps(kind):
    fwd, inv = {"cyclic": ("ntt_fwd", "ntt_inv"),
                "nwc": ("nwc_ntt_fwd", "nwc_ntt_inv")}[kind]
    for tp, jp in PAIRS:
        tm, jm = plans(tp, jp)
        x = operands(tp, (jm.t + 1, tp.n), seed=3)
        jspec = getattr(jm, fwd)(x, interpret=True)
        spec = getattr(tm, fwd)(uint32_to_int32(x))
        assert np.array_equal(int32_to_uint32(tm.bitrev_to_natural(spec)),
                              natural_jax(jm, jspec)), tp.name
        # an arbitrary spectrum, in natural order, through both inverses
        nat = operands(tp, (2, tp.n), seed=4)
        jin = nat[:, np.argsort(jm.fourstep_to_natural_perm())]
        got = getattr(tm, inv)(tm.natural_to_bitrev(uint32_to_int32(nat)))
        assert same(got, getattr(jm, inv)(jin, interpret=True)), tp.name
        assert same(getattr(tm, inv)(spec), x), tp.name


def test_spectrum_and_cached_match_jax_and_the_bridge():
    for tp, jp in PAIRS:
        tm, jm = plans(tp, jp)
        a = operands(tp, (jm.t + 1, tp.n), seed=5)
        b = operands(tp, (jm.t + 1, tp.n), seed=6)
        jspec = jm.nwc_spectrum(b, interpret=True)
        spec = tm.nwc_spectrum(uint32_to_int32(b))
        assert np.array_equal(int32_to_uint32(tm.bitrev_to_natural(spec)),
                              natural_jax(jm, jspec)), tp.name
        assert torch.equal(spectra_from_jax(jspec), spec), tp.name
        want = jm.nwc_poly_mult_cached(a, jspec, interpret=True)
        got = tm.nwc_poly_mult_cached(uint32_to_int32(a), spectra_from_jax(jspec))
        assert same(got, want), tp.name
        assert torch.equal(got, tm.nwc_poly_mult(uint32_to_int32(a), uint32_to_int32(b)))


@pytest.mark.parametrize("cached", [False, True])
def test_dot_matches_jax_interpret(cached):
    for tp, jp in PAIRS:
        tm, jm = plans(tp, jp)
        a = operands(tp, (3, 2, tp.n), seed=7)
        b = operands(tp, (3, 2, tp.n), seed=8)
        if cached:
            jspec = np.asarray(jm.nwc_spectrum(b.reshape(-1, tp.n), interpret=True))
            jspec = jspec.reshape(b.shape)
            want = jm.nwc_dot_cached(a, jspec, interpret=True)
            got = tm.nwc_dot_cached(uint32_to_int32(a), spectra_from_jax(jspec))
        else:
            want = jm.nwc_dot(a, b, interpret=True)
            got = tm.nwc_dot(uint32_to_int32(a), uint32_to_int32(b))
        assert same(got, want), tp.name


def test_matvec_matches_jax_and_the_bridge():
    for tp, jp in PAIRS:
        tm, jm = plans(tp, jp)
        A = operands(tp, (2, 2, tp.n), seed=9)
        s = operands(tp, (2, jm.t + 1, tp.n), seed=10)
        blocks = jm.nwc_matvec_spectra(A, interpret=True)
        spectra = tm.nwc_matvec_spectra(uint32_to_int32(A))
        assert torch.equal(matvec_spectra_from_jax(blocks, tp.n), spectra), tp.name
        want = jm.nwc_matvec_cached(s, blocks, interpret=True)
        got = tm.nwc_matvec_cached(uint32_to_int32(s), spectra)
        assert got.shape == (2, jm.t + 1, tp.n)
        assert same(got, want), tp.name


def test_p24_4096_matches_jax_merged():
    tm = MxuPlan(P24_4096, "cpu")
    a = operands(P24_4096, (2, P24_4096.n), seed=11)
    b = operands(P24_4096, (2, P24_4096.n), seed=12)
    jplan = jntt.NttPlan(jparams.P24_4096)
    want = jntt.nwc_poly_mult_merged(jplan, a, b)
    assert same(tm.nwc_poly_mult(uint32_to_int32(a), uint32_to_int32(b)), want)


def test_largest_n_16384_matches_jax_merged():
    """n = 16384 needs a prime of 2-adicity 15: 8380417 stops at n = 4096."""
    q = 16580609
    tm = MxuPlan(make_params(16384, q), "cpu")
    jp = jparams.make_params(16384, q)
    a = operands(jp, (1, jp.n), seed=13)
    b = operands(jp, (1, jp.n), seed=14)
    want = jntt.nwc_poly_mult_merged(jntt.NttPlan(jp), a, b)
    assert same(tm.nwc_poly_mult(uint32_to_int32(a), uint32_to_int32(b)), want)


def test_covers_matches_jax_on_a_grid():
    for q in (12289, 8380417, 16580609, 7340033, 998244353, jparams.P60_4096.q):
        for n in (128, 256, 1024, 4096, 16384, 32768):
            want = jkernels.covers(n, q)
            got = kernels.covers(n, q)
            assert MxuPlan.covers(n, q) == (want is JaxMxuPlan), (n, q)
            if want is JaxMxuPlan:
                assert got is MxuPlan, (n, q)
            else:
                assert got is not MxuPlan, (n, q)


@pytest.mark.parametrize("bad", ["int64", "shape", "width", "device", "strided",
                                 "mismatch", "dot_terms", "matvec_shape"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    tm = MxuPlan(DILITHIUM_256, "cpu")
    a = uint32_to_int32(operands(DILITHIUM_256, (2, 256), seed=15))
    b = a.flip(0).contiguous()
    call, err = tm.nwc_poly_mult, ValueError
    if bad == "int64":
        a, err = a.to(torch.int64), TypeError
    elif bad == "shape":
        a = a[0]
    elif bad == "width":
        a, b = a[:, :128], b[:, :128]
    elif bad == "device":
        a = a.to("meta")
    elif bad == "strided":
        a = torch.cat([a, a], dim=1)[:, ::2]
    elif bad == "mismatch":
        b = b[:1]
    elif bad == "dot_terms":
        call = tm.nwc_dot
        a = b = a.new_zeros((9, 1, 256))
    else:
        call = tm.nwc_matvec_cached
        a, b = a.new_zeros((3, 1, 256)), a.new_zeros((2, 2, 256))
    with pytest.raises(err):
        call(a, b)


def test_empty_batch_and_no_launch_on_the_cpu():
    tm = MxuPlan(DILITHIUM_256, "cpu")
    before = dict(MxuPlan.launches)
    empty = torch.zeros((0, 256), dtype=torch.int32)
    assert tm.nwc_poly_mult(empty, empty).shape == (0, 256)
    assert tm.nwc_ntt_fwd(empty).shape == (0, 256)
    assert tm.nwc_dot(empty[None], empty[None]).shape == (0, 256)
    a = uint32_to_int32(operands(DILITHIUM_256, (2, 256), seed=16))
    assert torch.equal(tm.nwc_poly_mult(a, a), tm.nwc_poly_mult_plain(a, a))
    assert MxuPlan.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    tm = MxuPlan(P24_4096, cuda_device)
    a, b = (uint32_to_int32(operands(P24_4096, (8, 4096), seed=s), cuda_device)
            for s in (17, 18))
    before = dict(MxuPlan.launches)
    for method in ("nwc_poly_mult", "cyclic_poly_mult"):
        assert torch.equal(getattr(tm, method)(a, b),
                           getattr(tm, method + "_plain")(a, b)), method
    for method in ("ntt_fwd", "ntt_inv", "nwc_ntt_fwd", "nwc_ntt_inv", "nwc_spectrum"):
        assert torch.equal(getattr(tm, method)(a), getattr(tm, method + "_plain")(a)), method
    spec = tm.nwc_spectrum(b)
    assert torch.equal(tm.nwc_poly_mult_cached(a, spec),
                       tm.nwc_poly_mult_cached_plain(a, spec))
    a3, b3 = a.reshape(2, 4, 4096), b.reshape(2, 4, 4096)
    assert torch.equal(tm.nwc_dot(a3, b3), tm.nwc_dot_plain(a3, b3))
    assert torch.equal(tm.nwc_matvec_cached(a3, b3.reshape(1, 8, 4096)[:, :2]),
                       tm.nwc_matvec_cached_plain(a3, b3.reshape(1, 8, 4096)[:, :2]))
    torch.cuda.synchronize()
    assert all(MxuPlan.launches[k] > before[k] for k in KERNELS), MxuPlan.launches

"""The port's 60-bit kernel module against tpu_ntt's (kernel K1): transforms,
products and cached spectra.

On the CPU every ``tpu_ntt_torch.kernels.mxu64.MxuPlan64`` method runs its
plain version; each must equal ``tpu_ntt.kernels.mxu64.MxuPlan64`` in Pallas
interpret mode at n = 256 for the generic prime 576460752308273153 (bench.py's
60-bit q, not a trinomial), and the product and spectrum also at a 62-bit
q above 2^61 - 2^40, where the JAX plan turns its lazy reduction off.
Spectra are compared in natural order through both packages' layout maps,
and JAX's cached spectra, carried over by ``convert.spectra64_from_jax``,
must give JAX's products.  The dot and the matvec are in
``test_torch_kernels_mxu64_dot.py``.  The CUDA kernels are compared with
the plain versions only where a CUDA device is present (marker ``cuda``); on
the card that check is ``chip_smoke.py``.  Operands come from
``numpy.random.default_rng`` with rows of 0, 1 and q - 1.
Tolerance: none — exact integer equality.
"""

import functools

import numpy as np
import pytest
import torch

import tpu_ntt.kernels as jkernels
import tpu_ntt.params as jparams
from tpu_ntt.kernels.gl64 import GoldilocksPlan64 as JaxGoldilocksPlan64
from tpu_ntt.kernels.mxu import MxuPlan as JaxMxuPlan
from tpu_ntt.kernels.mxu64 import MxuPlan64 as JaxMxuPlan64
from tpu_ntt.kernels.sol64 import SolinasPlan64 as JaxSolinasPlan64
from tpu_ntt_torch import bounds, kernels
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64, spectra64_from_jax
from tpu_ntt_torch.kernels.fourstep64 import FourStepPlan64
from tpu_ntt_torch.kernels.gl64 import GoldilocksPlan64
from tpu_ntt_torch.kernels.mxu import MxuPlan
from tpu_ntt_torch.kernels.mxu64 import KERNELS, MxuPlan64
from tpu_ntt_torch.kernels.sol64 import SolinasPlan64
from tpu_ntt_torch.params import P60_4096, make_params

N = 256
Q_GENERIC = 576460752308273153  # bench.py:35, 60 bits, not a trinomial
Q62 = 3458764513820557313  # 3 * 2^60 + 2^14 + 1, above 2^61 - 2^40


def operands(q: int, shape, seed: int) -> torch.Tensor:
    """Residues of the given shape, (..., B, n); the first rows are all 0,
    all 1, all q - 1 and [0, 1, q - 1] cycled."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, size=shape, dtype=np.int64)
    n = shape[-1]
    edge = np.stack([np.zeros(n), np.ones(n), np.full(n, q - 1),
                     np.resize([0, 1, q - 1], n)]).astype(np.int64)
    rows = x.reshape(-1, n)
    k = min(4, rows.shape[0])
    rows[:k] = edge[:k] if seed % 2 else edge[:k][::-1]
    return torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def plans(q: int = Q_GENERIC):
    jm = JaxMxuPlan64(jparams.make_params(N, q))
    jm.groups_per_step = 1  # keep interpret-mode cost down
    return MxuPlan64(make_params(N, q), "cpu"), jm


def from_jax(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def natural_jax(jm, out) -> torch.Tensor:
    return from_jax(out)[..., jm.fourstep_to_natural_perm()]


@pytest.mark.parametrize("method", ["nwc_poly_mult", "cyclic_poly_mult"])
def test_products_match_jax_interpret(method):
    tm, jm = plans()
    a, b = operands(Q_GENERIC, (3, N), seed=1), operands(Q_GENERIC, (3, N), seed=2)
    want = getattr(jm, method)(int64_to_pairs(a), int64_to_pairs(b), interpret=True)
    assert torch.equal(getattr(tm, method)(a, b), from_jax(want))


@pytest.mark.parametrize("kind", ["cyclic", "nwc"])
def test_transforms_match_jax_through_layout_maps(kind):
    fwd, inv = {"cyclic": ("ntt_fwd", "ntt_inv"),
                "nwc": ("nwc_ntt_fwd", "nwc_ntt_inv")}[kind]
    tm, jm = plans()
    x = operands(Q_GENERIC, (3, N), seed=3)
    spec = getattr(tm, fwd)(x)
    jspec = getattr(jm, fwd)(int64_to_pairs(x), interpret=True)
    assert torch.equal(tm.bitrev_to_natural(spec), natural_jax(jm, jspec))
    assert torch.equal(getattr(tm, inv)(spec), x)
    # an arbitrary natural-order spectrum, through both inverses
    nat = operands(Q_GENERIC, (2, N), seed=4)
    jin = int64_to_pairs(nat[:, np.argsort(jm.fourstep_to_natural_perm())])
    assert torch.equal(getattr(tm, inv)(tm.natural_to_bitrev(nat)),
                       from_jax(getattr(jm, inv)(jin, interpret=True)))


def test_spectrum_and_cached_match_jax_and_the_bridge():
    tm, jm = plans()
    a, b = operands(Q_GENERIC, (3, N), seed=5), operands(Q_GENERIC, (3, N), seed=6)
    jspec = jm.nwc_spectrum(int64_to_pairs(b), interpret=True)
    spec = tm.nwc_spectrum(b)
    assert torch.equal(tm.bitrev_to_natural(spec), natural_jax(jm, jspec))
    bridged = spectra64_from_jax(*jspec)
    assert torch.equal(bridged, spec)
    want = jm.nwc_poly_mult_cached(int64_to_pairs(a), jspec, interpret=True)
    got = tm.nwc_poly_mult_cached(a, bridged)
    assert torch.equal(got, from_jax(want))
    assert torch.equal(got, tm.nwc_poly_mult(a, b))


def test_62_bit_q_matches_jax_interpret():
    """Above 2^61 - 2^40 the JAX plan reduces every step fully; the port is
    canonical throughout, so only the modulus changes."""
    tm, jm = plans(Q62)
    a, b = operands(Q62, (3, N), seed=7), operands(Q62, (3, N), seed=8)
    want = jm.nwc_poly_mult(int64_to_pairs(a), int64_to_pairs(b), interpret=True)
    assert torch.equal(tm.nwc_poly_mult(a, b), from_jax(want))
    jspec = jm.nwc_spectrum(int64_to_pairs(b), interpret=True)
    assert torch.equal(tm.nwc_spectrum(b), spectra64_from_jax(*jspec))


def test_covers_matches_jax_on_a_grid():
    """The port serves JAX's K1 classes up to n = 8192, above that the
    four-step where q = 1 mod 2n, nothing else of 30 < width <= 62, and
    Goldilocks (K2) on its own plan up to n = 8192 and on the four-step
    above, as well; no tables are built."""
    port_of = {JaxMxuPlan: MxuPlan, JaxMxuPlan64: MxuPlan64,
               JaxSolinasPlan64: SolinasPlan64, JaxGoldilocksPlan64: GoldilocksPlan64,
               None: None}
    for q in (8380417, 998244353, 2147483649 + 2 ** 20, Q_GENERIC, P60_4096.q, Q62,
              4611686018427322369, jparams.GOLDILOCKS_4096.q):
        for n in (128, 256, 1024, 4096, 8192, 16384, 32768):
            want = port_of[jkernels.covers(n, q)]
            if want in (MxuPlan64, SolinasPlan64) and n > 8192:
                want = FourStepPlan64 if (q - 1) % (2 * n) == 0 else None
            elif want is GoldilocksPlan64 and n > 8192:
                want = FourStepPlan64  # K2's large-n bodies
            assert kernels.covers(n, q) is want, (n, q)
            assert MxuPlan64.covers(n, q) == (want in (MxuPlan64, SolinasPlan64)), (n, q)


def test_bounds_count_the_kernels_multiplies():
    """chip_smoke.py's bound of the 60-bit product: three transforms of
    (n/2) log2 n Shoup-64 products, n Montgomery-64 slot products and n
    Shoup-64 scales, 12 IMADs each, plus Shoup's 4 and REDC's 8 for the
    product by a q that is not shifts and adds."""
    t = 4096 // 2 * 12
    assert bounds.work("nwc64_product", P60_4096, 2048) == (
        3 * 2048 * 4096 * 8, 2048 * (3 * t * 12 + 4096 * 24))
    assert bounds.work("nwc64_product", make_params(4096, Q_GENERIC), 2048)[1] == (
        2048 * (3 * t * 16 + 4096 * 36))
    assert bounds.naf_weight(P60_4096.q) == 3 and bounds.naf_weight(Q_GENERIC) > 3


@pytest.mark.parametrize("bad", ["int32", "shape", "width", "device", "strided",
                                 "mismatch", "dot_terms", "matvec_rows"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    tm, _ = plans()
    a = operands(Q_GENERIC, (2, N), seed=9)
    b = a.flip(0).contiguous()
    call, err = tm.nwc_poly_mult, ValueError
    if bad == "int32":
        a, err = a.to(torch.int32), TypeError
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
        a = b = a.new_zeros((9, 1, N))
    else:
        call = tm.nwc_matvec_cached
        a, b = a.new_zeros((2, 1, N)), a.new_zeros((9, 2, N))
    with pytest.raises(err):
        call(a, b)


def test_cpu_tensors_launch_nothing():
    tm, _ = plans()
    before = dict(MxuPlan64.launches)
    assert set(before) == set(KERNELS)
    empty = torch.zeros((0, N), dtype=torch.int64)
    assert tm.nwc_poly_mult(empty, empty).shape == (0, N)
    assert tm.nwc_dot(empty[None], empty[None]).shape == (0, N)
    a = operands(Q_GENERIC, (2, N), seed=10)
    assert torch.equal(tm.nwc_ntt_inv(tm.nwc_ntt_fwd(a)), a)
    assert torch.equal(tm.nwc_poly_mult(a, a), tm.nwc_poly_mult_plain(a, a))
    assert MxuPlan64.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 4096, 8192])
def test_cuda_kernels_match_plain(cuda_device, n):
    tm = MxuPlan64(make_params(n, Q_GENERIC), cuda_device)
    a, b = (operands(Q_GENERIC, (8, n), seed=s).to(cuda_device) for s in (11, 12))
    before = dict(MxuPlan64.launches)
    for method in ("nwc_poly_mult", "cyclic_poly_mult"):
        assert torch.equal(getattr(tm, method)(a, b),
                           getattr(tm, method + "_plain")(a, b)), method
    for method in ("ntt_fwd", "ntt_inv", "nwc_ntt_fwd", "nwc_ntt_inv", "nwc_spectrum"):
        assert torch.equal(getattr(tm, method)(a), getattr(tm, method + "_plain")(a)), method
    spec = tm.nwc_spectrum(b)
    assert torch.equal(tm.nwc_poly_mult_cached(a, spec),
                       tm.nwc_poly_mult_cached_plain(a, spec))
    a3, b3 = a.reshape(2, 4, n), b.reshape(2, 4, n)
    assert torch.equal(tm.nwc_dot(a3, b3), tm.nwc_dot_plain(a3, b3))
    spectra = tm.nwc_matvec_spectra(b3[:, :2].contiguous())
    assert torch.equal(tm.nwc_matvec_cached(a3, spectra),
                       tm.nwc_matvec_cached_plain(a3, spectra))
    tw = tuple(t.reshape(2, n) for t in tm.ring.encode_tw(range(1, 2 * n + 1), cuda_device))
    row_spec = tm.ntt_fwd_scaled(b, tw, True)
    mat = row_spec.reshape(2, 2, 2, n)  # (k, l, period, n) cached rows
    for method, args in (("cyclic_poly_mult_scaled", (a, b, tw, tw)),
                         ("ntt_fwd_scaled", (a, tw)), ("ntt_inv_scaled", (a, tw)),
                         ("cyclic_poly_mult_cached_scaled", (a, row_spec, tw, tw)),
                         ("dot_scaled", (a3, b3, tw, tw)),
                         ("dot_scaled", (a3, row_spec.reshape(2, 4, n), tw, tw, True)),
                         ("matvec_scaled", (tm.ntt_fwd_scaled(a, tw).reshape(2, 4, n),
                                            mat, tw))):
        assert torch.equal(getattr(tm, method)(*args),
                           getattr(tm, method + "_plain")(*args)), method
    torch.cuda.synchronize()
    # the column entry points are SubPlan64's column pass (test_torch_nwc64_radix.py)
    assert all(MxuPlan64.launches[k] > before[k] for k in KERNELS
               if not k.endswith("_cols")), MxuPlan64.launches

"""The port's Goldilocks kernel module against tpu_ntt's (kernel K2).

On the CPU every ``tpu_ntt_torch.kernels.gl64.GoldilocksPlan64`` op runs its
plain version; the product, the cached spectrum (in the plain domain, the
negacyclic forward) and the dot must equal
``tpu_ntt.kernels.gl64.GoldilocksPlan64`` in Pallas interpret mode at
n = 256 (three JAX calls, 5 to 15 s each here).  JAX's gl64
spectra are in the plain domain, as the port's are, so
``convert.spectra64_from_jax`` and ``matvec_spectra64_from_jax`` only
permute: JAX's cached spectra must give the port's products.  The other ops
are held to those: inverses undo forwards, the cyclic product and the
matvec equal their big-int goldens.  Also: ``covers`` against JAX's, the
rejections, the C signatures ``load`` binds against ``csrc/gl64.cu``, and
the bounds.  The CUDA kernels are compared with the plain versions only
where a CUDA device is present (marker ``cuda``); on the card that check is
``chip_smoke.py``.  Operands come from ``numpy.random.default_rng`` with
rows of 0, 1, q - 1, 2^63 and 2^63 - 1.  Tolerance: none — exact integer
equality.
"""

import functools
import re

import numpy as np
import pytest
import torch

import tpu_ntt.kernels as jkernels
import tpu_ntt.params as jparams
from tpu_ntt.kernels.gl64 import GoldilocksPlan64 as JaxGoldilocksPlan64
from tpu_ntt_torch import bounds, kernels, reference
from tpu_ntt_torch.convert import (int64_to_pairs, matvec_spectra64_from_jax,
                                   pairs_to_int64, spectra64_from_jax)
from tpu_ntt_torch.kernels import _build, _plan
from tpu_ntt_torch.kernels import gl64 as kgl64
from tpu_ntt_torch.kernels.fourstep64 import FourStepPlan64
from tpu_ntt_torch.kernels.gl64 import KERNELS, GoldilocksPlan64
from tpu_ntt_torch.kernels.mxu64 import MxuPlan64
from tpu_ntt_torch.modmath import GOLDILOCKS_Q as Q
from tpu_ntt_torch.params import GOLDILOCKS_4096, make_params

N = 256
EDGES = [0, 1, Q - 1, 1 << 63, (1 << 63) - 1]


def operands(shape, seed: int) -> torch.Tensor:
    """int64 patterns of residues, (..., B, n); the first rows all 0, 1,
    q - 1, 2^63, 2^63 - 1 and those cycled (reversed for an even seed)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint64)
    n = shape[-1]
    edge = np.array([[v] * n for v in EDGES] + [np.resize(EDGES, n).tolist()],
                    dtype=np.uint64)
    rows = x.reshape(-1, n)
    k = min(len(edge), rows.shape[0])
    rows[:k] = edge[:k] if seed % 2 else edge[::-1][:k]
    return torch.from_numpy(x.view(np.int64))


@functools.lru_cache(maxsize=None)
def plans():
    jm = JaxGoldilocksPlan64(jparams.make_params(N, Q))
    jm.groups_per_step = 1  # keep interpret-mode cost down
    return GoldilocksPlan64(make_params(N, Q), "cpu"), jm


def from_jax(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def natural_jax(jm, out) -> torch.Tensor:
    return from_jax(out)[..., jm.fourstep_to_natural_perm()]


def unsigned(t: torch.Tensor) -> list:
    return t.numpy().view(np.uint64).tolist()


def test_product_matches_jax_interpret():
    tm, jm = plans()
    a, b = operands((6, N), seed=1), operands((6, N), seed=2)
    want = jm.nwc_poly_mult(int64_to_pairs(a), int64_to_pairs(b), interpret=True)
    got = tm.nwc_poly_mult(a, b)
    assert torch.equal(got, from_jax(want))
    assert unsigned(got)[2] == reference.nwc_poly_mult(unsigned(a)[2], unsigned(b)[2], tm.p)


def test_forward_evaluates_at_the_odd_powers_of_psi():
    """Natural-order slot k of the negacyclic forward is x(psi^(2k+1)), by
    Horner in big-int arithmetic; the inverses undo the forwards.  (JAX's
    forward is held to the port's through its spectrum, which in the plain
    domain is the forward itself: see the next test.)"""
    tm, _ = plans()
    x = operands((3, N), seed=3)
    nat = unsigned(tm.bitrev_to_natural(tm.nwc_ntt_fwd(x)))
    for row in range(3):
        coeffs = unsigned(x)[row]
        for k in (0, 1, 77, N - 1):
            point = pow(tm.p.psi, 2 * k + 1, Q)
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * point + c) % Q
            assert nat[row][k] == acc, (row, k)
    assert torch.equal(tm.nwc_ntt_inv(tm.nwc_ntt_fwd(x)), x)
    assert torch.equal(tm.ntt_inv(tm.ntt_fwd(x)), x)


def test_spectra_are_plain_and_bridge_from_jax():
    """One JAX call spectrum-transforms b's rows and a 2 x 2 matrix: the
    bridged spectra equal the port's (the plain domain: the negacyclic
    forward itself), and give the port's cached, dot and matvec products."""
    tm, jm = plans()
    a, b = operands((3, N), seed=5), operands((3, N), seed=6)
    A = operands((2, 2, N), seed=7)
    jspec = jm.nwc_spectrum(int64_to_pairs(torch.cat([b, A.reshape(4, N)])),
                            interpret=True)
    bridged = spectra64_from_jax(*jspec)
    assert torch.equal(bridged[:3], tm.nwc_spectrum(b))
    assert torch.equal(tm.nwc_spectrum(b), tm.nwc_ntt_fwd(b))
    assert torch.equal(tm.nwc_poly_mult_cached(a, bridged[:3]), tm.nwc_poly_mult(a, b))
    # JAX's matvec blocks tile each spectrum over the rows of an MXU group
    hi, lo = (np.asarray(w)[3:].reshape(2, 2, N // 128, 128) for w in jspec)
    blocks = tuple(np.concatenate([w, w], axis=2) for w in (hi, lo))
    spectra = matvec_spectra64_from_jax(blocks, N)
    assert torch.equal(spectra, tm.nwc_matvec_spectra(A))
    s = operands((2, 3, N), seed=8)
    got = tm.nwc_matvec_cached(s, spectra)
    for i in range(2):
        want = [[0] * N for _ in range(3)]
        for j in range(2):
            for r in range(3):
                prod = reference.nwc_poly_mult(unsigned(A[i, j]), unsigned(s[j, r]), tm.p)
                want[r] = [(u + v) % Q for u, v in zip(want[r], prod)]
        assert unsigned(got[i]) == want
    assert torch.equal(tm.nwc_dot_cached(s, tm.nwc_spectrum(A[0].contiguous())[:, None]
                                         .expand(2, 3, N).contiguous()),
                       tm.nwc_dot(s, A[0][:, None].expand(2, 3, N).contiguous()))


def test_dot_matches_jax_interpret():
    tm, jm = plans()
    a3, b3 = operands((2, 3, N), seed=9), operands((2, 3, N), seed=10)
    want = jm.nwc_dot(int64_to_pairs(a3), int64_to_pairs(b3), interpret=True)
    assert torch.equal(tm.nwc_dot(a3, b3), from_jax(want))


def test_cyclic_product_matches_the_golden():
    tm, _ = plans()
    a, b = operands((2, N), seed=11), operands((2, N), seed=12)
    got = unsigned(tm.cyclic_poly_mult(a, b))
    for r in range(2):
        assert got[r] == reference.cyclic_poly_mult(unsigned(a)[r], unsigned(b)[r], tm.p)


def test_covers_matches_jax_up_to_8192():
    """The port serves JAX's Goldilocks window on its flat plan up to
    n = 8192 and on the four-step above (where JAX runs its flat plan to
    32768, its kernel four-step from 65536); the 60-bit plans never take
    the Goldilocks prime; no tables are built."""
    for n in (128, 256, 1024, 4096, 8192, 16384, 32768, 65536):
        jcls = jkernels.covers(n, Q)
        want = GoldilocksPlan64 if jcls is JaxGoldilocksPlan64 and n <= 8192 else None
        if n > 8192:
            assert jcls is (JaxGoldilocksPlan64 if n <= 32768 else None), n
            want = FourStepPlan64
        assert kernels.covers(n, Q) is want, n
        assert GoldilocksPlan64.covers(n, Q) == (want is GoldilocksPlan64), n
        assert not MxuPlan64.covers(n, Q)
    assert not GoldilocksPlan64.covers(4096, 576460752308273153)
    assert kernels.covers(4096, GOLDILOCKS_4096.q) is GoldilocksPlan64
    for p in (make_params(128, Q), make_params(16384, Q), make_params(256, 7681)):
        with pytest.raises(ValueError, match="GoldilocksPlan64 covers"):
            GoldilocksPlan64(p, "cpu")


@pytest.mark.parametrize("bad", ["int32", "shape", "width", "device", "strided",
                                 "mismatch", "dot_terms", "matvec_rows"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    tm, _ = plans()
    a = operands((2, N), seed=13)
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
    before = dict(GoldilocksPlan64.launches)
    assert set(before) == set(KERNELS)
    empty = torch.zeros((0, N), dtype=torch.int64)
    assert tm.nwc_poly_mult(empty, empty).shape == (0, N)
    assert tm.nwc_dot(empty[None], empty[None]).shape == (0, N)
    a = operands((2, N), seed=14)
    assert torch.equal(tm.nwc_poly_mult(a, a), tm.nwc_poly_mult_plain(a, a))
    assert GoldilocksPlan64.launches == before


C_TYPES = {"int": kgl64.ctypes.c_int, "uint64_t": kgl64.ctypes.c_uint64}


def test_load_binds_the_c_signatures_of_gl64_cu(monkeypatch):
    """Each entry point ``load`` types has the C name, argument count and
    argument types of ``csrc/gl64.cu``'s ``extern "C"`` function: a CPU
    test cannot link it."""
    bound = {}
    monkeypatch.setattr(_plan, "bind", lambda name, argtypes: bound.update(argtypes))
    kgl64.load.__wrapped__()
    source = (_build.CSRC / "gl64.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (gl64_\w+)\(([^)]*)\)', source))
    assert sorted(decls) == sorted(KERNELS) == sorted(f"gl64_{k}" for k in bound)
    for suffix, types in bound.items():
        params = [p.strip() for p in decls[f"gl64_{suffix}"].split(",")]
        assert len(params) == len(types), suffix
        for param, ty in zip(params, types):
            want = (kgl64.ctypes.c_void_p if "*" in param
                    else C_TYPES[param.rsplit(" ", 1)[0]])
            assert ty is want, (suffix, param)


def test_bounds_count_goldilocks_products():
    """chip_smoke.py's bound of each gl64 function: every product, twiddle,
    slot or scale, is 8 IMADs (the phi-fold multiplies nothing), and the
    forward has no scale."""
    t = 4096 // 2 * 12
    assert bounds.work("gl64_product", GOLDILOCKS_4096, 2048) == (
        3 * 2048 * 4096 * 8, 2048 * (3 * t + 2 * 4096) * 8)
    assert bounds.work("gl64_forward", GOLDILOCKS_4096, 2048)[1] == 2048 * t * 8
    assert bounds.work("gl64_inverse", GOLDILOCKS_4096, 2048)[1] == 2048 * (t + 4096) * 8
    assert bounds.work("gl64_dot", GOLDILOCKS_4096, 512)[1] == (
        512 * (8 * t + 4 * 4096 + t + 4096) * 8)
    assert bounds.muls("gl64", Q) == 8
    # the column entry points are priced as their row twins on the same
    # transforms, and the four-step's bytes as built have no transposes:
    # at goldilocks_32768 (256 x 128), B = 256, the nwc chain's column
    # forward of a and b, row kernel and column inverse move what they read
    # and write (the row kernel its two plain mid tables too)
    col, row = make_params(256, Q), make_params(128, Q)
    for entry in ("forward", "inverse"):
        assert (bounds.work(f"gl64_{entry}_cols", col, 512 * 128)
                == bounds.work(f"gl64_{entry}", col, 512 * 128))
    data = 256 * 32768 * 8
    nbytes, built, imads = bounds.fourstep_work("nwc", 32768, Q, 256)
    assert nbytes == 3 * data + 2 * 32768 * 8
    assert built == 2 * 2 * data + (3 * data + 2 * 32768 * 8) + 2 * data
    assert imads == sum(bounds.work(k, p, rows, period=256)[1] for k, p, rows in (
        ("gl64_forward_cols", col, 512 * 128), ("gl64_cyclic_scaled", row, 256 * 256),
        ("gl64_inverse_cols", col, 256 * 128)))


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    dev = torch.device("cuda", torch.cuda.current_device())
    before = dict(GoldilocksPlan64.launches)
    for n in (256, 4096, 8192):
        tm = GoldilocksPlan64(make_params(n, Q), dev)
        a, b = (operands((8, n), seed=s).to(dev) for s in (15, 16))
        for method in ("nwc_poly_mult", "cyclic_poly_mult"):
            assert torch.equal(getattr(tm, method)(a, b),
                               getattr(tm, method + "_plain")(a, b)), method
        for method in ("ntt_fwd", "ntt_inv", "nwc_ntt_fwd", "nwc_ntt_inv",
                       "nwc_spectrum"):
            assert torch.equal(getattr(tm, method)(a),
                               getattr(tm, method + "_plain")(a)), method
        spec = tm.nwc_spectrum(b)
        assert torch.equal(tm.nwc_poly_mult_cached(a, spec),
                           tm.nwc_poly_mult_cached_plain(a, spec))
        a3, b3 = a.reshape(2, 4, n), b.reshape(2, 4, n)
        assert torch.equal(tm.nwc_dot(a3, b3), tm.nwc_dot_plain(a3, b3))
        spectra = tm.nwc_matvec_spectra(b3[:, :2].contiguous())
        assert torch.equal(tm.nwc_matvec_cached(a3, spectra),
                           tm.nwc_matvec_cached_plain(a3, spectra))
    torch.cuda.synchronize()
    assert all(GoldilocksPlan64.launches[k] > before[k] for k in KERNELS[:6])

"""The port's ML-KEM kernel module against tpu_ntt's (kernel K4).

On the CPU every ``tpu_ntt_torch.kernels.kyber.KyberPlan`` op runs its plain
version; each must equal ``tpu_ntt.kernels.kyber.KyberPlan`` in Pallas
interpret mode, with both ``parity_matrices`` settings for the ops whose
outputs hold no cached spectrum (the two settings differ only in that
layout), on two groups of the TPU kernel.  JAX's
cached spectra and matvec blocks, carried over by ``convert``, must give
JAX's products; the port's own must be the FIPS-order spectra times 2^32.
Also: the rejections, the constructor's default device, the C signatures
``load`` binds against ``csrc/kyber.cu``, the bounds ``work`` gives, and
the device timers' refusal of a CPU tensor.
The CUDA kernels are compared with the plain versions only where a CUDA
device is present (marker ``cuda``); on the card that check is
``chip_smoke.py``.  Operands come from ``numpy.random.default_rng`` with
rows of 0, 1 and q - 1.  Tolerance: none — exact integer equality.
"""

import inspect
import re

import numpy as np
import pytest
import torch

from tpu_ntt.kernels.kyber import KyberPlan as JaxKyberPlan
from tpu_ntt_torch import benchlib, bounds, ntt
from tpu_ntt_torch.convert import (int32_to_uint32, kyber_blocks_from_jax,
                                   kyber_spectra_from_jax, uint32_to_int32)
from tpu_ntt_torch.kernels import _build, _plan
from tpu_ntt_torch.kernels import kyber as kkyber
from tpu_ntt_torch.kernels.kyber import KERNELS, KyberPlan

Q, N = 3329, 256


def residues(shape, seed: int) -> np.ndarray:
    """uint32 residues of shape (..., 256); the first rows all 0, all 1,
    all q - 1 and [0, 1, q - 1] cycled (reversed for an even seed)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint32)
    edge = np.stack([np.zeros(N), np.ones(N), np.full(N, Q - 1),
                     np.resize([0, 1, Q - 1], N)]).astype(np.uint32)
    rows = x.reshape(-1, N)
    k = min(4, rows.shape[0])
    rows[:k] = edge[:k] if seed % 2 else edge[::-1][:k]
    return x


def plans(parity_matrices: bool = True, supertile: bool = False):
    jp = JaxKyberPlan()
    jp.parity_matrices = parity_matrices
    jp.supertile = supertile
    # keep interpret-mode cost down: one group a grid step, two for the
    # super-tile body, whose groups share one matmul
    jp.groups_per_step = 2 if supertile else 1
    return KyberPlan("cpu"), jp


def t(x) -> torch.Tensor:
    return uint32_to_int32(x)


def same(got: torch.Tensor, want) -> bool:
    return np.array_equal(int32_to_uint32(got), np.asarray(want))


@pytest.mark.parametrize("parity_matrices", [True, False, "supertile"])
def test_spectrum_free_ops_match_jax_interpret(parity_matrices):
    """Both layouts, and "supertile": K4b's ablation body, the pair layout
    with ``KyberPlan.supertile = True`` (tpu_ntt/kernels/kyber.py:482-484,
    ``_poly_mult_kernel_st``), whose ``poly_mult`` runs two groups' rows
    (130 rows: three groups of 64 and a padded fourth) in one matmul."""
    supertile = parity_matrices == "supertile"
    if supertile:
        parity_matrices = False
    tp, jp = plans(parity_matrices, supertile)
    # two TPU groups, the second padded: 128 polynomials each in the
    # parity-matrix layout, 64 in the pair layout (which ntt and intt take)
    a, b = residues((130, N), 1), residues((130, N), 2)
    rows = 130 if parity_matrices or supertile else 65
    assert same(tp.poly_mult(t(a[:rows]), t(b[:rows])),
                jp.poly_mult(a[:rows], b[:rows], True))
    assert same(tp.ntt(t(a[:65])), jp.ntt(a[:65], True))
    assert same(tp.intt(t(b[:65])), jp.intt(b[:65], True))
    a3, b3 = residues((3, 2, N), 3), residues((3, 2, N), 4)
    assert same(tp.dot(t(a3), t(b3)), jp.dot(a3, b3, True))


def test_cached_spectra_from_jax_give_jax_products():
    tp, jp = plans()
    a, b = residues((3, N), 5), residues((3, N), 6)
    jspec = jp.spectrum(b, True)
    spec = tp.spectrum(t(b))
    assert torch.equal(kyber_spectra_from_jax(jspec), spec)
    assert same(tp.poly_mult_cached(t(a), kyber_spectra_from_jax(jspec)),
                jp.poly_mult_cached(a, jspec, True))
    assert torch.equal(tp.poly_mult_cached(t(a), spec), tp.poly_mult(t(a), t(b)))
    a3, b3 = residues((2, 3, N), 7), residues((2, 3, N), 8)
    jspec3 = np.asarray(jp.spectrum(b3.reshape(-1, N), True)).reshape(b3.shape)
    assert same(tp.dot_cached(t(a3), kyber_spectra_from_jax(jspec3)),
                jp.dot_cached(a3, jspec3, True))
    assert torch.equal(tp.dot_cached(t(a3), tp.spectrum(t(b3).reshape(-1, N))
                                     .reshape(b3.shape)), tp.dot(t(a3), t(b3)))


def test_matvec_blocks_from_jax_give_jax_products():
    tp, jp = plans()
    A, A_hat = residues((3, 2, N), 9), residues((3, 2, N), 10)
    s = residues((2, 3, N), 11)
    for jblocks, blocks in ((jp.matvec_spectra(A, True), tp.matvec_spectra(t(A))),
                            (jp.ntt_domain_blocks(A_hat), tp.ntt_domain_blocks(t(A_hat)))):
        assert torch.equal(kyber_blocks_from_jax(jblocks), blocks)
        got = tp.matvec(t(s), blocks)
        assert got.shape == (3, 3, N)
        assert same(got, jp.matvec(s, jblocks, True))


def test_spectrum_layout_is_fips_order_times_2_32():
    tp, _ = plans()
    x = t(residues((3, N), 12))
    perm = KyberPlan.spectrum_to_fips_perm()
    assert np.array_equal(perm, np.arange(N))
    back = tp.ring.mul_tw(tp.spectrum(x)[..., perm], tp._r_inv_tw)
    assert torch.equal(back, tp.ntt(x))
    fx = tp.ntt(x)
    assert torch.equal(tp.ntt_domain_blocks(fx[None]), tp.matvec_spectra(x[None]))


@pytest.mark.parametrize("bad", ["int64", "shape", "width", "device", "strided",
                                 "mismatch", "dot_terms", "matvec_terms",
                                 "matvec_cols"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    tp = KyberPlan("cpu")
    a = t(residues((2, N), 13))
    b = a.flip(0).contiguous()
    call, err = tp.poly_mult, ValueError
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
        call = tp.dot
        a = b = a.new_zeros((9, 1, N))
    elif bad == "matvec_terms":
        call = tp.matvec
        a, b = a.new_zeros((9, 1, N)), a.new_zeros((1, 9, N))
    else:
        call = tp.matvec
        a, b = a.new_zeros((3, 1, N)), a.new_zeros((2, 2, N))
    with pytest.raises(err):
        call(a, b)


def test_empty_batch_and_no_launch_on_the_cpu():
    tp = KyberPlan("cpu")
    before = dict(KyberPlan.launches)
    empty = torch.zeros((0, N), dtype=torch.int32)
    assert tp.poly_mult(empty, empty).shape == (0, N)
    assert tp.ntt(empty).shape == (0, N)
    assert tp.dot(empty[None], empty[None]).shape == (0, N)
    assert tp.matvec(empty[None], torch.zeros((2, 1, N), dtype=torch.int32)).shape == (2, 0, N)
    a = t(residues((2, N), 14))
    assert torch.equal(tp.basemul(tp.ntt(a), tp.ntt(a)), tp.basemul_plain(tp.ntt(a), tp.ntt(a)))
    assert KyberPlan.launches == before


def test_constructor_defaults_to_the_card(monkeypatch):
    """``KyberPlan()`` asks ``resolve_device`` for None (the card); the
    stand-in answers with the CPU, which gets the tables."""
    asked = []

    def resolve(device=None):
        asked.append(device)
        return torch.device("cpu")

    monkeypatch.setattr(ntt, "resolve_device", resolve)
    assert inspect.signature(KyberPlan).parameters["device"].default is None
    plan = KyberPlan()
    assert asked and asked[0] is None and plan.device == torch.device("cpu")
    assert plan.plan.device == torch.device("cpu")


def test_load_binds_the_c_signatures_of_kyber_cu(monkeypatch):
    """Each entry point ``load`` types has the C name and argument count of
    ``csrc/kyber.cu``'s ``extern "C"`` function: a CPU test cannot link it."""
    bound = {}
    monkeypatch.setattr(_plan, "bind", lambda name, argtypes: bound.update(argtypes))
    kkyber.load.__wrapped__()
    source = (_build.CSRC / "kyber.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (kyber_\w+)\(([^)]*)\)', source))
    assert sorted(decls) == sorted(KERNELS) == sorted(f"kyber_{k}" for k in bound)
    for suffix, types in bound.items():
        params = [p for p in decls[f"kyber_{suffix}"].split(",") if p.strip()]
        assert len(params) == len(types), suffix
        assert all((("*" in p) == (ty is kkyber.ctypes.c_void_p))
                   for p, ty in zip(params, types)), suffix


def test_bounds_count_the_ported_kernels():
    """``work`` prices ``kyber_*`` at B = 16384, ML-KEM-768 (the bounds the
    kernel table states)."""
    imad_per_s = bounds.H100_SMS * bounds.IMAD_PER_SM_CLOCK * bounds.H100_TOP_SM_HZ
    want = {"forward": (0.0100, "bytes"), "product": (0.0150, "bytes"),
            "dot": (0.0351, "bytes"), "matvec": (0.0406, "operations")}
    for entry, (ms, by) in want.items():
        t_bytes, t_ops = bounds.seconds(*bounds.work(f"kyber_{entry}", None,
                                                     bounds.KYBER_BATCH, 3), imad_per_s)
        assert round(max(t_bytes, t_ops) * 1e3, 4) == ms, entry
        assert ("bytes" if t_bytes >= t_ops else "operations") == by, entry


def test_bounds_work_out_the_all_to_all():
    """K6: one exchange of p60_1048576, B = 4, over four cards holds 8 MiB
    a card and sends 6 MiB of it, 14 us at 450 GB/s; among four logical
    shards of one card it reads and writes 32 MiB each way, 20 us at
    3.35 TB/s, 24 MiB of it changing shard."""
    held, sent = bounds.a2a_work(1 << 20, 4)
    assert (held, sent) == (8 << 20, 6 << 20)
    assert round(sent / bounds.NVLINK_BYTES_PER_S * 1e6, 1) == 14.0
    nbytes, crossing = bounds.a2a_card_work(1 << 20, 4, 4)
    assert (nbytes, crossing) == (64 << 20, 24 << 20)
    assert round(nbytes / bounds.MEM_BYTES_PER_S * 1e6, 1) == 20.0


def test_timers_refuse_a_cpu_tensor():
    """The device timers, graph replay among them, give device times only."""
    x = t(residues((2, N), 17))
    for timer in (benchlib.device_seconds_per_call, benchlib.graph_seconds_per_call,
                  benchlib.host_seconds_per_call):
        with pytest.raises(ValueError, match="CUDA tensor"):
            timer(KyberPlan("cpu").ntt, x)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    dev = torch.device("cuda", torch.cuda.current_device())
    tp = KyberPlan(dev)
    a, b = (uint32_to_int32(residues((8, N), s), dev) for s in (15, 16))
    before = dict(KyberPlan.launches)
    for method in ("ntt", "intt", "spectrum"):
        assert torch.equal(getattr(tp, method)(a), getattr(tp, method + "_plain")(a)), method
    assert torch.equal(tp.poly_mult(a, b), tp.poly_mult_plain(a, b))
    spec = tp.spectrum(b)
    assert torch.equal(tp.poly_mult_cached(a, spec), tp.poly_mult_cached_plain(a, spec))
    a3, b3 = a.reshape(2, 4, N), b.reshape(2, 4, N)
    assert torch.equal(tp.dot(a3, b3), tp.dot_plain(a3, b3))
    blocks = tp.matvec_spectra(b3[:, :2].contiguous())
    assert torch.equal(tp.matvec(a3, blocks), tp.matvec_plain(a3, blocks))
    torch.cuda.synchronize()
    assert all(KyberPlan.launches[k] > before[k] for k in KERNELS), KyberPlan.launches

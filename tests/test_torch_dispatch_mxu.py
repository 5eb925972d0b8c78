"""The 24-bit slice end to end: ``tpu_ntt_torch.dispatch`` against
``tpu_ntt.dispatch`` at P24_4096 for all twelve ops, and the ML-DSA-44-shaped
4 x 4 matvec at DILITHIUM_256.

The same operands, from ``numpy.random.default_rng`` with rows of 0, 1 and
q - 1, go to ``tpu_ntt.dispatch.best(P24_4096, op)`` (the Pallas kernel in
interpret mode on the CPU) and to the port's ``best`` on CPU tensors.
Spectra are compared in natural order through each backend's layout map; a
spectrum fed to an inverse is one natural-order array given to each backend
in its own layout; cached spectra and matvec blocks are each package's own.
Also: the constructors default to the card and use the CPU only when asked.
Tolerance: none — exact integer equality.
"""

import functools
import inspect

import numpy as np
import pytest
import torch

import tpu_ntt.dispatch as jdispatch
import tpu_ntt.params as jparams
import tpu_ntt.reference as jref
import tpu_ntt_torch as tt
from tpu_ntt.kernels.mxu import MxuPlan as JaxMxuPlan
from tpu_ntt_torch import dispatch, kernels, ntt
from tpu_ntt_torch.convert import (int32_to_uint32, matvec_spectra_from_jax,
                                   uint32_to_int32)
from tpu_ntt_torch.kernels.mxu import MxuPlan
from tpu_ntt_torch.kernels.sol64 import SolinasPlan64
from tpu_ntt_torch.params import DILITHIUM_256, P24_4096, P60_4096, PRESETS

P, JP = P24_4096, jparams.P24_4096
N, Q = P.n, P.q


def residues(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint32)
    rows = x.reshape(-1, N)
    rows[0] = np.roll(np.resize(np.array([0, 1, Q - 1], np.uint32), N), seed)
    rows[1] = Q - 1 if seed % 2 else 0
    return x


@functools.lru_cache(maxsize=None)
def port_plan() -> MxuPlan:
    return MxuPlan(P, "cpu")


@functools.lru_cache(maxsize=None)
def jax_perm() -> np.ndarray:
    return JaxMxuPlan(JP).fourstep_to_natural_perm()


def natural(op_out, port: bool) -> np.ndarray:
    """A spectrum in natural order, from either package's layout."""
    if port:
        return int32_to_uint32(port_plan().bitrev_to_natural(op_out))
    return np.asarray(op_out)[..., jax_perm()]


def to_jax_layout(nat: np.ndarray) -> np.ndarray:
    return nat[..., np.argsort(jax_perm())]


def run_both(op: str):
    """(port result, JAX result) for one op, both as uint32 numpy arrays in
    comparable order."""
    a, b = residues((2, N), 1), residues((2, N), 2)
    A, s = residues((2, 2, N), 3), residues((2, 2, N), 4)
    jbest, tbest = jdispatch.best(JP, op), dispatch.best(P, op)
    t = uint32_to_int32
    if op in ("nwc", "cyclic", "dot"):
        x, y = (a, b) if op != "dot" else (A, s)
        return int32_to_uint32(tbest(t(x), t(y))), np.asarray(jbest(x, y))
    if op in ("fwd", "nwc_fwd", "spectrum", "matvec_spectra"):
        x = A if op == "matvec_spectra" else a
        if op == "matvec_spectra":  # blocks: compare the spectra they hold
            return (int32_to_uint32(tbest(t(x))),
                    int32_to_uint32(matvec_spectra_from_jax(jbest(x), N)))
        return natural(tbest(t(x)), True), natural(jbest(x), False)
    if op in ("inv", "nwc_inv"):
        nat = residues((2, N), 5)
        tin = port_plan().natural_to_bitrev(t(nat))
        return int32_to_uint32(tbest(tin)), np.asarray(jbest(to_jax_layout(nat)))
    if op in ("cached", "dot_cached"):
        x, y = (a, b) if op == "cached" else (A, s)
        tspec = dispatch.best(P, "spectrum")(t(y.reshape(-1, N))).reshape(y.shape)
        jspec = np.asarray(jdispatch.best(JP, "spectrum")(y.reshape(-1, N))).reshape(y.shape)
        return int32_to_uint32(tbest(t(x), tspec)), np.asarray(jbest(x, jspec))
    assert op == "matvec"
    tblocks = dispatch.best(P, "matvec_spectra")(t(A))
    jblocks = jdispatch.best(JP, "matvec_spectra")(A)
    return int32_to_uint32(tbest(t(s), tblocks)), np.asarray(jbest(s, jblocks))


@pytest.mark.parametrize("op", dispatch.OPS)
def test_best_matches_jax_dispatch_at_p24_4096(op):
    got, want = run_both(op)
    assert got.shape == want.shape and np.array_equal(got, want), op


def test_dilithium_4x4_matvec_end_to_end():
    """The ML-DSA-44 shape: A is 4 x 4, s holds 4 polynomials per row of the
    batch; against the JAX dispatch and a golden sum of products."""
    jp = jparams.DILITHIUM_256
    rng = np.random.default_rng(7)
    A = rng.integers(0, jp.q, size=(4, 4, 256), dtype=np.uint32)
    s = rng.integers(0, jp.q, size=(4, 3, 256), dtype=np.uint32)
    A[0, 0], s[0, 0] = jp.q - 1, jp.q - 1
    spectra = tt.best_nwc_matvec_spectra(DILITHIUM_256)(uint32_to_int32(A))
    got = int32_to_uint32(tt.best_nwc_matvec(DILITHIUM_256)(uint32_to_int32(s), spectra))
    jblocks = jdispatch.best_nwc_matvec_spectra(jp)(A)
    assert np.array_equal(got, np.asarray(jdispatch.best_nwc_matvec(jp)(s, jblocks)))
    for i, r in ((0, 0), (3, 2)):
        want = [0] * 256
        for j in range(4):
            prod = jref.nwc_poly_mult(A[i, j].tolist(), s[j, r].tolist(), jp)
            want = [(x + y) % jp.q for x, y in zip(want, prod)]
        assert got[i, r].tolist() == want


def test_surface_covers_the_24_bit_family():
    for name in ("p24_4096", "p24_1024", "dilithium_256", "falcon_512", "falcon_1024"):
        p = PRESETS[name]
        assert all(dispatch.impl_name(p, op) == "cuda-mxu" for op in dispatch.OPS), name
        assert dispatch.takes_pairs(p) is False
    assert dispatch.impl_name(P60_4096) == "cuda-sol64"
    helpers = [h for h in dir(jdispatch) if h.startswith("best_")]
    assert helpers and all(callable(getattr(dispatch, h)) for h in helpers)
    a = uint32_to_int32(residues((2, N), 6))
    with pytest.raises(TypeError):
        dispatch.best_nwc_poly_mult(P)(a.to(torch.int64), a.to(torch.int64))


def test_resolve_device_defaults_to_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert ntt.resolve_device() == torch.device("cuda", 3)
    assert ntt.resolve_device("cuda") == torch.device("cuda", 3)
    assert ntt.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert ntt.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("make", ["NttPlan", "MxuPlan", "SolinasPlan64", "plan_for"])
def test_constructors_default_to_the_card(make, monkeypatch):
    """Each constructor asks ``resolve_device`` for None (the card) unless
    given a device; here the answer is the CPU, which has the tables."""
    asked = []

    def resolve(device=None):
        asked.append(device)
        return torch.device("cpu")

    monkeypatch.setattr(ntt, "resolve_device", resolve)
    p = P60_4096 if make == "SolinasPlan64" else P
    fn = {"NttPlan": ntt.NttPlan, "MxuPlan": MxuPlan,
          "SolinasPlan64": SolinasPlan64, "plan_for": kernels.plan_for}[make]
    assert inspect.signature(fn).parameters["device"].default is None
    plan = fn(p)
    assert asked and asked[0] is None and plan.device == torch.device("cpu")

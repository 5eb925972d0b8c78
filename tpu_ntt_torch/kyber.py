"""ML-KEM (Kyber, FIPS 203): the incomplete-NTT surface of ``tpu_ntt.kyber``.

The same eleven entry points, names and meanings, plus ``impl_name``, on
contiguous ``torch.int32`` tensors of residues in [0, q), q = 3329:
coefficients (B, 256) in natural order, spectra from ``ntt`` in FIPS-203
serialization order, byte-compatible with ML-KEM's ByteEncode_12 stream once
packed.  ``spectrum``, ``matvec_spectra`` and ``ntt_domain_blocks`` return
the cacheable form, which only ``poly_mult_cached``, ``dot_cached`` and
``matvec`` take (``kernels.kyber``: the FIPS-order spectrum times 2^32 mod
q).

Each entry point runs on the device of its tensor: the hand-written kernels
of ``kernels/csrc/kyber.cu`` for a CUDA tensor, their plain PyTorch versions
for a CPU tensor; any other device raises and nothing falls back.
``basemul`` and ``ntt_domain_blocks`` are elementwise and are plain torch ops
on both, as JAX computes them outside any kernel.

    import tpu_ntt_torch.kyber as kyber
    c = kyber.poly_mult(a, b)                  # (B, 256) int32 on the card
    t = kyber.matvec(s, kyber.ntt_domain_blocks(A_hat))  # K-PKE's A_hat o s
"""

from __future__ import annotations

import functools

import torch

from .kernels import _plan
from .kernels.kyber import HALF_PARAMS, KyberPlan, gamma_table
from .reference import KYBER_N, KYBER_Q, KYBER_ZETA

Q = KYBER_Q
N = KYBER_N
ZETA = KYBER_ZETA

__all__ = [
    "HALF_PARAMS", "N", "Q", "ZETA", "basemul", "dot", "dot_cached",
    "gamma_table", "impl_name", "intt", "matvec", "matvec_spectra", "ntt",
    "ntt_domain_blocks", "poly_mult", "poly_mult_cached", "spectrum",
]


@functools.lru_cache(maxsize=None)
def _plan_on(device: torch.device) -> KyberPlan:
    return KyberPlan(device)


def _plan_for(x: torch.Tensor) -> KyberPlan:
    """The plan on x's device, built once per device."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.int32 tensor, got {type(x).__name__}")
    _plan.runs_plain(x)  # raises for a device with no kernel and no plain path
    return _plan_on(x.device)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """FIPS-203 NTT: (B, 256) natural coefficients -> plain spectra in
    serialization order."""
    return _plan_for(x).ntt(x)


def intt(x: torch.Tensor) -> torch.Tensor:
    """FIPS-203 inverse NTT of plain serialization-order spectra."""
    return _plan_for(x).intt(x)


def basemul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MultiplyNTTs on plain spectra (FIPS-203 Algorithm 11)."""
    return _plan_for(a).basemul(a, b)


def poly_mult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The negacyclic product in Z_q[x]/(x^256 + 1): coefficients in and out."""
    return _plan_for(a).poly_mult(a, b)


def spectrum(x: torch.Tensor) -> torch.Tensor:
    """The cacheable operand spectrum for poly_mult_cached and dot_cached."""
    return _plan_for(x).spectrum(x)


def poly_mult_cached(a: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """The product against a cached ``spectrum``: one forward instead of two."""
    return _plan_for(a).poly_mult_cached(a, spec)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """INTT(sum_k NTT(a_k) o NTT(b_k)) for (K, B, 256) stacks: the ML-KEM
    decryption inner product (s_hat^T o u_hat), one inverse per output."""
    return _plan_for(a).dot(a, b)


def dot_cached(a: torch.Tensor, spectra: torch.Tensor) -> torch.Tensor:
    """The dot against cached ``spectrum`` stacks: K forwards, one inverse."""
    return _plan_for(a).dot_cached(a, spectra)


def matvec_spectra(A: torch.Tensor) -> torch.Tensor:
    """The matvec spectra of a (k, l, 256) coefficient matrix."""
    return _plan_for(A).matvec_spectra(A)


def ntt_domain_blocks(A_hat: torch.Tensor) -> torch.Tensor:
    """The matvec spectra of a (k, l, 256) plain NTT-domain matrix, the form
    FIPS-203 samples A_hat in (Algorithm 13, SampleNTT)."""
    return _plan_for(A_hat).ntt_domain_blocks(A_hat)


def matvec(s: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """A_hat o NTT(s), then INTT: s is (l, B, 256) coefficients, blocks from
    matvec_spectra or ntt_domain_blocks; returns (k, B, 256), the K-PKE
    key-generation and encryption shape (FIPS-203 Algorithms 13-14)."""
    return _plan_for(s).matvec(s, blocks)


def impl_name() -> str:
    return KyberPlan.name

"""Implementation dispatch: which path runs an operation on a parameter set.

The same surface as ``tpu_ntt.dispatch`` (``OPS``, ``best``,
``best_nwc_poly_mult``, ``impl_name``, ``takes_pairs``)::

    mult = tpu_ntt_torch.dispatch.best_nwc_poly_mult(params)
    out = mult(a, b)        # (B, n) torch.int64 residues in, same out

The port serves the ``"nwc"`` product for the moduli and sizes its kernels
cover (``kernels.covers``): trinomial q = 2^a - 2^b + 1 of 31..62 bits at
256 <= n <= 8192, on the CUDA kernel for a CUDA tensor and on the plain
version for a CPU tensor.  Every other op and every other (n, q) raises
``NotImplementedError`` naming its ROADMAP.md item; nothing falls back.
"""

from __future__ import annotations

import functools

import torch

from . import kernels
from .params import GOLDILOCKS_4096, NttParams

#: operations the dispatch layer routes (the same tuple as tpu_ntt.dispatch)
OPS = (
    "nwc",        # negacyclic poly-mult, natural order in/out
    "cyclic",     # INTT(NTT . NTT)
    "fwd",        # cyclic forward NTT
    "inv",        # cyclic inverse NTT (consumes fwd's layout)
    "nwc_fwd",    # psi-twist + forward NTT
    "nwc_inv",    # inverse + untwist + n^-1 (consumes nwc_fwd's layout)
    "spectrum",   # cacheable NWC operand spectrum
    "cached",     # product against a cached spectrum
    "dot",        # INTT(sum_k NTT(a_k).NTT(b_k)): (K, B, n) inputs
    "dot_cached",  # dot against a (K, B, n) stack of cached spectra
    "matvec_spectra",  # precompute spectra of a fixed (k, l, n) poly matrix
    "matvec",     # A @ s: (l, B, n) against matvec_spectra output
)


def _uncovered(p: NttParams) -> str:
    if p.q == GOLDILOCKS_4096.q:
        item = "Q1.6 (Goldilocks, kernel K2)"
    elif p.width <= 30:
        item = "Q1.4 (Ring32 and the 24-bit kernel K3)"
    elif p.width > 62:
        item = "Q1.10 (RNS for moduli above 62 bits)"
    elif p.n > kernels.MAX_N:
        item = "Q1.7 (large n)"
    else:
        item = "Q1.5 (generic q < 2^62 on kernel K1)"
    return (f"no ported path covers {p.name or 'params'} (n={p.n}, q={p.q}) "
            f"yet: ROADMAP.md {item}")


def _require(p: NttParams, op: str):
    """The plan class serving (p, op), or a raise."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if op != "nwc":
        raise NotImplementedError(
            f"op {op!r} is not ported yet: ROADMAP.md Q1.5 (the other entry "
            "points on kernel K1)")
    cls = kernels.covers(p.n, p.q)
    if cls is None:
        raise NotImplementedError(_uncovered(p))
    return cls


@functools.lru_cache(maxsize=None)
def _plan(p: NttParams, device: torch.device):
    return kernels.plan_for(p, device)


def _nwc(p: NttParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _plan(p, a.device).nwc_poly_mult(a, b)


def takes_pairs(p: NttParams) -> bool:
    """Always False where the port serves p: a residue of any q < 2^63 fits
    one int64, so the port never splits it into (hi, lo) uint32 words as the
    JAX package does (``convert.py`` bridges the two).  Goldilocks (q > 2^63)
    is ROADMAP work and decides its own element format."""
    _require(p, "nwc")
    return False


def best(p: NttParams, op: str):
    """The implementation of ``op`` for this parameter set: a callable on
    (B, n) int64 tensors that runs on their device."""
    _require(p, op)
    return functools.partial(_nwc, p)


def best_nwc_poly_mult(p: NttParams):
    """The negacyclic poly-mult for this parameter set."""
    return best(p, "nwc")


def impl_name(p: NttParams, op: str = "nwc") -> str:
    """Which backend serves (p, op) (for logging and tests)."""
    return _require(p, op).name

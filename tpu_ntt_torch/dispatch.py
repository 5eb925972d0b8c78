"""Implementation dispatch: which path runs an operation on a parameter set.

The same surface as ``tpu_ntt.dispatch`` (``OPS``, ``best``, the ``best_*``
helpers, ``impl_name``, ``takes_pairs``)::

    mult = tpu_ntt_torch.dispatch.best_nwc_poly_mult(params)
    out = mult(a, b)        # (B, n) residues in, same out

The port serves the moduli and sizes its kernels cover (``kernels.covers``),
all twelve ops, on the CUDA kernel for a CUDA tensor and on the plain
version for a CPU tensor:

* q < 2^24 at 256 <= n <= 16384, n % 128 == 0 (``kernels.mxu.MxuPlan``),
  on (B, n) ``torch.int32`` residues;
* 30 < width <= 62 at 256 <= n <= 8192 on (B, n) ``torch.int64`` residues:
  a trinomial q = 2^a - 2^b + 1 that the JAX policy sends to its Solinas
  kernel on ``kernels.sol64.SolinasPlan64`` (P60_4096), every other q on
  ``kernels.mxu64.MxuPlan64``;
* the Goldilocks prime 2^64 - 2^32 + 1 at 256 <= n <= 8192 on
  ``kernels.gl64.GoldilocksPlan64`` (GOLDILOCKS_4096), on (B, n)
  ``torch.int64`` tensors holding the residues' 64-bit patterns;
* 30 < width <= 62 (q = 1 mod 2n) and the Goldilocks prime at
  8192 < n <= 2^20 on ``kernels.fourstep64.FourStepPlan64``
  (``cuda-fourstep-64``): the four-step of ``sharded.KernelFourStep`` on
  the same kernels, every op, where JAX runs its flat split-radix plans or
  its kernel four-step.

Spectra come in the serving backend's bit-reversed layout
(``bitrev_to_natural_perm``), and fwd/inv, nwc_fwd/nwc_inv,
spectrum/cached/dot_cached and matvec_spectra/matvec pair within it, as
tpu_ntt/dispatch.py:51-56 says.  A modulus above 62 bits other than
Goldilocks raises ``ValueError``, as JAX's ``best`` does (its ``make_ring``):
no NTT path serves it, RNS channels do.  Every other (n, q) raises
``NotImplementedError`` naming its ROADMAP.md item; nothing falls back.
"""

from __future__ import annotations

import functools

import torch

from . import kernels
from .kernels.fourstep64 import MAX_FOURSTEP_N
from .modmath import GOLDILOCKS_Q
from .params import NttParams

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

#: the plan method that serves each op
METHODS = {
    "nwc": "nwc_poly_mult",
    "cyclic": "cyclic_poly_mult",
    "fwd": "ntt_fwd",
    "inv": "ntt_inv",
    "nwc_fwd": "nwc_ntt_fwd",
    "nwc_inv": "nwc_ntt_inv",
    "spectrum": "nwc_spectrum",
    "cached": "nwc_poly_mult_cached",
    "dot": "nwc_dot",
    "dot_cached": "nwc_dot_cached",
    "matvec_spectra": "nwc_matvec_spectra",
    "matvec": "nwc_matvec_cached",
}


def _uncovered(p: NttParams) -> str:
    if p.width <= 30:
        item = ("Q1.4b (the merged Ring32 route: 24 < width <= 30, and "
                "q < 2^24 outside 256 <= n <= 16384)")
    elif p.n > MAX_FOURSTEP_N:
        item = "Q1.8 (device tables: n above 2^20)"
    else:
        item = ("Q1.4c (the merged Ring64 route: 30 < width <= 62 and "
                "Goldilocks at n < 256)")
    return (f"no ported path covers {p.name or 'params'} (n={p.n}, q={p.q}) "
            f"yet: ROADMAP.md {item}")


def _require(p: NttParams, op: str):
    """The plan class serving (p, op), or a raise."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if p.width > 62 and p.q != GOLDILOCKS_Q:  # JAX's best raises the same type
        raise ValueError(
            f"{p.width}-bit modulus q={p.q} exceeds the 62-bit ring and is not the "
            "Goldilocks prime: no NTT path serves it, RNS channels do (not ported "
            "yet, ROADMAP.md Q1.10)")
    cls = kernels.covers(p.n, p.q)
    if cls is None:
        raise NotImplementedError(_uncovered(p))
    return cls


@functools.lru_cache(maxsize=None)
def _plan(p: NttParams, device: torch.device):
    return kernels.plan_for(p, device)


def _run(p: NttParams, method: str, x: torch.Tensor, *rest) -> torch.Tensor:
    return getattr(_plan(p, x.device), method)(x, *rest)


def takes_pairs(p: NttParams) -> bool:
    """Always False where the port serves p: a residue of any q < 2^63 fits
    one int64 (one int32 below 2^31), and a Goldilocks residue (q > 2^63)
    is one int64 holding its 64-bit pattern, so the port never splits a
    residue into (hi, lo) uint32 words as the JAX package does
    (``convert.py`` bridges the two).  Pairs would double the bytes the
    kernels move and give them nothing: the card multiplies 64-bit words."""
    _require(p, "nwc")
    return False


def best(p: NttParams, op: str):
    """The implementation of ``op`` for this parameter set: a callable that
    runs on the device of its first tensor."""
    _require(p, op)
    return functools.partial(_run, p, METHODS[op])


def best_nwc_poly_mult(p: NttParams):
    """The negacyclic poly-mult for this parameter set."""
    return best(p, "nwc")


def best_cyclic_poly_mult(p: NttParams):
    return best(p, "cyclic")


def best_ntt_fwd(p: NttParams):
    return best(p, "fwd")


def best_ntt_inv(p: NttParams):
    return best(p, "inv")


def best_nwc_ntt_fwd(p: NttParams):
    return best(p, "nwc_fwd")


def best_nwc_ntt_inv(p: NttParams):
    return best(p, "nwc_inv")


def best_nwc_spectrum(p: NttParams):
    return best(p, "spectrum")


def best_nwc_poly_mult_cached(p: NttParams):
    return best(p, "cached")


def best_nwc_dot(p: NttParams):
    """The fused inner product INTT(sum_k NTT(a_k) . NTT(b_k)) for (K, B, n)
    operand stacks: one inverse transform per output."""
    return best(p, "dot")


def best_nwc_dot_cached(p: NttParams):
    """The inner product against a (K, B, n) stack of cached spectra, each
    from ``best_nwc_spectrum``: K forwards and one inverse."""
    return best(p, "dot_cached")


def best_nwc_matvec_spectra(p: NttParams):
    """Spectra of a fixed (k, l, n) polynomial matrix for ``best_nwc_matvec``
    (transform A once at key setup)."""
    return best(p, "matvec_spectra")


def best_nwc_matvec(p: NttParams):
    """A @ s over the polynomial ring: s is (l, B, n), the second argument
    ``best_nwc_matvec_spectra``'s output for the same params; returns
    (k, B, n) with out[i] = sum_j A[i, j] * s[j], in l + k transforms."""
    return best(p, "matvec")


def impl_name(p: NttParams, op: str = "nwc") -> str:
    """Which backend serves (p, op) (for logging and tests)."""
    return _require(p, op).name

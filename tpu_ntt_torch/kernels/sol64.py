"""Every K1 op for Solinas trinomial moduli q = 2^a - 2^b + 1.

The counterpart of ``tpu_ntt.kernels.sol64.SolinasPlan64`` and, as there, a
subclass of ``MxuPlan64``: the headline 60-bit modulus 2^60 - 2^14 + 1 at
256 <= n <= 8192, all twelve ops inherited.  On a CUDA tensor each op
launches its hand-written kernel of ``csrc/nwc64.cu``; on a CPU tensor it
runs its plain version over the same plan, whose integers it matches bit for
bit.  Any other device raises.  ``launches`` is ``MxuPlan64``'s dict.

The CUDA kernels need only an odd q < 2^62.  ``covers_q`` nevertheless
accepts exactly the moduli the JAX plan accepts, by re-running the bound
checks of its shift-add fold (``tpu_ntt.kernels.sol64._FoldPlan``), so that
dispatch routes the same (n, q) cases here as the JAX policy routes there.
"""

from __future__ import annotations

from ..params import NttParams
from .mxu64 import MAX_N, MIN_N, MxuPlan64

_BIAS1 = 1 << 27  # the TPU fold's step-1 lane bias
_BIAS2 = 1 << 24  # the TPU fold's step-3 lane bias


def solinas_exponents(q: int) -> tuple[int, int] | None:
    """(a, b) with q = 2^a - 2^b + 1, or None if q is not of that form."""
    a = q.bit_length()
    for b in range(1, a):
        if (1 << a) - (1 << b) + 1 == q:
            return a, b
    return None


def _fold_terms(a: int, b: int, e: int) -> list[tuple[int, int]]:
    """2^e mod q as [(exponent, coeff)], all exponents < a, coeffs exact."""
    pend, out = [(e, 1)], {}
    while pend:
        ee, s = pend.pop()
        if ee < a:
            out[ee] = out.get(ee, 0) + s
        else:
            pend.append((ee - a + b, s))
            pend.append((ee - a, -s))
    return [(ee, c) for ee, c in sorted(out.items()) if c]


def _lane_terms(a: int, b: int, e: int) -> list[tuple[int, int]]:
    """2^e folded onto the 16-bit digit grid as (lane, signed coeff)."""
    return [(ee // 16, c * (1 << (ee % 16))) for ee, c in _fold_terms(a, b, e)]


def _lane_bound(n: int) -> int:
    """Worst-case |carry-save lane| of the TPU kernel's 8-digit matmul."""
    rows = max(n // 128, 128)
    d = 8 * rows * 128 * 128
    return d + ((1 << 16) - 256) + d // 256 + 1


def _fold_bounds_hold(a: int, b: int, q: int, lane_max: int) -> bool:
    """True iff ``tpu_ntt.kernels.sol64._FoldPlan(a, b, lane_max, q)``
    builds: each check below is one of its ``raise ValueError`` lines."""
    if not 48 <= a <= 62 or lane_max >= _BIAS1:
        return False
    src = [_lane_terms(a, b, 16 * j) for j in range(4, 8)]
    c8_terms = _lane_terms(a, b, 128)
    if any(dst > 3 or abs(c) >= 1 << 31
           for terms in (*src, c8_terms) for dst, c in terms):
        return False
    c = 0
    for _ in range(8):
        t = lane_max + _BIAS1 + c
        if t >= 1 << 32:
            return False
        c = t >> 16
    c8_max = c
    vmax, vmin = [2 * 65535] * 4, [0] * 4
    for scale, terms in [(65535, t) for t in src] + [(c8_max, c8_terms)]:
        for dst, coeff in terms:
            if coeff > 0:
                vmax[dst] += coeff * scale
            else:
                vmin[dst] += coeff * scale
    bias2 = max(_BIAS2, 1 << (-min(vmin)).bit_length())
    if any(v >= (1 << 31) - bias2 for v in vmax) or any(
            v <= -(1 << 31) for v in vmin):
        return False
    c = 0
    for k in range(4):
        t = vmax[k] + bias2 + c
        if t >= 1 << 32:
            return False
        c = t >> 16
    vtop_max = ((1 << 32) - 1 >> (a - 32)) + (c << (64 - a))
    lazy_max = (1 << a) + vtop_max * ((1 << b) - 1)
    return not (lazy_max >= 2 * q or lazy_max >= 1 << 62 or (
        q < (1 << 61) - (1 << 40) and lazy_max >= 1 << 61))


class SolinasPlan64(MxuPlan64):
    """Every K1 op for one trinomial parameter set on one device."""

    name = "cuda-sol64"

    @staticmethod
    def covers_q(q: int, n: int) -> bool:
        """Cheap predicate, the same as the JAX plan's: q is a trinomial
        whose TPU fold bounds verify at size n."""
        ab = solinas_exponents(q)
        if ab is None or not 30 < q.bit_length() <= 62:
            return False
        return _fold_bounds_hold(ab[0], ab[1], q, _lane_bound(n))

    @classmethod
    def covers(cls, n: int, q: int) -> bool:
        """``MxuPlan64``'s window, trinomial q whose fold bounds verify."""
        return MxuPlan64.covers(n, q) and cls.covers_q(q, n)

    def _refusal(self, p: NttParams) -> str:
        return (f"SolinasPlan64 covers trinomial q at {MIN_N} <= n <= {MAX_N}; "
                f"got n={p.n}, q={p.q}")

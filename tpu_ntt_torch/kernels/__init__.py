"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``sol64`` holds the one kernel of the main path: the fused 60-bit negacyclic
product.  The 24-bit, generic 62-bit and Goldilocks kernels of
``tpu_ntt.kernels`` are not ported yet (ROADMAP.md Queue 2), so
``plan_for`` returns ``None`` for their cases.
"""

from __future__ import annotations

from ..params import NttParams
from .sol64 import MAX_N, MIN_N, SolinasPlan64


def covers(n: int, q: int):
    """The plan class ``plan_for`` would build for (n, q), or ``None``:
    a cheap predicate with no table construction."""
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        return None
    if SolinasPlan64.covers_q(q, n):
        return SolinasPlan64
    return None


def plan_for(p: NttParams, device="cpu"):
    """The kernel plan covering this parameter set on ``device``, or
    ``None`` where no ported kernel covers it."""
    cls = covers(p.n, p.q)
    return cls(p, device) if cls is not None else None

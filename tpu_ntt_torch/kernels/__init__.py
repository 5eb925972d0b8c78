"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``mxu`` holds the 24-bit family's kernels (every op, q < 2^24 at
256 <= n <= 16384); ``sol64`` the fused 60-bit negacyclic product for
trinomial moduli.  The generic 62-bit and Goldilocks kernels of
``tpu_ntt.kernels`` are not ported yet (ROADMAP.md Queue 2), so ``plan_for``
returns ``None`` for their cases.
"""

from __future__ import annotations

from ..params import NttParams
from . import sol64
from .mxu import MxuPlan
from .sol64 import SolinasPlan64


def covers(n: int, q: int):
    """The plan class ``plan_for`` would build for (n, q), or ``None``:
    a cheap predicate with no table construction, in the order of
    ``tpu_ntt.kernels.covers``."""
    if n & (n - 1):
        return None
    if MxuPlan.covers(n, q):
        return MxuPlan
    if sol64.MIN_N <= n <= sol64.MAX_N and SolinasPlan64.covers_q(q, n):
        return SolinasPlan64
    return None


def plan_for(p: NttParams, device=None):
    """The kernel plan covering this parameter set on ``device`` (by default
    the current CUDA device), or ``None`` where no ported kernel covers it."""
    cls = covers(p.n, p.q)
    return cls(p, device) if cls is not None else None

"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``mxu`` holds the 24-bit family's kernels (every op, q < 2^24 at
256 <= n <= 16384, ``csrc/nwc32.cu``); ``mxu64`` the 60-bit family's (every
op, 30 < width <= 62 at 256 <= n <= 8192, ``csrc/nwc64.cu``), with
``sol64.SolinasPlan64`` its subclass for the trinomial moduli the JAX policy
sends to its Solinas kernel; ``gl64.GoldilocksPlan64`` the Goldilocks
prime's (every op at 256 <= n <= 8192, ``csrc/gl64.cu``, on wrapped int64
residues); ``kyber.KyberPlan`` the ML-KEM ring's (every op of
``tpu_ntt.kernels.kyber.KyberPlan``, ``csrc/kyber.cu``), whose ring is
fixed, so ``plan_for`` does not serve it: ``tpu_ntt_torch.kyber`` calls it;
``poseidon`` the Poseidon2-GL permutation and sponge (``csrc/poseidon.cu``),
which ``tpu_ntt_torch.poseidon.Poseidon2GL`` calls; ``fourstep64
.FourStepPlan64`` both 64-bit families above n = 8192 (every op at
8192 < n <= 2^20 through ``sharded.KernelFourStep``, on ``csrc/nwc64.cu``
at 30 < width <= 62 and on ``csrc/gl64.cu`` at the Goldilocks prime, whose
row passes are K1a's large-n bodies); ``a2a`` the four-step's stage
exchange between the shards of a mesh axis (kernel K6, ``csrc/a2a.cu``),
which ``sharded.ShardedNtt`` calls.
"""

from __future__ import annotations

from ..modmath import GOLDILOCKS_Q
from ..params import NttParams
from .fourstep64 import FourStepPlan64
from .gl64 import GoldilocksPlan64
from .kyber import KyberPlan
from .mxu import MxuPlan
from .mxu64 import MxuPlan64
from .sol64 import SolinasPlan64


def covers(n: int, q: int):
    """The plan class ``plan_for`` would build for (n, q), or ``None``:
    a cheap predicate with no table construction, in the order of
    ``tpu_ntt.kernels.covers`` (tpu_ntt/kernels/__init__.py:63-79)."""
    if n & (n - 1):
        return None
    if MxuPlan.covers(n, q):
        return MxuPlan
    if q == GOLDILOCKS_Q:
        if GoldilocksPlan64.covers(n, q):
            return GoldilocksPlan64
        return FourStepPlan64 if FourStepPlan64.covers(n, q) else None
    if SolinasPlan64.covers(n, q):
        return SolinasPlan64
    if MxuPlan64.covers(n, q):
        return MxuPlan64
    if FourStepPlan64.covers(n, q):
        return FourStepPlan64
    return None


def plan_for(p: NttParams, device=None):
    """The kernel plan covering this parameter set on ``device`` (by default
    the current CUDA device), or ``None`` where no ported kernel covers it."""
    cls = covers(p.n, p.q)
    return cls(p, device) if cls is not None else None

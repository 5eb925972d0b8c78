"""Batched NTT / INTT / negacyclic polynomial multiplication in plain PyTorch.

The same functions as ``tpu_ntt.ntt`` on (..., n) ``torch.int64`` tensors of
residues in [0, q), natural order, over the port's ``Ring64``.  Every result
is bit-identical to the JAX package's (tests/test_torch_ntt.py).  This is
the plain version each kernel of ``kernels/`` is held against.

Algorithm:
  forward : bit-reverse, then log2(n) constant-geometry CT stages
            A[i] = a[2i] + w*a[2i+1], A[i+n/2] = a[2i] - w*a[2i+1].
  inverse : the same network with omega^-1 twiddles, then scale by n^-1.
  negacyclic multiply: psi-twist inputs, cyclic multiply, psi^-1-untwist.
  merged  : the psi powers folded into a Cooley-Tukey forward (natural in,
            bit-reversed out) and a Gentleman-Sande inverse (bit-reversed
            in, natural out), so a product needs no permutation and no twist.

The no-gather cyclic forms and the ring inverse/division are not ported yet.
"""

from __future__ import annotations

import torch

from . import reference, tables
from .modmath import Ring64
from .params import NttParams, Reduction


def _tw_view(tw, shape):
    """A twiddle table (a tensor, or a Shoup (w, w') pair) viewed as shape."""
    if isinstance(tw, tuple):
        return tuple(t.reshape(shape) for t in tw)
    return tw.reshape(shape)


def _tw_slice(tw, lo: int, hi: int):
    if isinstance(tw, tuple):
        return tuple(t[lo:hi] for t in tw)
    return tw[lo:hi]


class NttPlan:
    """Precomputed tables for one (params, reduction) configuration, held as
    tensors on ``device`` and encoded for the ring's reduction backend."""

    def __init__(self, p: NttParams, reduction: Reduction | None = None,
                 device="cpu"):
        self.p = p
        self.ring = Ring64(p, reduction or Reduction.SHOUP)
        self.device = torch.device(device)
        n, q = p.n, p.q
        self.n = n
        self.log_n = p.log_n

        def enc(values):
            return self.ring.encode_tw(values, self.device)

        perm = reference.bit_reverse_permutation(n)
        self.bitrev = torch.tensor(perm, dtype=torch.int64, device=self.device)

        fwd = tables.stage_twiddles(n, p.omega, q)
        inv = tables.stage_twiddles(n, p.omega_inv, q)
        self.stage_tw = [enc(list(fwd[s])) for s in range(self.log_n)]
        self.stage_tw_inv = [enc(list(inv[s])) for s in range(self.log_n)]
        psi_pows = tables.psi_powers(p)
        psi_inv_pows = tables.psi_inv_powers(p)
        self.psi_pows = enc(psi_pows)
        self.psi_inv_pows = enc(psi_inv_pows)
        self.n_inv_tw = enc([p.n_inv])

        # Merged-psi tables: psi powers in bit-reversed index order.  The
        # stage with m butterfly groups reads entries [m, 2m), so one flat
        # table serves every stage (the CUDA kernel indexes it as m + group).
        self.merged_flat = enc([psi_pows[j] for j in perm])
        self.merged_inv_flat = enc([psi_inv_pows[j] for j in perm])
        self.merged_tw = [_tw_slice(self.merged_flat, 1 << s, 2 << s)
                          for s in range(self.log_n)]
        self.merged_tw_inv = [_tw_slice(self.merged_inv_flat, 1 << s, 2 << s)
                              for s in range(self.log_n)]


# ---------------------------------------------------------------------------
# Constant-geometry cyclic transforms
# ---------------------------------------------------------------------------


def _butterfly_stage(ring, x: torch.Tensor, tw) -> torch.Tensor:
    """One CG stage over the last axis: (..., n) -> (..., n)."""
    even, odd = x[..., 0::2], x[..., 1::2]
    t = ring.mul_tw(odd, tw)
    return torch.cat([ring.add(even, t), ring.sub(even, t)], dim=-1)


def _transform(plan: NttPlan, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    ring = plan.ring
    x = x[..., plan.bitrev]
    tw_list = plan.stage_tw_inv if inverse else plan.stage_tw
    for s in range(plan.log_n):
        x = _butterfly_stage(ring, x, tw_list[s])
    if inverse:
        x = ring.mul_tw(x, plan.n_inv_tw)
    return x


def ntt_fwd(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Cyclic forward NTT over the last axis (natural order in and out)."""
    return _transform(plan, x, inverse=False)


def ntt_inv(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Cyclic inverse NTT (forward network with omega^-1, then n^-1 scale)."""
    return _transform(plan, x, inverse=True)


def pointwise_mul(plan: NttPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Transform-domain coefficientwise product."""
    return plan.ring.mul(a, b)


def cyclic_poly_mult(plan: NttPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """INTT(NTT(a) ⊙ NTT(b))."""
    return ntt_inv(plan, pointwise_mul(plan, ntt_fwd(plan, a), ntt_fwd(plan, b)))


def twist(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """x_i <- x_i * psi^i (negacyclic pre-twist)."""
    return plan.ring.mul_tw(x, plan.psi_pows)


def untwist(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """x_i <- x_i * psi^-i (negacyclic post-twist)."""
    return plan.ring.mul_tw(x, plan.psi_inv_pows)


def nwc_poly_mult(plan: NttPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negacyclic polynomial product mod (x^n + 1, q)."""
    return untwist(plan, cyclic_poly_mult(plan, twist(plan, a), twist(plan, b)))


# ---------------------------------------------------------------------------
# Merged-psi negacyclic transforms (no twist pass, no bit-reverse gather)
# ---------------------------------------------------------------------------


def _stage_view(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (groups, 2, x.shape[-1] // (2 * groups)))


def nwc_fwd_merged(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward transform: NTT(psi-twisted x) in bit-reversed
    order, computed with merged twiddles (CT butterflies, NO -> BO)."""
    ring = plan.ring
    for s in range(plan.log_n):
        m = 1 << s  # butterfly groups this stage
        g = _stage_view(x, m)
        u = g[..., 0, :]
        v = ring.mul_tw(g[..., 1, :], _tw_view(plan.merged_tw[s], (m, 1)))
        x = torch.stack([ring.add(u, v), ring.sub(u, v)], dim=-2).reshape(x.shape)
    return x


def nwc_inv_merged(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse of nwc_fwd_merged (GS butterflies, BO -> NO), including the
    n^-1 scale and the psi^-1 untwist (both folded into the twiddles)."""
    ring = plan.ring
    for s in range(plan.log_n - 1, -1, -1):
        h = 1 << s
        g = _stage_view(x, h)
        u, v = g[..., 0, :], g[..., 1, :]
        lo = ring.mul_tw(ring.sub(u, v), _tw_view(plan.merged_tw_inv[s], (h, 1)))
        x = torch.stack([ring.add(u, v), lo], dim=-2).reshape(x.shape)
    return ring.mul_tw(x, plan.n_inv_tw)


def nwc_poly_mult_merged(plan: NttPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negacyclic product via the merged-twiddle path — same result as
    nwc_poly_mult, bit-exact, with no permutation or twist passes."""
    fa = nwc_fwd_merged(plan, a)
    fb = nwc_fwd_merged(plan, b)
    return nwc_inv_merged(plan, plan.ring.mul(fa, fb))

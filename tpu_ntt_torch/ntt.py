"""Batched NTT / INTT / negacyclic polynomial multiplication in plain PyTorch.

The same functions as ``tpu_ntt.ntt`` on (..., n) tensors of residues in
[0, q), natural order, over the ring ``modmath.make_ring`` picks: int32
elements for q < 2^30 (``Ring32``), int64 above (``Ring64``).  Every result
is bit-identical to the JAX package's (tests/test_torch_ntt.py,
tests/test_torch_kernels_mxu.py).  These are the plain versions the kernels
of ``kernels/`` are held against.

Algorithm:
  forward : bit-reverse, then log2(n) constant-geometry CT stages
            A[i] = a[2i] + w*a[2i+1], A[i+n/2] = a[2i] - w*a[2i+1].
  inverse : the same network with omega^-1 twiddles, then scale by n^-1.
  negacyclic multiply: psi-twist inputs, cyclic multiply, psi^-1-untwist.
  merged  : the psi powers folded into a Cooley-Tukey forward (natural in,
            bit-reversed out) and a Gentleman-Sande inverse (bit-reversed
            in, natural out), so a product needs no permutation and no twist.
  bitrev  : the cyclic transform on the same two networks, natural in and
            bit-reversed out (the output of ``tpu_ntt.ntt.ntt_fwd_nogather``)
            and back.  The stage with m groups takes omega^(brv_s(g) n/2m) =
            psi^(brv_n(g)) for group g: the first m entries of the merged
            table, where the negacyclic stage takes the next m.

The ring inverse/division and the no-gather DIF network are not ported yet.
"""

from __future__ import annotations

import functools

import torch

from . import reference, tables
from .modmath import make_ring
from .params import NttParams, Reduction


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None, or "cuda" without an index,
    is the current CUDA device, resolved now.  The port's plans live on the
    card unless the caller asks for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


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
    tensors on ``device`` (by default the current CUDA device) and encoded
    for the ring's reduction backend."""

    def __init__(self, p: NttParams, reduction: Reduction | None = None,
                 device=None):
        self.p = p
        self.ring = make_ring(p, reduction)
        self.device = resolve_device(device)
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
        brv = [psi_pows[j] for j in perm]
        brv_inv = [psi_inv_pows[j] for j in perm]
        self.merged_flat = enc(brv)
        self.merged_inv_flat = enc(brv_inv)
        self.merged_tw = [_tw_slice(self.merged_flat, 1 << s, 2 << s)
                          for s in range(self.log_n)]
        self.merged_tw_inv = [_tw_slice(self.merged_inv_flat, 1 << s, 2 << s)
                              for s in range(self.log_n)]

    # Cyclic tables in the merged tables' flat layout: entry m + g is the
    # merged table's entry g (entry 0 is unused), so the kernels index both
    # kinds alike.  Only the bitrev transforms and the 24-bit kernels take
    # them, so they are built on first use.

    def _cyclic_table(self, pows: list[int]):
        brv = [pows[j] for j in reference.bit_reverse_permutation(self.n)]
        return self.ring.encode_tw(
            [1] + [v for s in range(self.log_n) for v in brv[:1 << s]], self.device)

    @functools.cached_property
    def cyclic_flat(self):
        return self._cyclic_table(tables.psi_powers(self.p))

    @functools.cached_property
    def cyclic_inv_flat(self):
        return self._cyclic_table(tables.psi_inv_powers(self.p))

    @functools.cached_property
    def cyclic_tw(self):
        return [_tw_slice(self.cyclic_flat, 1 << s, 2 << s) for s in range(self.log_n)]

    @functools.cached_property
    def cyclic_tw_inv(self):
        return [_tw_slice(self.cyclic_inv_flat, 1 << s, 2 << s)
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


def _ct_forward(plan: NttPlan, x: torch.Tensor, stage_tw) -> torch.Tensor:
    """Cooley-Tukey stages, natural in, bit-reversed out; stage s has
    m = 2^s groups and takes stage_tw[s][g] for group g."""
    ring = plan.ring
    for s in range(plan.log_n):
        m = 1 << s  # butterfly groups this stage
        g = _stage_view(x, m)
        u = g[..., 0, :]
        v = ring.mul_tw(g[..., 1, :], _tw_view(stage_tw[s], (m, 1)))
        x = torch.stack([ring.add(u, v), ring.sub(u, v)], dim=-2).reshape(x.shape)
    return x


def _gs_inverse(plan: NttPlan, x: torch.Tensor, stage_tw) -> torch.Tensor:
    """Gentleman-Sande stages undoing ``_ct_forward``, then the n^-1 scale."""
    ring = plan.ring
    for s in range(plan.log_n - 1, -1, -1):
        h = 1 << s
        g = _stage_view(x, h)
        u, v = g[..., 0, :], g[..., 1, :]
        lo = ring.mul_tw(ring.sub(u, v), _tw_view(stage_tw[s], (h, 1)))
        x = torch.stack([ring.add(u, v), lo], dim=-2).reshape(x.shape)
    return ring.mul_tw(x, plan.n_inv_tw)


def nwc_fwd_merged(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward transform: NTT(psi-twisted x) in bit-reversed
    order, computed with merged twiddles (CT butterflies, NO -> BO)."""
    return _ct_forward(plan, x, plan.merged_tw)


def nwc_inv_merged(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse of nwc_fwd_merged (GS butterflies, BO -> NO), including the
    n^-1 scale and the psi^-1 untwist (both folded into the twiddles)."""
    return _gs_inverse(plan, x, plan.merged_tw_inv)


def ntt_fwd_bitrev(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Cyclic forward NTT, natural in, bit-reversed out (position j holds
    X[bitrev(j)]): the integers of ``tpu_ntt.ntt.ntt_fwd_nogather``."""
    return _ct_forward(plan, x, plan.cyclic_tw)


def ntt_inv_bitrev(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Cyclic inverse NTT of a bit-reversed spectrum, natural out, n^-1
    applied: the integers of ``tpu_ntt.ntt.ntt_inv_nogather``."""
    return _gs_inverse(plan, x, plan.cyclic_tw_inv)


def nwc_poly_mult_merged(plan: NttPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negacyclic product via the merged-twiddle path — same result as
    nwc_poly_mult, bit-exact, with no permutation or twist passes."""
    fa = nwc_fwd_merged(plan, a)
    fb = nwc_fwd_merged(plan, b)
    return nwc_inv_merged(plan, plan.ring.mul(fa, fb))

"""Bridge between the JAX package's element layout and the port's.

``tpu_ntt`` holds a 64-bit residue as a (hi, lo) pair of uint32 arrays
(``tpu_ntt.dispatch`` splits a (B, n) uint64 array that way); the port holds
one (B, n) ``torch.int64`` tensor.  These functions take numpy arrays only,
so they import no JAX: a test hands them what the JAX package returned.
"""

from __future__ import annotations

import numpy as np
import torch


def pairs_to_int64(hi, lo, device=None) -> torch.Tensor:
    """(hi, lo) uint32 numpy arrays -> int64 tensor with the same 64-bit
    patterns (a value >= 2^63 comes out as its wrapped int64)."""
    hi = np.asarray(hi).astype(np.uint64)
    lo = np.asarray(lo).astype(np.uint64)
    return torch.from_numpy(((hi << np.uint64(32)) | lo).view(np.int64)).to(device)


def int64_to_pairs(x: torch.Tensor):
    """int64 tensor -> (hi, lo) uint32 numpy arrays."""
    v = x.detach().cpu().numpy().view(np.uint64)
    return ((v >> np.uint64(32)).astype(np.uint32),
            (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _table(enc, device):
    """One encoded JAX table: a (hi, lo) pair, or for SHOUP the pair of
    pairs ((w_hi, w_lo), (ws_hi, ws_lo)) -> a tensor or a (w, ws) tuple."""
    if isinstance(enc[0], tuple):
        return tuple(pairs_to_int64(*e, device=device) for e in enc)
    return pairs_to_int64(*enc, device=device)


def tables_from_jax(plan, device=None) -> dict:
    """The tables of a ``tpu_ntt.ntt.NttPlan`` over ``Ring64``, in the form
    the port's ``NttPlan`` holds them, keyed by the port's attribute names."""
    out = {
        "bitrev": torch.from_numpy(np.asarray(plan.bitrev, dtype=np.int64)).to(device),
        "psi_pows": _table(plan.psi_pows, device),
        "psi_inv_pows": _table(plan.psi_inv_pows, device),
        "n_inv_tw": _table(plan.n_inv_tw, device),
    }
    for name in ("stage_tw", "stage_tw_inv", "merged_tw", "merged_tw_inv"):
        out[name] = [_table(t, device) for t in getattr(plan, name)]
    return out

"""tpu_ntt_torch: the PyTorch + CUDA port of tpu_ntt.

Batched negacyclic polynomial multiplication mod (x^n + 1, q) on an NVIDIA
Hopper card.  This slice serves the headline product: trinomial 60-bit
moduli (P60_4096: q = 2^60 - 2^14 + 1) at 256 <= n <= 8192, through a
hand-written CUDA kernel on CUDA tensors and its plain PyTorch version on
CPU tensors.  Elements are (B, n) ``torch.int64`` residues in [0, q).

    from tpu_ntt_torch import P60_4096, best_nwc_poly_mult
    c = best_nwc_poly_mult(P60_4096)(a, b)

The package imports ``torch`` and never ``jax`` or ``tpu_ntt``.
"""

from .dispatch import OPS, best, best_nwc_poly_mult, impl_name, takes_pairs
from .ntt import NttPlan, nwc_poly_mult, nwc_poly_mult_merged
from .params import PRESETS, P60_4096, NttParams, Reduction, make_params

__all__ = [
    "OPS", "best", "best_nwc_poly_mult", "impl_name", "takes_pairs",
    "NttPlan", "nwc_poly_mult", "nwc_poly_mult_merged",
    "PRESETS", "P60_4096", "NttParams", "Reduction", "make_params",
]

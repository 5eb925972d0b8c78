"""tpu_ntt_torch: the PyTorch + CUDA port of tpu_ntt.

Batched polynomial arithmetic mod (x^n + 1, q) on an NVIDIA Hopper card,
through hand-written CUDA kernels on CUDA tensors and their plain PyTorch
versions on CPU tensors.  This much is ported:

* the 24-bit family (q < 2^24 at 256 <= n <= 16384: P24_4096, P24_1024,
  DILITHIUM_256, FALCON_512, FALCON_1024), every dispatch op, on (B, n)
  ``torch.int32`` residues in [0, q);
* the 60-bit family (any q of 31 to 62 bits at 256 <= n <= 8192:
  P60_4096's trinomial 2^60 - 2^14 + 1 and generic primes alike; above,
  up to 2^20 where q = 1 mod 2n, on the four-step), every dispatch op, on
  (B, n) ``torch.int64`` residues;
* ML-KEM (FIPS 203, q = 3329, n = 256), every entry point of
  ``tpu_ntt.kyber``, in ``tpu_ntt_torch.kyber`` on (B, 256) ``torch.int32``
  residues;
* the Goldilocks field q = 2^64 - 2^32 + 1 at 256 <= n <= 2^20
  (GOLDILOCKS_4096; the four-step above 8192), every dispatch op, on
  (B, n) ``torch.int64`` tensors holding the residues' 64-bit patterns
  (``modmath``'s docstring);
* the STARK commitment path over it: Poseidon2-GL permutations, sponges and
  Merkle trees (``tpu_ntt_torch.poseidon``), the coset LDE and FRI prover
  and verifier (``tpu_ntt_torch.stark``), on the kernels up to N = 2^20.
* the mesh: ``tpu_ntt_torch.sharded``'s ``shard_batch``/``batch_pjit``
  (data parallelism) and ``ShardedNtt``, the four-step sharded over one
  mesh axis with its stage exchange on ``kernels/csrc/a2a.cu`` (kernel
  K6); a mesh is an array of torch devices driven by one process, by
  default D logical shards of one card.

    from tpu_ntt_torch import P60_4096, best_nwc_poly_mult, kyber
    c = best_nwc_poly_mult(P60_4096)(a, b)
    d = kyber.poly_mult(x, y)
    plan = stark.LdePlan(1024, GOLDILOCKS_4096.q, 8, order="kernel")
    evals = plan.extend(coeffs)

The package imports ``torch`` and never ``jax`` or ``tpu_ntt``.
"""

from . import kyber, poseidon, sharded, stark
from .dispatch import (
    OPS, best, best_cyclic_poly_mult, best_ntt_fwd, best_ntt_inv, best_nwc_dot,
    best_nwc_dot_cached, best_nwc_matvec, best_nwc_matvec_spectra,
    best_nwc_ntt_fwd, best_nwc_ntt_inv, best_nwc_poly_mult,
    best_nwc_poly_mult_cached, best_nwc_spectrum, impl_name, takes_pairs)
from .modmath import GoldilocksRing, Ring32, Ring64, make_ring
from .ntt import NttPlan, nwc_poly_mult, nwc_poly_mult_merged
from .params import (
    DILITHIUM_256, FALCON_512, FALCON_1024, GOLDILOCKS_4096, P24_1024, P24_4096,
    P60_4096, PRESETS, NttParams, Reduction, make_params)

__all__ = [
    "OPS", "best", "best_cyclic_poly_mult", "best_ntt_fwd", "best_ntt_inv",
    "best_nwc_dot", "best_nwc_dot_cached", "best_nwc_matvec",
    "best_nwc_matvec_spectra", "best_nwc_ntt_fwd", "best_nwc_ntt_inv",
    "best_nwc_poly_mult", "best_nwc_poly_mult_cached", "best_nwc_spectrum",
    "impl_name", "takes_pairs", "kyber", "poseidon", "sharded", "stark",
    "GoldilocksRing", "Ring32", "Ring64", "make_ring",
    "NttPlan", "nwc_poly_mult", "nwc_poly_mult_merged",
    "DILITHIUM_256", "FALCON_512", "FALCON_1024", "GOLDILOCKS_4096", "P24_1024",
    "P24_4096",
    "P60_4096", "PRESETS", "NttParams", "Reduction", "make_params",
]

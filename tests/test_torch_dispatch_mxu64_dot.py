"""The 60-bit slice end to end at n = 256: ``tpu_ntt_torch.dispatch``
against ``tpu_ntt.dispatch``, the ops on stacks of rows.

The same operands, from ``numpy.random.default_rng`` with rows of 0, 1 and
q - 1, go to ``tpu_ntt.dispatch.best(p, op)`` (at n = 256 the Solinas Pallas
kernels in interpret mode on the CPU) and to the port's ``best`` on CPU
tensors, for the trinomial q = 2^60 - 2^14 + 1: the dot of K = 2 pairs,
fresh and against cached spectra, the matvec spectra of a 2 x 2 matrix
(JAX's blocks compared through ``convert.matvec_spectra64_from_jax``) and
the matvec against them.  Cached spectra and blocks are each package's own.
Tolerance: none — exact integer equality.
"""

import numpy as np
import pytest
import torch

import tpu_ntt.dispatch as jdispatch
import tpu_ntt.params as jparams
from tpu_ntt_torch import dispatch
from tpu_ntt_torch.convert import matvec_spectra64_from_jax, pairs_to_int64
from tpu_ntt_torch.params import P60_4096, make_params

N = 256
Q = P60_4096.q  # 2^60 - 2^14 + 1
P, JP = make_params(N, Q), jparams.make_params(N, Q)


def residues(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint64)
    rows = x.reshape(-1, N)
    rows[0] = np.roll(np.resize(np.array([0, 1, Q - 1], np.uint64), N), seed)
    rows[1] = Q - 1 if seed % 2 else 0
    return x


def port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def from_jax(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


def run_both(op: str):
    """(port result, JAX result) for one op, as int64 tensors."""
    A, s = residues((2, 2, N), 3), residues((2, 3, N), 4)
    jbest, tbest = jdispatch.best(JP, op), dispatch.best(P, op)
    if op == "dot":
        return tbest(port(A), port(s[:, :2])), from_jax(jbest(A, s[:, :2]))
    if op == "dot_cached":
        flat = s[:, :2].reshape(-1, N)
        tspec = dispatch.best(P, "spectrum")(port(flat)).reshape(2, 2, N)
        jspec = tuple(np.asarray(w).reshape(2, 2, N)
                      for w in jdispatch.best(JP, "spectrum")(flat))
        return tbest(port(A), tspec), from_jax(jbest(A, jspec))
    if op == "matvec_spectra":  # blocks: compare the spectra they hold
        return tbest(port(A)), matvec_spectra64_from_jax(jbest(A), N)
    assert op == "matvec"
    tblocks = dispatch.best(P, "matvec_spectra")(port(A))
    jblocks = jdispatch.best(JP, "matvec_spectra")(A)
    return tbest(port(s), tblocks), from_jax(jbest(s, jblocks))


@pytest.mark.parametrize("op", ["dot", "dot_cached", "matvec_spectra", "matvec"])
def test_best_matches_jax_dispatch_at_n256(op):
    got, want = run_both(op)
    assert got.shape == want.shape and torch.equal(got, want), op

"""The 60-bit slice end to end at n = 256: ``tpu_ntt_torch.dispatch``
against ``tpu_ntt.dispatch``, the one-row ops.

The same operands, from ``numpy.random.default_rng`` with rows of 0, 1 and
q - 1, go to ``tpu_ntt.dispatch.best(p, op)`` (at n = 256 the Solinas Pallas
kernel in interpret mode on the CPU) and to the port's ``best`` on CPU
tensors, for the trinomial q = 2^60 - 2^14 + 1: the products, the four
transforms, the spectrum (which checks the Montgomery-64 domain of the
trinomial class) and the product against it.  Spectra are compared in
natural order through each backend's layout map; a spectrum fed to an
inverse is one natural-order array given to each backend in its own layout;
cached spectra are each package's own.  The dot and the matvec are in
``test_torch_dispatch_mxu64_dot.py``, P60_4096 in
``test_torch_dispatch_mxu64_p60.py``.  Also: which backend serves each op
and each class of q, and that the port's ``best`` is its plan's method.
Tolerance: none — exact integer equality.
"""

import functools

import numpy as np
import pytest
import torch

import tpu_ntt.dispatch as jdispatch
import tpu_ntt.params as jparams
from tpu_ntt.kernels.sol64 import SolinasPlan64 as JaxSolinasPlan64
from tpu_ntt_torch import dispatch, kernels
from tpu_ntt_torch.convert import pairs_to_int64
from tpu_ntt_torch.kernels.mxu64 import MxuPlan64
from tpu_ntt_torch.kernels.sol64 import SolinasPlan64
from tpu_ntt_torch.params import P60_4096, make_params

N = 256
Q = P60_4096.q  # 2^60 - 2^14 + 1
Q_GENERIC = 576460752308273153  # bench.py:35, not a trinomial
P, JP = make_params(N, Q), jparams.make_params(N, Q)
ONE_ROW = ("nwc", "cyclic", "fwd", "inv", "nwc_fwd", "nwc_inv", "spectrum", "cached")


def residues(shape, seed: int, q: int = Q) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, size=shape, dtype=np.uint64)
    rows = x.reshape(-1, N)
    rows[0] = np.roll(np.resize(np.array([0, 1, q - 1], np.uint64), N), seed)
    rows[1] = q - 1 if seed % 2 else 0
    return x


def port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int64))


def from_jax(out) -> torch.Tensor:
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


@functools.lru_cache(maxsize=None)
def jax_perm() -> np.ndarray:
    return JaxSolinasPlan64(JP).fourstep_to_natural_perm()


@functools.lru_cache(maxsize=None)
def port_plan():
    return kernels.plan_for(P, "cpu")


def run_both(op: str):
    """(port result, JAX result) for one op, int64 tensors in comparable
    order."""
    a, b = residues((2, N), 1), residues((2, N), 2)
    jbest, tbest = jdispatch.best(JP, op), dispatch.best(P, op)
    if op in ("nwc", "cyclic"):
        return tbest(port(a), port(b)), from_jax(jbest(a, b))
    if op in ("fwd", "nwc_fwd", "spectrum"):
        return (port_plan().bitrev_to_natural(tbest(port(a))),
                from_jax(jbest(a))[..., jax_perm()])
    if op in ("inv", "nwc_inv"):
        nat = residues((2, N), 5)
        jin = nat[..., np.argsort(jax_perm())]
        return tbest(port_plan().natural_to_bitrev(port(nat))), from_jax(jbest(jin))
    assert op == "cached"
    tspec = dispatch.best(P, "spectrum")(port(b))
    jspec = jdispatch.best(JP, "spectrum")(b)
    return tbest(port(a), tspec), from_jax(jbest(a, jspec))


@pytest.mark.parametrize("op", ONE_ROW)
def test_best_matches_jax_dispatch_at_n256(op):
    got, want = run_both(op)
    assert got.shape == want.shape and torch.equal(got, want), op


@pytest.mark.parametrize("q,name,jax_name", [
    (Q, SolinasPlan64.name, "pallas-sol64"),
    (Q_GENERIC, MxuPlan64.name, "pallas-mxu64"),
])
def test_every_op_is_served_by_its_class(q, name, jax_name):
    """The port serves each op where the JAX policy runs kernel K1, on the
    port's class of the same name, and ``best`` runs that plan's method."""
    p = make_params(N, q)
    jp = jparams.make_params(N, q)
    assert jdispatch.impl_name(jp) == jax_name
    assert dispatch.takes_pairs(p) is False
    plan = kernels.plan_for(p, "cpu")
    assert type(plan).name == name
    a = port(residues((2, N), 6, q))
    for op in dispatch.OPS:
        assert dispatch.impl_name(p, op) == name, op
        assert callable(getattr(plan, dispatch.METHODS[op])), op
    assert torch.equal(dispatch.best(p, "nwc")(a, a), plan.nwc_poly_mult_plain(a, a))
    assert torch.equal(dispatch.best(p, "nwc_fwd")(a), plan.nwc_ntt_fwd_plain(a))

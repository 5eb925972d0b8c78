"""``ShardedNtt`` over the port's ``KernelFourStep`` (the sub-plan kernels,
plain on CPU shards) and kernel K6's binding.

* At a 60-bit q (n = 1024, 32 x 32, 8 shards on one coeff axis) and at
  Goldilocks (32 x 32 on a 2 x 4 batch x coeff mesh) against JAX's
  ``ShardedNtt`` on its XLA locals (JAX's ``KernelFourStep`` is never run
  here: Pallas interpret mode at 256 x 256 takes minutes): the product in
  natural order, the cyclic spectrum through both ``spectrum_indices``
  maps, and the cacheable spectrum, which the port keeps in the row plan's
  domain (times 2^64 mod q at 60 bits, plain for Goldilocks).
* Every op gathered equal, bit for bit, to the port's single-device chain
  (``fourstep_*_kernel``), with ``fused_exchange`` True and False.
* ``csrc/a2a.cu``'s C signatures against ``kernels/a2a.py``'s bindings.
* The refusals: D not dividing n1 or n2, mixed devices, a device that is
  neither CPU nor CUDA, an element split the wrong way.

Operands hold 0, 1 and q - 1 (for Goldilocks also 2^63 - 1, 2^63 and
2^64 - 2^32).  Tolerance: none, exact integer equality.
"""

import ctypes
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import tpu_ntt.params as jparams
from tpu_ntt import sharded as jsharded
from tpu_ntt_torch import convert, sharded
from tpu_ntt_torch.kernels import _build, a2a
from tpu_ntt_torch.modmath import GOLDILOCKS_Q
from tpu_ntt_torch.params import make_params

Q60 = 576460752308273153  # bench.py:35
EDGES = {Q60: [0, 1, Q60 - 1],
         GOLDILOCKS_Q: [0, 1, GOLDILOCKS_Q - 1, (1 << 63) - 1, 1 << 63, (1 << 64) - (1 << 32)]}
CASES = {  # q, JAX mesh shape and names, batch axis
    "w60_8": (Q60, (8,), ("coeff",), None),
    "goldilocks_2x4": (GOLDILOCKS_Q, (2, 4), ("batch", "coeff"), "batch"),
}


def operands(q: int, shape, seed: int) -> np.ndarray:
    """uint64 residues of (..., 32, 32) elements: the first cycles the
    boundary values, the last is all q - 1."""
    x = np.random.default_rng(seed).integers(0, q, size=shape, dtype=np.uint64)
    rows = x.reshape(-1, 1024)
    rows[0] = np.resize(np.array(EDGES[q], dtype=np.uint64), 1024)
    rows[-1] = q - 1
    return x


def pairs(x: np.ndarray):
    return (x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32)


def flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, 1024)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_locals_match_jax_xla_locals(case):
    q, shape, names, batch_axis = CASES[case]
    p = make_params(1024, q)
    jsn = jsharded.ShardedNtt(jsharded.FourStepPlan(jparams.make_params(1024, q), 32, 32),
                              JaxMesh(np.array(jax.devices()[:8]).reshape(shape), names),
                              batch_axis=batch_axis)
    a, b = operands(q, (2, 32, 32), 1), operands(q, (2, 32, 32), 2)
    ja, jb = (jsn.put_natural(pairs(x)) for x in (a, b))
    want = {"nwc": jsn.nwc_poly_mult(ja, jb), "fwd": jsn.ntt_fwd(ja),
            "spectrum": jsn.nwc_spectrum(jb)}
    want = {k: flat(convert.shards_from_jax(v, device="cpu").gather()) for k, v in want.items()}
    fs = sharded.KernelFourStep(p, 32, 32, "cpu")
    to_natural = np.argsort(fs.spectrum_indices().reshape(-1))
    jax_to_natural = np.argsort(jsn.fs.spectrum_indices().reshape(-1))
    r = (1 << 64) % q if q != GOLDILOCKS_Q else 1  # the row plan's cached domain
    spectrum = want["spectrum"][:, jax_to_natural].numpy().view(np.uint64).astype(object)
    spectrum = torch.from_numpy((spectrum * r % q).astype(np.uint64).view(np.int64))
    for fused in (False, True):
        sn = sharded.ShardedNtt(fs, sharded.make_mesh(shape, names, "cpu"),
                                batch_axis=batch_axis, fused_exchange=fused)
        pa, pb = (convert.shards_from_jax(x, device="cpu") for x in (ja, jb))
        assert torch.equal(flat(sn.nwc_poly_mult(pa, pb).gather()), want["nwc"])
        assert torch.equal(flat(sn.ntt_fwd(pa).gather())[:, to_natural],
                           want["fwd"][:, jax_to_natural])
        assert torch.equal(flat(sn.nwc_spectrum(pb).gather())[:, to_natural], spectrum)


@pytest.mark.parametrize("q", [Q60, GOLDILOCKS_Q])
def test_sharded_ops_equal_the_single_device_chain(q):
    """The eight ops on 8 shards (a 1-D coeff mesh, B = 2) gathered: the
    single-device four-step's results, bit for bit, with either exchange."""
    p = make_params(1024, q)
    fs = sharded.KernelFourStep(p, 32, 32, "cpu")
    a, b = (torch.from_numpy(operands(q, (2, 2, 1024), s).view(np.int64)) for s in (3, 4))
    prod = [sharded.fourstep_nwc_poly_mult_kernel(fs, x, y) for x, y in zip(a, b)]
    want = {
        "nwc": prod[0], "cyclic": sharded.fourstep_nwc_poly_mult_kernel(fs, a[0], b[0], False),
        "fwd": sharded.fourstep_fwd_kernel(fs, a[0]),
        "spectrum": sharded.fourstep_fwd_kernel(fs, b[0], True, True),
        "dot": fs.ring.add(prod[0], prod[1]),
    }
    for fused in (False, True):
        sn = sharded.ShardedNtt(fs, sharded.make_mesh((8,), ("coeff",), "cpu"),
                                fused_exchange=fused)
        pa, pb = (sn.put_natural(x[0].reshape(2, 32, 32)) for x in (a, b))
        pa2, pb2 = (sn.put_natural(x.reshape(2, 2, 32, 32), stacked=True) for x in (a, b))
        got = {"nwc": sn.nwc_poly_mult(pa, pb), "cyclic": sn.cyclic_poly_mult(pa, pb),
               "fwd": sn.ntt_fwd(pa), "spectrum": sn.nwc_spectrum(pb),
               "dot": sn.nwc_dot(pa2, pb2)}
        for op, x in got.items():
            assert torch.equal(flat(x.gather()), want[op]), (op, fused)
        assert torch.equal(flat(sn.ntt_inv(got["fwd"]).gather()), a[0])
        assert torch.equal(flat(sn.nwc_poly_mult_cached(pa, got["spectrum"]).gather()),
                           want["nwc"])
        spectra = sharded.shard(sn.mesh, sn.spec_fourstep(stacked=True), torch.stack(
            [sn.nwc_spectrum(sn.put_natural(x.reshape(2, 32, 32))).gather() for x in b]))
        assert torch.equal(flat(sn.nwc_dot_cached(pa2, spectra).gather()), want["dot"])
        single = sn.nwc_poly_mult(*(sn.put_natural(x[0, 0].reshape(32, 32), batched=False)
                                    for x in (a, b)), batched=False)
        assert single.shape == (32, 32) and torch.equal(flat(single.gather()), prod[0][:1])


def test_load_binds_the_c_signatures_of_a2a_cu(monkeypatch):
    """The entry points ``load`` types have the C names, argument counts and
    types of ``csrc/a2a.cu``'s, the ``Peers`` struct passed by value with
    its 16 pointers."""
    bound = {}
    monkeypatch.setattr(a2a._plan, "bind", lambda name, argtypes: bound.update(argtypes))
    a2a.load.__wrapped__()
    source = (_build.CSRC / "a2a.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (a2a_\w+)\(([^)]*)\)', source))
    assert sorted(decls) == sorted(f"a2a_{k}" for k in bound)
    assert "a2a_exchange" in decls and a2a.KERNELS == ("a2a_exchange",)
    assert f"kMaxPeers = {a2a.MAX_PEERS};" in source
    c_types = {"int": ctypes.c_int, "Peers": a2a.Peers}
    for suffix, types_ in bound.items():
        params = [s.strip() for s in decls[f"a2a_{suffix}"].split(",")]
        assert len(params) == len(types_), suffix
        for param, ty in zip(params, types_):
            want = ctypes.c_void_p if "*" in param else c_types[param.rsplit(" ", 1)[0]]
            assert ty is want, (suffix, param)
    assert [f[0] for f in a2a.Peers._fields_] == ["dst"]
    assert ctypes.sizeof(a2a.Peers) == a2a.MAX_PEERS * ctypes.sizeof(ctypes.c_void_p)


def test_sharded_ntt_refusals():
    fs = sharded.FourStepPlan(make_params(1024, Q60), 64, 16, "cpu")
    with pytest.raises(ValueError, match="divisible"):
        sharded.ShardedNtt(fs, sharded.make_mesh((32,), ("coeff",), "cpu"))  # 32 > n2 = 16
    with pytest.raises(ValueError, match="divisible"):
        sharded.ShardedNtt(sharded.FourStepPlan(make_params(1024, Q60), 32, 32, "cpu"),
                           sharded.make_mesh((3,), ("coeff",), "cpu"))
    mixed = sharded.make_mesh((2,), ("coeff",), ["cpu", "meta"])
    with pytest.raises(ValueError, match="all on CUDA"):
        sharded.ShardedNtt(fs, mixed)
    with pytest.raises(ValueError, match="all on CUDA"):
        sharded.ShardedNtt(fs, sharded.make_mesh((2,), ("coeff",), "meta"))
    x = torch.zeros(2, 64, 16, dtype=torch.int64)
    with pytest.raises(ValueError, match="at once|no exchange"):
        a2a.all_to_all([x[0], x[1].to("meta")], 2)
    with pytest.raises(ValueError, match="no exchange"):
        a2a.all_to_all([x[0].to("meta"), x[1].to("meta")], 2)
    sn = sharded.ShardedNtt(fs, sharded.make_mesh((2, 4), ("batch", "coeff"), "cpu"),
                            batch_axis="batch")
    wrong = sharded.shard(sn.mesh, sn.spec_fourstep(), x)  # a spectrum's split
    with pytest.raises(ValueError, match="expected a ShardedTensor"):
        sn.nwc_poly_mult(wrong, wrong)
    with pytest.raises(ValueError, match="expected a ShardedTensor"):
        sn.ntt_fwd(x)
    with pytest.raises(ValueError, match="not all in"):
        sharded.ShardedNtt(fs, sn.mesh, coeff_axis="rows")


@pytest.mark.cuda
def test_cuda_exchange_and_sharded_product_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.from_numpy(operands(GOLDILOCKS_Q, (4, 3, 32, 32), 5).view(np.int64)).to(dev)
    for split in (1, 2):
        before = a2a.launches["a2a_exchange"]
        got = a2a.all_to_all(list(x), split)
        assert a2a.launches["a2a_exchange"] == before + 4
        assert all(torch.equal(g, w) for g, w in zip(got, a2a.all_to_all_plain(list(x), split)))
    fs = sharded.KernelFourStep(make_params(1024, Q60), 32, 32, dev)
    sn = sharded.ShardedNtt(fs, sharded.make_mesh((4,), ("coeff",), dev), fused_exchange=True)
    a, b = (torch.from_numpy(operands(Q60, (2, 1024), s).view(np.int64)).to(dev) for s in (6, 7))
    got = sn.nwc_poly_mult(*(sn.put_natural(t.reshape(2, 32, 32)) for t in (a, b)))
    assert torch.equal(flat(got.gather()), sharded.fourstep_nwc_poly_mult_kernel(fs, a, b))

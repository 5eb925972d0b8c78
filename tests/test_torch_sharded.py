"""The port's mesh layer (``tpu_ntt_torch.sharded``) against tpu_ntt's, on the
plain versions: CPU shards against JAX's 8 virtual CPU devices.

* ``kernels.a2a.all_to_all_plain`` (K6's plain version; ``all_to_all`` runs
  it on CPU shards) against JAX's ``_a2a_pallas_leaf`` inside
  ``jax.shard_map`` in interpret mode and against ``jax.lax.all_to_all``
  with ``tiled=True``: both directions, D = 2, 4 and 8, a batch axis, and
  an exchange on the coeff axis of a 2 x 4 batch x coeff mesh.
* ``make_mesh``, ``shard``/``put_natural``, ``ShardedTensor.gather`` and
  ``convert.shards_from_jax``.
* ``ShardedNtt`` on a plain ``FourStepPlan`` (torch ops, JAX's XLA locals)
  at DILITHIUM_256 16 x 16 on 8 shards and P24_1024 32 x 32 on the 2 x 4
  mesh against JAX's ``ShardedNtt`` on its XLA locals, one
  ``fused_exchange`` value each on the JAX side, both on the port's:
  products in natural order, spectra through both ``spectrum_indices``
  maps, round trips, the cached product, the dot and the cached dot.
* ``shard_batch``/``batch_pjit`` against JAX's.

Operands come from ``numpy.random.default_rng`` with 0, 1 and q - 1 in
them.  Tolerance: none, exact integer equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import tpu_ntt.params as jparams
from tpu_ntt import NttPlan as JaxNttPlan
from tpu_ntt import nwc_poly_mult as jax_nwc_poly_mult
from tpu_ntt import sharded as jsharded
from tpu_ntt_torch import convert, ntt, reference, sharded
from tpu_ntt_torch.kernels import a2a
from tpu_ntt_torch.params import DILITHIUM_256, P24_1024


def jax_mesh(shape, names):
    return JaxMesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


def words(shape, seed: int) -> np.ndarray:
    """uint32 words of every size, 0, 1 and 2^32 - 1 among them."""
    x = np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint64)
    x.reshape(-1)[:3] = [0, 1, (1 << 32) - 1]
    return x.astype(np.uint32)


def residues(p, shape, seed: int) -> np.ndarray:
    """Residues mod p.q, with a row cycling 0, 1, q - 1 and one all q - 1."""
    x = np.random.default_rng(seed).integers(0, p.q, size=shape, dtype=np.int64)
    rows = x.reshape(-1, shape[-1])
    rows[0] = np.resize(np.array([0, 1, p.q - 1]), shape[-1])
    rows[-1] = p.q - 1
    return x


def jax_exchange(mesh, axes, leaf_shape, x, split_from_end, pallas):
    """JAX's exchange over the 'coeff' axis of ``mesh``: x is (*mesh shape,
    *leaf_shape), one leaf a device; returns the leaves out, stacked the same
    way."""
    lead = P(*axes)

    def body(leaf):
        leaf = leaf.reshape(leaf_shape)
        if pallas:
            out = jsharded._a2a_pallas_leaf(leaf, mesh_axes=axes, exchange_axis="coeff",
                                            d=mesh.shape["coeff"],
                                            split_from_end=split_from_end, interpret=True)
        else:
            out = jax.lax.all_to_all(leaf, "coeff", leaf.ndim - split_from_end,
                                     leaf.ndim - 3 + split_from_end, tiled=True)
        return out.reshape((1,) * len(axes) + out.shape)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=lead, out_specs=lead,
                               check_vma=not pallas))
    return np.asarray(fn(jax.device_put(x, NamedSharding(mesh, lead))))


def port_exchange(x, mesh_shape, split_from_end):
    """The port's plain exchange on each group of peers along the last mesh
    axis of x's (*mesh shape, *leaf) stack."""
    groups = torch.from_numpy(x.view(np.int32)).reshape(-1, mesh_shape[-1], *x.shape[len(mesh_shape):])
    out = [torch.stack(a2a.all_to_all_plain(list(g), split_from_end)) for g in groups]
    return torch.stack(out).reshape(*mesh_shape, *out[0].shape[1:]).numpy().view(np.uint32)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("split_from_end", [2, 1])
def test_all_to_all_plain_matches_jax_exchanges(d, split_from_end):
    """A (3, rows, cols) leaf a shard, 3 the batch axis; the port's plain
    exchange equals JAX's Pallas kernel (interpret mode) and its all_to_all."""
    leaf = (3, 8 * d, 6 * d)
    x = words((d, *leaf), 10 * d + split_from_end)
    mesh = jax_mesh((d,), ("coeff",))
    got = port_exchange(x, (d,), split_from_end)
    assert got.shape == (d, *a2a.out_shape(leaf, d, split_from_end))
    for pallas in (True, False):
        assert (jax_exchange(mesh, ("coeff",), leaf, x, split_from_end, pallas) == got).all()


@pytest.mark.parametrize("split_from_end", [2, 1])
def test_all_to_all_plain_on_a_2x4_mesh(split_from_end):
    """The exchange runs among the four coeff peers of each batch row: peers
    differ only on the exchange axis."""
    leaf = (2, 16, 12)
    x = words((2, 4, *leaf), 30 + split_from_end)
    mesh = jax_mesh((2, 4), ("batch", "coeff"))
    got = port_exchange(x, (2, 4), split_from_end)
    for pallas in (True, False):
        want = jax_exchange(mesh, ("batch", "coeff"), leaf, x, split_from_end, pallas)
        assert (want == got).all()


def test_all_to_all_plain_moves_odd_blocks_and_refuses_bad_shards():
    """int64 words of any pattern in blocks of 3 words (24 bytes: no 16-byte
    vector) and of 2 rows, both directions and back; then the refusals of
    the checks ``all_to_all`` shares."""
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -(1 << 63), (1 << 63) - 1, size=(4, 2, 8, 12), dtype=np.int64))
    # 0, 1, 2^64 - 1, 2^63, 2^63 - 1 and 2^64 - 2^32 as int64 bit patterns
    x.view(-1)[:6] = torch.tensor([0, 1, -1, -(1 << 63), (1 << 63) - 1, -(1 << 32)])
    inv = a2a.all_to_all_plain(list(x), 1)
    fwd = a2a.all_to_all_plain(list(x), 2)
    for t in range(4):
        assert torch.equal(inv[t], torch.cat([x[s][..., 3 * t:3 * t + 3] for s in range(4)], 1))
        assert torch.equal(fwd[t], torch.cat([x[s][:, 2 * t:2 * t + 2] for s in range(4)], 2))
    assert all(torch.equal(y, s) for y, s in zip(a2a.all_to_all_plain(fwd, 1), x))
    with pytest.raises(ValueError, match="do not divide"):
        a2a.all_to_all(list(x[:, :, :6]), 2)  # 6 rows among 4 peers
    with pytest.raises(ValueError, match="differ"):
        a2a.all_to_all([x[0], x[1, :, :4]], 2)
    with pytest.raises(ValueError, match="1 or 2"):
        a2a.all_to_all(list(x), 3)


def test_mesh_shard_and_gather():
    """make_mesh's devices and names, a split with replicas and its gather,
    and the refusals."""
    mesh = sharded.make_mesh((2, 4), ("batch", "coeff"), "cpu")
    assert mesh.shape == {"batch": 2, "coeff": 4} and mesh.size == 8
    assert mesh.device_list() == [torch.device("cpu")] * 8
    assert mesh == sharded.make_mesh((2, 4), ("batch", "coeff"), ["cpu"] * 8)
    assert mesh != sharded.make_mesh((2, 4), ("coeff", "batch"), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.make_mesh((2,), ("coeff",))
    x = torch.arange(6 * 8 * 12).reshape(6, 8, 12)
    s = sharded.shard(mesh, (None, None, "coeff"), x)  # split on coeff, replicas on batch
    assert s.shape == (6, 8, 12) and s.shards[0].shape == (6, 8, 3)
    assert all(torch.equal(s.shards[i], s.shards[i + 4]) for i in range(4))
    assert torch.equal(s.shards[5], x[..., 3:6])
    assert torch.equal(s.gather(), x)
    t = sharded.shard(mesh, ("batch", "coeff"), x)
    assert t.spec == ("batch", "coeff", None) and torch.equal(t.shards[6], x[3:, 4:6])
    assert torch.equal(t.gather("cpu"), x)
    with pytest.raises(ValueError, match="cannot split"):
        sharded.shard(mesh, (None, "coeff", "batch"), x[:, :6])
    with pytest.raises(ValueError, match="shards for a mesh"):
        sharded.ShardedTensor(mesh, (None, "coeff"), t.shards[:4])
    with pytest.raises(ValueError, match="names no axis"):
        sharded.ShardedTensor(mesh, ("rows", None, None), t.shards)


def test_shards_from_jax_carries_sharded_arrays():
    """A JAX array put by ``ShardedNtt.put_natural`` (uint32 words, and a
    (hi, lo) pair of a 60-bit element) becomes the port's split of the same
    values on the same mesh shape and spec."""
    jmesh = jax_mesh((2, 4), ("batch", "coeff"))
    jfs = jsharded.FourStepPlan(jparams.DILITHIUM_256, 16, 16)
    jsn = jsharded.ShardedNtt(jfs, jmesh, batch_axis="batch")
    x = residues(DILITHIUM_256, (4, 16, 16), 40).astype(np.uint32)
    got = convert.shards_from_jax(jsn.put_natural(x), device="cpu")
    mesh = sharded.make_mesh((2, 4), ("batch", "coeff"), "cpu")
    assert got.mesh == mesh and got.spec == ("batch", None, "coeff")
    want = sharded.shard(mesh, got.spec, torch.from_numpy(x.view(np.int32)))
    assert all(torch.equal(g, w) for g, w in zip(got.shards, want.shards))
    wide = np.random.default_rng(41).integers(0, 1 << 62, size=(4, 16, 16), dtype=np.uint64)
    hi, lo = (wide >> np.uint64(32)).astype(np.uint32), wide.astype(np.uint32)
    spec = NamedSharding(jmesh, P("batch", None, "coeff"))
    pair = tuple(jax.device_put(w, spec) for w in (hi, lo))
    got = convert.shards_from_jax(pair, device="cpu")
    assert torch.equal(got.gather(), torch.from_numpy(wide.view(np.int64)))
    assert got.shards[5].shape == (2, 16, 4)


CASES = {  # params, split, JAX mesh, batch axis, batch (None: unbatched), JAX's exchange
    "dilithium_16x16": (DILITHIUM_256, 16, (8,), ("coeff",), None, None, True),
    "p24_1024_32x32": (P24_1024, 32, (2, 4), ("batch", "coeff"), "batch", 4, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_locals_match_jax_sharded_ntt(case):
    """The port's ShardedNtt on a plain FourStepPlan, with both exchanges,
    against JAX's on its XLA locals: the same inputs (carried over by
    ``shards_from_jax``) give the same shards out."""
    p, n1, shape, names, batch_axis, batch, jax_fused = CASES[case]
    n2 = p.n // n1
    jp = jparams.make_params(p.n, p.q, psi=p.psi)
    jsn = jsharded.ShardedNtt(jsharded.FourStepPlan(jp, n1, n2), jax_mesh(shape, names),
                              batch_axis=batch_axis, fused_exchange=jax_fused)
    batched = batch is not None
    lead = (batch,) if batched else ()
    a, b = (residues(p, (2, *lead, n1, n2), seed).astype(np.uint32) for seed in (50, 51))
    ja, jb = (jsn.put_natural(x[0], batched) for x in (a, b))
    ja2, jb2 = (jsn.put_natural(x, batched, stacked=True) for x in (a, b))
    want = {
        "nwc": jsn.nwc_poly_mult(ja, jb, batched), "cyclic": jsn.cyclic_poly_mult(ja, jb, batched),
        "fwd": jsn.ntt_fwd(ja, batched), "spectrum": jsn.nwc_spectrum(jb, batched),
        "dot": jsn.nwc_dot(ja2, jb2, batched),
    }
    want = {k: convert.shards_from_jax(v, device="cpu").gather() for k, v in want.items()}
    fs = sharded.FourStepPlan(p, n1, n2, "cpu")
    to_natural = np.argsort(fs.spectrum_indices().reshape(-1))
    jax_to_natural = np.argsort(jsn.fs.spectrum_indices().reshape(-1))
    natural = lambda s, perm: s.reshape(*s.shape[:-2], p.n)[..., perm]  # noqa: E731
    for fused in (False, True):
        sn = sharded.ShardedNtt(fs, sharded.make_mesh(shape, names, "cpu"),
                                batch_axis=batch_axis, fused_exchange=fused)
        pa, pb = (convert.shards_from_jax(x, device="cpu") for x in (ja, jb))
        pa2, pb2 = (convert.shards_from_jax(x, device="cpu") for x in (ja2, jb2))
        assert pa.spec == sn.spec_natural(batched)
        got = sn.nwc_poly_mult(pa, pb, batched)
        assert torch.equal(got.gather(), want["nwc"])
        assert torch.equal(sn.cyclic_poly_mult(pa, pb, batched).gather(), want["cyclic"])
        fwd = sn.ntt_fwd(pa, batched)
        assert torch.equal(natural(fwd.gather(), to_natural),
                           natural(want["fwd"], jax_to_natural))
        assert torch.equal(sn.ntt_inv(fwd, batched).gather(), pa.gather())
        spec = sn.nwc_spectrum(pb, batched)
        assert torch.equal(natural(spec.gather(), to_natural),
                           natural(want["spectrum"], jax_to_natural))
        assert torch.equal(sn.nwc_poly_mult_cached(pa, spec, batched).gather(), want["nwc"])
        assert torch.equal(sn.nwc_dot(pa2, pb2, batched).gather(), want["dot"])
        spectra = sharded.shard(sn.mesh, sn.spec_fourstep(batched, stacked=True),
                                torch.stack([sn.nwc_spectrum(convert.shards_from_jax(
                                    jsn.put_natural(x, batched), device="cpu"),
                                    batched).gather() for x in b]))
        assert torch.equal(sn.nwc_dot_cached(pa2, spectra, batched).gather(), want["dot"])
    first = lambda x: x.reshape(-1, p.n)[0].tolist()  # noqa: E731  (0, 1, q - 1 cycled)
    assert first(want["nwc"]) == reference.nwc_poly_mult(first(a[0]), first(b[0]), p)


def test_shard_batch_and_batch_pjit_match_jax():
    """Data parallelism: ``fn(plan, *shards)`` on each of 8 batch shards with
    a plan of the same parameters, no exchange; JAX's ``batch_pjit`` of its
    ``nwc_poly_mult`` (tests/test_sharded.py:604-616) gives the same shards."""
    jmesh = jax_mesh((8,), ("batch",))
    jplan = JaxNttPlan(jparams.DILITHIUM_256)
    a, b = (residues(DILITHIUM_256, (16, 256), seed).astype(np.uint32) for seed in (60, 61))
    ja, jb = (jsharded.shard_batch(jmesh, "batch", jnp.asarray(x)) for x in (a, b))
    want = convert.shards_from_jax(jsharded.batch_pjit(jplan, jax_nwc_poly_mult, jmesh)(ja, jb),
                                   device="cpu")
    mesh = sharded.make_mesh((8,), ("batch",), "cpu")
    plan = ntt.NttPlan(DILITHIUM_256, device="cpu")
    run = sharded.batch_pjit(plan, ntt.nwc_poly_mult, mesh)
    pa = convert.shards_from_jax(ja, device="cpu")
    assert pa.spec == ("batch", None)
    got = run(pa, torch.from_numpy(b.view(np.int32)))  # a global tensor is split first
    assert got.spec == ("batch", None) and got.shards[0].shape == (2, 256)
    assert all(torch.equal(g, w) for g, w in zip(got.shards, want.shards))
    assert got.gather()[15].tolist() == reference.nwc_poly_mult(
        a[15].tolist(), b[15].tolist(), DILITHIUM_256)
    pb = sharded.shard_batch(mesh, "batch", torch.from_numpy(b.view(np.int32)))
    with pytest.raises(ValueError, match="leading axis"):
        run(pa, sharded.shard(mesh, (None, "batch"), pb.gather()))

"""The port's Poseidon2-GL and Merkle trees against tpu_ntt's (kernels K5a, K5b).

The port's constants and its big-int model ``PoseidonRef`` must equal
``tpu_ntt.poseidon``'s; ``Poseidon2GL.permute`` at widths 8 and 12 must equal
JAX's XLA ``Poseidon2GL.permute`` (one call each: JAX's Pallas backend is
never run here, its interpret-mode compile runs for minutes) and JAX's
``PoseidonRef``; the sponge at row lengths 0, 1, 5 and 8, ``compress`` and
the Merkle trees must equal JAX's big-int model, a Merkle path must verify
and a tampered one fail.  On the CPU every call runs the plain version.
Also: ``constants=``, the rejections, the C signatures ``load`` binds
against ``csrc/poseidon.cu`` and the bounds.  The CUDA kernels are compared
with the plain versions only where a CUDA device is present (marker
``cuda``); on the card that check is ``chip_smoke.py``.  Operands come from
``numpy.random.default_rng`` with the values 0, 1, q - 1, 2^63 and
2^63 - 1.  Tolerance: none — exact integer equality.
"""

import re

import numpy as np
import pytest
import torch

import tpu_ntt.poseidon as jposeidon
from tpu_ntt_torch import bounds, poseidon
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels import _build, _plan
from tpu_ntt_torch.kernels import poseidon as kposeidon
from tpu_ntt_torch.modmath import GOLDILOCKS_Q as Q

EDGES = [0, 1, Q - 1, 1 << 63, (1 << 63) - 1]


def elements(shape, seed: int) -> torch.Tensor:
    """int64 patterns of residues, the boundary values first."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint64).reshape(-1)
    k = min(len(EDGES), x.size)
    x[:k] = EDGES[:k]
    return torch.from_numpy(x.reshape(shape).view(np.int64))


def unsigned(t: torch.Tensor) -> list:
    return t.contiguous().numpy().view(np.uint64).tolist()


@pytest.mark.parametrize("width", [8, 12])
def test_constants_match_jax(width):
    assert poseidon.default_constants(width, 8, 22) == jposeidon.default_constants(
        width, 8, 22)
    h = poseidon.Poseidon2GL(width)
    rcs, diag = jposeidon.default_constants(width, 8, 22)
    table = unsigned(h.constants_table("cpu"))
    assert table == [c for rc in rcs if len(rc) == width for c in rc] + [
        rc[0] for rc in rcs if len(rc) == 1] + [(d - 1) % Q for d in diag]


def test_reference_model_matches_jax():
    assert np.array_equal(poseidon.M4, jposeidon.M4)
    for diag in ([3, 5, 7, 11, 13, 17, 19, 23], [1, 2, 1, 4, 5, 6, 7, 8]):
        assert poseidon._internal_matrix_det(diag) == jposeidon._internal_matrix_det(diag)
    rng = np.random.default_rng(1)
    for width in (8, 12):
        ref, jref = poseidon.PoseidonRef(width), jposeidon.PoseidonRef(width)
        state = EDGES + [int(v) for v in rng.integers(0, Q, width - 5, dtype=np.uint64)]
        assert ref.permute(state) == jref.permute(state)
    ref, jref = poseidon.PoseidonRef(), jposeidon.PoseidonRef()
    for length in (0, 1, 4, 9):
        vals = [int(v) for v in rng.integers(0, Q, length, dtype=np.uint64)]
        assert ref.hash_elements(vals) == jref.hash_elements(vals)
    assert ref.compress(EDGES[:4], EDGES[1:]) == jref.compress(EDGES[:4], EDGES[1:])


@pytest.mark.parametrize("width", [8, 12])
def test_permute_matches_jax_xla_and_the_model(width):
    """One un-jitted call of JAX's XLA permutation on 64 columns; its scans
    are not unrolled (``unroll`` changes the compile, not the result), which
    halves their compile here."""
    h = poseidon.Poseidon2GL(width)
    x = elements((width, 64), seed=width)
    got = torch.stack(h.permute(list(x)))
    jout = jposeidon.Poseidon2GL(width, unroll=(1, 1)).permute(
        [int64_to_pairs(lane) for lane in x])
    want = torch.stack([pairs_to_int64(np.asarray(hi), np.asarray(lo)) for hi, lo in jout])
    assert torch.equal(got, want)
    jref = jposeidon.PoseidonRef(width)
    cols = unsigned(x.T)
    assert unsigned(got.T)[:4] == [jref.permute(c) for c in cols[:4]]


@pytest.mark.parametrize("length", [0, 1, 5, 8])
def test_hash_rows_matches_the_model(length):
    h = poseidon.Poseidon2GL()
    rows = elements((6, max(length, 1)), seed=20 + length)[:, :length]
    got = unsigned(torch.stack(h.hash_rows(rows)).T)
    jref = jposeidon.PoseidonRef()
    assert got == [jref.hash_elements(r) for r in unsigned(rows)]


def test_hash_rows_takes_any_batch_shape():
    h = poseidon.Poseidon2GL()
    rows = elements((2, 3, 5), seed=30)
    got = torch.stack(h.hash_rows(rows))
    assert got.shape == (4, 2, 3)
    flat = torch.stack(h.hash_rows(rows.reshape(6, 5)))
    assert torch.equal(got.reshape(4, 6), flat)


def test_compress_matches_the_model():
    h = poseidon.Poseidon2GL()
    left, right = elements((4, 7), seed=31), elements((4, 7), seed=32)
    got = unsigned(torch.stack(h.compress(list(left), list(right))).T)
    jref = jposeidon.PoseidonRef()
    assert got == [jref.compress(l, r) for l, r in zip(unsigned(left.T), unsigned(right.T))]


def big_int_root(jref, leaves: list) -> list:
    level = leaves
    while len(level) > 1:
        level = [jref.compress(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]


def test_merkle_tree_open_and_verify():
    h = poseidon.Poseidon2GL()
    leaves = elements((4, 16), seed=33)
    levels = poseidon.merkle_levels(h, list(leaves))
    assert [lvl[0].shape[0] for lvl in levels] == [16, 8, 4, 2, 1]
    root = poseidon.digest_ints(levels[-1])
    assert torch.equal(torch.stack(poseidon.merkle_root(h, list(leaves))),
                       torch.stack(levels[-1]))
    jref = jposeidon.PoseidonRef()
    leaf_ints = unsigned(leaves.T)
    assert root == big_int_root(jref, leaf_ints)
    for index in (0, 5, 15):
        path = poseidon.merkle_open(levels, index)
        assert len(path) == 4
        assert poseidon.merkle_verify(h.ref, root, index, leaf_ints[index], path)
        assert jposeidon.merkle_verify(jref, root, index, leaf_ints[index], path)


def test_merkle_rejects_tampering_and_ragged_trees():
    h = poseidon.Poseidon2GL()
    leaves = elements((4, 8), seed=34)
    levels = poseidon.merkle_levels(h, list(leaves))
    root = poseidon.digest_ints(levels[-1])
    leaf = unsigned(leaves[:, 3])
    path = poseidon.merkle_open(levels, 3)
    assert not poseidon.merkle_verify(h.ref, root, 2, leaf, path)
    bad = [list(d) for d in path]
    bad[1][2] = (bad[1][2] + 1) % Q
    assert not poseidon.merkle_verify(h.ref, root, 3, leaf, bad)
    with pytest.raises(ValueError, match="power of two"):
        poseidon.merkle_levels(h, list(elements((4, 6), seed=35)))


def test_custom_constants_hold():
    """``constants=`` reaches the plain version and the kernels' table."""
    rng = np.random.default_rng(36)
    rcs = [[int(v) for v in rng.integers(0, Q, 8, dtype=np.uint64)] for _ in range(2)]
    rcs.insert(1, [int(rng.integers(0, Q, dtype=np.uint64))])
    diag = [int(v) for v in rng.integers(2, Q, 8, dtype=np.uint64)]
    h = poseidon.Poseidon2GL(8, rf=2, rp=1, constants=(rcs, diag))
    jref = jposeidon.PoseidonRef(8, 2, 1, constants=(rcs, diag))
    x = elements((8, 5), seed=37)
    assert unsigned(torch.stack(h.permute(list(x))).T) == [jref.permute(c)
                                                           for c in unsigned(x.T)]
    assert unsigned(h.constants_table("cpu"))[-8:] == [(d - 1) % Q for d in diag]


def test_rejections():
    with pytest.raises(ValueError, match="width"):
        poseidon.Poseidon2GL(4)
    with pytest.raises(ValueError, match="rf"):
        poseidon.Poseidon2GL(8, rf=3)
    with pytest.raises(ValueError, match="constants"):
        poseidon.Poseidon2GL(8, rf=2, rp=1, constants=([[1] * 8, [1] * 8], [2] * 8))
    h = poseidon.Poseidon2GL()
    with pytest.raises(ValueError, match="lanes"):
        h.permute(list(elements((7, 4), seed=38)))
    with pytest.raises(TypeError):
        h.permute([t.to(torch.int32) for t in elements((8, 4), seed=39)])
    with pytest.raises(TypeError):
        h.hash_rows(elements((4, 3), seed=40).to(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kposeidon.permute(h, elements((8, 4), seed=41))


def test_cpu_tensors_launch_nothing():
    before = dict(kposeidon.launches)
    h = poseidon.Poseidon2GL()
    h.permute(list(elements((8, 3), seed=42)))
    h.hash_rows(elements((3, 6), seed=43))
    assert h.hash_rows(elements((0, 6), seed=44))[0].shape == (0,)
    assert kposeidon.launches == before


C_TYPES = {"int": kposeidon.ctypes.c_int}


def test_load_binds_the_c_signatures_of_poseidon_cu(monkeypatch):
    bound = {}
    monkeypatch.setattr(_plan, "bind", lambda name, argtypes: bound.update(argtypes))
    kposeidon.load.__wrapped__()
    source = (_build.CSRC / "poseidon.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (poseidon_\w+)\(([^)]*)\)', source))
    assert sorted(decls) == sorted(kposeidon.KERNELS + (kposeidon.PROBE,)) == sorted(
        f"poseidon_{k}" for k in bound)
    for suffix, types in bound.items():
        params = [p.strip() for p in decls[f"poseidon_{suffix}"].split(",")]
        assert len(params) == len(types), suffix
        for param, ty in zip(params, types):
            want = (kposeidon.ctypes.c_void_p if "*" in param
                    else C_TYPES[param.rsplit(" ", 1)[0]])
            assert ty is want, (suffix, param)


def test_bounds_count_the_permutations():
    """520 Goldilocks products a width-8 permutation (8 * 4 * 8 full-round
    S-box products, 22 * (4 + 8) partial), 8 IMADs each; a sponge over rows
    of L runs max(ceil(L / 4), 1) permutations a row."""
    assert bounds.poseidon_products(8) == 520
    assert bounds.poseidon_products(12) == 8 * 4 * 12 + 22 * 16
    assert bounds.poseidon_work("permute", 8, 131072) == (
        2 * 8 * 131072 * 8, 131072 * 520 * 8)
    assert bounds.poseidon_work("sponge", 8, 8192, 135) == (
        8192 * 139 * 8, 8192 * 34 * 520 * 8)
    assert bounds.poseidon_work("sponge", 8, 10, 0)[1] == 10 * 520 * 8
    assert bounds.POSEIDON_BATCH == 131072


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    dev = torch.device("cuda", torch.cuda.current_device())
    before = dict(kposeidon.launches)
    for width in (8, 12):
        h = poseidon.Poseidon2GL(width)
        x = elements((width, 1000), seed=45).to(dev)
        assert torch.equal(torch.stack(h.permute(list(x))),
                           torch.stack(h.permute_plain(list(x))))
        for length in (0, 1, 5, 8, 135):
            rows = elements((300, max(length, 1)), seed=46)[:, :length].contiguous().to(dev)
            assert torch.equal(torch.stack(h.hash_rows(rows)),
                               torch.stack(h.hash_rows_plain(rows))), length
        # a schedule other than the default: the rounds' loops take any rf, rp
        h = poseidon.Poseidon2GL(width, rf=6, rp=11)
        assert torch.equal(torch.stack(h.permute(list(x))),
                           torch.stack(h.permute_plain(list(x))))
        rows = elements((300, 9), seed=47).to(dev)
        assert torch.equal(torch.stack(h.hash_rows(rows)), torch.stack(h.hash_rows_plain(rows)))
    # the arithmetic core on words outside [0, q) too
    edges = [0, 1, 2, (1 << 32) - 1, 1 << 32, Q - 1, Q, Q + 1, (1 << 63) - 1, 1 << 63,
             (1 << 64) - (1 << 32), (1 << 64) - 1]
    pairs = np.array([(u, v) for u in edges for v in edges], dtype=np.uint64)
    rand = np.random.default_rng(48).integers(0, 1 << 64, size=(4096, 3), dtype=np.uint64,
                                               endpoint=False)
    ops = np.concatenate([np.column_stack([pairs, pairs[::-1, 0]]), rand])
    a, b, c = (torch.from_numpy(ops[:, k].copy().view(np.int64)).to(dev) for k in range(3))
    got = kposeidon.field_probe(a, b, c).cpu().numpy().view(np.uint64).astype(object)
    want = kposeidon.field_probe_want(*(ops[:, k].tolist() for k in range(3)))
    for k, row in enumerate(want):
        assert ((got[k] % Q == row) if k in kposeidon.PROBE_LAZY_ROWS else (got[k] == row)).all(), k
    torch.cuda.synchronize()
    assert all(kposeidon.launches[k] > before[k] for k in kposeidon.KERNELS + (kposeidon.PROBE,))

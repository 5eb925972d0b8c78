"""Poseidon2 over the Goldilocks field and Merkle commitment, in PyTorch.

The counterpart of ``tpu_ntt.poseidon``: the hashing half of a STARK
prover.  ``Poseidon2GL`` permutes a state of ``width`` lanes (8 or 12), each
a ``torch.int64`` tensor of Goldilocks residues in the format of
``modmath`` (64-bit patterns, a residue >= 2^63 negative), where the JAX
class takes (hi, lo) uint32 pairs.  For CUDA tensors it launches the
hand-written kernels of ``kernels/poseidon.py`` (``csrc/poseidon.cu``: one
permutation, or one sponge over a row, a thread); for CPU tensors it runs
its plain version, the ``*_plain`` method beside it.  Nothing else chooses:
JAX's ``backend``, ``interpret`` and ``unroll`` pick a TPU program and its
``*_j`` entry points are jit caches, and the port has none of them.

Construction, constants and the big-int model ``PoseidonRef`` are copies of
the JAX module's (tpu_ntt/poseidon.py:53-211), held equal to it by
tests/test_torch_poseidon.py: width-W state, x^7 S-box, RF = 8 full rounds
split 4 + 4 around RP = 22 partial rounds, the external layer built from
M4 blockwise and block-summed, the internal layer all-ones plus a diagonal;
round constants and the diagonal from SHA-256 counter streams, or
``constants=``.  Sponge: rate 4, the row length in the first capacity lane.
Merkle trees compress sibling digest pairs through one width-8 permutation
a node, one launch a level.  JAX's ``merkle_levels`` options ``jit`` and
``group`` only group JAX calls and are dropped; its ``to_pairs`` and
``from_pairs`` are ``convert.int64_to_pairs`` and ``pairs_to_int64``.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from .kernels import _plan
from .kernels import poseidon as kposeidon
from .modmath import GOLDILOCKS_Q as Q
from .modmath import encode64, goldilocks_add, goldilocks_mul

_M64 = (1 << 64) - 1
RATE = 4  # elements absorbed a permutation; the digest is RATE lanes

# ---------------------------------------------------------------------------
# parameter derivation (deterministic, documented)
# ---------------------------------------------------------------------------


def _sha_field_stream(tag: str, count: int) -> list[int]:
    """``count`` field elements from SHA-256(tag || counter), rejection
    sampling 8-byte big-endian words below q (acceptance ~1 - 2^-32)."""
    out: list[int] = []
    ctr = 0
    while len(out) < count:
        h = hashlib.sha256(f"{tag}|{ctr}".encode()).digest()
        ctr += 1
        for off in range(0, 32, 8):
            v = int.from_bytes(h[off:off + 8], "big")
            if v < Q:
                out.append(v)
                if len(out) == count:
                    break
    return out


# M4 from the Poseidon2 paper (section 5.1); the external layer for W = 4k
# is block-circulant [[2*M4, M4, ...], [M4, 2*M4, ...], ...].
M4 = np.array([[5, 7, 1, 3],
               [4, 6, 1, 1],
               [1, 3, 5, 7],
               [1, 1, 4, 6]], dtype=np.int64)


def _internal_matrix_det(diag: list[int]) -> int:
    """det(J + diag(mu_i - 1)) mod Q for the all-ones matrix J, by the
    matrix determinant lemma applied exactly: with d_i = mu_i - 1,
    det = prod(d_i) * (1 + sum 1/d_i) when all d_i != 0; any d_i == 0
    falls back to modular Gaussian elimination (Q prime)."""
    W = len(diag)
    d = [(mu - 1) % Q for mu in diag]
    if all(d):
        prod = 1
        for v in d:
            prod = prod * v % Q
        s = sum(pow(v, -1, Q) for v in d) % Q
        return prod * (1 + s) % Q
    m = [[(1 + (d[i] if i == j else 0)) % Q for j in range(W)]
         for i in range(W)]
    det = 1
    for c in range(W):
        piv = next((r for r in range(c, W) if m[r][c]), None)
        if piv is None:
            return 0
        if piv != c:
            m[c], m[piv] = m[piv], m[c]
            det = Q - det
        det = det * m[c][c] % Q
        inv = pow(m[c][c], -1, Q)
        for r in range(c + 1, W):
            f = m[r][c] * inv % Q
            for j in range(c, W):
                m[r][j] = (m[r][j] - f * m[c][j]) % Q
    return det


@functools.lru_cache(maxsize=None)
def default_constants(width: int, rf: int, rp: int):
    """(round_constants, internal_diag): rc[r] is a width-vector for the
    rf full rounds and a single element for each partial round (only lane
    0 is shifted there); diag mu_i for the internal matrix, re-drawn from
    the continuation of the same SHA stream until every mu_i != 0 and the
    internal matrix is invertible (the first draw passes for widths 8 and
    12)."""
    rc_full = _sha_field_stream(f"tpu_ntt.poseidon2.gl.w{width}.rc", rf * width)
    rc_part = _sha_field_stream(f"tpu_ntt.poseidon2.gl.w{width}.rp", rp)
    attempt = 0
    while True:
        tag = (f"tpu_ntt.poseidon2.gl.w{width}.diag"
               + (f".retry{attempt}" if attempt else ""))
        diag = _sha_field_stream(tag, width)
        if all(diag) and _internal_matrix_det(diag) != 0:
            break
        attempt += 1
    half = rf // 2
    rcs = [rc_full[r * width:(r + 1) * width] for r in range(half)]
    rcs += [[c] for c in rc_part]
    rcs += [rc_full[r * width:(r + 1) * width] for r in range(half, rf)]
    return rcs, diag


# ---------------------------------------------------------------------------
# pure-Python reference model (oracle for the device path + FRI verifier)
# ---------------------------------------------------------------------------


class PoseidonRef:
    """Big-int model of the exact same permutation (slow, independent)."""

    def __init__(self, width: int = 8, rf: int = 8, rp: int = 22,
                 constants=None):
        self.width, self.rf, self.rp = width, rf, rp
        self.rcs, self.diag = constants or default_constants(width, rf, rp)

    def _m4(self, x):
        return [sum(int(M4[i][j]) * x[j] for j in range(4)) % Q
                for i in range(4)]

    def _external(self, x):
        blocks = [self._m4(x[o:o + 4]) for o in range(0, self.width, 4)]
        if self.width == 4:
            # W=4 external layer is 2*M4 (paper section 5.1)
            return [2 * v % Q for v in blocks[0]]
        s = [sum(b[i] for b in blocks) % Q for i in range(4)]
        return [(b[i] + s[i]) % Q for b in blocks for i in range(4)]

    def _internal(self, x):
        s = sum(x) % Q
        return [(s + (self.diag[i] - 1) * x[i]) % Q
                for i in range(self.width)]

    @staticmethod
    def _sbox(v):
        v2 = v * v % Q
        v4 = v2 * v2 % Q
        return v4 * v2 % Q * v % Q

    def permute(self, state):
        x = [int(v) % Q for v in state]
        assert len(x) == self.width
        x = self._external(x)
        for rc in self.rcs:
            if len(rc) == self.width:  # full round
                x = [(v + c) % Q for v, c in zip(x, rc)]
                x = [self._sbox(v) for v in x]
                x = self._external(x)
            else:  # partial round
                x[0] = self._sbox((x[0] + rc[0]) % Q)
                x = self._internal(x)
        return x

    def hash_elements(self, values, rate: int = RATE) -> list[int]:
        vals = [int(v) % Q for v in values]
        state = [0] * self.width
        state[rate] = len(vals) % Q  # length domain separation
        for off in range(0, max(len(vals), 1), rate):
            chunk = vals[off:off + rate]
            for i, v in enumerate(chunk):
                state[i] = (state[i] + v) % Q
            state = self.permute(state)
        return state[:rate]

    def compress(self, left, right) -> list[int]:
        return self.permute([int(v) % Q for v in left] +
                            [int(v) % Q for v in right])[:4]


# ---------------------------------------------------------------------------
# batched permutation on tensors
# ---------------------------------------------------------------------------


class Poseidon2GL:
    """Poseidon2-GL on lanes of int64 tensors: the kernel on a CUDA tensor,
    the plain version on a CPU tensor.

    The state is a list of ``width`` tensors of one shape (any batch shape,
    as in JAX); the constants live in a device tensor made on first use on
    each device, so one hasher serves every device."""

    WIDTHS = (8, 12)  # the widths the kernels are built for

    def __init__(self, width: int = 8, rf: int = 8, rp: int = 22,
                 constants=None):
        if width not in self.WIDTHS:
            raise ValueError(f"width must be one of {self.WIDTHS}, got {width}")
        if rf % 2 or rf < 2 or rp < 0:
            raise ValueError(f"need an even rf >= 2 and rp >= 0, got {rf}, {rp}")
        self.width, self.rf, self.rp = width, rf, rp
        self.rcs, self.diag = constants or default_constants(width, rf, rp)
        self.ref = PoseidonRef(width, rf, rp, (self.rcs, self.diag))
        self.rc_full = [rc for rc in self.rcs if len(rc) == width]
        self.rc_part = [rc[0] for rc in self.rcs if len(rc) == 1]
        if len(self.rc_full) != rf or len(self.rc_part) != rp:
            raise ValueError(f"constants need {rf} full-round vectors of {width} "
                             f"and {rp} partial-round scalars")
        self.diag_m1 = [(d - 1) % Q for d in self.diag]
        self._tables: dict[torch.device, torch.Tensor] = {}

    def constants_table(self, device) -> torch.Tensor:
        """The kernels' constants on ``device``: the rf full-round vectors,
        the rp partial-round constants, then the diagonal minus one, as
        int64 bit patterns."""
        device = torch.device(device)
        if device not in self._tables:
            values = [c for rc in self.rc_full for c in rc] + self.rc_part + self.diag_m1
            self._tables[device] = encode64(values, device)
        return self._tables[device]

    # -- the permutation ----------------------------------------------------

    def _lanes(self, state) -> torch.Tensor:
        """The state as one (width, ...) int64 tensor, checked."""
        if len(state) != self.width:
            raise ValueError(f"state needs {self.width} lanes, got {len(state)}")
        x = torch.stack(list(state))
        if x.dtype != torch.int64:
            raise TypeError(f"lanes must be int64 residues, got {x.dtype}")
        return x

    def permute(self, state):
        """state: list of ``width`` int64 tensors of one shape -> the same."""
        x = self._lanes(state)
        if _plan.runs_plain(x):
            return self.permute_plain(state)
        out = kposeidon.permute(self, x.reshape(self.width, x[0].numel()))
        return list(out.reshape(x.shape).unbind(0))

    def permute_plain(self, state):
        x = self._lanes(state)
        const = functools.partial(_column, x)
        x = self._external(x)
        half = self.rf // 2
        for rc in self.rc_full[:half]:
            x = self._external(_sbox(goldilocks_add(x, const(rc))))
        dm1 = const(self.diag_m1)
        for c in self.rc_part:
            x0 = _sbox(goldilocks_add(x[0], c))
            x = torch.cat([x0[None], x[1:]])
            s = x[0]
            for i in range(1, self.width):
                s = goldilocks_add(s, x[i])
            x = goldilocks_add(goldilocks_mul(x, dm1), s)
        for rc in self.rc_full[half:]:
            x = self._external(_sbox(goldilocks_add(x, const(rc))))
        return list(x.unbind(0))

    def _external(self, x: torch.Tensor) -> torch.Tensor:
        """The external layer on the (width, ...) state: M4 on each block of
        four lanes by the schedule of ``tpu_ntt.poseidon._m4_block``, then
        each block plus the sum of the blocks."""
        blocks = _m4_block(x.reshape((self.width // 4, 4) + x.shape[1:]))
        s = blocks[0]
        for b in blocks[1:]:
            s = goldilocks_add(s, b)
        return goldilocks_add(blocks, s).reshape(x.shape)

    # -- sponge and compression ---------------------------------------------

    def hash_rows(self, rows: torch.Tensor):
        """(..., L) int64 rows -> digest: 4 tensors of shape (...).  Rows
        are absorbed rate 4, a short last chunk as if zero-padded; the row
        length sits in the first capacity lane; L = 0 still permutes once."""
        if rows.dtype != torch.int64:
            raise TypeError(f"rows must be int64 residues, got {rows.dtype}")
        if rows.dim() < 1:
            raise ValueError("rows need a last axis of elements")
        if _plan.runs_plain(rows):
            return self.hash_rows_plain(rows)
        batch, L = rows.shape[:-1], rows.shape[-1]
        out = kposeidon.sponge(self, rows.reshape(batch.numel(), L).contiguous())
        return list(out.reshape((RATE,) + batch).unbind(0))

    def hash_rows_plain(self, rows: torch.Tensor):
        batch, L = rows.shape[:-1], rows.shape[-1]
        zero = rows.new_zeros(batch)
        state = [zero] * self.width
        state[RATE] = torch.full_like(zero, L % Q)
        for off in range(0, max(L, 1), RATE):
            for i in range(min(RATE, L - off)):
                state[i] = goldilocks_add(state[i], rows[..., off + i])
            state = self.permute_plain(state)
        return state[:RATE]

    def compress(self, left, right):
        """Two 4-lane digests -> one (a 2-to-1 Merkle node): the first four
        lanes of the width-8 permutation of their concatenation."""
        return self.permute(list(left) + list(right))[:RATE]


def _column(like: torch.Tensor, values) -> torch.Tensor:
    """Per-lane constants as a (width, 1, ...) tensor that broadcasts
    against the (width, ...) state ``like``."""
    c = encode64([v % Q for v in values], like.device)
    return c.reshape((len(values),) + (1,) * (like.dim() - 1))


def _sbox(v: torch.Tensor) -> torch.Tensor:
    """x^7 = x * x^2 * x^4: four products."""
    v2 = goldilocks_mul(v, v)
    v4 = goldilocks_mul(v2, v2)
    return goldilocks_mul(goldilocks_mul(v4, v2), v)


def _m4_block(x: torch.Tensor) -> torch.Tensor:
    """M4 @ x over axis 1 of (blocks, 4, ...) by tpu_ntt's addition
    schedule: 8 adds and 4 doublings, no multiplies."""
    add = goldilocks_add
    x0, x1, x2, x3 = x.unbind(1)
    t0 = add(x0, x1)
    t1 = add(x2, x3)
    t2 = add(add(x1, x1), t1)  # 2*x1 + x2 + x3
    t3 = add(add(x3, x3), t0)  # 2*x3 + x0 + x1
    t4 = add(add(add(t1, t1), add(t1, t1)), t3)  # 4*t1 + t3
    t5 = add(add(add(t0, t0), add(t0, t0)), t2)  # 4*t0 + t2
    t6 = add(t3, t5)
    t7 = add(t2, t4)
    return torch.stack([t6, t5, t7, t4], dim=1)


# ---------------------------------------------------------------------------
# Merkle trees
# ---------------------------------------------------------------------------


def merkle_levels(hasher: Poseidon2GL, leaves):
    """leaves: 4 tensors of shape (N,) -> list of levels, root last (each
    level 4 tensors of shape (N/2^k,)): one ``compress`` call a level."""
    cur = list(leaves)
    n = int(cur[0].shape[0])
    if n & (n - 1) or n < 1:
        raise ValueError(f"leaf count must be a power of two, got {n}")
    levels = [cur]
    while n > 1:
        cur = hasher.compress([d[0::2] for d in cur], [d[1::2] for d in cur])
        levels.append(cur)
        n //= 2
    return levels


def merkle_root(hasher: Poseidon2GL, leaves):
    return merkle_levels(hasher, leaves)[-1]


def merkle_open(levels, index: int) -> list[list[int]]:
    """Authentication path for leaf ``index`` from ``merkle_levels``
    output: the sibling digest at every level, leaf-adjacent first."""
    path = []
    node = index
    for lvl in levels[:-1]:
        sib = node ^ 1
        path.append([v & _M64 for v in torch.stack([d[sib] for d in lvl]).tolist()])
        node >>= 1
    return path


def merkle_verify(ref: PoseidonRef, root: list[int], index: int,
                  leaf: list[int], path: list[list[int]]) -> bool:
    """Host-side path check against the independent reference model."""
    dig = [int(v) % Q for v in leaf]
    node = index
    for sib in path:
        dig = ref.compress(sib, dig) if node & 1 else ref.compress(dig, sib)
        node >>= 1
    return dig == [int(v) % Q for v in root]


def digest_ints(digest) -> list[int]:
    """A 4-lane digest of one element a lane -> 4 Python ints."""
    return [v & _M64 for v in torch.cat([d.reshape(-1) for d in digest]).tolist()]

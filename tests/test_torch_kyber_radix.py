"""The radix-16 core of ``csrc/kyber.cu``'s ``kyber_dot`` modelled on the
CPU, and K4b's super-tile ablation body held to the port.

* The lazy arithmetic at q = 3329: a model of the .cu's 32-bit Shoup
  product (``__umulhi``), CT butterflies with no compare and GS ones with
  one, the Barrett step that makes a fresh b's lanes canonical, and the
  base case's REDC for products below 2^32 (``mont_small``: hi(m q) +
  (a b != 0), no high product, no compare), with the range asserts the .cu
  states beside each step (the forward's lanes below (3 + 2s) q after
  stage s, 15q at its end; GS lanes below 2q; b1 gamma at most q; a slot's
  c0 and c1 below 30 q^2 a term, eight terms' sum below 240 q^2 < 2^32;
  the scale's product below 2q), on every pair of 0, 1, q - 1, q, 2q - 1,
  4q - 1, 15q - 1 and random words.
* The schedule: a numpy model of the kernel (``Launch``: 16 threads a row,
  8 rows a block; the .cu's pass 1 (here 0), stages 0-3, on register k =
  element 16k + t loaded from device memory; one exchange; its pass 2
  (here 1), stages 4-6, on register k = element 16t + k; the per-pass tables of ``mxu64.pass_table`` for the
  passes ``kernels.kyber.PASSES``; the base case of slots 8t ... 8t + 7;
  the dot's loop, fresh and cached; the inverse mirrored, stored at the
  first pass's positions), at K = 1, 3 and 8 on batches that do not fill a tile,
  rows 0, 1 and q - 1 first: its forward against ``ntt_plain``, its dot
  against ``dot_plain`` and ``dot_cached_plain`` and against JAX's
  ``KyberPlan.dot`` and ``dot_cached`` in interpret mode; the tables cover
  every stage's twiddles once, at the offsets the .cu reads; the shared
  memory's accesses counted for bank conflicts (the exchange's 4-byte
  writes two ways at most, its reads a thread's adjacent words as 16-byte
  vectors, the private tiles none).
* A faked launch: ``kyber_dot`` receives the per-pass tables, the other
  five entry points the flat ones.
* K4b's ablation: JAX's ``KyberPlan`` with ``supertile = True`` and
  ``parity_matrices = False`` (tpu_ntt/kernels/kyber.py:482-484, body
  ``_poly_mult_kernel_st``) lives in tests/test_torch_kernels_kyber.py.

Operands come from ``numpy.random.default_rng``.  Tolerance: none — exact
integer equality.
"""

import functools
import re

import numpy as np
import pytest
import torch

from tpu_ntt.kernels.kyber import KyberPlan as JaxKyberPlan
from tpu_ntt_torch.convert import int32_to_uint32, kyber_spectra_from_jax, uint32_to_int32
from tpu_ntt_torch.kernels import _build
from tpu_ntt_torch.kernels import mxu64 as kmxu64
from tpu_ntt_torch.kernels.kyber import PASSES, KyberPlan

Q, N = 3329, 256
WORDS = 16  # words a thread holds
ROW_THREADS = N // WORDS  # 16 threads a row
TILE = 8  # rows a block
THREADS = TILE * ROW_THREADS
M32 = (1 << 32) - 1


def residues(shape, seed: int) -> np.ndarray:
    """uint32 residues of shape (..., 256); the first rows all 0, all 1 and
    all q - 1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint32)
    rows = x.reshape(-1, N)
    for k, v in enumerate((0, 1, Q - 1)[:rows.shape[0]]):
        rows[k] = v
    return x


def words(t: torch.Tensor) -> np.ndarray:
    return int32_to_uint32(t).astype(np.uint64)


# ---------------------------------------------------------------------------
# The lazy arithmetic, as the .cu states it
# ---------------------------------------------------------------------------


def shoup_lazy(a, w, ws):
    """a * w - hi(a * ws) q for any a < 2^32: in [0, 2q), congruent to a w."""
    a = np.asarray(a, dtype=np.uint64)
    assert np.all(a <= M32)
    r = a * np.uint64(w) - ((a * np.uint64(ws)) >> np.uint64(32)) * np.uint64(Q)
    assert np.all(r < 2 * Q) and np.all(r % Q == a * np.uint64(w) % np.uint64(Q))
    return r


def csub(x, m):
    return np.where(x >= m, x - np.uint64(m), x)


def ct(x, y, w, ws, bound):
    """No compare: x, y below ``bound`` in, below bound + 2q out (the .cu's
    stage s: bound (1 + 2s) q, 15q after seven stages)."""
    assert np.all(x < bound) and np.all(y < bound) and bound <= 13 * Q
    v = shoup_lazy(y, w, ws)
    out = x + v, x + np.uint64(2 * Q) - v
    assert all(np.all(z < bound + 2 * Q) for z in out)
    return out


def canonical(x):
    """x mod q for any 32-bit x: x - hi(x floor(2^32 / q)) q below 2q, one
    compare."""
    x = np.asarray(x, dtype=np.uint64)
    assert np.all(x <= M32)
    r = x - ((x * np.uint64(M32 // Q)) >> np.uint64(32)) * np.uint64(Q)
    assert np.all(r < 2 * Q)
    r = csub(r, Q)
    assert np.all(r == x % np.uint64(Q))
    return r


def gs(x, y, w, ws):
    """x, y in [0, 2q) in and out."""
    assert np.all(x < 2 * Q) and np.all(y < 2 * Q)
    out = csub(x + y, 2 * Q), shoup_lazy(x + np.uint64(2 * Q) - y, w, ws)
    assert all(np.all(z < 2 * Q) for z in out)
    return out


def mont_small(a, b, q_prime):
    """REDC(a b) for a b < 2^32: hi(m q) + (a b != 0) with m = a b q' mod
    2^32; in [0, q], congruent to a b 2^-32."""
    a, b = np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64)
    lo = a * b
    assert np.all(lo <= M32)
    m = (lo * np.uint64(q_prime)) & np.uint64(M32)
    r = ((m * np.uint64(Q)) >> np.uint64(32)) + (lo != 0)
    assert np.all(r <= Q) and np.all((r << np.uint64(32)) % np.uint64(Q) == lo % np.uint64(Q))
    return r


def base_case(a0, a1, b0, b1, gamma, q_prime):
    """A slot's plain products: t = REDC(b1 gamma 2^32) = b1 gamma in
    [0, q], c0 = a0 b0 + a1 t and c1 = a0 b1 + a1 b0, a's lanes below 15q,
    b's canonical, gamma below q; each below 30 q^2."""
    assert np.all(a0 < 15 * Q) and np.all(a1 < 15 * Q) and np.all(b0 < Q) and np.all(b1 < Q)
    t = mont_small(b1, gamma, q_prime)
    c0, c1 = a0 * b0 + a1 * t, a0 * b1 + a1 * b0
    assert np.all(c0 < 30 * Q * Q) and np.all(c1 < 30 * Q * Q)
    return c0, c1


def shoup(w: int) -> int:
    return (w << 32) // Q


@functools.lru_cache(maxsize=None)
def plan() -> KyberPlan:
    return KyberPlan("cpu")


def test_lazy_steps_hold_their_ranges():
    """Every step on every pair of the boundary and random words: the CT
    butterflies' x + wy, x - wy with no compare, their lanes below the
    stage's bound plus 2q; the GS lanes below 2q and x + y, (x - y) w; the
    Barrett step canonical on any 32-bit word; the REDC of products below
    2^32 at most q and congruent to a b 2^-32; the base case's c0, c1 below
    30 q^2 and equal to the slot's product (times 2^32 with a cached b);
    eight worst terms' sum below 240 q^2 < 2^32, and its lazy product by
    either of the dot's scales below 2q; the slack's edges: a CT lane past
    13q, and a product of 2^32 (lanes of 2^16), break their steps."""
    kp = plan()
    rng = np.random.default_rng(3329)
    q_prime = kp._q_prime
    edge = np.array([0, 1, Q - 1, Q, 2 * Q - 1, 4 * Q - 1, 13 * Q - 1], dtype=np.uint64)
    lanes = np.concatenate([edge, rng.integers(0, 13 * Q, 120, dtype=np.uint64)])
    x, y = (v.reshape(-1) for v in np.meshgrid(lanes, lanes))
    xo, yo = x.astype(object), y.astype(object)
    low = (x < 2 * Q) & (y < 2 * Q)
    for w in (0, 1, Q - 1, int(rng.integers(0, Q))):
        u, v = ct(x, y, w, shoup(w), 13 * Q)
        assert np.all((u.astype(object) - xo - w * yo) % Q == 0)
        assert np.all((v.astype(object) + w * yo - xo) % Q == 0)
        u, v = gs(x[low], y[low], w, shoup(w))
        assert np.all((u.astype(object) - xo[low] - yo[low]) % Q == 0)
        assert np.all((v.astype(object) - (xo[low] - yo[low]) * w) % Q == 0)
    words32 = np.concatenate([lanes, np.array([M32, M32 - 1, 240 * Q * Q], dtype=np.uint64),
                              rng.integers(0, 1 << 32, 4096, dtype=np.uint64)])
    canonical(words32)
    r_inv = pow(1 << 32, -1, Q)
    small = (x < 15 * Q) & (y < 4 * Q)
    p = mont_small(x[small], y[small], q_prime)
    assert np.all((p.astype(object) - xo[small] * yo[small] * r_inv) % Q == 0)
    gammas = words(kp._gamma_mont)
    assert np.all(gammas < Q)
    a0, a1 = (rng.integers(0, 15 * Q, 4096, dtype=np.uint64) for _ in range(2))
    b0, b1 = (rng.integers(0, Q, 4096, dtype=np.uint64) for _ in range(2))
    a0[:2], a1[:2], b0[:2], b1[:2] = 15 * Q - 1, 15 * Q - 1, Q - 1, Q - 1
    g = rng.choice(gammas, 4096)
    c0, c1 = base_case(a0, a1, b0, b1, g, q_prime)
    ao, bo = (a0.astype(object), a1.astype(object)), (b0.astype(object), b1.astype(object))
    gamma = g.astype(object) * r_inv  # gamma_i itself
    assert np.all((c0.astype(object) - ao[0] * bo[0] - ao[1] * bo[1] * gamma) % Q == 0)
    assert np.all((c1.astype(object) - ao[0] * bo[1] - ao[1] * bo[0]) % Q == 0)
    top = np.full(2, 15 * Q - 1, dtype=np.uint64)  # the worst lanes
    worst = base_case(*top, *np.full(2, Q - 1, dtype=np.uint64), np.uint64(gammas.max()), q_prime)
    total = 8 * max(int(c) for c in worst)
    assert total < 240 * Q * Q < 1 << 32
    for scale in kp._dot_scales:
        shoup_lazy(np.array([total, M32], dtype=np.uint64), *scale)
    with pytest.raises(AssertionError):  # a product at 2^32: the REDC needs its high word
        mont_small(np.array([1 << 16], np.uint64), np.array([1 << 16], np.uint64), q_prime)
    with pytest.raises(AssertionError):
        ct(np.array([13 * Q], dtype=np.uint64), np.zeros(1, np.uint64), 1, shoup(1), 13 * Q)
    with pytest.raises(AssertionError):
        gs(np.array([2 * Q], dtype=np.uint64), np.zeros(1, np.uint64), 1, shoup(1))


# ---------------------------------------------------------------------------
# The kernel's schedule, as the .cu lays it out
# ---------------------------------------------------------------------------


def pass_words(p: int, t):
    """The element register k of thread t holds in pass p: 16k + t in pass
    0 (stages 0-3), 16t + k in pass 1 (stages 4-6)."""
    return [WORDS * k + t if p == 0 else WORDS * t + k for k in range(WORDS)]


def source_constant(name: str) -> int:
    text = (_build.CSRC / "kyber.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


class Launch:
    """The threads of a kyber_dot launch on ``rows`` output rows, every
    block at once: each thread's row in its block's tile (g), index in its
    row (t), row of the tensor and whether it is live."""

    def __init__(self, rows: int):
        self.rows = rows
        self.blocks = -(-rows // TILE)
        tid = np.tile(np.arange(THREADS), self.blocks)
        block = np.repeat(np.arange(self.blocks), THREADS)
        self.g, self.t = tid // ROW_THREADS, tid % ROW_THREADS
        self.row = block * TILE + self.g
        self.live = self.row < rows
        self.slot = lambda i: block * (TILE * N) + self.g * N + i  # noqa: E731
        self.offsets = (0, 1 << (PASSES[0][0] + PASSES[0][1]))

    def load(self, x: np.ndarray, p: int) -> list:
        """Pass p's words of the (rows, 256) rows x (0 in a dead row)."""
        data = x.reshape(-1)
        at = np.where(self.live, self.row * N, 0)
        return [np.where(self.live, data[at + i], 0).astype(np.uint64)
                for i in pass_words(p, self.t)]

    def exchange(self, regs: list, written: int, read: int) -> list:
        """Write pass ``written``'s words to the row's tile, read pass
        ``read``'s: every word read is one written, no two threads write one
        word, and each thread's words stay in its row's 1 KiB."""
        smem = np.full(self.blocks * TILE * N, -1, dtype=np.int64)
        for reg, i in enumerate(pass_words(written, self.t)):
            assert np.all(smem[self.slot(i)] < 0) and np.all(i < N)
            smem[self.slot(i)] = regs[reg]
        out = [smem[self.slot(i)] for i in pass_words(read, self.t)]
        assert all(np.all(v >= 0) for v in out)
        return [v.astype(np.uint64) for v in out]

    def run_pass(self, x: list, tables, p: int, inverse: bool) -> None:
        """The stages of pass p (stage s + d pairs registers k and
        k + 2^(3 - d), twiddle k >> (4 - d) of the group), reversed with
        ``inverse`` (GS; CT lanes below (1 + 2(s + d)) q in); the twiddle of
        stage s + d, u-th of group hi, at word 2^d + u (0 for d = 0) of the
        group's pairs."""
        (s, stages), (w_tab, ws_tab) = PASSES[p], tables
        hi = 0 if p == 0 else self.t
        for d in (reversed(range(stages)) if inverse else range(stages)):
            span = 8 >> d
            w, ws = [], []
            for u in range(1 << d):
                word = 0 if d == 0 else (1 << d) + u
                at = self.offsets[p] + 2 * (((word // 2) << s) + hi) + word % 2
                w.append(w_tab[at])
                ws.append(ws_tab[at])
            for k in range(WORDS):
                if not k & span:
                    e = k >> (4 - d)
                    if inverse:
                        x[k], x[k + span] = gs(x[k], x[k + span], w[e], ws[e])
                    else:
                        x[k], x[k + span] = ct(x[k], x[k + span], w[e], ws[e],
                                               (1 + 2 * (s + d)) * Q)

    def forward(self, x: np.ndarray, tables) -> list:
        """Pass 0 from device memory, the exchange, pass 1: lanes below 15q,
        thread t holding words 16t ... 16t + 15."""
        regs = self.load(x, 0)
        self.run_pass(regs, tables, 0, inverse=False)
        regs = self.exchange(regs, 0, 1)
        self.run_pass(regs, tables, 1, inverse=False)
        return regs

    def inverse(self, regs: list, tables) -> torch.Tensor:
        """Pass 1 reversed from words 16t ... (lanes in [0, 2q)), the
        exchange, pass 0 reversed, one compare, the store at pass 0's
        positions."""
        self.run_pass(regs, tables, 1, inverse=True)
        regs = self.exchange(regs, 1, 0)
        self.run_pass(regs, tables, 0, inverse=True)
        out = np.zeros(self.rows * N, dtype=np.uint64)
        for reg, i in enumerate(pass_words(0, self.t)):
            v = csub(regs[reg], Q)
            assert np.all(v < Q)
            out[(self.row * N + i)[self.live]] = v[self.live]
        return uint32_to_int32(out.astype(np.uint32).reshape(self.rows, N))


def tables(kp: KyberPlan):
    """kyber_dot's forward and inverse per-pass tables (w, w') as words."""
    tw = tuple(words(t) for t in kp._dot_tables[:2])
    itw = tuple(words(t) for t in kp._dot_tables[2:4])
    return tw, itw


def forward_model(kp: KyberPlan, x: torch.Tensor) -> torch.Tensor:
    """The forward of (R, 256) rows made canonical and stored at words
    16t + k: Algorithm 9's spectrum in FIPS order."""
    run = Launch(x.shape[0])
    regs = run.forward(words(x), tables(kp)[0])
    out = np.zeros(x.shape[0] * N, dtype=np.uint64)
    for reg, i in enumerate(pass_words(1, run.t)):
        out[(run.row * N + i)[run.live]] = canonical(regs[reg])[run.live]
    return uint32_to_int32(out.astype(np.uint32).reshape(x.shape[0], N))


def dot_model(kp: KyberPlan, a: torch.Tensor, b: torch.Tensor, cached: bool) -> torch.Tensor:
    """dot_kernel on (K, R, 256) stacks: a step a forward (b's lanes of a
    fresh term made canonical, then a's), the base case of slots 8t ...
    8t + 7 against b's words (a cached spectrum's words 16t ... 16t + 15 of
    its row), each slot's plain products added into the sum with no
    reduction, the sum times the dot's scale, one inverse."""
    run = Launch(a.shape[1])
    tw, itw = tables(kp)
    gamma = words(kp._gamma_mont)
    q_prime = kp._q_prime
    acc = [np.zeros_like(run.t, dtype=np.uint64) for _ in range(WORDS)]
    for k in range(a.shape[0]):
        y = run.load(words(b[k]), 1) if cached else [canonical(v) for v in
                                                      run.forward(words(b[k]), tw)]
        x = run.forward(words(a[k]), tw)
        for j in range(WORDS // 2):  # slot 8t + j: words 2j, 2j + 1
            c0, c1 = base_case(x[2 * j], x[2 * j + 1], y[2 * j], y[2 * j + 1],
                               gamma[8 * run.t + j], q_prime)
            acc[2 * j], acc[2 * j + 1] = acc[2 * j] + c0, acc[2 * j + 1] + c1
    assert all(np.all(v < 30 * Q * Q * a.shape[0]) for v in acc) and a.shape[0] <= 8
    return run.inverse([shoup_lazy(v, *kp._dot_scales[cached]) for v in acc], itw)


def test_pass_table_covers_every_stage_once():
    """The passes ((0, 4), (4, 3)) cover Algorithm 9's seven stages in
    order; their per-pass layout holds every flat entry 1 ... 127 once
    (pass 0's 16 words, pass 1's 16 groups of four pairs, the pads entry
    0), pass 1 at the offset the .cu reads (kLastTable), the table 16-byte
    loads' alignment; the plan builds both tables once, from the merged
    forward and inverse tables, beside gamma_i * 2^32, and the .cu's shape
    constants are the model's."""
    assert [s for s, _ in PASSES] == [0, PASSES[0][1]] and sum(r for _, r in PASSES) == 7
    idx = kmxu64.schedule_indices(PASSES)
    assert len(idx) == sum(1 << (s + r) for s, r in PASSES) == 144
    assert np.array_equal(np.sort(idx[idx > 0]), np.arange(1, 128))
    assert np.count_nonzero(idx == 0) == 1 + 16  # the pads: pass 0's one, a group's in pass 1
    assert source_constant("kLastTable") == 1 << sum(PASSES[0])
    assert (source_constant("kWords"), source_constant("kTile")) == (WORDS, TILE)
    kp = plan()
    tw, tws, itw, itws, gamma = kp._dot_tables
    for got, flat in ((tw, kp.plan.merged_flat[0]), (tws, kp.plan.merged_flat[1]),
                      (itw, kp.plan.merged_inv_flat[0]), (itws, kp.plan.merged_inv_flat[1])):
        assert got.dtype == torch.int32 and got.is_contiguous() and got.shape == (144,)
        assert torch.equal(got, flat[torch.from_numpy(idx)])
    assert gamma is kp._gamma_mont and gamma.shape == (128,)
    # pass 1's stage 4 + d twiddle u of group t: flat entry 2^(4 + d) + t 2^d + u
    for t in range(16):
        for d in range(3):
            for u in range(1 << d):
                word = 0 if d == 0 else (1 << d) + u
                assert idx[16 + 2 * (((word // 2) << 4) + t) + word % 2] == (16 << d) + t * (1 << d) + u


def test_shared_memory_accesses():
    """The exchange: no two threads of a block write one word, every word
    lies in the thread's own row of the tile (a row's 16 threads are half
    a warp, so the warp's barrier orders them), and both passes' words are
    written and read; a warp's 4-byte accesses of pass 0's words hit every
    bank at most twice; pass 1's words of a thread are adjacent and 16-byte
    aligned (four 16-byte vectors); the private tiles' words (w * 128 + i)
    hit 32 banks a warp; a warp holds whole rows."""
    run = Launch(TILE)
    tid = run.g * ROW_THREADS + run.t
    assert np.array_equal(tid // 32, (run.g * ROW_THREADS) // 32)  # a row in one warp
    for p in (0, 1):
        slots = np.stack([run.slot(i) for i in pass_words(p, run.t)])
        assert len(np.unique(slots)) == slots.size and slots.max() < TILE * N
        assert np.all(slots // N == run.g)
        if p == 1:
            assert np.array_equal(slots - slots[0], np.arange(WORDS)[:, None]
                                  + np.zeros_like(slots[0]))
            assert np.all(slots[0] % 4 == 0)
            continue
        banks = slots.reshape(WORDS, -1, 32) % 32
        ways = max(np.bincount(warp, minlength=32).max() for warp in banks.reshape(-1, 32))
        assert ways <= 2, ways
    own = np.arange(WORDS)[:, None] * THREADS + np.arange(THREADS)
    assert len(np.unique(own)) == own.size
    assert all(len(np.unique(warp % 32)) == 32 for warp in own.reshape(-1, 32))


@pytest.mark.parametrize("rows", [1, 5, 11])
def test_forward_model_matches_plain(rows):
    """The model's forward of (R, 256) rows, rows 0, 1 and q - 1 first, R
    not a multiple of the tile: canonical, it equals ``ntt_plain`` in FIPS
    order (so the spectrum's words 16t ... 16t + 15 are slots 8t ...
    8t + 7)."""
    kp = plan()
    x = uint32_to_int32(residues((rows, N), seed=rows))
    assert torch.equal(forward_model(kp, x), kp.ntt_plain(x))


@functools.lru_cache(maxsize=None)
def jax_plan() -> JaxKyberPlan:
    jp = JaxKyberPlan()
    jp.groups_per_step = 1  # keep interpret-mode cost down
    return jp


@pytest.mark.parametrize("terms,rows", [(1, 1), (3, 5), (8, 11)])
def test_dot_model_matches_plain_and_jax(terms, rows):
    """dot_kernel's model at K terms on R rows (R not a multiple of the
    tile), rows 0, 1 and q - 1 first, b's reversed against a's (0 meets
    q - 1), fresh and against the spectra: equal to ``dot_plain`` and
    ``dot_cached_plain``, to each other, and at K = 3 and 8 to JAX's
    ``KyberPlan.dot`` and ``dot_cached`` in interpret mode, JAX's spectra
    through ``kyber_spectra_from_jax``."""
    kp = plan()
    a_np, b_np = residues((terms, rows, N), seed=terms), residues((terms, rows, N), seed=rows)
    b_np[0, :3] = b_np[0, 2::-1].copy()
    a, b = uint32_to_int32(a_np), uint32_to_int32(b_np)
    spectra = kp.spectrum_plain(b.reshape(-1, N)).reshape(b.shape)
    fresh = dot_model(kp, a, b, cached=False)
    assert torch.equal(fresh, kp.dot_plain(a, b))
    cached = dot_model(kp, a, spectra, cached=True)
    assert torch.equal(cached, kp.dot_cached_plain(a, spectra))
    assert torch.equal(fresh, cached)
    if terms == 1:
        return
    jp = jax_plan()
    assert np.array_equal(int32_to_uint32(fresh), np.asarray(jp.dot(a_np, b_np, True)))
    jspec = np.asarray(jp.spectrum(b_np.reshape(-1, N), True)).reshape(b_np.shape)
    assert torch.equal(kyber_spectra_from_jax(jspec), spectra)
    assert np.array_equal(int32_to_uint32(cached), np.asarray(jp.dot_cached(a_np, jspec, True)))


def test_dot_model_sum_at_its_bound():
    """Eight terms of all q - 1 rows against b rows of q - 1 and 0 (and
    their spectra): the sum's lanes reach their largest, the model's
    asserts hold, and the result equals the plain dot."""
    kp = plan()
    a = torch.full((8, 9, N), Q - 1, dtype=torch.int32)
    b = torch.full((8, 9, N), Q - 1, dtype=torch.int32)
    b[:, 1::2] = 0
    spectra = kp.spectrum_plain(b.reshape(-1, N)).reshape(b.shape)
    assert torch.equal(dot_model(kp, a, b, cached=False), kp.dot_plain(a, b))
    assert torch.equal(dot_model(kp, a, spectra, cached=True), kp.dot_cached_plain(a, spectra))


# ---------------------------------------------------------------------------
# The launch path, faked on the CPU
# ---------------------------------------------------------------------------


def test_dot_launches_with_per_pass_tables(monkeypatch):
    """On the launch path (the plan told its tensors are on a card)
    ``dot`` and ``dot_cached`` hand kyber_dot the per-pass tables of the
    merged forward and inverse tables and gamma_i * 2^32, with K, B, q, q',
    the dot's scale (128^-1, and 2^-32 against spectra) and the cached
    flag; the other entry points the flat tables."""
    kp = KyberPlan("cpu")
    calls = []
    monkeypatch.setattr("tpu_ntt_torch.kernels.kyber._plan.runs_plain", lambda x: False)
    monkeypatch.setattr(kp, "_launch", lambda entry, out, *args: calls.append(
        (entry, args)) or out)
    a = uint32_to_int32(residues((3, 2, N), seed=7))
    for fn, cached in ((kp.dot, 0), (kp.dot_cached, 1)):
        calls.clear()
        fn(a, a)
        (entry, args), = calls
        assert entry == "dot"
        assert all(x is y for x, y in zip(args[3:8], kp._dot_tables))
        assert args[8:] == (3, 2, Q, kp._q_prime, *kp._dot_scales[cached], cached)
    half_inv, r = pow(128, -1, Q), (1 << 32) % Q
    assert [w for w, _ in kp._dot_scales] == [half_inv, half_inv * pow(r, -1, Q) % Q]
    flat = kp._tables()
    calls.clear()
    kp.poly_mult(a[0], a[0])
    kp.matvec(a, a[:, :1].reshape(1, 3, N).contiguous())
    for entry, args in calls:
        assert entry in ("product", "matvec")
        assert all(x is y for x, y in zip(args[3:8], flat)), entry
        assert args[3].shape == (128,)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_dot_matches_plain(cuda_device):
    """kyber_dot on the card against the plain dots, fresh and cached, at
    K = 1, 3 and 8 on 1, 5 and 11 rows."""
    kp = KyberPlan(cuda_device)
    for terms, rows in ((1, 1), (3, 5), (8, 11)):
        a, b = (uint32_to_int32(residues((terms, rows, N), seed=s)).to(cuda_device)
                for s in (terms, rows))
        spectra = kp.spectrum(b.reshape(-1, N)).reshape(b.shape)
        assert torch.equal(kp.dot(a, b), kp.dot_plain(a, b))
        assert torch.equal(kp.dot_cached(a, spectra), kp.dot_cached_plain(a, spectra))

"""The radix-16 core of ``csrc/nwc32.cu`` (``nwc32_forward``,
``nwc32_inverse``, and fused on it ``nwc32_product``, ``nwc32_cached``,
``nwc32_dot`` and ``nwc32_matvec``) modelled on the CPU, and K3's two
ablation toggles.

* The lazy arithmetic: a model of the .cu's 32-bit Shoup product
  (``__umulhi``), CT and GS butterflies, lazy REDC slot, the dot's sum, the
  matvec's REDC of its 64-bit sum and the stores, with the range asserts
  the .cu states beside each step (CT lanes below 4q, GS lanes, slot
  products and the sum below 2q, the matvec's REDC of eight products below
  3q, every word below 2^32), on every pair of 0, 1, q - 1, q, 2q - 1, 4q - 1 and random
  words at DILITHIUM_256's and P24_4096's q = 8380417, q = 16580609,
  FALCON's q = 12289 and q = 2^30 - 2^18 + 1, near the header's bound.
* The pass schedule: a numpy model of the kernels (which words each thread
  holds in each pass, the exchanges through the tile, the per-pass tables
  of ``mxu64.pass_table`` at four stages a pass, the forward, the inverse's
  passes in reverse order, the slot, the dot's loop, the matvec's loop and
  its output rows) at n = 256, 4096 and
  16384, boundary rows 0, 1 and q - 1 first, cyclic and merged tables:
  the forward at scales 1 and 2^32 mod q against ``ntt_fwd_plain``,
  ``nwc_ntt_fwd_plain`` and ``nwc_spectrum_plain``; the inverse
  (``nwc32_inverse``: the spectrum's words, n^-1's lazy Shoup product, the
  passes) against ``nwc_ntt_inv_plain`` and ``ntt_inv_plain``, and above
  n = 256 against JAX's jitted XLA inverses; the fused product, cyclic
  product, cached product and dot (K = 1 and 3, fresh and cached) against
  their plain versions; and all of them against JAX: ``MxuPlan`` in
  interpret mode at DILITHIUM_256 (``nwc_poly_mult``,
  ``nwc_poly_mult_cached``, ``nwc_dot``, ``nwc_dot_cached`` at K = 3), its
  jitted XLA transforms at n = 4096 and 16384, through the layout maps; the
  matvec's accumulate-and-inverse (``radix_matvec_kernel``: words 16t ...
  16t + 15 of S[j, r] and A[i, j] a loop step, their plain products summed
  in 64 bits, one REDC, n^-1, the inverse, the k output rows of a batch
  row adjacent)
  at (k, l) = (1, 1), (4, 4) and (3, 5) on the spectra of s against
  ``nwc_matvec_cached_plain`` and the slot sums of JAX's jitted XLA
  transforms, at DILITHIUM_256 (1, 1) also against ``MxuPlan`` in
  interpret mode; the shared-memory accesses of every exchange of both directions and of the
  private tiles at every n from 256 to 16384, counted for bank conflicts
  (two ways at most, the last pass's words adjacent, the private tiles
  none).
* Faked launches on the CPU: ``nwc32_forward``, ``nwc32_inverse``,
  ``nwc32_product``, ``nwc32_cached``, ``nwc32_dot`` and ``nwc32_matvec``
  receive the per-pass tables.
* JAX's ``MxuPlan`` with ``int8_path=False`` (bf16 limbs) and with
  ``balanced = True`` (tpu_ntt/kernels/mxu.py:103-105) in interpret mode
  at DILITHIUM_256: ``nwc_ntt_fwd``, ``nwc_spectrum`` and
  ``nwc_poly_mult`` give the port's integers.

Operands come from ``numpy.random.default_rng``.  Tolerance: none — exact
integer equality.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
from tpu_ntt.kernels.mxu import MxuPlan as JaxMxuPlan
from tpu_ntt_torch.convert import (int32_to_uint32, matvec_spectra_from_jax, spectra_from_jax,
                                   uint32_to_int32)
from tpu_ntt_torch.kernels import mxu64 as kmxu64
from tpu_ntt_torch.kernels.mxu import RADIX, MxuPlan
from tpu_ntt_torch.params import DILITHIUM_256, make_params

Q30 = (1 << 30) - (1 << 18) + 1  # a prime near the header's bound q < 2^30
QS = (8380417, 16580609, 12289)
WORDS = 16  # words a thread holds
M32 = (1 << 32) - 1


def operands(q: int, shape, seed: int) -> np.ndarray:
    """uint32 residues of the given shape; the first rows are all 0, all 1
    and all q - 1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, size=shape, dtype=np.uint32)
    rows = x.reshape(-1, shape[-1])
    for k, v in enumerate((0, 1, q - 1)[:rows.shape[0]]):
        rows[k] = v
    return x


def words(t: torch.Tensor) -> np.ndarray:
    """int32 words -> their uint32 values, as uint64 (products fit)."""
    return int32_to_uint32(t).astype(np.uint64)


# ---------------------------------------------------------------------------
# The lazy arithmetic, as the .cu states it (q < 2^30: every lane < 4q < 2^32)
# ---------------------------------------------------------------------------


def shoup_lazy(a, w, ws, q):
    """a * w - hi(a * ws) q for any a < 2^32: in [0, 2q), congruent to a w."""
    a = np.asarray(a, dtype=np.uint64)
    assert np.all(a <= M32)
    hi = (a * np.uint64(ws)) >> np.uint64(32)
    r = a * np.uint64(w) - hi * np.uint64(q)  # the exact value: nothing wraps
    assert np.all(r < 2 * q) and np.all(r % q == a * np.uint64(w) % np.uint64(q))
    return r


def csub(x, m):
    return np.where(x >= m, x - np.uint64(m), x)


def ct(x, y, w, ws, q, fresh=False):
    """The CT butterfly: x, y in [0, 4q) in and out; fresh (the first
    stage of a forward): x below q, no compare."""
    assert np.all(x < (q if fresh else 4 * q)) and np.all(y < 4 * q)
    u = x if fresh else csub(x, 2 * q)
    v = shoup_lazy(y, w, ws, q)
    out = u + v, u + np.uint64(2 * q) - v
    assert all(np.all(z < 4 * q) for z in out) and 4 * q <= M32
    return out


def gs(x, y, w, ws, q):
    """The GS butterfly: x, y in [0, 2q) in and out; x + y below 4q < 2^32
    before its compare."""
    assert np.all(x < 2 * q) and np.all(y < 2 * q) and 4 * q <= M32
    out = csub(x + y, 2 * q), shoup_lazy(x + np.uint64(2 * q) - y, w, ws, q)
    assert all(np.all(z < 2 * q) for z in out)
    return out


def mont_lazy(a, b, q, q_prime):
    """The slot's lazy REDC: hi(a b) + hi(m q) + (lo(a b) != 0), m = lo(a b)
    q'; for a b < q 2^32 in [0, 2q), congruent to a b 2^-32."""
    a, b = np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64)
    ab = a * b  # below 2^64: both words below 2^32
    assert np.all(ab < np.uint64(q) << np.uint64(32))
    lo = ab & np.uint64(M32)
    m = (lo * np.uint64(q_prime)) & np.uint64(M32)
    r = (ab >> np.uint64(32)) + ((m * np.uint64(q)) >> np.uint64(32)) + (lo != 0)
    assert np.all(r < 2 * q) and np.all((r << np.uint64(32)) % np.uint64(q) == ab % np.uint64(q))
    return r


def slot(x, y, q, q_prime, cached):
    """a's forward lane x of [0, 4q) times b's y: y of a fresh spectrum in
    [0, 2q) and x brought under 2q, or y of a cached one in [0, q) and x as
    it is; [0, 2q) out."""
    assert np.all(x < 4 * q) and np.all(y < (q if cached else 2 * q))
    return mont_lazy(x if cached else csub(x, 2 * q), y, q, q_prime)


def add_sum(acc, p, q):
    """The dot's sum: acc and a slot product below 2q, one compare."""
    assert np.all(acc < 2 * q) and np.all(p < 2 * q) and 4 * q <= M32
    out = csub(acc + p, 2 * q)
    assert np.all(out < 2 * q)
    return out


def redc64(t, q, q_prime):
    """The matvec's REDC of its 64-bit sum t < 2^63: (t + m q) / 2^32 with
    m = lo(t) q' mod 2^32 (t + m q below 2^64: no wrap); congruent to
    t 2^-32, below t / 2^32 + q."""
    t = np.asarray(t, dtype=np.uint64)
    assert np.all(t < np.uint64(1 << 63))
    m = ((t & np.uint64(M32)) * np.uint64(q_prime)) & np.uint64(M32)
    r = (t + m * np.uint64(q)) >> np.uint64(32)
    assert np.all(r.astype(object) < t.astype(object) // (1 << 32) + q + 1)
    assert np.all((r << np.uint64(32)) % np.uint64(q) == t % np.uint64(q))
    return r


def forward_out(x, scale, scale_shoup, q):
    """The forward's store: [0, 4q) -> [0, q), times scale unless it is 1."""
    y = csub(csub(x, 2 * q), q) if scale == 1 else csub(shoup_lazy(x, scale, scale_shoup, q), q)
    assert np.all(y < q)
    return y


def shoup(w: int, q: int) -> int:
    return (w << 32) // q


@pytest.mark.parametrize("q", QS + (Q30,))
def test_lazy_butterflies_hold_their_ranges(q):
    """Every step on every pair of the boundary words and random words: the
    Shoup product in [0, 2q) for any 32-bit word, the CT lanes in [0, 4q),
    the GS lanes, the slot's lazy REDC and the dot's sum in [0, 2q), the
    stores canonical; the butterflies' outputs are x + wy, x - wy and
    x + y, (x - y) w, the slot's x y 2^-32; the matvec's REDC of 64-bit sums
    of up to eight products of canonical words (8 (q - 1)^2 first) below 3q
    and congruent to the sum times 2^-32."""
    rng = np.random.default_rng(q)
    q_prime = (-pow(q, -1, 1 << 32)) % (1 << 32)
    edge = np.array([0, 1, q - 1, q, 2 * q - 1, 4 * q - 1], dtype=np.uint64)
    lanes = np.concatenate([edge, rng.integers(0, 4 * q, 200, dtype=np.uint64)])
    x, y = (v.reshape(-1) for v in np.meshgrid(lanes, lanes))
    xo, yo = x.astype(object), y.astype(object)
    low, low_y = x < 2 * q, y < 2 * q
    for w in (0, 1, q - 1, int(rng.integers(0, q))):
        u, v = ct(x, y, w, shoup(w, q), q)
        assert np.all((u.astype(object) - xo - w * yo) % q == 0)
        assert np.all((v.astype(object) + w * yo - xo) % q == 0)
        fresh = x[x < q]
        ct(fresh, y[x < q], w, shoup(w, q), q, fresh=True)
        shoup_lazy(np.array([M32, M32 - 1], dtype=np.uint64), w, shoup(w, q), q)
        both = low & low_y
        u, v = gs(x[both], y[both], w, shoup(w, q), q)
        assert np.all((u.astype(object) - xo[both] - yo[both]) % q == 0)
        assert np.all((v.astype(object) - (xo[both] - yo[both]) * w) % q == 0)
    r_inv = pow(1 << 32, -1, q)
    fresh_p = slot(x[low_y], y[low_y], q, q_prime, cached=False)
    assert np.all((fresh_p.astype(object) - xo[low_y] * yo[low_y] * r_inv) % q == 0)
    canon = y < q
    cached_p = slot(x[canon], y[canon], q, q_prime, cached=True)
    assert np.all((cached_p.astype(object) - xo[canon] * yo[canon] * r_inv) % q == 0)
    acc = add_sum(x[low & low_y], fresh_p[low[low_y]], q)
    assert np.all((acc.astype(object) - xo[low & low_y] - fresh_p[low[low_y]].astype(object))
                  % q == 0)
    for scale in (1, (1 << 32) % q, q - 1):
        got = forward_out(lanes, scale, shoup(scale, q), q)
        assert np.all(got == lanes * np.uint64(scale) % np.uint64(q))
    # the matvec's 64-bit sums of up to eight products of canonical words,
    # their worst first: one REDC below 3q, then the scale's product below 2q
    canon = np.concatenate([np.array([q - 1, 0, 1], dtype=np.uint64),
                            rng.integers(0, q, 64, dtype=np.uint64)])
    sums = np.concatenate([[np.uint64(8 * (q - 1) ** 2)],
                           (canon[:, None] * canon[None, :]).reshape(-1) * np.uint64(8),
                           rng.integers(0, 8 * q * q, 4096, dtype=np.uint64)])
    reduced = redc64(sums, q, q_prime)
    assert np.all(reduced < 3 * q) and np.all(shoup_lazy(reduced, 1, shoup(1, q), q) < 2 * q)
    with pytest.raises(AssertionError):
        ct(np.array([4 * q], dtype=np.uint64), np.zeros(1, np.uint64), 1, shoup(1, q), q)
    with pytest.raises(AssertionError):
        gs(np.array([2 * q], dtype=np.uint64), np.zeros(1, np.uint64), 1, shoup(1, q), q)
    with pytest.raises(AssertionError):  # x y at or above q 2^32
        mont_lazy(np.array([M32], dtype=np.uint64), np.array([M32], np.uint64), q, q_prime)
    if q == Q30:  # near 2^30, a fresh lane must come under 2q first
        with pytest.raises(AssertionError):
            mont_lazy(np.array([4 * q - 1], dtype=np.uint64), np.array([2 * q - 1], np.uint64),
                      q, q_prime)


# ---------------------------------------------------------------------------
# The kernels' schedule, as the .cu lays it out
# ---------------------------------------------------------------------------


def tile(log_n: int) -> int:
    """Rows a block (the .cu's ``tile``): at least 128 threads."""
    return 1 if log_n >= 11 else 2048 >> log_n


def element(log_n: int, s: int, r: int, t, reg: int):
    """The element register ``reg`` of thread t holds in pass (s, r)."""
    T = (1 << log_n) >> (s + r)
    j = t + (reg >> r) * ((1 << log_n) // WORDS)
    return (j // T) * (T << r) + (reg % (1 << r)) * T + j % T


def threads(log_n: int):
    """(g, t) of each thread of a block: its row in the tile and its index
    in the row."""
    per = (1 << log_n) // WORDS
    tid = np.arange(tile(log_n) * per)
    return tid // per, tid % per


def pass_words(log_n: int, p: int, t):
    s, r = kmxu64.passes(log_n, RADIX)[p]
    return [element(log_n, s, r, t, reg) for reg in range(WORDS)]


class Launch:
    """The threads of a launch on ``rows`` rows of n, every block at once:
    each thread's block, row in the block's tile (g), index in its row (t),
    row of the tensor and whether it is live."""

    def __init__(self, plan: MxuPlan, rows: int):
        self.log_n, self.n, self.q = plan.p.log_n, plan.p.n, plan.p.q
        self.q_prime = plan._q_prime
        self.schedule = kmxu64.passes(self.log_n, RADIX)
        self.offsets = np.cumsum([0] + [1 << (r + s) for s, r in self.schedule])
        g_tile = tile(self.log_n)
        g, t = threads(self.log_n)
        self.blocks = -(-rows // g_tile)
        self.g, self.t = np.tile(g, self.blocks), np.tile(t, self.blocks)
        block = np.repeat(np.arange(self.blocks), g_tile * self.n // WORDS)
        self.slot = lambda i: block * (g_tile << self.log_n) + self.g * self.n + i  # noqa: E731
        self.rows = rows
        self.row = block * g_tile + self.g
        self.live = self.row < rows

    def load(self, x: torch.Tensor, p: int) -> list:
        """Pass p's words of the (rows, n) tensor x (0 in a dead row)."""
        data = words(x).reshape(-1)
        live, row = self.live, self.row
        return [np.where(live, data[np.where(live, row * self.n + i, 0)], 0).astype(np.uint64)
                for i in pass_words(self.log_n, p, self.t)]

    def store(self, regs: list, p: int, out_row=None) -> torch.Tensor:
        """Pass p's words to the rows of a (rows, n) tensor: each thread's
        own row, or ``out_row`` (a row for each thread)."""
        out = np.zeros(self.rows * self.n, dtype=np.uint64)
        row = self.row if out_row is None else out_row
        for reg, i in enumerate(pass_words(self.log_n, p, self.t)):
            assert np.all(regs[reg][self.live] < self.q)
            out[(row * self.n + i)[self.live]] = regs[reg][self.live]
        return uint32_to_int32(out.astype(np.uint32).reshape(self.rows, self.n))

    def exchange(self, regs: list, written: int, read: int) -> list:
        """Each thread writes pass ``written``'s words to the tile and reads
        pass ``read``'s: every word read is one written, no two threads
        write one word."""
        smem = np.full(self.blocks * (tile(self.log_n) << self.log_n), -1, dtype=np.int64)
        for reg, i in enumerate(pass_words(self.log_n, written, self.t)):
            assert np.all(smem[self.slot(i)] < 0)
            smem[self.slot(i)] = regs[reg]
        out = [smem[self.slot(i)] for i in pass_words(self.log_n, read, self.t)]
        assert all(np.all(v >= 0) for v in out)
        return [v.astype(np.uint64) for v in out]

    def run_pass(self, x, tables, p: int, inverse: bool, fresh: bool = False):
        """The stages of pass p on the registers x, in reverse order with
        ``inverse`` (GS): stage s + d's u-th twiddle of group hi at word
        2^d + u (word 0 for d = 0) of the group's pairs; ``fresh``: a
        forward's first stage, on words below q."""
        (s, r), w_tab, ws_tab = self.schedule[p], *tables
        hi = 0 if p == 0 else self.t // (self.n >> (s + RADIX))
        for d in (reversed(range(r)) if inverse else range(r)):
            span = (1 << r) >> (d + 1)
            w, ws = [], []
            for u in range(1 << d):
                word = 0 if d == 0 else (1 << d) + u
                at = self.offsets[p] + 2 * (((word // 2) << s) + hi) + word % 2
                w.append(w_tab[at])
                ws.append(ws_tab[at])
            for reg in range(WORDS):
                k = reg % (1 << r)
                if not k & span:
                    e = k >> (r - d)
                    if inverse:
                        x[reg], x[reg + span] = gs(x[reg], x[reg + span], w[e], ws[e], self.q)
                    else:
                        x[reg], x[reg + span] = ct(x[reg], x[reg + span], w[e], ws[e], self.q,
                                                   fresh and d == 0)

    def forward(self, x: torch.Tensor, tables) -> list:
        """The forward of the rows x: the first pass from device memory,
        each later pass after its exchange; lanes in [0, 4q) out, thread t
        holding spectrum words 16t ... 16t + 15."""
        regs = self.load(x, 0)
        for p in range(len(self.schedule)):
            if p:
                regs = self.exchange(regs, p - 1, p)
            self.run_pass(regs, tables, p, inverse=False, fresh=p == 0)
        last = pass_words(self.log_n, len(self.schedule) - 1, self.t)
        assert all(np.all(i == WORDS * self.t + reg) for reg, i in enumerate(last))
        return regs

    def inverse(self, regs: list, tables, out_row=None) -> torch.Tensor:
        """The inverse from the last pass's registers (lanes in [0, 2q)):
        the passes in reverse order, each after its exchange, then the
        store in natural order at the forward's load positions, one
        compare (to ``out_row`` as ``store``)."""
        last = len(self.schedule) - 1
        for p in range(last, -1, -1):
            if p < last:
                regs = self.exchange(regs, p + 1, p)
            self.run_pass(regs, tables, p, inverse=True)
        return self.store([csub(v, self.q) for v in regs], 0, out_row)


def per_pass(plan: MxuPlan, flat: tuple):
    return tuple(words(t) for t in plan._transform_table(flat))


def model(plan: MxuPlan, x: torch.Tensor, flat: tuple, scale: tuple) -> torch.Tensor:
    """radix_forward_kernel on (R, n) int32 rows: the forward, the store of
    words 16t ... 16t + 15 at ``scale``."""
    run = Launch(plan, x.shape[0])
    regs = run.forward(x, per_pass(plan, flat))
    return run.store([forward_out(v, *scale, run.q) for v in regs], len(run.schedule) - 1)


def inverse_model(plan: MxuPlan, spectrum: torch.Tensor, iflat: tuple) -> torch.Tensor:
    """The inverse of (R, n) spectra on the radix-16 core: their words
    16t ... 16t + 15, one lazy Shoup product by n^-1, inverse_row."""
    run = Launch(plan, spectrum.shape[0])
    regs = run.load(spectrum, len(run.schedule) - 1)
    regs = [shoup_lazy(v, *plan._scale_cached, run.q) for v in regs]
    return run.inverse(regs, per_pass(plan, iflat))


def product_model(plan: MxuPlan, a: torch.Tensor, b: torch.Tensor, flat: tuple, iflat: tuple,
                  cached: bool) -> torch.Tensor:
    """product_kernel: b's forward (its lanes under 2q, the private tile's
    words) or, ``cached``, b's spectrum words 16t ... 16t + 15; a's
    forward, the slot times the wrapper's scale, the inverse."""
    run = Launch(plan, a.shape[0])
    tw, itw = per_pass(plan, flat), per_pass(plan, iflat)
    last = len(run.schedule) - 1
    y = run.load(b, last) if cached else [csub(v, 2 * run.q) for v in run.forward(b, tw)]
    x = run.forward(a, tw)
    scale = plan._scale_cached if cached else plan._scale_fresh
    regs = [shoup_lazy(slot(u, v, run.q, run.q_prime, cached), *scale, run.q)
            for u, v in zip(x, y)]
    return run.inverse(regs, itw)


def dot_model(plan: MxuPlan, a: torch.Tensor, b: torch.Tensor, cached: bool) -> torch.Tensor:
    """dot_kernel on (K, R, n) stacks, merged tables: a step a forward (b's
    of a fresh term, then a's), the slot added into the sum, the sum times
    the scale, one inverse."""
    run = Launch(plan, a.shape[1])
    tw, itw = per_pass(plan, plan.plan.merged_flat), per_pass(plan, plan.plan.merged_inv_flat)
    last = len(run.schedule) - 1
    acc = [np.zeros_like(run.t, dtype=np.uint64) for _ in range(WORDS)]
    for k in range(a.shape[0]):
        y = run.load(b[k], last) if cached else [csub(v, 2 * run.q)
                                                 for v in run.forward(b[k], tw)]
        x = run.forward(a[k], tw)
        acc = [add_sum(s, slot(u, v, run.q, run.q_prime, cached), run.q)
               for s, u, v in zip(acc, x, y)]
    scale = plan._scale_cached if cached else plan._scale_fresh
    return run.inverse([shoup_lazy(s, *scale, run.q) for s in acc], itw)


def matvec_model(plan: MxuPlan, fs: torch.Tensor, spectra: torch.Tensor) -> torch.Tensor:
    """radix_matvec_kernel on the (l, B, n) plain spectra fs of s and the
    (k, l, n) cached spectra of A: output row o = r * k + i (the k rows of
    batch row r adjacent, tiling the blocks), a loop step the words 16t ...
    16t + 15 of S[j, r] and A[i, j] and their plain products added into
    64-bit sums (below l q^2 < 2^63, no reduction), then one REDC (below
    3q) and n^-1's lazy Shoup product, the inverse on the merged inverse's
    per-pass tables and the store to row i * B + r; (k, B, n) out."""
    (k, l), batch = spectra.shape[:2], fs.shape[1]
    run = Launch(plan, k * batch)
    o = np.where(run.live, run.row, 0)
    r, i = o // k, o % k
    last = pass_words(run.log_n, len(run.schedule) - 1, run.t)
    S, A = words(fs).reshape(l, batch, run.n), words(spectra)
    acc = [np.zeros_like(run.t, dtype=np.uint64) for _ in range(WORDS)]
    for j in range(l):
        s_regs = [np.where(run.live, S[j, r, w], 0) for w in last]  # [0, q)
        a_regs = [np.where(run.live, A[i, j, w], 0) for w in last]  # [0, q), times 2^32
        assert all(np.all(v < run.q) for v in s_regs + a_regs)
        acc = [v + x * y for v, x, y in zip(acc, s_regs, a_regs)]
    assert all(np.all(v <= np.uint64(l * (run.q - 1) ** 2)) for v in acc) and l <= 8
    regs = [shoup_lazy(redc64(v, run.q, run.q_prime), *plan._scale_cached, run.q) for v in acc]
    out = run.inverse(regs, per_pass(plan, plan.plan.merged_inv_flat), out_row=i * batch + r)
    return out.reshape(k, batch, run.n)


@functools.lru_cache(maxsize=None)
def plans(n: int, q: int):
    """The port's plan and JAX's NttPlan at (n, q): DILITHIUM_256's psi at
    its (n, q), make_params' elsewhere."""
    dil = (n, q) == (DILITHIUM_256.n, DILITHIUM_256.q)
    tp, jp = ((DILITHIUM_256, jparams.DILITHIUM_256) if dil else
              (make_params(n, q), jparams.make_params(n, q)))
    return MxuPlan(tp, "cpu"), jntt.NttPlan(jp)


@functools.lru_cache(maxsize=None)
def jax_mxu():
    """JAX's MxuPlan at DILITHIUM_256, one group a grid step (interpret-mode
    cost)."""
    jm = JaxMxuPlan(jparams.DILITHIUM_256)
    jm.groups_per_step = 1
    return jm


def times(plan: MxuPlan, x: torch.Tensor, c: int) -> torch.Tensor:
    return uint32_to_int32(words(x) * np.uint64(c) % np.uint64(plan.p.q))


RADIX_ENTRIES = {"forward", "inverse", "product", "cached", "dot", "matvec"}


def test_pass_schedule_and_tables_cover_every_stage():
    """Every stage once, the first pass short, four stages a later pass, the
    tables' offsets the .cu's, every twiddle of every stage in its pass's
    table once a group, the per-pass tables built once a table and read by
    the radix-16 entry points alone."""
    for log_n in range(8, 15):
        schedule = kmxu64.passes(log_n, RADIX)
        assert [s for s, _ in schedule] == list(np.cumsum([0] + [r for _, r in schedule])[:-1])
        assert sum(r for _, r in schedule) == log_n and len(schedule) == (log_n - 1) // 4 + 1
        assert schedule[0][1] in (1, 2, 3, 4) and all(r == 4 for _, r in schedule[1:])
        idx = kmxu64.pass_indices(log_n, RADIX)
        assert len(idx) == sum(1 << (s + r) for s, r in schedule)
        assert np.array_equal(np.sort(idx[idx > 0]), np.arange(1, 1 << log_n))
    plan, _ = plans(256, DILITHIUM_256.q)
    w, ws = plan._transform_table(plan.plan.merged_flat)
    assert w.dtype == torch.int32 and w.is_contiguous() and w.shape == (16 + 256,)
    assert torch.equal(ws, plan.plan.merged_flat[1][torch.from_numpy(kmxu64.pass_indices(8, 4))])
    assert plan._transform_table(plan.plan.merged_flat) is plan._transform_table(
        plan.plan.merged_flat)
    assert MxuPlan.pass_entries == RADIX_ENTRIES


def test_shared_memory_accesses_conflict_at_most_two_ways():
    """n = 256 to 16384: no two threads of a block share a word of the
    tile, and every word lies in the block's tile; every exchange writes
    one pass's words and reads another's (the forward's p - 1 then p, the
    inverse's p + 1 then p, so every pass's words are both written and
    read), and a warp's 4-byte accesses of every pass but the last hit
    every bank at most twice (at most two wavefronts); in the last a
    thread's sixteen words are adjacent (16t ... 16t + 15: four 16-byte
    vectors a thread); the private tiles' words (r * threads + i) hit 32
    banks a warp."""
    for log_n in range(8, 15):
        g, t = threads(log_n)
        assert g.size >= 128 and g.size % 32 == 0 and g.size <= 1024
        last = len(kmxu64.passes(log_n, RADIX)) - 1
        forward = [(p - 1, p) for p in range(1, last + 1)]
        inverse = [(p + 1, p) for p in range(last - 1, -1, -1)]
        assert {p for e in forward + inverse for p in e} == set(range(last + 1))
        for p in range(last + 1):
            slots = np.stack([g * (1 << log_n) + i for i in pass_words(log_n, p, t)])
            assert len(np.unique(slots)) == slots.size
            assert slots.max() < tile(log_n) << log_n
            if p == last:
                assert np.array_equal(slots - slots[0], np.arange(WORDS)[:, None]
                                      + np.zeros_like(slots[0]))
                assert np.all(slots[0] % WORDS == 0)
                continue
            banks = slots.reshape(WORDS, -1, 32) % 32
            ways = max(np.bincount(warp, minlength=32).max() for warp in banks.reshape(-1, 32))
            assert ways <= 2, (log_n, p, ways)
        own = np.arange(WORDS)[:, None] * g.size + np.arange(g.size)
        assert len(np.unique(own)) == own.size and own.max() < tile(log_n) << log_n
        assert all(len(np.unique(warp % 32)) == 32 for warp in own.reshape(-1, 32))


def jax_merged(jplan):
    """JAX's XLA negacyclic forward (bit-reversed, the port's order) and its
    cyclic forward (natural order), jitted."""
    return (jax.jit(functools.partial(jntt.nwc_fwd_merged, jplan)),
            jax.jit(functools.partial(jntt.ntt_fwd, jplan)))


@functools.lru_cache(maxsize=None)
def jax_transforms(n: int, q: int):
    """JAX's XLA transforms at (n, q), jitted once: the negacyclic forward
    and inverse (bit-reversed spectra) and the cyclic ones (natural
    order)."""
    jplan = plans(n, q)[1]
    return tuple(jax.jit(functools.partial(f, jplan)) for f in (
        jntt.nwc_fwd_merged, jntt.nwc_inv_merged, jntt.ntt_fwd, jntt.ntt_inv))


@pytest.mark.parametrize("n,q,rows", [(256, DILITHIUM_256.q, 19), (4096, 8380417, 2),
                                      (16384, 16580609, 2)])
def test_model_matches_plain_and_jax(n, q, rows):
    """The model on cyclic and merged tables at scale 1, and on merged ones
    at 2^32 mod q (the spectrum's), against the plain forwards and JAX:
    ``MxuPlan`` in interpret mode at DILITHIUM_256 (19 rows: a partial last
    block of eight rows), its jitted XLA transforms above, through the
    layout maps."""
    plan, jplan = plans(n, q)
    x_np = operands(q, (rows, n), seed=n)
    x = uint32_to_int32(x_np)
    spec = model(plan, x, plan.plan.merged_flat, plan._scale_one)
    assert torch.equal(spec, plan.nwc_ntt_fwd_plain(x))
    cyc = model(plan, x, plan.plan.cyclic_flat, plan._scale_one)
    assert torch.equal(cyc, plan.ntt_fwd_plain(x))
    cached = model(plan, x, plan.plan.merged_flat, plan._scale_spectrum)
    assert torch.equal(cached, plan.nwc_spectrum_plain(x))
    assert torch.equal(cached, times(plan, spec, (1 << 32) % q))
    cyc_scaled = model(plan, x, plan.plan.cyclic_flat, plan._scale_spectrum)
    assert torch.equal(cyc_scaled, times(plan, cyc, (1 << 32) % q))
    if n == 256:
        jm = jax_mxu()
        perm = jm.fourstep_to_natural_perm()
        for got, fwd in ((spec, jm.nwc_ntt_fwd), (cyc, jm.ntt_fwd)):
            want = np.asarray(fwd(x_np, interpret=True))[..., perm]
            assert np.array_equal(int32_to_uint32(plan.bitrev_to_natural(got)), want)
        assert torch.equal(spectra_from_jax(jm.nwc_spectrum(x_np, interpret=True)), cached)
        return
    merged, natural = jax_merged(jplan)
    assert np.array_equal(int32_to_uint32(spec), np.asarray(merged(x_np)))
    assert np.array_equal(int32_to_uint32(plan.bitrev_to_natural(cyc)), np.asarray(natural(x_np)))


@pytest.mark.parametrize("n,q,rows", [(256, DILITHIUM_256.q, 11), (4096, 8380417, 3),
                                      (16384, 16580609, 3)])
def test_fused_model_matches_plain_and_jax(n, q, rows):
    """The inverse, the fused products and the dot on the model, boundary
    rows first (b's reversed against a's, so 0 meets q - 1): the inverse of
    spectra on merged and cyclic tables against ``nwc_ntt_inv_plain`` and
    ``ntt_inv_plain``; ``product_kernel`` on merged and cyclic tables (the
    negacyclic and cyclic products) and against a cached spectrum; the dot
    at K = 1 and 3, fresh and cached; each against its plain version and
    JAX: ``MxuPlan`` in interpret mode at DILITHIUM_256 (11 rows: a partial
    block; ``nwc_poly_mult``, ``nwc_poly_mult_cached``, ``nwc_dot`` and
    ``nwc_dot_cached`` at K = 3, its spectra through ``spectra_from_jax``),
    the jitted XLA transforms above, the slot products and sums by numpy
    on their spectra."""
    plan, _ = plans(n, q)
    a_np, b_np = (operands(q, (3, rows, n), seed=n + s) for s in (1, 2))
    b_np[0, :3] = b_np[0, 2::-1].copy()
    a3, b3 = uint32_to_int32(a_np), uint32_to_int32(b_np)
    a, b = a3[0], b3[0]
    merged = (plan.plan.merged_flat, plan.plan.merged_inv_flat)
    cyclic = (plan.plan.cyclic_flat, plan.plan.cyclic_inv_flat)
    fa = plan.nwc_ntt_fwd_plain(a)
    nwc_back = inverse_model(plan, fa, merged[1])
    assert torch.equal(nwc_back, plan.nwc_ntt_inv_plain(fa))
    cyc_back = inverse_model(plan, fa, cyclic[1])
    assert torch.equal(cyc_back, plan.ntt_inv_plain(fa))
    nwc = product_model(plan, a, b, *merged, cached=False)
    assert torch.equal(nwc, plan.nwc_poly_mult_plain(a, b))
    cyc = product_model(plan, a, b, *cyclic, cached=False)
    assert torch.equal(cyc, plan.cyclic_poly_mult_plain(a, b))
    spectra = plan.nwc_spectrum_plain(b3.reshape(-1, n)).reshape(b3.shape)
    cached = product_model(plan, a, spectra[0], *merged, cached=True)
    assert torch.equal(cached, plan.nwc_poly_mult_cached_plain(a, spectra[0]))
    assert torch.equal(cached, nwc)
    dots = {}
    for terms in (1, 3):
        for kind, z in (("fresh", b3[:terms]), ("cached", spectra[:terms])):
            got = dot_model(plan, a3[:terms], z, kind == "cached")
            plain = plan.nwc_dot_cached_plain if kind == "cached" else plan.nwc_dot_plain
            assert torch.equal(got, plain(a3[:terms], z)), (terms, kind)
            dots[terms, kind] = got
        assert torch.equal(dots[terms, "fresh"], dots[terms, "cached"])
    assert torch.equal(dots[1, "fresh"], nwc)
    if n == 256:
        jm = jax_mxu()
        assert np.array_equal(int32_to_uint32(nwc), np.asarray(jm.nwc_poly_mult(
            a_np[0], b_np[0], interpret=True)))
        jspec = jm.nwc_spectrum(b_np.reshape(-1, n), interpret=True)
        assert torch.equal(spectra_from_jax(jspec).reshape(spectra.shape), spectra)
        jspec = np.asarray(jspec).reshape(b_np.shape)
        assert np.array_equal(int32_to_uint32(cached), np.asarray(jm.nwc_poly_mult_cached(
            a_np[0], jspec[0], interpret=True)))
        assert np.array_equal(int32_to_uint32(dots[3, "fresh"]),
                              np.asarray(jm.nwc_dot(a_np, b_np, interpret=True)))
        assert np.array_equal(int32_to_uint32(dots[3, "cached"]),
                              np.asarray(jm.nwc_dot_cached(a_np, jspec, interpret=True)))
        return
    nwc_fwd, nwc_inv, fwd, inv = jax_transforms(n, q)
    qq = np.uint64(q)
    assert np.array_equal(int32_to_uint32(nwc_back), np.asarray(nwc_inv(int32_to_uint32(fa))))
    assert np.array_equal(int32_to_uint32(cyc_back),
                          np.asarray(inv(int32_to_uint32(plan.bitrev_to_natural(fa)))))

    def spectral(f, x):
        return np.asarray(f(x)).astype(np.uint64)

    fa3 = spectral(nwc_fwd, a_np.reshape(-1, n)).reshape(a_np.shape)
    fb3 = spectral(nwc_fwd, b_np.reshape(-1, n)).reshape(b_np.shape)
    assert np.array_equal(int32_to_uint32(nwc), np.asarray(nwc_inv((fa3[0] * fb3[0] % qq)
                                                                   .astype(np.uint32))))
    c = spectral(fwd, a_np[0]) * spectral(fwd, b_np[0]) % qq
    assert np.array_equal(int32_to_uint32(cyc), np.asarray(inv(c.astype(np.uint32))))
    acc = (fa3 * fb3 % qq).sum(axis=0) % qq
    assert np.array_equal(int32_to_uint32(dots[3, "fresh"]),
                          np.asarray(nwc_inv(acc.astype(np.uint32))))


@pytest.mark.parametrize("n,q", [(256, DILITHIUM_256.q), (4096, 8380417), (16384, 16580609)])
def test_matvec_model_matches_plain_and_jax(n, q):
    """radix_matvec_kernel's model at (k, l) = (1, 1), (4, 4) and (3, 5) on
    B = 3 rows of s (B = 1 at n = 16384: a partial block of eight output
    rows below n = 2048), s's rows 0, 1 and q - 1 first and A's first row
    all q - 1, on the spectra of s the forward makes: against
    ``nwc_matvec_cached_plain`` and the slot sums of JAX's jitted XLA
    forward (s and A, their rows padded to 32 to share one jit) and
    inverse (padded to 16); at DILITHIUM_256 (1, 1) also against JAX's
    ``MxuPlan.nwc_matvec_cached`` in interpret mode, its blocks through
    ``matvec_spectra_from_jax``."""
    plan, _ = plans(n, q)
    batch = 1 if n == 16384 else 3
    nwc_fwd, nwc_inv, _, _ = jax_transforms(n, q)
    qq = np.uint64(q)

    def padded(f, x, rows):
        return np.asarray(f(np.concatenate([x, np.zeros((rows - len(x), n), np.uint32)])))[
            :len(x)].astype(np.uint64)

    for k, l in ((1, 1), (4, 4), (3, 5)):
        s_np = operands(q, (l, batch, n), seed=n + k)
        a_np = operands(q, (k, l, n), seed=n + l)
        a_np[0, 0] = q - 1
        s, A = uint32_to_int32(s_np), uint32_to_int32(a_np)
        spectra = plan.nwc_matvec_spectra_plain(A)
        fs = plan.nwc_ntt_fwd_plain(s.reshape(-1, n)).reshape(s.shape)
        got = matvec_model(plan, fs, spectra)
        assert torch.equal(got, plan.nwc_matvec_cached_plain(s, spectra)), (k, l)
        f = padded(nwc_fwd, np.concatenate([s_np.reshape(-1, n), a_np.reshape(-1, n)]), 32)
        fs_j, fa_j = f[:l * batch].reshape(l, batch, n), f[l * batch:].reshape(k, l, n)
        acc = (fa_j[:, :, None] * fs_j[None] % qq).sum(axis=1) % qq  # (k, B, n)
        want = padded(nwc_inv, acc.reshape(-1, n).astype(np.uint32), 16)
        assert np.array_equal(int32_to_uint32(got).reshape(-1, n), want), (k, l)
        if n == 256 and (k, l) == (1, 1):
            jm = jax_mxu()
            blocks = jm.nwc_matvec_spectra(a_np, interpret=True)
            assert torch.equal(matvec_spectra_from_jax(blocks, n), spectra)
            assert np.array_equal(int32_to_uint32(got), np.asarray(
                jm.nwc_matvec_cached(s_np, blocks, interpret=True)))


# ---------------------------------------------------------------------------
# The launch path, faked on the CPU
# ---------------------------------------------------------------------------


def test_forward_launches_with_per_pass_tables(monkeypatch):
    """On the launch path (the plan told its tensors are on a card) every op
    that transforms forward (ntt_fwd, nwc_ntt_fwd, nwc_spectrum, the
    matvec's spectra and its s) hands nwc32_forward the per-pass tables of
    its flat tables, four stages a pass, and so do the fused ops:
    nwc32_product (the negacyclic product on the merged tables, the cyclic
    one on the cyclic tables), nwc32_cached and nwc32_dot (fresh and
    cached) both tables, forward and inverse; nwc32_inverse the inverse's
    (ntt_inv the cyclic, nwc_ntt_inv the merged), with n^-1; nwc32_matvec
    the merged inverse's, with k, l, B and n^-1."""
    plan = MxuPlan(DILITHIUM_256, "cpu")
    calls = []
    monkeypatch.setattr(plan, "_runs_plain", lambda x: False)
    monkeypatch.setattr(plan, "_launch", lambda entry, out, *args: calls.append(
        (entry, args)) or out)
    a = uint32_to_int32(operands(plan.p.q, (2, 256), seed=1))
    a3 = a.reshape(2, 1, 256)
    merged, cyclic = plan.plan.merged_flat, plan.plan.cyclic_flat
    imerged, icyclic = plan.plan.merged_inv_flat, plan.plan.cyclic_inv_flat
    pm, pc = plan._transform_table(merged), plan._transform_table(cyclic)
    pim, pic = plan._transform_table(imerged), plan._transform_table(icyclic)
    for fn, args, want in (
            (plan.ntt_fwd, (a,), [("forward", pc)]),
            (plan.nwc_ntt_fwd, (a,), [("forward", pm)]),
            (plan.nwc_spectrum, (a,), [("forward", pm)]),
            (plan.nwc_matvec_spectra, (a3,), [("forward", pm)]),
            (plan.nwc_matvec_cached, (a3, a3.reshape(1, 2, 256)), [("forward", pm),
                                                                   ("matvec", pim)]),
            (plan.nwc_poly_mult, (a, a), [("product", pm + pim)]),
            (plan.cyclic_poly_mult, (a, a), [("product", pc + pic)]),
            (plan.nwc_poly_mult_cached, (a, a), [("cached", pm + pim)]),
            (plan.ntt_inv, (a,), [("inverse", pic)]),
            (plan.nwc_ntt_inv, (a,), [("inverse", pim)]),
            (plan.nwc_dot, (a3, a3), [("dot", pm + pim)]),
            (plan.nwc_dot_cached, (a3, a3), [("dot", pm + pim)])):
        calls.clear()
        fn(*args)
        assert [entry for entry, _ in calls] == [entry for entry, _ in want], fn.__name__
        for (entry, got), (_, tables) in zip(calls, want):
            at = {"forward": 2, "inverse": 2, "matvec": 3}.get(entry, 3)
            assert all(x is y for x, y in zip(got[at:at + len(tables)], tables)), (
                fn.__name__, entry)
            per_pass_table = any(tables[0] is t for t in (pm[0], pc[0], pim[0], pic[0]))
            assert (entry in RADIX_ENTRIES) == per_pass_table, (fn.__name__, entry)
            if entry in ("forward", "inverse"):
                assert got[at + 2] == a.numel() // 256 and got[at + 3] == 8
            if entry == "inverse":
                assert got[at + 5:at + 7] == plan._scale_cached  # n^-1 and its companion
            if entry == "dot":
                assert got[at + 4:at + 7] == (2, 1, 8) and got[-1] == (fn == plan.nwc_dot_cached)
            if entry == "matvec":  # k, l, B, log n, q, q', n^-1 and its companion
                assert got[at + 2:at + 6] == (1, 2, 1, 8)
                assert got[at + 8:at + 10] == plan._scale_cached


# ---------------------------------------------------------------------------
# K3's ablation toggles: the default body's integers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("toggle", ["int8_path", "balanced"])
def test_k3_toggle_gives_the_ports_integers(toggle):
    """JAX's ``MxuPlan(p, int8_path=False)`` (the bf16 limb matmuls,
    tpu_ntt/kernels/mxu.py:105) and a subclass with ``balanced = True``
    (four balanced signed digits, :103; set on the class before
    construction) in interpret mode at DILITHIUM_256 on 2 rows: the port's
    ``nwc_ntt_fwd``, ``nwc_spectrum`` and ``nwc_poly_mult`` give the same
    integers, spectra through the layout maps."""
    if toggle == "balanced":
        jm = type("JaxMxuPlanBalanced", (JaxMxuPlan,), {"balanced": True})(
            jparams.DILITHIUM_256)
    else:
        jm = JaxMxuPlan(jparams.DILITHIUM_256, int8_path=False)
    jm.groups_per_step = 1  # keep interpret-mode cost down
    tm = MxuPlan(DILITHIUM_256, "cpu")
    a_np, b_np = (operands(DILITHIUM_256.q, (2, 256), seed=s) for s in (21, 22))
    b_np = b_np[::-1].copy()
    a, b = uint32_to_int32(a_np), uint32_to_int32(b_np)
    spec = np.asarray(jm.nwc_ntt_fwd(a_np, interpret=True))[..., jm.fourstep_to_natural_perm()]
    assert np.array_equal(int32_to_uint32(tm.bitrev_to_natural(tm.nwc_ntt_fwd(a))), spec)
    assert torch.equal(spectra_from_jax(jm.nwc_spectrum(b_np, interpret=True)),
                       tm.nwc_spectrum(b))
    want = np.asarray(jm.nwc_poly_mult(a_np, b_np, interpret=True))
    assert np.array_equal(int32_to_uint32(tm.nwc_poly_mult(a, b)), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_forward_matches_plain(cuda_device):
    """The five radix-16 entry points on the card against their plain
    versions: the forwards and the spectrum, both inverses, the negacyclic,
    cyclic and cached products, the dot at K = 3, fresh and cached."""
    for n, q in ((256, DILITHIUM_256.q), (4096, 8380417), (16384, 16580609)):
        plan = MxuPlan(make_params(n, q), cuda_device)
        x = uint32_to_int32(operands(q, (19, n), seed=n)).to(cuda_device)
        y = x.flip(0).contiguous()
        for method in ("ntt_fwd", "nwc_ntt_fwd", "nwc_spectrum", "ntt_inv", "nwc_ntt_inv"):
            assert torch.equal(getattr(plan, method)(x),
                               getattr(plan, method + "_plain")(x)), (n, method)
        spectrum = plan.nwc_spectrum(y)
        for method, args in (("nwc_poly_mult", (x, y)), ("cyclic_poly_mult", (x, y)),
                             ("nwc_poly_mult_cached", (x, spectrum)),
                             ("nwc_dot", (x[:18].reshape(3, 6, n), y[:18].reshape(3, 6, n))),
                             ("nwc_dot_cached", (x[:18].reshape(3, 6, n),
                                                 spectrum[:18].reshape(3, 6, n)))):
            assert torch.equal(getattr(plan, method)(*args),
                               getattr(plan, method + "_plain")(*args)), (n, method)

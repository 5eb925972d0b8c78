"""The radix-8 core of ``csrc/nwc64.cu`` (``nwc64_forward``, ``nwc64_inverse``,
their column entry points, the product fused on it, ``nwc64_product`` and
``nwc64_cached``, the four-step's row passes fused on it,
``nwc64_cyclic_scaled``, ``nwc64_cached_scaled`` and ``nwc64_dot_scaled``,
its row forward ``nwc64_forward_scaled``, its row inverse
``nwc64_inverse_scaled``, the flat dot ``nwc64_dot`` and the matvec's
accumulate-and-inverse ``nwc64_matvec``) modelled on the CPU, and K1a's
three ablation toggles.

* The lazy butterflies: a Python model of the .cu's Shoup product, CT and
  GS butterflies and final corrections, with the range asserts the .cu
  states beside each step, on every pair of 0, 1, q - 1, q, 2q - 1, 4q - 1
  and random words at P60_4096's q, q = 576460752308273153 and the largest
  62-bit prime q = 1 mod 2^14 (``Q62_MAX``, where 4q is 2^18 below 2^64).
* The pass schedule: a numpy model of the kernel (which words each thread
  holds in each pass, the tile's swizzle, the per-pass twiddle tables of
  ``mxu64.pass_table``) run at n = 32, 256 and 4096, rows and columns,
  cyclic and negacyclic tables, scales 1 and not 1, against the plain
  ``ntt`` transforms and JAX's XLA transforms (``tpu_ntt.ntt``); the shared
  memory accesses of every pass at every n from 32 to 8192, both layouts,
  counted for bank conflicts.
* The fused product: the model's passes run as the kernel runs them (b's
  forward, a's, the slot product on the lanes the registers hold, its
  lanes' range asserted, the inverse from those registers) with merged and
  cyclic tables and against a cached spectrum, at n = 32, 256 and 4096,
  against the plain products and JAX's XLA ``nwc_poly_mult_merged`` and
  ``cyclic_poly_mult`` (their bodies run with their transforms jitted).
* The fused row passes on the same model (``scaled_model``): pre's lazy
  Shoup product on the words the first pass loads (the first stage's
  lanes then below 2q, asserted), both forwards, the slot product, for the
  dot the sum of K terms kept below 2q, the scale's product on it, the
  inverse, post's product and one compare at the store, with (P, n)
  tables at (n, rows, P) = (32, 36, 1), (32, 36, 3), (256, 6, 3) and
  (128, 256, 256) (p60_32768's row pass), fresh and cached, the dot at
  K = 1 and 3 at (256, 6, 3),
  against the plain row passes and JAX's XLA ``cyclic_poly_mult`` between
  the scales (by Python ints); the row forward (``forward_scaled_model``:
  pre's product, the forward, the transforms' store) at n = 128 and 1024,
  P = 1 and 3, scale 1 and 2^64, against ``ntt_fwd_scaled_plain``; the
  row inverse (``inverse_scaled_model``: the spectrum's words, n^-1's lazy
  Shoup product below 2q, the passes, post's product and one compare) at
  the same shapes against ``ntt_inv_scaled_plain`` and JAX's XLA
  ``ntt_inv`` times post; the flat dot (``scaled_model`` without scales, merged tables, canonical
  first lanes asserted) at K = 1 and 3 at n = 256 against
  ``nwc_dot_plain`` and ``nwc_dot_cached_plain``; the matvec
  (``matvec_model``: the words 8t ... 8t + 7 of each S[j, r] and A[i, j],
  the sum of lazy REDCs kept below 2q, n^-1, the inverse) at (k, l) =
  (1, 1) and (3, 2) on 6 rows of 256 against ``nwc_matvec_cached_plain``
  and the sums of JAX's XLA ``nwc_poly_mult_merged``, its sum's bound at
  l = 8 on q - 1; faked launches show the seven entry points receive the
  per-pass tables on ``SubPlan64`` and ``MxuPlan64``, the Goldilocks
  plans' ``gl64_forward_scaled``, ``gl64_dot``, ``gl64_dot_scaled`` and
  ``gl64_inverse_scaled`` theirs, ``gl64_matvec`` and ``nwc32_matvec`` the
  flat ones.
* ``SubPlan64``'s column methods (plain on the CPU: the transpose route)
  against ``FourStepPlan``'s transposes and JAX's four-step locals
  (``tpu_ntt.sharded._along`` of its XLA transforms) at 32 x 32 and
  64 x 32, widths n2 / D for D = 2, 4 and 8.
* The C signatures ``load`` and ``load_scaled`` bind for the thirteen
  entry points; a ``cuda``-marked case holds both layouts, both products,
  the three row passes, the row forward, the row inverse, the flat dot and
  the matvec against plain on a card.
* JAX's ``MxuPlan64`` with ``prefix_scan = True``, with
  ``carry_save = False`` and with ``shoup_lazy = False``
  (mxu64.py:785-799) in interpret mode at n = 256: the same integers as
  the port's ``MxuPlan64``.

Operands come from ``numpy.random.default_rng`` with rows of 0, 1 and
q - 1.  Tolerance: none — exact integer equality.
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch

import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
from tpu_ntt import sharded as jsharded
from tpu_ntt.kernels.mxu64 import MxuPlan64 as JaxMxuPlan64
from tpu_ntt_torch import ntt, sharded
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels import _build, _plan
from tpu_ntt_torch.kernels import mxu64 as kmxu64
from tpu_ntt_torch.kernels.gl64 import GoldilocksPlan64, GoldilocksSubPlan64
from tpu_ntt_torch.kernels.mxu import MxuPlan
from tpu_ntt_torch.kernels.mxu64 import MxuPlan64, SubPlan64
from tpu_ntt_torch.modmath import GOLDILOCKS_Q
from tpu_ntt_torch.params import P60_4096, make_params

Q_GENERIC = 576460752308273153  # bench.py:35, 60 bits, not a trinomial
Q62_MAX = 4611686018427322369  # 2^62 - 2^16 + 1: the largest prime q < 2^62, q = 1 mod 2^14
QS = (P60_4096.q, Q_GENERIC, Q62_MAX)
MASK = (1 << 64) - 1
WORDS = 8  # words a thread holds


def operands(q: int, shape, seed: int) -> torch.Tensor:
    """Residues of the given shape; the first rows are all 0, all 1 and all
    q - 1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, size=shape, dtype=np.int64)
    rows = x.reshape(-1, shape[-1])
    for k, v in enumerate((0, 1, q - 1)[:rows.shape[0]]):
        rows[k] = v
    return torch.from_numpy(x)


def ints(t: torch.Tensor) -> np.ndarray:
    """int64 words -> an object array of Python ints (their uint64 values)."""
    return np.array(t.numpy().view(np.uint64).tolist(), dtype=object)


# ---------------------------------------------------------------------------
# The lazy arithmetic, as the .cu states it (q < 2^62: every lane < 4q < 2^64)
# ---------------------------------------------------------------------------


def shoup_lazy(a, w, ws, q):
    """a * w - floor(a * ws / 2^64) * q mod 2^64: in [0, 2q) for any
    a < 2^64, given w < q and ws = floor(w * 2^64 / q)."""
    assert np.all(a >= 0) and np.all(a <= MASK) and np.all(w < q)
    r = (a * w - ((a * ws) >> 64) * q) & MASK
    assert np.all(r < 2 * q) and np.all(r % q == a * w % q)
    return r


def csub(x, m):
    return np.where(x >= m, x - m, x)


def ct(x, y, w, ws, q, below=None):
    """Cooley-Tukey: lanes in [0, 4q) in and out; ``below``: the forward's
    first stage, which skips the compare, x below it in (q for words from
    device memory, 2q after the row passes' lazy entry scale; the step
    needs u < 2q)."""
    assert np.all(x < (below or 4 * q)) and np.all(y < 4 * q)
    assert below is None or below <= 2 * q
    u = x if below else csub(x, 2 * q)
    assert np.all(u < 2 * q)
    v = shoup_lazy(y, w, ws, q)
    x, y = u + v, u + 2 * q - v
    assert np.all(x < 4 * q) and np.all(y > 0) and np.all(y < 4 * q)
    return x, y


def gs(x, y, w, ws, q):
    """Gentleman-Sande: lanes in [0, 2q) in and out."""
    assert np.all(x < 2 * q) and np.all(y < 2 * q)
    total, diff = x + y, x + 2 * q - y
    assert np.all(total < 4 * q) and np.all(diff > 0) and np.all(diff < 4 * q)
    return csub(total, 2 * q), shoup_lazy(diff, w, ws, q)


def forward_out(x, scale, scale_shoup, q):
    """The forward's store: [0, 4q) -> [0, q), the scale folded in."""
    assert np.all(x < 4 * q)
    if scale == 1:
        return csub(csub(x, 2 * q), q)
    return csub(shoup_lazy(x, scale, scale_shoup, q), q)


def inverse_out(x, scale, scale_shoup, q):
    assert np.all(x < 2 * q)
    return csub(shoup_lazy(x, scale, scale_shoup, q), q)


@pytest.mark.parametrize("q", QS)
def test_lazy_butterflies_hold_their_ranges(q):
    rng = np.random.default_rng(q % 1000)
    words = [0, 1, q - 1, q, 2 * q - 1, 4 * q - 1] + [
        int(v) for v in rng.integers(0, 4 * q, size=6, dtype=np.uint64)]
    twiddles = [0, 1, q - 1] + [int(v) for v in rng.integers(0, q, size=3)]
    x, y = (np.array(v, dtype=object) for v in zip(*[(a, b) for a in words for b in words]))
    for w in twiddles:
        ws = (w << 64) // q
        cx, cy = ct(x, y, w, ws, q)
        assert np.all(cx % q == (x + w * y) % q) and np.all(cy % q == (x - w * y) % q)
        low = (x < 2 * q) & (y < 2 * q)
        gx, gy = gs(x[low], y[low], w, ws, q)
        assert np.all(gx % q == (x[low] + y[low]) % q)
        assert np.all(gy % q == (x[low] - y[low]) * w % q)
        # the store: canonical from any lane the passes leave
        for scale in (1, w):
            out = forward_out(cx, scale, (scale << 64) // q, q)
            assert np.all(out < q) and np.all(out == cx * scale % q)
        out = inverse_out(gx, w, ws, q)
        assert np.all(out < q) and np.all(out == gx * w % q)
    # the row passes' first stage: x below 2q (the entry scale's lazy Shoup
    # product), no compare
    low = x < 2 * q
    cx, cy = ct(x[low], y[low], q - 1, ((q - 1) << 64) // q, q, below=2 * q)
    assert np.all(cx % q == (x[low] - y[low]) % q) and np.all(cy % q == (x[low] + y[low]) % q)
    with pytest.raises(AssertionError):
        ct(np.array([2 * q], dtype=object), np.array([0], dtype=object), 1, (1 << 64) // q, q,
           below=2 * q)
    # the fused product's slot step on every such pair of the words above:
    # two lanes below 2q (one compare each), or a lane below 4q against a
    # cached canonical one
    fx = np.array([v for v in words for _ in words], dtype=object)
    fy = np.array([v for _ in words for v in words], dtype=object)
    mont_lazy(csub(fx, 2 * q), csub(fy, 2 * q), q)
    mont_lazy(fx, fy % q, q)
    # any 64-bit word into the Shoup product (its asserts: below 2q, the
    # right residue), and the butterflies' asserts bite
    shoup_lazy(MASK, q - 1, ((q - 1) << 64) // q, q)
    zero, one = np.array([0], dtype=object), (1 << 64) // q
    with pytest.raises(AssertionError):
        gs(np.array([4 * q - 1], dtype=object), zero, 1, one, q)
    with pytest.raises(AssertionError):
        ct(np.array([4 * q], dtype=object), zero, 1, one, q)
    if 16 * q > 1 << 64:  # two lazy lanes can pass q 2^64: one must be canonical
        with pytest.raises(AssertionError):
            mont_lazy(np.array([4 * q - 1], dtype=object), np.array([4 * q - 1], dtype=object), q)


# ---------------------------------------------------------------------------
# The kernel's schedule, as the .cu lays it out
# ---------------------------------------------------------------------------


def tile(log_n: int, cols: bool) -> int:
    """Transforms a block (the .cu's ``tile``)."""
    n = 1 << log_n
    if not cols:
        return 1 if n >= 1024 else 1024 // n
    return min(max(8, 1024 // n), 8192 // n)


def swizzle(a):
    """Where word a of the tile lives in shared memory."""
    return a ^ ((a >> 3) & 15)


def element(log_n: int, s: int, r: int, t, reg: int):
    """The element register ``reg`` of thread t holds in pass (s, r)."""
    T = (1 << log_n) >> (s + r)
    j = t + (reg >> r) * ((1 << log_n) // WORDS)
    return (j // T) * (T << r) + (reg % (1 << r)) * T + j % T


def tile_word(log_n: int, cols: bool, g, i):
    a = i * tile(log_n, True) + g if cols else g * (1 << log_n) + i
    return swizzle(a)


def threads(log_n: int, cols: bool):
    """(g, t) of each thread of a block."""
    tid = np.arange(tile(log_n, cols) * (1 << log_n) // WORDS)
    per, g_tile = (1 << log_n) // WORDS, tile(log_n, cols)
    return (tid % g_tile, tid // g_tile) if cols else (tid // per, tid % per)


def run_pass(x, w_tab, ws_tab, offset, s, r, hi, q, inverse, fresh=None):
    """The stages of pass (s, r) on the registers x, twiddles from the
    per-pass tables: stage s + d's u-th twiddle of group hi at word
    2^d + u (word 0 for d = 0) of the group's pairs; ``fresh``: the
    forward's first pass, its first stage on lanes below ``fresh``."""
    stages = range(r - 1, -1, -1) if inverse else range(r)
    for d in stages:
        span = (1 << r) >> (d + 1)
        w, ws = [], []
        for u in range(1 << d):
            word = 0 if d == 0 else (1 << d) + u
            at = offset + 2 * (((word // 2) << s) + hi) + word % 2
            w.append(w_tab[at])
            ws.append(ws_tab[at])
        for reg in range(WORDS):
            k = reg % (1 << r)
            if not k & span:
                e = k >> (r - d)
                if inverse:
                    x[reg], x[reg + span] = gs(x[reg], x[reg + span], w[e], ws[e], q)
                else:
                    x[reg], x[reg + span] = ct(x[reg], x[reg + span], w[e], ws[e], q,
                                               fresh if d == 0 else None)


def lanes(plan, x: torch.Tensor, width: int | None = None):
    """Every thread of every block of the kernel on (R, n * width) words,
    rows (width None) or every column of the (n, width) matrices, as one
    vector: (at, live, t, slot), where at(i) is the word of element i of
    each thread's transform, live whether that transform exists, t the
    thread's index in its transform and slot(i) the shared-memory word of
    element i, its block's tile laid end to end with the others."""
    log_n, n = plan.p.log_n, plan.p.n
    cols, width = width is not None, width or 1
    transforms, g_tile = x.numel() // n, tile(log_n, cols)
    g, t = threads(log_n, cols)
    block = np.repeat(np.arange(-(-transforms // g_tile)), g.size)
    g, t = np.tile(g, block[-1] + 1), np.tile(t, block[-1] + 1)
    tg = block * g_tile + g
    base = (tg // width) * n * width + tg % width if cols else tg * n
    return ((lambda i: base + i * width), tg < transforms, t,
            lambda i: block * (g_tile << log_n) + tile_word(log_n, cols, g, i))


def pass_words(log_n: int, p: int, t):
    """The element each register of thread t holds in pass p."""
    s, r = kmxu64.passes(log_n)[p]
    return [element(log_n, s, r, t, reg) for reg in range(WORDS)]


def load(words, at, live, idx):
    """Registers from device memory at elements idx (0 where not live)."""
    return [np.array(np.where(live, words[np.where(live, at(i), 0)], 0), dtype=object)
            for i in idx]


def exchange(regs, written, idx, slot):
    """Each thread's words into the tile at the elements it holds, the
    barrier, then the words of the elements idx; every word read is one
    written in this exchange, and no two threads write one word."""
    smem = np.full(int(max(slot(i).max() for i in written)) + 1, -1, dtype=object)
    for reg, i in enumerate(written):
        assert np.all(smem[slot(i)] < 0)
        smem[slot(i)] = regs[reg]
    regs = [smem[slot(i)] for i in idx]
    assert all(np.all(v >= 0) for v in regs)
    return regs


def passes_on(plan, regs, tables, inverse: bool, t, slot, below=None):
    """The passes on the registers of ``lanes``' threads, which hold the
    first pass's words in the order they run (the forward's pass 0, the
    inverse's last), with the exchange between passes; ``tables``: the
    per-pass (w, w') tables; ``below``: the bound of the forward's first
    lanes (q, canonical words, by default).  The registers end as the last
    pass leaves them."""
    log_n, q = plan.p.log_n, plan.p.q
    schedule = kmxu64.passes(log_n)
    offsets = np.cumsum([0] + [1 << (r + s) for s, r in schedule])
    w_tab, ws_tab = tables
    order = range(len(schedule) - 1, -1, -1) if inverse else range(len(schedule))
    written = None
    for p in order:
        s, r = schedule[p]
        idx = pass_words(log_n, p, t)
        if written is not None:
            regs = exchange(regs, written, idx, slot)
        hi = 0 if p == 0 else t // ((1 << log_n) >> (s + 3))
        run_pass(regs, w_tab, ws_tab, offsets[p], s, r, hi, q, inverse,
                 fresh=below or q if p == 0 and not inverse else None)
        written = idx
    return regs


def as_tensor(out: np.ndarray, shape) -> torch.Tensor:
    return torch.from_numpy(np.array(out.tolist(), dtype=np.uint64).view(np.int64)
                            .reshape(shape))


def model(plan: SubPlan64, x: torch.Tensor, flat: tuple, scale: tuple, inverse: bool,
          width: int | None = None) -> torch.Tensor:
    """The kernel on (R, n * width) words, every block at once: rows
    (width None) or every column of the (n, width) matrices."""
    log_n, q = plan.p.log_n, plan.p.q
    last = len(kmxu64.passes(log_n)) - 1
    tables = tuple(ints(t) for t in kmxu64.pass_table(flat))
    words, out = ints(x.reshape(-1)), np.zeros(x.numel(), dtype=object)
    first, final = (last, 0) if inverse else (0, last)
    at, live, t, slot = lanes(plan, x, width)
    regs = passes_on(plan, load(words, at, live, pass_words(log_n, first, t)), tables,
                     inverse, t, slot)
    for reg, i in enumerate(pass_words(log_n, final, t)):
        y = (inverse_out if inverse else forward_out)(regs[reg], *scale, q)
        out[at(i)[live]] = y[live]
    return as_tensor(out, x.shape)


def mont_lazy(a, b, q):
    """The fused product's slot step, REDC(a * b) = a b 2^-64 mod q without
    its compare: in [0, 2q), the inverse's range, given a b < q 2^64."""
    assert np.all(a * b < q << 64)
    q_prime = (-pow(q, -1, 1 << 64)) % (1 << 64)
    lo = (a * b) & MASK
    m = (lo * q_prime) & MASK
    t = ((a * b) >> 64) + ((m * q) >> 64) + np.where(lo != 0, 1, 0)
    assert np.all(t < 2 * q) and np.all(t * (1 << 64) % q == a * b % q)
    return t


def product_model(plan: SubPlan64, a: torch.Tensor, b: torch.Tensor, flat: tuple,
                  inv_flat: tuple, scale: tuple, cached: bool = False) -> torch.Tensor:
    """The fused product (nwc64_product; nwc64_cached with ``cached``) on
    (R, n) rows: the forward of b (unless cached), the forward of a, the
    slot product on the lanes as the registers hold them (both brought
    below 2q by one compare each, or a's left below 4q against a cached
    canonical b; the ranges asserted), the inverse from those registers,
    the store at ``scale``."""
    log_n, q = plan.p.log_n, plan.p.q
    last = len(kmxu64.passes(log_n)) - 1
    tw = tuple(ints(t) for t in kmxu64.pass_table(flat))
    itw = tuple(ints(t) for t in kmxu64.pass_table(inv_flat))
    wa, wb = ints(a.reshape(-1)), ints(b.reshape(-1))
    out = np.zeros(a.numel(), dtype=object)
    at, live, t, slot = lanes(plan, a)
    spectrum = pass_words(log_n, last, t)  # 8t ... 8t + 7
    assert all(np.all(i == WORDS * t + k) for k, i in enumerate(spectrum))
    if cached:
        y = load(wb, at, live, spectrum)
        assert all(np.all(v < q) for v in y)
    else:
        y = passes_on(plan, load(wb, at, live, pass_words(log_n, 0, t)), tw, False, t, slot)
        y = [csub(v, 2 * q) for v in y]  # [0, 4q) -> [0, 2q)
    x = passes_on(plan, load(wa, at, live, pass_words(log_n, 0, t)), tw, False, t, slot)
    for reg in range(WORDS):
        assert np.all(x[reg] < 4 * q) and np.all(y[reg] < (q if cached else 2 * q))
        x[reg] = mont_lazy(x[reg] if cached else csub(x[reg], 2 * q), y[reg], q)
    x = passes_on(plan, x, itw, True, t, slot)
    for reg, i in enumerate(pass_words(log_n, 0, t)):
        out[at(i)[live]] = inverse_out(x[reg], *scale, q)[live]
    return as_tensor(out, a.shape)


class RowBuckets:
    """A JAX transform of (hi, lo) pairs of (..., R, n) rows, jitted once,
    run on the rows padded with zero rows to max(64, 2^ceil(log2 R)): the
    tests' row counts (2 to 37 here, 256 there) share its compiles, 1-3 s
    each.  The transforms act on each row alone, so the padding changes
    no row.  The padding and the cut back are numpy's: as eager JAX ops
    they would compile again for every row count."""

    def __init__(self, fn):
        self.fn = jax.jit(fn)

    def __call__(self, x):
        rows = x[0].shape[-2]
        pad = [(0, 0)] * (x[0].ndim - 2) + [(0, max(64, 1 << (rows - 1).bit_length()) - rows),
                                             (0, 0)]
        out = self.fn(tuple(np.pad(np.asarray(w), pad) for w in x))
        return tuple(np.asarray(w)[..., :rows, :] for w in out)


def run_jax(fn, *xs):
    """A JAX function of (hi, lo) pairs on int64 words, jitted unless it is
    (1-3 s to compile here; eagerly, 7-17 s of op compiles)."""
    jitted = fn if hasattr(fn, "lower") or isinstance(fn, RowBuckets) else jax.jit(fn)
    out = jitted(*(int64_to_pairs(x) for x in xs))
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


#: JAX's transforms, each jitted once a plan (``jax_transform``)
JAX_TRANSFORMS = {name: getattr(jntt, name)
                  for name in ("nwc_fwd_merged", "nwc_inv_merged", "ntt_fwd", "ntt_inv")}


@functools.lru_cache(maxsize=None)
def jax_transform(name: str, jplan) -> RowBuckets:
    return RowBuckets(functools.partial(JAX_TRANSFORMS[name], jplan))


@functools.lru_cache(maxsize=None)
def jax_slot_mul(jplan) -> RowBuckets:
    """The plan's ring's slot product of two (hi, lo) operands of one shape,
    jitted once a plan as a ``RowBuckets`` of their four words: eagerly,
    each of its hundred-odd ops dispatches alone and compiles again for
    every new row count."""
    ring = jplan.ring
    mul = type(ring).mul
    return RowBuckets(lambda x: mul(ring, x[:2], x[2:]))


def run_jax_product(monkeypatch, product, jplan, a, b):
    """JAX's product function (``jntt.nwc_poly_mult_merged``,
    ``jntt.cyclic_poly_mult``) on a and b: its own body, with the
    transforms it calls jitted by ``jax_transform`` and its ring's slot
    product by ``jax_slot_mul``, so a product shares their compiles with
    the transform tests and the other products of its plan (one jit of a
    whole product costs 5-10 s here)."""
    for name in JAX_TRANSFORMS:
        monkeypatch.setattr(jntt, name, lambda plan, x, name=name: jax_transform(name, plan)(x))
    monkeypatch.setattr(jplan.ring, "mul",
                        lambda x, y: jax_slot_mul(jplan)((*x, *y)), raising=False)
    out = product(jplan, int64_to_pairs(a), int64_to_pairs(b))
    return pairs_to_int64(np.asarray(out[0]), np.asarray(out[1]))


@functools.lru_cache(maxsize=None)
def plans(n: int, q: int = P60_4096.q):
    jp = jparams.P60_4096 if (n, q) == (4096, P60_4096.q) else jparams.make_params(n, q)
    return SubPlan64(make_params(n, q), "cpu"), jntt.NttPlan(jp, jparams.Reduction.SHOUP)


def test_pass_schedule_and_tables_cover_every_stage():
    """Every stage once, the first pass short, the tables' offsets the
    .cu's, and every twiddle of every stage in its pass's table once a group."""
    for log_n in range(5, 14):
        schedule = kmxu64.passes(log_n)
        assert [s for s, _ in schedule] == list(np.cumsum([0] + [r for _, r in schedule])[:-1])
        assert sum(r for _, r in schedule) == log_n
        assert schedule[0][1] in (1, 2, 3) and all(r == 3 for _, r in schedule[1:])
        idx = kmxu64.pass_indices(log_n)
        assert len(idx) == sum(1 << (s + r) for s, r in schedule)
        used = np.sort(idx[idx > 0])
        assert np.array_equal(used, np.arange(1, 1 << log_n))  # each stage entry once
    plan, _ = plans(256)
    w, ws = kmxu64.pass_table(plan.plan.merged_flat)
    assert w.is_contiguous() and w.shape == (292,)
    assert torch.equal(w, plan.plan.merged_flat[0][torch.from_numpy(kmxu64.pass_indices(8))])
    assert plan._transform_table(plan.plan.merged_flat) is plan._transform_table(
        plan.plan.merged_flat)


def test_shared_memory_accesses_are_conflict_free():
    """Each half-warp's 8-byte accesses of every pass hit 16 distinct bank
    pairs (two wavefronts a warp), rows and columns, n = 32 to 8192; no two
    threads of a block share a word."""
    for log_n in range(5, 14):
        for cols in (False, True):
            g, t = threads(log_n, cols)
            for s, r in kmxu64.passes(log_n):
                words = np.stack([tile_word(log_n, cols, g, element(log_n, s, r, t, reg))
                                  for reg in range(WORDS)])
                assert len(np.unique(words)) == words.size
                assert words.max() < tile(log_n, cols) << log_n
                slots = np.sort(words.reshape(WORDS, -1, 16) % 16, axis=-1)
                assert np.all(np.diff(slots, axis=-1) > 0), (log_n, cols, s, r)


@pytest.mark.parametrize("n", [32, 256, 4096])
def test_model_matches_plain_and_jax(n):
    plan, jplan = plans(n)
    q, r = plan.p.q, (1 << 64) % plan.p.q
    rows = {32: 37, 256: 5, 4096: 3}[n]  # partial last tiles below 1024
    x = operands(q, (rows, n), seed=n)
    for kind, fwd, inv in (("merged", "nwc_ntt_fwd_plain", "nwc_ntt_inv_plain"),
                           ("cyclic", "ntt_fwd_plain", "ntt_inv_plain")):
        flat, flat_inv = (getattr(plan.plan, f"{kind}_flat"),
                          getattr(plan.plan, f"{kind}_inv_flat"))
        spec = model(plan, x, flat, plan._scale_one, False)
        assert torch.equal(spec, getattr(plan, fwd)(x)), kind
        scaled = model(plan, x, flat, plan._scale_args(r), False)
        assert torch.equal(scaled, plan.ring.mul_tw(spec, plan._r_tw)), kind
        back = model(plan, x, flat_inv, plan._scale_cached, True)
        assert torch.equal(back, getattr(plan, inv)(x)), kind
        assert torch.equal(model(plan, spec, flat_inv, plan._scale_cached, True), x)
        if kind == "merged":  # JAX's XLA merged transforms
            assert torch.equal(spec, run_jax(jax_transform("nwc_fwd_merged", jplan), x))
            assert torch.equal(back, run_jax(jax_transform("nwc_inv_merged", jplan), x))
    # columns: widths below, at and above the tile
    for width in (3, 8, 20):
        xc = operands(q, (2, n * width), seed=width)
        assert torch.equal(model(plan, xc, plan.plan.merged_flat, plan._scale_one, False,
                                 width), plan.nwc_ntt_fwd_cols_plain(xc, width)), width
        assert torch.equal(model(plan, xc, plan.plan.cyclic_inv_flat, plan._scale_cached,
                                 True, width), plan.ntt_inv_cols_plain(xc, width)), width
        if n == 4096:
            break


def product_operands(q: int, rows: int, n: int, seed: int):
    """a and b with the boundary pairs (0, q - 1), (1, 1) and (q - 1, q - 1)
    in rows 0-2, random rows after."""
    a, b = operands(q, (rows, n), seed), operands(q, (rows, n), seed + 1)
    b[:3] = torch.tensor([q - 1, 1, q - 1])[:, None]
    return a, b


@pytest.mark.parametrize("n", [32, 256, 4096])
def test_fused_product_model_matches_plain_and_jax(n, monkeypatch):
    """nwc64_product with merged and cyclic tables and nwc64_cached, the
    model of their fused schedule on the per-pass tables, against the
    plain products and JAX's XLA products."""
    plan, jplan = plans(n)
    q = plan.p.q
    a, b = product_operands(q, {32: 37, 256: 5, 4096: 3}[n], n, seed=n)
    for kind, plain, jfn in (("merged", plan.nwc_poly_mult_plain, jntt.nwc_poly_mult_merged),
                             ("cyclic", plan.cyclic_poly_mult_plain, jntt.cyclic_poly_mult)):
        got = product_model(plan, a, b, getattr(plan.plan, f"{kind}_flat"),
                            getattr(plan.plan, f"{kind}_inv_flat"), plan._scale_fresh)
        assert torch.equal(got, plain(a, b)), kind
        assert torch.equal(got, run_jax_product(monkeypatch, jfn, jplan, a, b)), kind
    spectrum = plan.nwc_spectrum_plain(b)
    got = product_model(plan, a, spectrum, plan.plan.merged_flat, plan.plan.merged_inv_flat,
                        plan._scale_cached, cached=True)
    assert torch.equal(got, plan.nwc_poly_mult_cached_plain(a, spectrum))


def row_lanes(plan: SubPlan64, x: torch.Tensor, period: int):
    """``lanes`` of (R, n) rows, and srow: each thread's row r % P of a
    (P, n) scale table, as a word offset (r % P) n."""
    at, live, t, slot = lanes(plan, x)
    return at, live, t, slot, at(0) // plan.p.n % period * plan.p.n


def times_row(plan: SubPlan64, regs, lane, table):
    """Registers holding the first pass's words times the (P, n) Shoup
    table's words at the same positions of each thread's row srow, lazily:
    any words in, [0, 2q) out (asserted by shoup_lazy); with ``table``
    None, the registers as they are."""
    if table is None:
        return regs
    *_, t, _, srow = lane
    w, ws = (ints(v.reshape(-1)) for v in table)
    return [shoup_lazy(v, w[srow + i], ws[srow + i], plan.p.q)
            for v, i in zip(regs, pass_words(plan.p.log_n, 0, t))]


def row_forward(plan: SubPlan64, words, lane, pre, tw):
    """The fused kernels' forward of one operand (``scaled_forward``): the
    words the first pass loads, times pre (with ``pre`` None canonical,
    as they are), whose first stage then takes lanes below 2q (below q),
    then the passes on the per-pass tables ``tw``: lanes below 4q, the
    spectrum words 8t ... 8t + 7."""
    at, live, t, slot, _ = lane
    x = times_row(plan, load(words, at, live, pass_words(plan.p.log_n, 0, t)), lane, pre)
    return passes_on(plan, x, tw, False, t, slot, below=plan.p.q * (1 if pre is None else 2))


def forward_scaled_model(plan: SubPlan64, x: torch.Tensor, pre: tuple,
                         cacheable: bool) -> torch.Tensor:
    """nwc64_forward_scaled on (R, n) rows: ``row_forward`` on the cyclic
    per-pass tables, row r entered by row r % P of pre, then the
    transforms' store (scale 1, or 2^64 mod q for a cacheable spectrum) of
    words 8t ... 8t + 7."""
    log_n, q = plan.p.log_n, plan.p.q
    lane = row_lanes(plan, x, pre[0].shape[0])
    at, live, t = lane[:3]
    tw = tuple(ints(v) for v in kmxu64.pass_table(plan.plan.cyclic_flat))
    regs = row_forward(plan, ints(x.reshape(-1)), lane, pre, tw)
    out = np.zeros(x.numel(), dtype=object)
    scale = plan._scale_spectrum if cacheable else plan._scale_one
    for reg, i in enumerate(pass_words(log_n, len(kmxu64.passes(log_n)) - 1, t)):
        out[at(i)[live]] = forward_out(regs[reg], *scale, q)[live]
    return as_tensor(out, x.shape)


def inverse_scaled_model(plan: SubPlan64, x: torch.Tensor, post: tuple) -> torch.Tensor:
    """nwc64_inverse_scaled on (R, n) bit-reversed spectra: the words the
    inverse's first pass loads (8t ... 8t + 7, canonical), one lazy Shoup
    product by n^-1 (any word in, [0, 2q) out: the inverse's range), the
    passes on the cyclic per-pass tables, post's lazy Shoup product at the
    store's positions (the .cu reads its words in halves where a thread has
    64 registers: the same products), one compare.  Row r reads row r % P
    of post."""
    log_n, q = plan.p.log_n, plan.p.q
    lane = row_lanes(plan, x, post[0].shape[0])
    at, live, t, slot, _ = lane
    itw = tuple(ints(v) for v in kmxu64.pass_table(plan.plan.cyclic_inv_flat))
    spectrum = pass_words(log_n, len(kmxu64.passes(log_n)) - 1, t)  # 8t ... 8t + 7
    assert all(np.all(i == WORDS * t + k) for k, i in enumerate(spectrum))
    regs = load(ints(x.reshape(-1)), at, live, spectrum)
    assert all(np.all(v < q) for v in regs)
    regs = passes_on(plan, [shoup_lazy(v, *plan._scale_cached, q) for v in regs], itw, True, t,
                     slot)
    out = np.zeros(x.numel(), dtype=object)
    for reg, (v, i) in enumerate(zip(times_row(plan, regs, lane, post),
                                     pass_words(log_n, 0, t))):
        assert np.all(v < 2 * q)
        out[at(i)[live]] = csub(v, q)[live]
    return as_tensor(out, x.shape)


def scaled_model(plan: SubPlan64, a: torch.Tensor, b: torch.Tensor, pre, post,
                 cached: bool = False) -> torch.Tensor:
    """The four-step's row passes fused on the radix-8 core with cyclic
    per-pass tables: on (R, n) rows, nwc64_cyclic_scaled
    (nwc64_cached_scaled with ``cached``); on (K, R, n) stacks,
    nwc64_dot_scaled.  Row r reads row r % P of the (P, n) Shoup tables
    pre and post.  Each term: pre's lazy Shoup product on the words the
    first pass loads (b's unless cached), whose first stage then takes
    lanes below 2q; the forward of b, the forward of a, the slot product on
    the lanes as the registers hold them; the sum of the terms kept below
    2q by one compare after each add; the scale's lazy Shoup product on it
    (the row passes' slot, K = 1); the inverse from those registers, post's
    lazy Shoup product and one compare at the store.  With pre and post
    None, the flat dot nwc64_dot: the same loop on the negacyclic (merged)
    per-pass tables, no scale tables, the first pass on canonical words.
    Every range the .cu states is asserted."""
    log_n, q = plan.p.log_n, plan.p.q
    a3, b3 = (x if x.dim() == 3 else x[None] for x in (a, b))
    kind = "cyclic" if pre is not None else "merged"
    tw = tuple(ints(t) for t in kmxu64.pass_table(getattr(plan.plan, f"{kind}_flat")))
    itw = tuple(ints(t) for t in kmxu64.pass_table(getattr(plan.plan, f"{kind}_inv_flat")))
    out = np.zeros(a3[0].numel(), dtype=object)
    lane = row_lanes(plan, a3[0], 1 if pre is None else pre[0].shape[0])
    at, live, t, slot, _ = lane
    first = pass_words(log_n, 0, t)
    spectrum = pass_words(log_n, len(kmxu64.passes(log_n)) - 1, t)  # 8t ... 8t + 7
    acc = [np.zeros(at(0).shape, dtype=object) for _ in range(WORDS)]
    for a_k, b_k in zip(a3, b3):
        if cached:
            y = load(ints(b_k.reshape(-1)), at, live, spectrum)
            assert all(np.all(v < q) for v in y)
        else:  # [0, 4q) -> [0, 2q)
            y = [csub(v, 2 * q) for v in row_forward(plan, ints(b_k.reshape(-1)), lane, pre, tw)]
        x = row_forward(plan, ints(a_k.reshape(-1)), lane, pre, tw)
        for reg in range(WORDS):
            assert np.all(x[reg] < 4 * q) and np.all(y[reg] < (q if cached else 2 * q))
            p = mont_lazy(x[reg] if cached else csub(x[reg], 2 * q), y[reg], q)
            assert np.all(acc[reg] + p < 4 * q)
            acc[reg] = csub(acc[reg] + p, 2 * q)
    scale = plan._scale_cached if cached else plan._scale_fresh
    x = passes_on(plan, [shoup_lazy(v, *scale, q) for v in acc], itw, True, t, slot)
    for reg, v in enumerate(times_row(plan, x, lane, post)):
        assert np.all(v < 2 * q)
        out[at(first[reg])[live]] = csub(v, q)[live]
    return as_tensor(out, a3[0].shape)


def matvec_sum(terms, q):
    """The matvec's sum of slot products: for each (s, a) pair of canonical
    words, mont_lazy in [0, 2q), added into a sum kept below 2q by one
    compare a term; every range asserted."""
    acc = 0
    for s, a in terms:
        assert np.all(s < q) and np.all(a < q)
        p = mont_lazy(s, a, q)
        assert np.all(acc + p < 4 * q)
        acc = csub(acc + p, 2 * q)
    return acc


def matvec_model(plan: SubPlan64, s: torch.Tensor, spectra: torch.Tensor) -> torch.Tensor:
    """nwc64_matvec on the (l, B, n) rows s against the (k, l, n) cached
    spectra of A, after the wrapper's forward of s (``model``, merged
    tables): output row o = r k + i, the k rows of batch row r adjacent,
    rows tiling blocks as in the transforms.  Thread t of row (i, r) loads
    words 8t ... 8t + 7 of S[j, r] and A[i, j] for each j (``matvec_sum``),
    n^-1's lazy Shoup product, the passes on the merged inverse per-pass
    tables, one compare at the natural-order store; (k, B, n) out."""
    log_n, q, n = plan.p.log_n, plan.p.q, plan.p.n
    (k, l), batch = spectra.shape[:2], s.shape[1]
    fs = model(plan, s.reshape(-1, n), plan.plan.merged_flat, plan._scale_one, False)
    words_s, words_a = ints(fs.reshape(-1)), ints(spectra.reshape(-1))
    at, live, t, slot = lanes(plan, torch.empty((k * batch, n), dtype=torch.int64))
    r, i = at(0) // n // k, at(0) // n % k
    spectrum = pass_words(log_n, len(kmxu64.passes(log_n)) - 1, t)  # 8t ... 8t + 7
    acc = [matvec_sum([(load(words_s, lambda e: (j * batch + r) * n + e, live, [e])[0],
                        load(words_a, lambda e: (i * l + j) * n + e, live, [e])[0])
                       for j in range(l)], q) for e in spectrum]
    itw = tuple(ints(v) for v in kmxu64.pass_table(plan.plan.merged_inv_flat))
    x = passes_on(plan, [shoup_lazy(v, *plan._scale_cached, q) for v in acc], itw, True, t,
                  slot)
    out = np.zeros(k * batch * n, dtype=object)
    for v, e in zip(x, pass_words(log_n, 0, t)):
        assert np.all(v < 2 * q)
        out[((i * batch + r) * n + e)[live]] = csub(v, q)[live]
    return as_tensor(out, (k, batch, n))


def scale_tables(plan, period: int, seed: int) -> tuple:
    """Random (P, n) Shoup tables pre and post, rows 0 and 1 of pre all 1
    and all q - 1 where P allows."""
    q, n = plan.p.q, plan.p.n
    values = operands(q, (2, period, n), seed)
    values[0, :2] = torch.tensor([1, q - 1])[:period, None]
    return tuple(tuple(w.reshape(period, n) for w in plan.ring.encode_tw(v.reshape(-1).tolist(),
                                                                            "cpu"))
                 for v in values)


def rows_times(x: torch.Tensor, table: tuple, q: int) -> torch.Tensor:
    """Row r of the (R, n) x times row r % P of the (P, n) Shoup table's w,
    by Python ints."""
    return as_tensor(ints(x) * np.resize(ints(table[0]), x.shape) % q, x.shape)


@pytest.mark.parametrize("n,rows,period", [(32, 36, 1), (32, 36, 3), (256, 6, 3),
                                           (128, 256, 256)])
def test_fused_row_pass_model_matches_plain_and_jax(n, rows, period, monkeypatch):
    """nwc64_cyclic_scaled and nwc64_cached_scaled, the model of their
    fused schedule on the per-pass tables, against the plain row passes
    and JAX's XLA ``cyclic_poly_mult`` between the scales (by Python ints);
    256 rows of 128 at period 256 are p60_32768's row pass (n1 = 256).
    There also the models of nwc64_forward_scaled (scale 1 and cacheable,
    times 2^64) and nwc64_inverse_scaled at n = 128 (partial tiles) and at
    p60_1048576's n2 = 1024, periods 1 and 3, rows of 0, 1 and q - 1
    first, against ``ntt_fwd_scaled_plain`` and ``ntt_inv_scaled_plain``,
    and the row inverse against JAX's XLA ``ntt_inv`` of the same spectra
    (in natural order) times post (by Python ints)."""
    plan, jplan = plans(n)
    q = plan.p.q
    a, b = product_operands(q, rows, n, seed=n + period)
    pre, post = scale_tables(plan, period, seed=n + period)
    got = scaled_model(plan, a, b, pre, post)
    assert torch.equal(got, plan.cyclic_poly_mult_scaled_plain(a, b, pre, post))
    want = run_jax_product(monkeypatch, jntt.cyclic_poly_mult, jplan,
                           rows_times(a, pre, q), rows_times(b, pre, q))
    assert torch.equal(got, rows_times(want, post, q))
    spectrum = plan.ntt_fwd_scaled_plain(b, pre, True)
    got = scaled_model(plan, a, spectrum, pre, post, cached=True)
    assert torch.equal(got, plan.cyclic_poly_mult_cached_scaled_plain(a, spectrum, pre, post))
    assert torch.equal(got, rows_times(want, post, q))
    if (n, period) != (128, 256):
        return
    for n_f, rows_f in ((128, 12), (1024, 6)):  # partial tiles at 128; a block a row at 1024
        plan_f, jplan_f = plans(n_f)
        x = operands(q, (rows_f, n_f), seed=n_f)
        # JAX's ntt_inv reads natural order: the port's bit-reversed spectra permuted
        jax_inv = run_jax(jax_transform("ntt_inv", jplan_f), plan_f.bitrev_to_natural(x))
        for period_f in (1, 3):
            pre_f, post_f = scale_tables(plan_f, period_f, seed=period_f)
            for cacheable in (False, True):
                assert torch.equal(forward_scaled_model(plan_f, x, pre_f, cacheable),
                                   plan_f.ntt_fwd_scaled_plain(x, pre_f, cacheable)), (
                    n_f, period_f, cacheable)
            got = inverse_scaled_model(plan_f, x, post_f)
            assert torch.equal(got, plan_f.ntt_inv_scaled_plain(x, post_f)), (n_f, period_f)
            assert torch.equal(got, rows_times(jax_inv, post_f, q)), (n_f, period_f)


def test_fused_dot_model_matches_plain_and_jax(monkeypatch):
    """nwc64_dot_scaled at K = 1 and 3, fresh and cached, the model of its
    fused schedule (the row pass's forwards a term, the sum kept below 2q,
    one inverse) against ``dot_scaled_plain`` and the sum of JAX's XLA
    cyclic products between the scales, at 6 rows of 256, period 3 (a row
    pass test's shape: JAX's eager ops compiled once); the same loop
    without scales on merged tables, the flat dot nwc64_dot, against
    ``nwc_dot_plain`` and ``nwc_dot_cached_plain``.  On the same rows the
    matvec nwc64_matvec (``matvec_model``) at (k, l) = (1, 1) and (3, 2)
    against ``nwc_matvec_cached_plain`` and the sums over j of JAX's XLA
    ``nwc_poly_mult_merged(A[i, j], s[j])``; its sum stays below 2q at
    l = 8 with every operand q - 1, at the three q."""
    n, rows, period = 256, 6, 3
    plan, jplan = plans(n)
    q = plan.p.q
    pre, post = scale_tables(plan, period, seed=n)
    for terms in (1, 3):
        a = operands(q, (terms, rows, n), seed=terms)
        b = operands(q, (terms, rows, n), seed=terms + 10).flip(1).contiguous()
        spectra = plan.ntt_fwd_scaled_plain(b.reshape(-1, n), pre, True).reshape(b.shape)
        want = sum(ints(run_jax_product(monkeypatch, jntt.cyclic_poly_mult, jplan,
                                        rows_times(a[k], pre, q), rows_times(b[k], pre, q)))
                   for k in range(terms)) % q
        want = rows_times(as_tensor(want.reshape(-1), (rows, n)), post, q)
        for y, cached in ((b, False), (spectra, True)):
            got = scaled_model(plan, a, y, pre, post, cached)
            assert torch.equal(got, plan.dot_scaled_plain(a, y, pre, post, cached))
            assert torch.equal(got, want), (terms, cached)
        flat = plan.nwc_spectrum_plain(b.reshape(-1, n)).reshape(b.shape)
        assert torch.equal(scaled_model(plan, a, b, None, None), plan.nwc_dot_plain(a, b)), terms
        assert torch.equal(scaled_model(plan, a, flat, None, None, cached=True),
                           plan.nwc_dot_cached_plain(a, flat)), terms
    # nwc64_matvec on the same rows: the k rows of A by the l rows of s,
    # against the plain matvec and the sums of JAX's XLA negacyclic products
    for k, l in ((1, 1), (3, 2)):
        s = operands(q, (l, rows, n), seed=20 + l)  # rows 0, 1, q - 1 first
        mat = operands(q, (k * l + 1, n), seed=30 + k)[1:].reshape(k, l, n).contiguous()
        mat[0, 0] = q - 1
        spectra = plan.nwc_matvec_spectra_plain(mat)
        got = matvec_model(plan, s, spectra)
        assert torch.equal(got, plan.nwc_matvec_cached_plain(s, spectra)), (k, l)
        for i in range(k):
            want = sum(ints(run_jax_product(monkeypatch, jntt.nwc_poly_mult_merged, jplan,
                                            mat[i, j].expand(rows, n).contiguous(), s[j]))
                       for j in range(l)) % q
            assert torch.equal(got[i], as_tensor(want.reshape(-1), (rows, n))), (k, l, i)
    # the sum's bound at the most terms, every operand q - 1
    for q_ in QS:
        edge = np.full(4, q_ - 1, dtype=object)
        total = matvec_sum([(edge, edge)] * 8, q_)
        assert np.all(total < 2 * q_) and np.all((total << 64) % q_ == 8 * (q_ - 1) ** 2 % q_)


def faked_launches(monkeypatch, plan) -> dict:
    """The plan's launches, faked on the CPU: entry -> the C arguments of
    its last launch."""
    calls = {}
    monkeypatch.setattr(plan, "_runs_plain", lambda x: False)
    monkeypatch.setattr(plan, "_launch", lambda entry, out, *args: calls.update(
        {entry: args}) or out)
    return calls


def test_row_passes_launch_with_per_pass_tables(monkeypatch):
    """nwc64_cyclic_scaled, nwc64_cached_scaled, nwc64_dot_scaled,
    nwc64_forward_scaled and nwc64_inverse_scaled receive the cyclic tables
    in the per-pass layout (``pass_table``), nwc64_dot the merged ones and
    nwc64_matvec the merged inverse's, on ``SubPlan64`` (n = 128) and
    ``MxuPlan64`` (n = 256); on the Goldilocks plans gl64_forward_scaled,
    gl64_dot, gl64_dot_scaled, gl64_inverse_scaled and gl64_matvec_scaled,
    on gl64.cu's radix-8 core, receive the cyclic and the merged per-pass
    tables (the shared ``ScaledKernelPlan.ntt_inv_scaled``,
    ``ScaledKernelPlan.matvec_scaled`` and ``KernelPlan._matvec`` route by
    ``pass_entries``); nwc64_matvec_scaled on nwc64.cu's first core the flat
    cyclic inverse table, gl64_matvec on gl64.cu's first core the flat
    merged inverse table, and nwc32_matvec, on nwc32.cu's radix-16 core,
    the merged inverse table in its per-pass layout (four stages a
    pass)."""
    assert {"cyclic_scaled", "cached_scaled", "dot_scaled", "forward_scaled", "inverse_scaled",
            "dot", "matvec"} <= MxuPlan64.pass_entries
    assert {"forward_scaled", "dot", "dot_scaled", "inverse_scaled", "matvec_scaled"} <= \
        GoldilocksPlan64.pass_entries
    assert "matvec" not in GoldilocksPlan64.pass_entries
    assert "matvec" in MxuPlan.pass_entries
    assert "matvec_scaled" not in MxuPlan64.pass_entries
    for cls, gl_cls, n in ((SubPlan64, GoldilocksSubPlan64, 128),
                           (MxuPlan64, GoldilocksPlan64, 256)):
        plan = cls(make_params(n, Q_GENERIC), "cpu")
        calls = faked_launches(monkeypatch, plan)
        a = operands(Q_GENERIC, (4, n), seed=3)
        pre, post = scale_tables(plan, 2, seed=4)
        plan.cyclic_poly_mult_scaled(a, a, pre, post)
        plan.cyclic_poly_mult_cached_scaled(a, a, pre, post)
        plan.dot_scaled(a[None], a[None], pre, post)
        plan.ntt_fwd_scaled(a, pre)
        plan.ntt_inv_scaled(a, post)
        plan.nwc_dot(a[None], a[None])
        plan.nwc_matvec_cached(a.reshape(2, 2, n), a[:2].reshape(1, 2, n))
        plan.matvec_scaled(a[None], a[:2].reshape(1, 1, 2, n), post)
        tw = kmxu64.pass_table(plan.plan.cyclic_flat)
        itw = kmxu64.pass_table(plan.plan.cyclic_inv_flat)
        merged = (kmxu64.pass_table(plan.plan.merged_flat)
                  + kmxu64.pass_table(plan.plan.merged_inv_flat))
        for entry, want in (("cyclic_scaled", tw + itw), ("cached_scaled", tw + itw),
                            ("dot_scaled", tw + itw), ("dot", merged)):
            tables = calls[entry][3:7]  # after a, b and out
            assert all(torch.equal(x, y) for x, y in zip(tables, want)), (cls, entry)
        for entry in ("cyclic_scaled", "cached_scaled", "dot_scaled"):
            assert all(x is y for x, y in zip(calls[entry][7:11], (*pre, *post))), entry
        assert all(torch.equal(x, y) for x, y in zip(calls["forward_scaled"][2:4], tw))
        assert all(x is y for x, y in zip(calls["forward_scaled"][4:6], pre))
        assert all(x is y for x, y in zip(calls["inverse_scaled"][2:4],
                                          plan._transform_table(plan.plan.cyclic_inv_flat)))
        assert all(torch.equal(x, y) for x, y in zip(calls["inverse_scaled"][2:4], itw))
        assert all(x is y for x, y in zip(calls["inverse_scaled"][4:6], post))
        assert all(x is y for x, y in zip(calls["matvec"][3:5],
                                          plan._transform_table(plan.plan.merged_inv_flat)))
        assert all(torch.equal(x, y) for x, y in zip(
            calls["matvec"][3:5], kmxu64.pass_table(plan.plan.merged_inv_flat)))
        assert calls["matvec"][5:8] == (1, 2, 2)  # k, l, B
        assert all(x is y for x, y in zip(calls["matvec_scaled"][3:5],
                                          _plan._table(plan.plan.cyclic_inv_flat)))
        assert calls["matvec_scaled"][7:11] == (2, 1, 1, 4)  # P, k, l, B
        gl = gl_cls(make_params(n, GOLDILOCKS_Q), "cpu")
        calls = faked_launches(monkeypatch, gl)
        gl_pre, gl_post = (a[:2].contiguous(),), (a[2:].contiguous(),)
        gl.ntt_fwd_scaled(a, gl_pre)
        gl.nwc_dot(a[None], a[None])
        gl.dot_scaled(a[None], a[None], gl_pre, gl_post)
        gl.ntt_inv_scaled(a, gl_post)
        gl.nwc_matvec_cached(a.reshape(2, 2, n), a[:2].reshape(1, 2, n))
        gl.matvec_scaled(a[None], a[:2].reshape(1, 1, 2, n), gl_post)
        assert calls["forward_scaled"][2] is gl._transform_table(gl.plan.cyclic_flat)[0]
        assert calls["dot"][3] is gl._transform_table(gl.plan.merged_flat)[0]
        assert calls["dot"][4] is gl._transform_table(gl.plan.merged_inv_flat)[0]
        assert calls["dot_scaled"][3] is gl._transform_table(gl.plan.cyclic_flat)[0]
        assert calls["dot_scaled"][4] is gl._transform_table(gl.plan.cyclic_inv_flat)[0]
        assert calls["dot_scaled"][5:7] == (*gl_pre, *gl_post)
        assert calls["inverse_scaled"][2] is gl._transform_table(gl.plan.cyclic_inv_flat)[0]
        assert torch.equal(calls["inverse_scaled"][2],
                           kmxu64.pass_table(gl.plan.cyclic_inv_flat)[0])
        assert calls["inverse_scaled"][3] is gl_post[0]
        assert calls["matvec"][3] is _plan._table(gl.plan.merged_inv_flat)[0]
        assert calls["matvec"][3].shape == (n,)
        assert calls["matvec_scaled"][3] is gl._transform_table(gl.plan.cyclic_inv_flat)[0]
        assert torch.equal(calls["matvec_scaled"][3],
                           kmxu64.pass_table(gl.plan.cyclic_inv_flat)[0])
        assert calls["matvec_scaled"][4] is gl_post[0]
        assert calls["matvec_scaled"][5:9] == (2, 1, 1, 4)  # P, k, l, B
    plan24 = MxuPlan(make_params(256, 8380417), "cpu")
    calls = faked_launches(monkeypatch, plan24)
    s24 = torch.ones((2, 2, 256), dtype=torch.int32)
    plan24.nwc_matvec_cached(s24, s24[:1])
    assert all(x is y for x, y in zip(calls["matvec"][3:5],
                                      plan24._transform_table(plan24.plan.merged_inv_flat)))
    assert all(torch.equal(x, y) for x, y in zip(
        calls["matvec"][3:5], kmxu64.pass_table(plan24.plan.merged_inv_flat, 4)))


# ---------------------------------------------------------------------------
# The column methods, on the CPU the transpose route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n1,n2", [(32, 32), (64, 32)])
def test_column_methods_match_transposes_and_jax_locals(n1, n2):
    q = Q_GENERIC
    fs = sharded.KernelFourStep(make_params(n1 * n2, q), n1, n2, "cpu")
    jfs = jsharded.FourStepPlan(jparams.make_params(n1 * n2, q), n1, n2)
    col = fs.col_k
    for d in (2, 4, 8):
        width = n2 // d
        x = operands(q, (3, n1 * width), seed=d)
        for method in ("ntt_fwd", "nwc_ntt_fwd", "ntt_inv", "nwc_ntt_inv"):
            got = getattr(col, method + "_cols")(x, width)
            assert torch.equal(got, getattr(col, method + "_cols_plain")(x, width))
            route = fs.from_cols(getattr(col, method + "_plain")(fs.to_cols(x, width=width)),
                                 width=width)
            assert torch.equal(got, route), (method, width)
            out = torch.empty_like(x)
            assert getattr(col, method + "_cols")(x, width, out) is out
            assert torch.equal(out, got)
            if d == 4 and method in ("ntt_fwd", "ntt_inv"):  # JAX's local chain's passes
                jfn = jntt.ntt_fwd_nogather if method == "ntt_fwd" else jntt.ntt_inv_nogather
                local = functools.partial(jsharded._along, 2,
                                          lambda u, f=jfn: f(jfs.col_plan, u))
                want = run_jax(local, x.reshape(3, n1, width))
                assert torch.equal(got, want.reshape(x.shape)), (method, width)
        # the chain's helper: several operands stacked, no transposes
        y = sharded.columns(fs, "nwc_ntt_fwd", False, x, x.flip(0).contiguous(), width=width)
        assert torch.equal(y.reshape(2, 3, -1)[1], col.nwc_ntt_fwd_cols(x.flip(0).contiguous(),
                                                                           width))


def test_column_methods_refuse_what_the_kernel_does_not_take():
    col = SubPlan64(make_params(32, Q_GENERIC), "cpu")
    x = operands(Q_GENERIC, (2, 32 * 4), seed=1)
    with pytest.raises(ValueError, match="whole"):
        col.ntt_fwd_cols(x, 3)
    with pytest.raises(ValueError, match="whole"):
        col.ntt_fwd_cols(x, 0)
    with pytest.raises(TypeError):
        col.ntt_fwd_cols(x.int(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        col.ntt_fwd_cols(x.t(), 4)
    with pytest.raises(ValueError, match="holds"):
        col.ntt_inv_cols(x, 4, torch.empty(3, dtype=torch.int64))
    # the public plan keeps its rows only; Goldilocks and plain sub-plans transpose
    assert not hasattr(MxuPlan64, "ntt_fwd_cols")
    plain = sharded.FourStepPlan(make_params(1024, Q_GENERIC), 32, 32, "cpu")
    assert not hasattr(plain.col_k, "ntt_fwd_cols")


# ---------------------------------------------------------------------------
# The C signatures, and the card
# ---------------------------------------------------------------------------


C_TYPES = {"int": kmxu64.ctypes.c_int, "uint64_t": kmxu64.ctypes.c_uint64}


def test_load_binds_the_c_signatures_of_the_radix_core(monkeypatch):
    """``load`` types nwc64_forward, nwc64_inverse, nwc64_product,
    nwc64_cached, nwc64_dot and nwc64_matvec, ``load_scaled`` the column
    entry points, the three fused row passes, the row forward and the row
    inverse, with the C argument types of csrc/nwc64.cu; those thirteen
    read per-pass tables."""
    bound = {}
    monkeypatch.setattr(_plan, "bind", lambda name, argtypes: bound.update(argtypes))
    _plan.load.__wrapped__("nwc64", 64)
    monkeypatch.setattr(kmxu64, "load", lambda name, bits: None)
    monkeypatch.setattr(kmxu64, "bind", lambda name, argtypes: bound.update(argtypes))
    kmxu64.load_scaled.__wrapped__()
    source = (_build.CSRC / "nwc64.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (nwc64_\w+)\(([^)]*)\)', source))
    radix = ("forward", "inverse", "forward_cols", "inverse_cols", "product", "cached",
             "cyclic_scaled", "cached_scaled", "dot_scaled", "forward_scaled", "inverse_scaled",
             "dot", "matvec")
    assert MxuPlan64.pass_entries == set(radix)
    for suffix in radix:
        params = [p.strip() for p in decls[f"nwc64_{suffix}"].split(",")]
        assert len(params) == len(bound[suffix]), suffix
        for param, ty in zip(params, bound[suffix]):
            want = (kmxu64.ctypes.c_void_p if "*" in param
                    else C_TYPES[param.rsplit(" ", 1)[0]])
            assert ty is want, (suffix, param)
    assert {"nwc64_forward_cols", "nwc64_inverse_cols"} <= set(MxuPlan64.launches)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_rows_and_columns_match_plain(cuda_device):
    for n in (32, 256, 4096):
        plan = SubPlan64(make_params(n, Q62_MAX), cuda_device)
        x = operands(Q62_MAX, (5, n * 8), seed=n).to(cuda_device)
        rows = x.reshape(-1, n)
        for method in ("ntt_fwd", "nwc_ntt_fwd", "ntt_inv", "nwc_ntt_inv", "nwc_spectrum"):
            assert torch.equal(getattr(plan, method)(rows),
                               getattr(plan, method + "_plain")(rows)), (n, method)
        a, b = rows[:5], rows[5:10].contiguous()  # nwc64_product, nwc64_cached
        for method, y in (("nwc_poly_mult", b), ("cyclic_poly_mult", b),
                          ("nwc_poly_mult_cached", plan.nwc_spectrum(b))):
            assert torch.equal(getattr(plan, method)(a, y),
                               getattr(plan, method + "_plain")(a, y)), (n, method)
        pre, post = (tuple(w.to(cuda_device) for w in table)
                     for table in scale_tables(plan, 5, seed=n))
        spectrum = plan.ntt_fwd_scaled(b, pre, True)
        a3, b3 = a.reshape(1, 5, n), b.reshape(1, 5, n)
        for method, args in (("cyclic_poly_mult_scaled", (a, b, pre, post)),
                             ("cyclic_poly_mult_cached_scaled", (a, spectrum, pre, post)),
                             ("dot_scaled", (a3, b3, pre, post)),
                             ("dot_scaled", (a3, spectrum.reshape(1, 5, n), pre, post, True)),
                             ("ntt_fwd_scaled", (a, pre)), ("ntt_fwd_scaled", (a, pre, True)),
                             ("ntt_inv_scaled", (a, post)),
                             ("nwc_dot", (a3, b3)),
                             ("nwc_dot_cached", (a3, plan.nwc_spectrum(b).reshape(1, 5, n))),
                             ("nwc_matvec_cached", (rows[:10].reshape(2, 5, n),
                                                    plan.nwc_matvec_spectra(
                                                        rows[10:16].reshape(3, 2, n))))):
            assert torch.equal(getattr(plan, method)(*args),
                               getattr(plan, method + "_plain")(*args)), (n, method)
        for method in ("ntt_fwd", "nwc_ntt_fwd", "ntt_inv", "nwc_ntt_inv"):
            for width in (1, 3, 8):
                xc = x[:3].reshape(-1)[:3 * n * width].reshape(3, n * width)
                got = getattr(plan, method + "_cols")(xc, width)
                want = getattr(plan, method + "_cols_plain")(xc, width)
                assert torch.equal(got, want), (n, method, width)


# ---------------------------------------------------------------------------
# K1a's ablation toggles: the default body's integers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("toggle", ["prefix_scan", "carry_save", "shoup_lazy"])
def test_k1a_toggle_gives_the_ports_integers(toggle):
    """JAX's ``MxuPlan64`` with the Sklansky borrow scan on (mxu64.py:797,
    :699-708), the u32-word accumulator in place of the carry-save lanes
    (:791, ``_matmul_mont`` :862-945, ``_redc96`` :736) or the strict Shoup
    product in place of the lazy one (:799, ``_shoup`` :946-953), one
    product in interpret mode at n = 256: the port's ``MxuPlan64`` gives
    the same."""
    value = {"prefix_scan": True, "carry_save": False, "shoup_lazy": False}[toggle]
    jax_cls = type(f"JaxMxuPlan64_{toggle}", (JaxMxuPlan64,), {toggle: value})
    jm = jax_cls(jparams.make_params(256, Q_GENERIC))
    jm.groups_per_step = 1  # keep interpret-mode cost down
    a, b = operands(Q_GENERIC, (3, 256), seed=21), operands(Q_GENERIC, (3, 256), seed=22)
    want = jm.nwc_poly_mult(int64_to_pairs(a), int64_to_pairs(b), interpret=True)
    got = MxuPlan64(make_params(256, Q_GENERIC), "cpu").nwc_poly_mult(a, b)
    assert torch.equal(got, pairs_to_int64(np.asarray(want[0]), np.asarray(want[1])))
    assert torch.equal(got, ntt.nwc_poly_mult_merged(ntt.NttPlan(make_params(256, Q_GENERIC),
                                                                 device="cpu"), a, b))

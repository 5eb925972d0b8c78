"""The radix-16 core of ``csrc/nwc32.cu`` (``nwc32_forward``) modelled on the
CPU, and K3's two ablation toggles.

* The lazy arithmetic: a model of the .cu's 32-bit Shoup product
  (``__umulhi``), CT butterfly and store, with the range asserts the .cu
  states beside each step (CT lanes below 4q, every word below 2^32), on
  every pair of 0, 1, q - 1, q, 2q - 1, 4q - 1 and random words at
  DILITHIUM_256's and P24_4096's q = 8380417, q = 16580609 and FALCON's
  q = 12289.
* The pass schedule: a numpy model of the kernel (which words each thread
  holds in each pass, the tile's swizzle, the per-pass tables of
  ``mxu64.pass_table`` at four stages a pass) at n = 256, 4096 and 16384,
  boundary rows 0, 1 and q - 1 first, cyclic and merged tables, scales 1
  and 2^32 mod q, against ``ntt_fwd_plain``, ``nwc_ntt_fwd_plain`` and
  ``nwc_spectrum_plain``, and against JAX: ``MxuPlan`` in interpret mode at
  DILITHIUM_256, its jitted XLA transforms at n = 4096 and 16384, through
  the layout maps; the shared-memory accesses of every pass at every n
  from 256 to 16384, counted for bank conflicts (two ways at most, the
  last pass's words adjacent).
* Faked launches on the CPU: ``nwc32_forward`` receives the per-pass
  tables, the other five entry points the flat ones.
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
from tpu_ntt_torch.convert import int32_to_uint32, spectra_from_jax, uint32_to_int32
from tpu_ntt_torch.kernels import mxu64 as kmxu64
from tpu_ntt_torch.kernels.mxu import RADIX, MxuPlan
from tpu_ntt_torch.params import DILITHIUM_256, make_params

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
    stage of the first pass): x below q, no compare."""
    assert np.all(x < (q if fresh else 4 * q)) and np.all(y < 4 * q)
    u = x if fresh else csub(x, 2 * q)
    v = shoup_lazy(y, w, ws, q)
    out = u + v, u + np.uint64(2 * q) - v
    assert all(np.all(z < 4 * q) for z in out) and 4 * q <= M32
    return out


def forward_out(x, scale, scale_shoup, q):
    """The store: [0, 4q) -> [0, q), times scale unless it is 1."""
    y = csub(csub(x, 2 * q), q) if scale == 1 else csub(shoup_lazy(x, scale, scale_shoup, q), q)
    assert np.all(y < q)
    return y


def shoup(w: int, q: int) -> int:
    return (w << 32) // q


@pytest.mark.parametrize("q", QS)
def test_lazy_butterflies_hold_their_ranges(q):
    """Every step on every pair of the boundary words and random words: the
    Shoup product in [0, 2q) for any 32-bit word, the CT lanes in [0, 4q),
    the store canonical; the butterfly's outputs are x + wy and x - wy."""
    rng = np.random.default_rng(q)
    edge = np.array([0, 1, q - 1, q, 2 * q - 1, 4 * q - 1], dtype=np.uint64)
    lanes = np.concatenate([edge, rng.integers(0, 4 * q, 200, dtype=np.uint64)])
    x, y = (v.reshape(-1) for v in np.meshgrid(lanes, lanes))
    for w in (0, 1, q - 1, int(rng.integers(0, q))):
        u, v = ct(x, y, w, shoup(w, q), q)
        xo, yo = x.astype(object), y.astype(object)
        assert np.all((u.astype(object) - xo - w * yo) % q == 0)
        assert np.all((v.astype(object) + w * yo - xo) % q == 0)
        fresh = x[x < q]
        ct(fresh, y[x < q], w, shoup(w, q), q, fresh=True)
        shoup_lazy(np.array([M32, M32 - 1], dtype=np.uint64), w, shoup(w, q), q)
    for scale in (1, (1 << 32) % q, q - 1):
        got = forward_out(lanes, scale, shoup(scale, q), q)
        assert np.all(got == lanes * np.uint64(scale) % np.uint64(q))
    with pytest.raises(AssertionError):
        ct(np.array([4 * q], dtype=np.uint64), np.zeros(1, np.uint64), 1, shoup(1, q), q)


# ---------------------------------------------------------------------------
# The kernel's schedule, as the .cu lays it out
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


def run_pass(x, w_tab, ws_tab, offset, s, r, hi, q, fresh):
    """The stages of pass (s, r) on the registers x: stage s + d's u-th
    twiddle of group hi at word 2^d + u (word 0 for d = 0) of the group's
    pairs; ``fresh``: the first pass, its first stage on words below q."""
    for d in range(r):
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
                x[reg], x[reg + span] = ct(x[reg], x[reg + span], w[e], ws[e], q,
                                           fresh and d == 0)


def model(plan: MxuPlan, x: torch.Tensor, flat: tuple, scale: tuple) -> torch.Tensor:
    """The kernel on (R, n) int32 rows, every block at once: the first pass
    from device memory, each later pass after the exchange through the
    swizzled tile (every word read is one written, no two threads write
    one word), the store of words 16t ... 16t + 15 at ``scale``."""
    log_n, n, q = plan.p.log_n, plan.p.n, plan.p.q
    schedule = kmxu64.passes(log_n, RADIX)
    offsets = np.cumsum([0] + [1 << (r + s) for s, r in schedule])
    w_tab, ws_tab = (words(t) for t in plan._transform_table(flat))
    rows, g_tile = x.shape[0], tile(log_n)
    g, t = threads(log_n)
    blocks = -(-rows // g_tile)
    g, t = np.tile(g, blocks), np.tile(t, blocks)
    block = np.repeat(np.arange(blocks), g_tile * n // WORDS)
    row = block * g_tile + g
    live = row < rows
    data = words(x).reshape(-1)
    regs = [np.where(live, data[np.where(live, row * n + i, 0)], 0).astype(np.uint64)
            for i in pass_words(log_n, 0, t)]
    written = None
    for p, (s, r) in enumerate(schedule):
        idx = pass_words(log_n, p, t)
        if written is not None:
            slot = lambda i: block * (g_tile << log_n) + g * n + i  # noqa: E731
            smem = np.full(blocks * (g_tile << log_n), -1, dtype=np.int64)
            for reg, i in enumerate(written):
                assert np.all(smem[slot(i)] < 0)
                smem[slot(i)] = regs[reg]
            regs = [smem[slot(i)] for i in idx]
            assert all(np.all(v >= 0) for v in regs)
            regs = [v.astype(np.uint64) for v in regs]
        hi = 0 if p == 0 else t // (n >> (s + RADIX))
        run_pass(regs, w_tab, ws_tab, offsets[p], s, r, hi, q, p == 0)
        written = idx
    out = np.zeros(rows * n, dtype=np.uint64)
    for reg, i in enumerate(pass_words(log_n, len(schedule) - 1, t)):
        assert np.all(i == WORDS * t + reg)  # the store's 16-byte vectors
        out[(row * n + i)[live]] = forward_out(regs[reg], *scale, q)[live]
    return uint32_to_int32(out.astype(np.uint32).reshape(rows, n))


@functools.lru_cache(maxsize=None)
def plans(n: int, q: int):
    """The port's plan and JAX's NttPlan at (n, q): DILITHIUM_256's psi at
    its (n, q), make_params' elsewhere."""
    dil = (n, q) == (DILITHIUM_256.n, DILITHIUM_256.q)
    tp, jp = ((DILITHIUM_256, jparams.DILITHIUM_256) if dil else
              (make_params(n, q), jparams.make_params(n, q)))
    return MxuPlan(tp, "cpu"), jntt.NttPlan(jp)


def times(plan: MxuPlan, x: torch.Tensor, c: int) -> torch.Tensor:
    return uint32_to_int32(words(x) * np.uint64(c) % np.uint64(plan.p.q))


def test_pass_schedule_and_tables_cover_every_stage():
    """Every stage once, the first pass short, four stages a later pass, the
    tables' offsets the .cu's, every twiddle of every stage in its pass's
    table once a group, the per-pass tables built once a table and read by
    ``nwc32_forward`` alone."""
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
    assert MxuPlan.pass_entries == {"forward"}


def test_shared_memory_accesses_conflict_at_most_two_ways():
    """n = 256 to 16384: no two threads of a block share a word of the
    tile, and every word lies in the block's tile; a warp's 4-byte accesses
    of every pass but the last hit every bank at most twice (at most two
    wavefronts), and in the last a thread's sixteen words are adjacent
    (16t ... 16t + 15: four 16-byte vectors a thread)."""
    for log_n in range(8, 15):
        g, t = threads(log_n)
        assert g.size >= 128 and g.size % 32 == 0 and g.size <= 1024
        last = len(kmxu64.passes(log_n, RADIX)) - 1
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


def jax_merged(jplan):
    """JAX's XLA negacyclic forward (bit-reversed, the port's order) and its
    cyclic forward (natural order), jitted."""
    return (jax.jit(functools.partial(jntt.nwc_fwd_merged, jplan)),
            jax.jit(functools.partial(jntt.ntt_fwd, jplan)))


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
        jm = JaxMxuPlan(jparams.DILITHIUM_256)
        jm.groups_per_step = 1  # keep interpret-mode cost down
        perm = jm.fourstep_to_natural_perm()
        for got, fwd in ((spec, jm.nwc_ntt_fwd), (cyc, jm.ntt_fwd)):
            want = np.asarray(fwd(x_np, interpret=True))[..., perm]
            assert np.array_equal(int32_to_uint32(plan.bitrev_to_natural(got)), want)
        assert torch.equal(spectra_from_jax(jm.nwc_spectrum(x_np, interpret=True)), cached)
        return
    merged, natural = jax_merged(jplan)
    assert np.array_equal(int32_to_uint32(spec), np.asarray(merged(x_np)))
    assert np.array_equal(int32_to_uint32(plan.bitrev_to_natural(cyc)), np.asarray(natural(x_np)))


# ---------------------------------------------------------------------------
# The launch path, faked on the CPU
# ---------------------------------------------------------------------------


def test_forward_launches_with_per_pass_tables(monkeypatch):
    """On the launch path (the plan told its tensors are on a card) every op
    that transforms forward (ntt_fwd, nwc_ntt_fwd, nwc_spectrum, the
    matvec's spectra and its s) hands nwc32_forward the per-pass tables of
    its flat tables, four stages a pass; nwc32_product, nwc32_cached,
    nwc32_inverse, nwc32_dot and nwc32_matvec get the flat tables."""
    plan = MxuPlan(DILITHIUM_256, "cpu")
    calls = []
    monkeypatch.setattr(plan, "_runs_plain", lambda x: False)
    monkeypatch.setattr(plan, "_launch", lambda entry, out, *args: calls.append(
        (entry, args)) or out)
    a = uint32_to_int32(operands(plan.p.q, (2, 256), seed=1))
    a3 = a.reshape(2, 1, 256)
    merged, cyclic = plan.plan.merged_flat, plan.plan.cyclic_flat
    pm, pc = plan._transform_table(merged), plan._transform_table(cyclic)
    for fn, args, want in (
            (plan.ntt_fwd, (a,), [("forward", pc)]),
            (plan.nwc_ntt_fwd, (a,), [("forward", pm)]),
            (plan.nwc_spectrum, (a,), [("forward", pm)]),
            (plan.nwc_matvec_spectra, (a3,), [("forward", pm)]),
            (plan.nwc_matvec_cached, (a3, a3.reshape(1, 2, 256)), [("forward", pm),
                                                ("matvec", plan.plan.merged_inv_flat)]),
            (plan.nwc_poly_mult, (a, a), [("product", merged + plan.plan.merged_inv_flat)]),
            (plan.cyclic_poly_mult, (a, a), [("product",
                                              cyclic + plan.plan.cyclic_inv_flat)]),
            (plan.nwc_poly_mult_cached, (a, a), [("cached",
                                                  merged + plan.plan.merged_inv_flat)]),
            (plan.ntt_inv, (a,), [("inverse", plan.plan.cyclic_inv_flat)]),
            (plan.nwc_ntt_inv, (a,), [("inverse", plan.plan.merged_inv_flat)]),
            (plan.nwc_dot, (a3, a3), [("dot", merged + plan.plan.merged_inv_flat)])):
        calls.clear()
        fn(*args)
        assert [entry for entry, _ in calls] == [entry for entry, _ in want], fn.__name__
        for (entry, got), (_, tables) in zip(calls, want):
            at = {"forward": 2, "inverse": 2, "matvec": 3}.get(entry, 3)
            assert all(x is y for x, y in zip(got[at:at + len(tables)], tables)), (
                fn.__name__, entry)
            if entry == "forward":
                assert got[at + 2] == a.numel() // 256 and got[at + 3] == 8


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
    for n, q in ((256, DILITHIUM_256.q), (4096, 8380417), (16384, 16580609)):
        plan = MxuPlan(make_params(n, q), cuda_device)
        x = uint32_to_int32(operands(q, (19, n), seed=n)).to(cuda_device)
        for method in ("ntt_fwd", "nwc_ntt_fwd", "nwc_spectrum"):
            assert torch.equal(getattr(plan, method)(x),
                               getattr(plan, method + "_plain")(x)), (n, method)

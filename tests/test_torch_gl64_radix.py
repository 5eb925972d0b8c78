"""The radix-8 core of ``csrc/gl64.cu`` (``gl64_forward``, ``gl64_inverse``,
their column entry points, the row forward ``gl64_forward_scaled``, the row
inverse ``gl64_inverse_scaled``, and the products fused on it: K2's flat
``gl64_product``, ``gl64_cached`` and ``gl64_dot``, the four-step's row
passes ``gl64_cyclic_scaled``, ``gl64_cached_scaled``, ``gl64_dot_scaled``
and ``gl64_matvec_scaled``) modelled on the CPU, and K2's two ablation
toggles.

* The lazy arithmetic: each ``GL_PTX_*`` carry chain read out of gl64.cu
  and run on a model of the 32-bit PTX instructions (numpy object arrays,
  so one call runs a whole warp's lanes), with the C++ around the chains
  (``mul_lazy``, ``canonical``, ``add_reduced``, ``sub_reduced``,
  ``add_any``, ``sub_any``, the CT and GS butterflies, the store) in the
  .cu's order.  Each step asserts the range the .cu states beside it and
  its value mod q, on every pair of the boundary words 0, 1, q - 1,
  2^63 - 1, 2^63, 2^64 - 2^32, the non-canonical q, q + 1, 2^64 - 2,
  2^64 - 1 and random words of [0, 2^64); the chains gl64.cu shares with
  poseidon.cu are checked to be the same text.
* The pass schedule: a numpy model of the kernel (which words each thread
  holds in each pass, the tile's swizzle, the per-pass table of
  ``mxu64.pass_table`` on the plain Goldilocks twiddles) on those chains,
  at n = 32, 256 and 4096, rows and columns, cyclic and negacyclic tables,
  scales 1 and 2^64 mod q (forward), n^-1 and 1 (inverse), against the
  plain ``ntt`` transforms and JAX's jitted XLA transforms.  The schedule
  helpers (``lanes``, ``pass_words``, ``exchange``) are
  tests/test_torch_nwc64_radix.py's: gl64.cu's schedule is nwc64.cu's.
* The fused products on the same model (``fused_model``): both forwards,
  the slot product and n^-1 on the lanes as the registers hold them, the
  inverse, one compare at the store.  K2's flat product, fresh and cached,
  on merged and cyclic tables at n = 32 and 256 and on merged ones at
  goldilocks_4096's n, against the plain products and JAX's XLA
  ``nwc_poly_mult_merged`` and ``cyclic_poly_mult``; the row pass with the
  entry scale on the words the first pass loads and the exit scale at the
  store, (P, n) tables at P = 1, 3 and 256 (goldilocks_32768's 256 rows of
  128), against the plain row pass and JAX's XLA ``cyclic_poly_mult``
  between the scales.  The row forward (``model`` with ``pre``) at the row
  pass's shapes, scale 1 and q - 1, against ``ntt_fwd_scaled_plain``
  and JAX's XLA ``ntt_fwd`` of the scaled rows; the row inverse
  (``inverse_scaled_model``: n^-1 on the spectrum's words, the passes, post
  at the store) at n = 128 and 1024, P = 1 and 3, against
  ``ntt_inv_scaled_plain`` and JAX's XLA ``ntt_inv`` times post; the
  matvec's row pass (``matvec_scaled_model``: words 8t ... 8t + 7 of each
  S[j, r] and A[i, j, r % P], the slot's mul_lazy summed by add_any, n^-1,
  the passes, post at the store) at the same n, (k, l) = (1, 1) and (3, 2),
  P = 1 and 3, against ``matvec_scaled_plain`` and JAX's XLA ``ntt_inv``
  of the slot sums in natural order times post, in the inverse's JAX call
  (at n = 128 padded to the row pass's 256 rows: one compile).  K2's flat dot
  (``dot_model``: a forward a loop step, the slot's mul_lazy into a sum of
  add_any, one inverse) at K = 1 and 4, fresh and cached, at n = 32, 256
  and 4096 on merged tables, against ``nwc_dot_plain``,
  ``nwc_dot_cached_plain`` and the sum of JAX's XLA
  ``nwc_poly_mult_merged`` of the terms (JAX's ``GoldilocksPlan64`` dot in
  interpret mode at n = 256 is tests/test_torch_kernels_gl64.py's, held to
  the same plain dot); the four-step's row pass of the dot
  ``gl64_dot_scaled`` (``dot_model`` with pre and post on cyclic tables)
  at K = 1 and 4, fresh and cached, n = 32 (36 rows) and 256 (6 rows),
  period 3, against ``dot_scaled_plain`` and the sum of JAX's XLA cyclic
  products between the scales.
* ``GoldilocksSubPlan64``'s column methods (``_plan.ColumnPassPlan``;
  plain on the CPU: the transpose route) against ``FourStepPlan``'s
  transposes and JAX's four-step locals (``tpu_ntt.sharded._along`` of its
  XLA transforms) at 32 x 32 and 64 x 32, widths n2 / D for D = 2, 4, 8;
  the four-step's launch path runs them and never the transposes.
* The C signatures ``load`` binds for the thirteen radix-core entry
  points, and faked launches that hand them the per-pass tables; a
  ``cuda``-marked case holds both layouts, the flat products and dot, the
  row forward, the row inverse, both row passes, the row dot and the
  matvec's row pass against plain on a card.
* JAX's ``GoldilocksPlan64`` with ``split_left`` and ``const_mul_special``
  off (tpu_ntt/kernels/gl64.py:211, :216) in interpret mode at n = 32768
  against the port's four-step: ``slow``, about 25 s (a 12 s plan build).

Tolerance: none — exact integer equality.
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch

import tpu_ntt.ntt as jntt
import tpu_ntt.params as jparams
from test_torch_nwc64_radix import (WORDS, as_tensor, exchange, jax_transform, lanes, load,
                                    pass_words, run_jax, run_jax_product)
from tpu_ntt import sharded as jsharded
from tpu_ntt.kernels.gl64 import GoldilocksPlan64 as JaxGoldilocksPlan64
from tpu_ntt_torch import sharded
from tpu_ntt_torch.convert import int64_to_pairs, pairs_to_int64
from tpu_ntt_torch.kernels import _build, _plan
from tpu_ntt_torch.kernels import gl64 as kgl64
from tpu_ntt_torch.kernels import mxu64 as kmxu64
from tpu_ntt_torch.kernels.fourstep64 import FourStepPlan64
from tpu_ntt_torch.kernels.gl64 import GoldilocksPlan64, GoldilocksSubPlan64
from tpu_ntt_torch.params import make_params

Q = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1  # 2^64 mod q
M32, M64 = (1 << 32) - 1, (1 << 64) - 1
EDGES = [0, 1, Q - 1, (1 << 63) - 1, 1 << 63, (1 << 64) - (1 << 32), Q, Q + 1, M64 - 1, M64]


def operands(shape, seed: int) -> torch.Tensor:
    """Goldilocks residues as int64 bit patterns; the first rows are all 0,
    1, q - 1, 2^63 - 1, 2^63 and 2^64 - 2^32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=shape, dtype=np.uint64)
    rows = x.reshape(-1, shape[-1])
    for k, v in enumerate(EDGES[:6][:rows.shape[0]]):
        rows[k] = v
    return torch.from_numpy(x.view(np.int64))


def ints(t: torch.Tensor) -> np.ndarray:
    """int64 words -> an object array of Python ints (their uint64 values)."""
    return np.array(t.numpy().view(np.uint64).tolist(), dtype=object)


def words(values) -> np.ndarray:
    return np.asarray(values, dtype=object)


def select(cond, a, b) -> np.ndarray:
    """np.where on object words (a 0-d operand would become an int64)."""
    return words(np.where(cond, words(a), words(b)))


# ---------------------------------------------------------------------------
# The PTX carry chains of gl64.cu, on a model of the 32-bit instructions
# ---------------------------------------------------------------------------


def ptx_chains(source: str) -> dict:
    """name -> [(opcode, destination operand, source operands)] of each
    ``#define GL_PTX_<name>`` string of csrc/<source>; a source operand is
    ("%", k) or ("#", immediate)."""
    chains, name, text = {}, None, []
    for line in (_build.CSRC / source).read_text().splitlines():
        m = re.match(r"#define GL_PTX_(\w+)", line)
        if m:
            name, text = m.group(1), []
        if name is None:
            continue
        text += re.findall(r'"((?:[^"\\]|\\.)*)"', line)
        if not line.rstrip().endswith("\\"):
            body = "".join(text).replace("\\n", " ").replace("\\t", " ")
            chains[name] = [_parse(ins) for ins in body.split(";") if ins.strip()]
            name = None
    return chains


def _parse(ins: str):
    op, args = ins.split(None, 1)
    args = [a.strip() for a in args.split(",")]
    srcs = [("%", int(a[1:])) if a.startswith("%") else ("#", int(a, 0)) for a in args[1:]]
    return op, int(args[0][1:]), srcs


CHAINS = ptx_chains("gl64.cu")


def run(chain: str, regs: list, outs: int) -> list:
    """Execute GL_PTX_<chain> on the operands ``regs`` (32-bit words, or
    arrays of them, %k = regs[k]) as PTX does: .cc writes the carry flag
    (for sub, the borrow), addc/subc/madc read it, the destination keeps 32
    bits.  The words run as uint64 (a 32 x 32 product plus two 32-bit words
    and a carry stays below 2^64); %0 ... %(outs - 1) out, object arrays."""
    regs, cf = [np.asarray(r, dtype=object if np.ndim(r) == 0 else None).astype(np.uint64)
                for r in regs], None
    # every operand is 32 bits: the registers given, and each destination after
    assert all(np.all(r <= M32) for r in regs), chain
    one = np.uint64(1)
    for op, d, srcs in CHAINS[chain]:
        v = [regs[k] if kind == "%" else np.uint64(k) for kind, k in srcs]
        assert op.endswith(".u32"), op
        base = op.split(".")[0]
        carry_in = base in ("addc", "subc", "madc")
        assert not carry_in or cf is not None, f"{chain}: {op} reads no carry"
        c = cf if carry_in else np.uint64(0)
        if base in ("add", "addc"):
            s = v[0] + v[1] + c
        elif base in ("sub", "subc"):
            with np.errstate(over="ignore"):  # wraps below 0: its low 32 bits are the result
                s = v[0] - v[1] - c
            borrow = (v[0] < v[1] + c).astype(np.uint64)
        elif base in ("mul", "mad", "madc"):
            prod = v[0] * v[1]
            part = prod >> np.uint64(32) if ".hi" in op else prod & np.uint64(M32)
            s = part + (v[2] if base != "mul" else np.uint64(0)) + c
        else:
            raise AssertionError(f"{chain}: no model of {op}")
        regs[d] = s & np.uint64(M32)
        if ".cc" in op:
            cf = borrow if base in ("sub", "subc") else s >> np.uint64(32)
            assert np.all(cf <= one)
    return [words(r.astype(object)) for r in regs[:outs]]


def split(x):
    """A word's 32-bit halves (lo, hi), as uint64 arrays."""
    u = np.asarray(x, dtype=object).astype(np.uint64)
    return [u & np.uint64(M32), u >> np.uint64(32)]


def join(t0, t1):
    return t0 | t1 << 32


# -- gl64.cu's radix-core arithmetic, in its order --------------------------


def mul_lazy(a, b):
    """A word congruent to a * b for any words: the WIDE chain's four words
    (exact: a * b < 2^128), the fold with k in {-1, 0, 1}, then t + k eps,
    which must not wrap."""
    a, b = words(a), words(b)
    ab = a * b
    r = run("WIDE", [0] * 7 + split(a) + split(b) + [0, 0, 0], 4)
    assert np.all(r[0] | r[1] << 32 | r[2] << 64 | r[3] << 96 == ab)
    t0, t1, k = run("FOLD128", [0, 0, 0, *r, EPS], 3)
    signed = select(k == M32, -1, k)
    assert np.all((signed >= -1) & (signed <= 1))
    t = join(t0, t1)
    fixed = t + signed * EPS
    assert np.all((fixed >= 0) & (fixed <= M64)), "t + k eps wrapped"
    t0, t1 = run("ADD64", [t0, t1, (0 - k) & M32, select(k >> 31 == 1, M32, 0)], 2)
    out = join(t0, t1)
    assert np.all(out == fixed) and np.all(out % Q == ab % Q)
    return out


def canonical(x):
    """Any word -> [0, q): a word at or above q is below 2q."""
    x = words(x)
    out = select(x >= Q, x - Q, x)
    assert np.all(out < Q)
    return out


def add_reduced(a, b):
    """a + b for any word a and b below q: the one carry fix never wraps."""
    a, b = words(a), words(b)
    assert np.all(b < Q)
    t0, t1 = run("ADD_REDUCED", [0, 0, 0, *split(a), *split(b), EPS], 2)
    exact = a + b
    want = select(exact > M64, exact - (1 << 64) + EPS, exact)
    assert np.all(want <= M64) and np.all(join(t0, t1) == want)
    return join(t0, t1)


def sub_reduced(a, b):
    """a - b for any word a and b below q: the one borrow fix never wraps."""
    a, b = words(a), words(b)
    assert np.all(b < Q)
    t0, t1 = run("SUB_REDUCED", [0, 0, 0, *split(a), *split(b)], 2)
    exact = a - b
    want = select(exact < 0, exact + (1 << 64) - EPS, exact)
    assert np.all(want >= 0) and np.all(join(t0, t1) == want)
    return join(t0, t1)


def add_any(a, b):
    """a + b for any words: at most two carry fixes, the last never wraps."""
    a, b = words(a), words(b)
    t0, t1 = run("ADD_ANY", [0, 0, 0, *split(a), *split(b), EPS], 2)
    want = a + b
    for _ in range(2):
        want = select(want > M64, want - (1 << 64) + EPS, want)
    assert np.all(want <= M64) and np.all(join(t0, t1) == want)
    return join(t0, t1)


def sub_any(a, b):
    """a - b for any words: at most two borrow fixes, the last never wraps."""
    a, b = words(a), words(b)
    t0, t1 = run("SUB_ANY", [0, 0, 0, *split(a), *split(b)], 2)
    want = a - b
    for _ in range(2):
        want = select(want < 0, want + (1 << 64) - EPS, want)
    assert np.all(want >= 0) and np.all(join(t0, t1) == want)
    return join(t0, t1)


def ct(x, y, w):
    """The forward's butterfly: any words in and out, w below q."""
    assert np.all(words(w) < Q)
    v = canonical(mul_lazy(y, w))
    out = add_reduced(x, v), sub_reduced(x, v)
    wy = w * y
    assert np.all(out[0] % Q == (x + wy) % Q) and np.all(out[1] % Q == (x - wy) % Q)
    return out


def gs(x, y, w):
    """The inverse's butterfly: any words in and out."""
    out = add_any(x, y), mul_lazy(sub_any(x, y), w)
    assert np.all(out[0] % Q == (x + y) % Q) and np.all(out[1] % Q == (x - y) * w % Q)
    return out


def store(x, scale: int, inverse: bool):
    """The store: any word -> [0, q), times scale (the forward skips 1)."""
    return canonical(x if scale == 1 and not inverse else mul_lazy(x, scale))


def test_shared_chains_are_poseidons():
    """WIDE, FOLD128, ADD64 and ADD_REDUCED are poseidon.cu's chains, whose
    ranges tests/test_torch_poseidon_lazy.py also checks; SUB_REDUCED,
    ADD_ANY and SUB_ANY are gl64.cu's own."""
    theirs = ptx_chains("poseidon.cu")
    for name in ("WIDE", "FOLD128", "ADD64", "ADD_REDUCED"):
        assert CHAINS[name] == theirs[name], name
    assert set(CHAINS) == {"WIDE", "FOLD128", "ADD64", "ADD_REDUCED", "SUB_REDUCED",
                           "ADD_ANY", "SUB_ANY"}


def test_lazy_steps_hold_their_ranges():
    """Every step on every pair of boundary and random words (canonical and
    not), with canonical twiddles 0, 1, q - 1 and random: the asserts of
    each step hold and every result is the right residue."""
    rng = np.random.default_rng(11)
    pool = EDGES + [int(v) for v in rng.integers(0, 1 << 64, size=6, dtype=np.uint64)] + [
        int(v) for v in rng.integers(Q, 1 << 64, size=2, dtype=np.uint64)]
    x = words([a for a in pool for _ in pool])
    y = words([b for _ in pool for b in pool])
    twiddles = [0, 1, Q - 1] + [int(v) for v in rng.integers(0, Q, size=3, dtype=np.uint64)]
    mul_lazy(x, y)
    add_any(x, y)
    sub_any(x, y)
    low = words([v % Q for v in y])
    add_reduced(x, low)
    sub_reduced(x, low)
    for w in twiddles:
        cx, cy = ct(x, y, w)
        gx, gy = gs(x, y, w)
        for lane in (cx, cy, gx, gy):  # the store: canonical, the right residue
            for scale, inverse in ((1, False), (w, False), (w, True)):
                out = store(lane, scale, inverse)
                assert np.all(out < Q) and np.all(out == lane * scale % Q)


def test_one_fix_chains_fail_on_two_lazy_words():
    """Why GS takes the two-fix chains: ADD_REDUCED and SUB_REDUCED on a
    second operand at or above q give a wrong residue (the fix wraps)."""
    a, b = [M64, 0], [M64, M64]
    t0, t1 = run("ADD_REDUCED", [0, 0, 0, *split(a[0]), *split(b[0]), EPS], 2)
    assert join(t0, t1) % Q != (a[0] + b[0]) % Q
    t0, t1 = run("SUB_REDUCED", [0, 0, 0, *split(a[1]), *split(b[1])], 2)
    assert join(t0, t1) % Q != (a[1] - b[1]) % Q
    assert add_any(a[0], b[0]) % Q == (a[0] + b[0]) % Q
    assert sub_any(a[1], b[1]) % Q == (a[1] - b[1]) % Q
    with pytest.raises(AssertionError):
        add_reduced(a[0], b[0])


# ---------------------------------------------------------------------------
# The kernel's schedule on those chains
# ---------------------------------------------------------------------------


def run_pass(x, w_tab, offset, s, r, hi, inverse):
    """The stages of pass (s, r) on the registers x, twiddles from the
    per-pass table: stage s + d's u-th twiddle of group hi at word 2^d + u
    (word 0 for d = 0) of the group's pairs."""
    stages = range(r - 1, -1, -1) if inverse else range(r)
    for d in stages:
        span = (1 << r) >> (d + 1)
        w = [w_tab[offset + 2 * ((((0 if d == 0 else (1 << d) + u) // 2) << s) + hi)
                   + (0 if d == 0 else (1 << d) + u) % 2] for u in range(1 << d)]
        for reg in range(WORDS):
            k = reg % (1 << r)
            if not k & span:
                e = k >> (r - d)
                butterfly = gs if inverse else ct
                x[reg], x[reg + span] = butterfly(x[reg], x[reg + span], w[e])


def passes_on(plan, regs, table, inverse: bool, t, slot):
    """The passes on the registers of ``lanes``' threads, which hold the
    first pass's words in the order they run, with the exchange between
    passes; ``table``: the per-pass words.  The registers end as the last
    pass leaves them."""
    log_n = plan.p.log_n
    schedule = kmxu64.passes(log_n)
    offsets = np.cumsum([0] + [1 << (r + s) for s, r in schedule])
    order = range(len(schedule) - 1, -1, -1) if inverse else range(len(schedule))
    written = None
    for p in order:
        s, r = schedule[p]
        idx = pass_words(log_n, p, t)
        if written is not None:
            regs = [words(v) for v in exchange(regs, written, idx, slot)]
        hi = 0 if p == 0 else t // ((1 << log_n) >> (s + 3))
        run_pass(regs, table, offsets[p], s, r, hi, inverse)
        written = idx
    return regs


def times_row(plan, regs, at, table, idx):
    """Registers holding the words idx of each thread's row times the same
    words of its row r % P of the (P, n) table (mul_lazy: any words); with
    ``table`` None, the registers as they are."""
    if table is None:
        return regs
    n = plan.p.n
    srow = at(0) // n % table.shape[0] * n
    w = ints(table.reshape(-1))
    return [mul_lazy(v, words(w[srow + i])) for v, i in zip(regs, idx)]


def model(plan, x: torch.Tensor, flat, scale, inverse: bool,
          width: int | None = None, pre: torch.Tensor | None = None):
    """The kernel on (R, n * width) words, every block at once: rows
    (width None) or every column of the (n, width) matrices.  With the
    (P, n) table ``pre``, the row forward gl64_forward_scaled: row r's
    words times row r % P's as the first pass loads them.  ``scale`` an
    int, or a tuple of them: the store at each, one output each, from one
    run of the passes."""
    log_n = plan.p.log_n
    last = len(kmxu64.passes(log_n)) - 1
    (table,) = plan._transform_table(flat)
    data, out = ints(x.reshape(-1)), np.zeros(x.numel(), dtype=object)
    first, final = (last, 0) if inverse else (0, last)
    at, live, t, slot = lanes(plan, x, width)
    idx = pass_words(log_n, first, t)
    regs = times_row(plan, [words(v) for v in load(data, at, live, idx)], at, pre, idx)
    regs = passes_on(plan, regs, ints(table), inverse, t, slot)
    outs = []
    for c in scale if isinstance(scale, tuple) else (scale,):
        for reg, i in enumerate(pass_words(log_n, final, t)):
            out[at(i)[live]] = store(regs[reg], c, inverse)[live]
        outs.append(as_tensor(out, x.shape))
    return outs if isinstance(scale, tuple) else outs[0]


def fused_model(plan, a: torch.Tensor, b: torch.Tensor, pre, post,
                cached: bool = False, layout: str = "cyclic") -> torch.Tensor:
    """The products fused on the core on (R, n) rows: the row pass
    (gl64_cyclic_scaled; gl64_cached_scaled with ``cached``) with the (P, n)
    tables pre and post, row r reading their row r % P, on cyclic tables;
    with pre and post None, K2's flat product (gl64_product, gl64_cached)
    on the ``layout`` tables.  pre on the words the first pass loads (b's
    unless cached), the forward of b, the forward of a, the slot product
    and n^-1 on the lanes as the registers hold them, the inverse from
    those registers, post at the store and the one compare."""
    log_n = plan.p.log_n
    tw = ints(plan._transform_table(getattr(plan.plan, f"{layout}_flat"))[0])
    itw = ints(plan._transform_table(getattr(plan.plan, f"{layout}_inv_flat"))[0])
    wa, wb = ints(a.reshape(-1)), ints(b.reshape(-1))
    out = np.zeros(a.numel(), dtype=object)
    scale = (plan._scale_cached if cached else plan._scale_fresh)[0]
    at, live, t, slot = lanes(plan, a)
    first = pass_words(log_n, 0, t)
    spectrum = pass_words(log_n, len(kmxu64.passes(log_n)) - 1, t)  # 8t ... 8t + 7
    if cached:
        y = [words(v) for v in load(wb, at, live, spectrum)]
    else:
        y = times_row(plan, [words(v) for v in load(wb, at, live, first)], at, pre, first)
        y = passes_on(plan, y, tw, False, t, slot)
    x = times_row(plan, [words(v) for v in load(wa, at, live, first)], at, pre, first)
    x = passes_on(plan, x, tw, False, t, slot)
    x = [mul_lazy(mul_lazy(u, v), scale) for u, v in zip(x, y)]  # any words
    x = passes_on(plan, x, itw, True, t, slot)
    for reg, v in enumerate(times_row(plan, x, at, post, first)):
        out[at(first[reg])[live]] = canonical(v)[live]
    return as_tensor(out, a.shape)


def dot_model(plan, a: torch.Tensor, b: torch.Tensor, spectra: torch.Tensor, pre=None,
              post=None) -> list:
    """The dots on (K, R, n) stacks as the kernel runs them: per term the
    forward of b (fresh; cached, the words of b's plain spectrum where a's
    forward leaves its own, 8t ... 8t + 7), the forward of a, the slot's
    mul_lazy added into the sum by add_any (any words, the sum starting at
    0), then one inverse from the sum, n^-1 by mul_lazy and the one compare
    at the store.  Without tables K2's flat dot gl64_dot on merged
    per-pass tables; with the (P, n) tables pre and post, row r reading
    their row r % P, the row pass gl64_dot_scaled on cyclic ones: pre by
    mul_lazy on the words each fresh operand's first pass loads (a cached
    b's never), post by mul_lazy after n^-1's at the store's positions,
    before the compare.  a's forwards serve both; the sums after the first
    term are K = 1's.  Returns the outputs [fresh K = 1, cached K = 1,
    fresh K, cached K]."""
    log_n = plan.p.log_n
    kind = "merged" if pre is None else "cyclic"
    tw = ints(plan._transform_table(getattr(plan.plan, f"{kind}_flat"))[0])
    itw = ints(plan._transform_table(getattr(plan.plan, f"{kind}_inv_flat"))[0])
    at, live, t, slot = lanes(plan, a[0])
    first = pass_words(log_n, 0, t)
    spectrum = pass_words(log_n, len(kmxu64.passes(log_n)) - 1, t)  # 8t ... 8t + 7

    def forward(x):
        regs = times_row(plan, [words(v) for v in load(ints(x.reshape(-1)), at, live, first)], at,
                         pre, first)
        return passes_on(plan, regs, tw, False, t, slot)

    sums = [[words(np.zeros(at(0).shape, dtype=object)) for _ in range(WORDS)]
            for _ in range(2)]
    outs = []
    for k in range(a.shape[0]):
        fresh = forward(b[k])
        cached = [words(v) for v in load(ints(spectra[k].reshape(-1)), at, live, spectrum)]
        x = forward(a[k])
        sums = [[add_any(acc, mul_lazy(u, v)) for acc, u, v in zip(total, x, y)]
                for total, y in zip(sums, (fresh, cached))]
        if k + 1 not in (1, a.shape[0]):
            continue
        for total in sums:
            out = np.zeros(a[0].numel(), dtype=object)
            x = passes_on(plan, list(total), itw, True, t, slot)  # total stays
            x = times_row(plan, [mul_lazy(v, plan.p.n_inv) for v in x], at, post, first)
            for reg, v in enumerate(x):
                out[at(first[reg])[live]] = canonical(v)[live]
            outs.append(as_tensor(out, a[0].shape))
    return outs if a.shape[0] > 1 else outs * 2


def inverse_scaled_model(plan, x: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """gl64_inverse_scaled on (R, n) bit-reversed spectra: the words the
    inverse's first pass loads (8t ... 8t + 7), one mul_lazy by n^-1 (any
    words), the passes on the cyclic per-pass table, post's mul_lazy at the
    store's positions (row r reading row r % P of the (P, n) table), the
    one compare."""
    log_n = plan.p.log_n
    (itw,) = plan._transform_table(plan.plan.cyclic_inv_flat)
    at, live, t, slot = lanes(plan, x)
    first = pass_words(log_n, 0, t)
    spectrum = pass_words(log_n, len(kmxu64.passes(log_n)) - 1, t)  # 8t ... 8t + 7
    assert all(np.all(i == WORDS * t + k) for k, i in enumerate(spectrum))
    regs = [mul_lazy(words(v), plan.p.n_inv) for v in load(ints(x.reshape(-1)), at, live,
                                                          spectrum)]
    regs = passes_on(plan, regs, ints(itw), True, t, slot)
    out = np.zeros(x.numel(), dtype=object)
    for reg, v in enumerate(times_row(plan, regs, at, post, first)):
        out[at(first[reg])[live]] = canonical(v)[live]
    return as_tensor(out, x.shape)


def matvec_scaled_model(plan, spectra: torch.Tensor, mat: torch.Tensor,
                        post: torch.Tensor) -> torch.Tensor:
    """gl64_matvec_scaled on the (l, B, n) row spectra of s against the
    (k, l, P, n) rows of A's cached spectra: output row o = r k + i, the k
    rows of batch row r adjacent, rows tiling blocks as in the transforms.
    Thread t of row (i, r) loads words 8t ... 8t + 7 of S[j, r] and of
    A[i, j, r % P] for each j, the slot's mul_lazy added by add_any into a
    sum from 0 (any words), then one mul_lazy by n^-1, the passes on the
    cyclic inverse per-pass table, post's mul_lazy at the store's positions
    (row r % P of the (P, n) table) and the one compare; (k, B, n) out."""
    log_n, n = plan.p.log_n, plan.p.n
    (l, batch), (k, period) = spectra.shape[:2], (mat.shape[0], mat.shape[2])
    (itw,) = plan._transform_table(plan.plan.cyclic_inv_flat)
    words_s, words_a = ints(spectra.reshape(-1)), ints(mat.reshape(-1))
    at, live, t, slot = lanes(plan, torch.empty((k * batch, n), dtype=torch.int64))
    r, i = at(0) // n // k, at(0) // n % k  # batch row, row of A
    spectrum = pass_words(log_n, len(kmxu64.passes(log_n)) - 1, t)  # 8t ... 8t + 7
    total = [words(np.zeros(r.shape, dtype=object)) for _ in range(WORDS)]
    for j in range(l):
        s = load(words_s, lambda e: (j * batch + r) * n + e, live, spectrum)
        a = load(words_a, lambda e: ((i * l + j) * period + r % period) * n + e, live, spectrum)
        total = [add_any(acc, mul_lazy(words(u), words(v))) for acc, u, v in zip(total, s, a)]
    regs = passes_on(plan, [mul_lazy(v, plan.p.n_inv) for v in total], ints(itw), True, t, slot)
    first = pass_words(log_n, 0, t)
    out = np.zeros(k * batch * n, dtype=object)
    for v, e in zip(times_row(plan, regs, lambda e: r * n + e, post, first), first):
        out[((i * batch + r) * n + e)[live]] = canonical(v)[live]
    return as_tensor(out, (k, batch, n))


@functools.lru_cache(maxsize=None)
def plans(n: int):
    return (GoldilocksSubPlan64(make_params(n, Q), "cpu"),
            jntt.NttPlan(jparams.make_params(n, Q)))


def times(plan, x: torch.Tensor, c: int) -> torch.Tensor:
    return plan.ring.mul_tw(x, plan.ring.encode_tw([c], "cpu"))


def test_pass_tables_hold_the_plain_twiddles():
    """The Goldilocks pass table is the 1-tuple (w,) of the flat table's
    words in mxu64.pass_indices order, contiguous, built once a table, for
    the public plan and the sub-plan alike."""
    for cls, n in ((GoldilocksSubPlan64, 32), (GoldilocksPlan64, 256)):
        plan = cls(make_params(n, Q), "cpu")
        for flat in (plan.plan.merged_flat, plan.plan.cyclic_inv_flat):
            tables = plan._transform_table(flat)
            assert len(tables) == 1 and tables[0].is_contiguous()
            idx = torch.from_numpy(kmxu64.pass_indices(plan.p.log_n))
            assert torch.equal(tables[0], flat[idx])
            assert plan._transform_table(flat) is tables


@pytest.mark.parametrize("n", [32, 256, 4096])
def test_model_matches_plain_and_jax(n, monkeypatch):
    """The transforms' model on rows and columns; then K2's flat product
    fused on the core (``fused_model`` without scales: gl64_product, and
    gl64_cached against the plain spectrum) on merged tables, against the
    plain products and JAX's XLA ``nwc_poly_mult_merged`` (its body around
    the transforms jitted here: the same shape, so the same jits); then
    K2's flat dot (``dot_model``) at K = 1 and 4, fresh and cached, against
    the plain dots and the sum of JAX's products of its terms."""
    plan, jplan = plans(n)
    rows = {32: 37, 256: 5, 4096: 2}[n]  # partial last tiles below 1024
    x = operands((rows, n), seed=n)
    for kind, fwd, inv in (("merged", "nwc_ntt_fwd_plain", "nwc_ntt_inv_plain"),
                           ("cyclic", "ntt_fwd_plain", "ntt_inv_plain")):
        flat, flat_inv = (getattr(plan.plan, f"{kind}_flat"),
                          getattr(plan.plan, f"{kind}_inv_flat"))
        spec, spec_eps = model(plan, x, flat, (1, EPS), False)
        assert torch.equal(spec, getattr(plan, fwd)(x)), kind
        assert torch.equal(spec_eps, times(plan, spec, EPS)), kind
        back, back_n = model(plan, x, flat_inv, (plan.p.n_inv, 1), True)
        assert torch.equal(back, getattr(plan, inv)(x)), kind
        assert torch.equal(back_n, times(plan, back, n)), kind
        assert torch.equal(model(plan, spec, flat_inv, plan.p.n_inv, True), x)
        if kind == "merged":  # JAX's XLA merged transforms
            assert torch.equal(spec, run_jax(jax_transform("nwc_fwd_merged", jplan), x))
            assert torch.equal(back, run_jax(jax_transform("nwc_inv_merged", jplan), x))
    # columns: widths below, at and above the tile
    for width in (3, 8, 20):
        xc = operands((2, n * width), seed=width)
        assert torch.equal(model(plan, xc, plan.plan.merged_flat, 1, False, width),
                           plan.nwc_ntt_fwd_cols_plain(xc, width)), width
        assert torch.equal(model(plan, xc, plan.plan.cyclic_inv_flat, plan.p.n_inv, True,
                                 width), plan.ntt_inv_cols_plain(xc, width)), width
        if n == 4096:
            break
    a, b = row_pass_operands(rows, n, 1, seed=n)[:2]  # x's shape: JAX's jits shared
    want = plan.nwc_poly_mult_plain(a, b)
    assert torch.equal(fused_model(plan, a, b, None, None, layout="merged"), want)
    assert torch.equal(want, run_jax_product(monkeypatch, jntt.nwc_poly_mult_merged, jplan, a, b))
    spectrum = plan.nwc_spectrum_plain(b)
    got = fused_model(plan, a, spectrum, None, None, True, "merged")
    assert torch.equal(got, want)
    assert torch.equal(got, plan.nwc_poly_mult_cached_plain(a, spectrum))
    a3 = operands((4, rows, n), seed=n + 1)
    b3 = operands((4, rows, n), seed=n + 2).flip(1).contiguous()
    spectra = plan.nwc_spectrum_plain(b3.reshape(-1, n)).reshape(b3.shape)
    terms = [ints(run_jax_product(monkeypatch, jntt.nwc_poly_mult_merged, jplan, a3[k], b3[k]))
             for k in range(4)]
    got = dot_model(plan, a3, b3, spectra)
    for (k, cached), out in zip(((1, False), (1, True), (4, False), (4, True)), got):
        want = as_tensor((sum(terms[:k]) % Q).reshape(-1), (rows, n))
        plain = (plan.nwc_dot_cached_plain(a3[:k], spectra[:k]) if cached
                 else plan.nwc_dot_plain(a3[:k], b3[:k]))
        assert torch.equal(out, plain) and torch.equal(out, want), (k, cached)


def row_pass_operands(rows: int, n: int, period: int, seed: int):
    """a, b and random (period, n) tables pre and post; a's rows 0-5 are
    the boundary rows (all 0, 1, q - 1, 2^63 - 1, 2^63, 2^64 - 2^32) and b
    holds them in reverse order, or with fewer than six rows the boundary
    words cycled along row 0 of each."""
    a, b = operands((rows, n), seed), operands((rows, n), seed + 1)
    if rows < 6:
        ends = torch.from_numpy(np.resize(np.array(EDGES[:6], dtype=np.uint64), n)
                                .view(np.int64))
        a[0], b[0] = ends, ends.flip(0)
    else:
        b[:6] = b[:6].flip(0).clone()
    rng = np.random.default_rng(seed + 2)
    pre, post = (torch.from_numpy(rng.integers(0, Q, size=(period, n), dtype=np.uint64)
                                  .view(np.int64)) for _ in range(2))
    return a, b, (pre,), (post,)


def matvec_operands(plan, k: int, l: int, period: int, seed: int):
    """The matvec's row pass on B = 3 batch rows: the (l, B, n) row spectra
    of s, whose rows start with the boundary rows (all 0, 1, q - 1, ...);
    the (k, l, P, n) rows of A's, the boundary rows reversed first (with
    fewer than six, the boundary words from 2^64 - 2^32 down cycled along
    row 0); a random (P, n) table post; and the (k, B, n) slot sums
    sum_j S[j, r] A[i, j, r % P] mod q by Python ints."""
    n, batch = plan.p.n, 3
    s = operands((l * batch, n), seed)
    mat = operands((k * l * period, n), seed + 1)
    ends = min(6, mat.shape[0])
    mat[:ends] = mat[:ends].flip(0).clone()
    if ends < 6:
        mat[0] = torch.from_numpy(np.resize(np.array(EDGES[5::-1], dtype=np.uint64), n)
                                  .view(np.int64))
    rng = np.random.default_rng(seed + 2)
    post = torch.from_numpy(rng.integers(0, Q, size=(period, n), dtype=np.uint64).view(np.int64))
    words_s, words_a = ints(s).reshape(l, batch, n), ints(mat).reshape(k, l, period, n)
    rows = np.arange(batch) % period
    sums = np.array([sum(words_s[j] * words_a[i, j][rows] for j in range(l)) % Q
                     for i in range(k)])
    return (s.reshape(l, batch, n), mat.reshape(k, l, period, n), post,
            as_tensor(sums.reshape(-1), (k, batch, n)))


def times_rows(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Row r of x times row r % P of the (P, n) table, by Python ints."""
    rows, n = x.shape
    t = np.resize(ints(table), (rows, n))
    return as_tensor(ints(x) * t % Q, x.shape)


@pytest.mark.parametrize("n,rows,period", [(32, 36, 1), (32, 36, 3), (256, 6, 3),
                                           (4096, 2, 1), (128, 256, 256)])
def test_fused_row_pass_model_matches_plain_and_jax(n, rows, period, monkeypatch):
    """gl64_cyclic_scaled and gl64_cached_scaled, the model of their fused
    schedule on the per-pass tables and gl64.cu's chains, against the
    plain row pass and JAX's XLA cyclic product between the scales (by
    Python ints); 256 rows of 128 at period 256 are goldilocks_32768's row
    pass (n1 = 256), there gl64_cyclic_scaled alone (the model's chains on
    Python ints take 9 s for it), and the row inverse gl64_inverse_scaled
    (``inverse_scaled_model``) and the matvec's row pass
    gl64_matvec_scaled (``matvec_scaled_model``: (k, l) = (1, 1) and (3, 2),
    three batch rows, so nine rows of 128 end in a partial tile) at n = 128
    and 1024, periods 1 and 3, the boundary words first, against
    ``ntt_inv_scaled_plain`` and ``matvec_scaled_plain`` and JAX's XLA
    ``ntt_inv`` of the same spectra (and of the slot sums, by Python ints)
    in natural order times post (by Python ints), all in one JAX call.
    The row forward gl64_forward_scaled on a and pre, at scale 1 and q - 1
    (one run of the model's passes, two stores), against
    ``ntt_fwd_scaled_plain`` and JAX's XLA ``ntt_fwd`` of the scaled rows.
    At period 3, K2's flat product on the cyclic tables, fresh and cached,
    against ``cyclic_poly_mult_plain`` and JAX's on a and b."""
    plan, jplan = plans(n)
    a, b, pre, post = row_pass_operands(rows, n, period, seed=n + period)
    got = fused_model(plan, a, b, pre[0], post[0])
    assert torch.equal(got, plan.cyclic_poly_mult_scaled_plain(a, b, pre, post))
    want = run_jax_product(monkeypatch, jntt.cyclic_poly_mult, jplan,
                           times_rows(a, pre[0]), times_rows(b, pre[0]))
    assert torch.equal(got, times_rows(want, post[0]))
    spec, spec_q1 = model(plan, a, plan.plan.cyclic_flat, (1, Q - 1), False, pre=pre[0])
    assert torch.equal(spec, plan.ntt_fwd_scaled_plain(a, pre))
    assert torch.equal(spec_q1, times(plan, spec, Q - 1))
    natural = run_jax(jax_transform("ntt_fwd", jplan), times_rows(a, pre[0]))
    assert torch.equal(plan.bitrev_to_natural(spec), natural)
    if period == 256:  # the row inverse and the matvec's row pass at n = 128 and 1024
        for n_i, rows_i in ((128, 12), (1024, 6)):
            plan_i, jplan_i = plans(n_i)
            x = operands((rows_i, n_i), seed=n_i)  # the boundary rows first
            matvecs = [matvec_operands(plan_i, k, l, period_i, seed=n_i + 4 * k + l + period_i)
                       for k, l in ((1, 1), (3, 2)) for period_i in (1, 3)]
            # JAX's ntt_inv reads natural order: the port's bit-reversed spectra permuted;
            # x's rows and the matvecs' slot sums in one call
            stacked = torch.cat([x] + [sums.reshape(-1, n_i) for *_, sums in matvecs])
            sizes = [rows_i] + [sums[..., 0].numel() for *_, sums in matvecs]
            if n_i == n:  # padded to the row pass's rows: JAX's ntt_inv compiled once at 128
                stacked = torch.cat([stacked, stacked.new_zeros((rows - sum(sizes), n_i))])
            jax_inv = run_jax(jax_transform("ntt_inv", jplan_i),
                              plan_i.bitrev_to_natural(stacked))[:sum(sizes)].split(sizes)
            for period_i in (1, 3):  # post's rows: the boundary words from 2^64 - 2^32 down
                post_i = operands((6, n_i), seed=n_i + period_i).flip(0)[:period_i].contiguous()
                got = inverse_scaled_model(plan_i, x, post_i)
                assert torch.equal(got, plan_i.ntt_inv_scaled_plain(x, (post_i,))), (n_i,
                                                                                     period_i)
                assert torch.equal(got, times_rows(jax_inv[0], post_i)), (n_i, period_i)
            # gl64_matvec_scaled: n = 128 at k = 3 ends in a partial tile (9 rows, 8 a block)
            for (spectra, mat, post_i, sums), inv in zip(matvecs, jax_inv[1:]):
                got = matvec_scaled_model(plan_i, spectra, mat, post_i)
                label = (n_i, *mat.shape[:3])
                assert torch.equal(got, plan_i.matvec_scaled_plain(spectra, mat, (post_i,))), label
                assert torch.equal(got, times_rows(inv, post_i).reshape(got.shape)), label
    if rows > 64:
        return
    if n < 4096 and period == 3:  # K2's flat product on cyclic tables, fresh and cached
        flat = plan.cyclic_poly_mult_plain(a, b)
        assert torch.equal(flat, run_jax_product(monkeypatch, jntt.cyclic_poly_mult, jplan, a, b))
        assert torch.equal(fused_model(plan, a, b, None, None), flat)
        assert torch.equal(fused_model(plan, a, plan.ntt_fwd_plain(b), None, None, True), flat)
    spectrum = plan.ntt_fwd_scaled_plain(b, pre, True)
    got = fused_model(plan, a, spectrum, pre[0], post[0], cached=True)
    assert torch.equal(got, plan.cyclic_poly_mult_cached_scaled_plain(a, spectrum, pre, post))
    assert torch.equal(got, times_rows(want, post[0]))


@pytest.mark.parametrize("n,rows", [(32, 36), (256, 6)])
def test_row_pass_dot_model_matches_plain_and_jax(n, rows, monkeypatch):
    """gl64_dot_scaled, the dot's row pass (``dot_model`` with pre and
    post: the flat dot's loop on cyclic per-pass tables with the scales),
    at K = 1 and 4, fresh and cached, on (P, n) tables at period 3, against
    ``dot_scaled_plain`` and the sum of JAX's XLA cyclic products of the
    terms between the scales (by Python ints); term 0's rows 0-5 are the
    boundary rows (0, 1, q - 1, 2^63 - 1, 2^63, 2^64 - 2^32), b's in
    reverse order.  The shapes are the row pass test's, so JAX's jitted
    transforms are shared."""
    plan, jplan = plans(n)
    _, _, pre, post = row_pass_operands(rows, n, 3, seed=n + 5)
    a3 = operands((4, rows, n), seed=n + 6)
    b3 = operands((4, rows, n), seed=n + 7).flip(1).contiguous()
    spectra = plan.ntt_fwd_scaled_plain(b3.reshape(-1, n), pre, True).reshape(b3.shape)
    terms = [ints(run_jax_product(monkeypatch, jntt.cyclic_poly_mult, jplan,
                                  times_rows(a3[k], pre[0]), times_rows(b3[k], pre[0])))
             for k in range(4)]
    got = dot_model(plan, a3, b3, spectra, pre[0], post[0])
    for (k, cached), out in zip(((1, False), (1, True), (4, False), (4, True)), got):
        want = times_rows(as_tensor((sum(terms[:k]) % Q).reshape(-1), (rows, n)), post[0])
        plain = plan.dot_scaled_plain(a3[:k], spectra[:k] if cached else b3[:k], pre, post,
                                      cached)
        assert torch.equal(out, plain) and torch.equal(out, want), (k, cached)


# ---------------------------------------------------------------------------
# The column methods, on the CPU the transpose route; on the launch path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n1,n2", [(32, 32), (64, 32)])
def test_column_methods_match_transposes_and_jax_locals(n1, n2):
    fs = sharded.KernelFourStep(make_params(n1 * n2, Q), n1, n2, "cpu")
    jfs = jsharded.FourStepPlan(jparams.make_params(n1 * n2, Q), n1, n2)
    col = fs.col_k
    assert isinstance(col, GoldilocksSubPlan64) and isinstance(col, _plan.ColumnPassPlan)
    for d in (2, 4, 8):
        width = n2 // d
        x = operands((3, n1 * width), seed=d)
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
        y = sharded.columns(fs, "nwc_ntt_fwd", False, x, x.flip(0).contiguous(), width=width)
        assert torch.equal(y.reshape(2, 3, -1)[1],
                           col.nwc_ntt_fwd_cols(x.flip(0).contiguous(), width))


def test_fourstep_launches_the_column_entry_points(monkeypatch):
    """On the launch path (the plans told their tensors are on a card) the
    Goldilocks four-step's column pass launches gl64_forward_cols and
    gl64_inverse_cols, never the transposes or the row transforms, and
    hands each the tensors and Python ints of gl64.cu's C signature."""
    source = (_build.CSRC / "gl64.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (gl64_\w+)\(([^)]*)\)', source))
    plan = FourStepPlan64(make_params(16384, Q), "cpu")
    fs, calls = plan.fs, []
    for sub in (fs.col_k, fs.row_k):
        monkeypatch.setattr(sub, "_runs_plain", lambda x: False)
        monkeypatch.setattr(sub, "_launch", lambda entry, out, *args: calls.append(
            (f"gl64_{entry}", args)) or out)
    for name in ("to_cols", "from_cols"):
        monkeypatch.setattr(fs, name, lambda *a, **k: pytest.fail("a transpose ran"))
    a = operands((4, 16384), seed=3)
    for op in ("nwc_poly_mult", "nwc_ntt_fwd", "ntt_inv", "nwc_poly_mult_cached"):
        calls.clear()
        getattr(plan, op)(*((a, a) if "mult" in op else (a,)))
        names = [name for name, _ in calls]
        assert not {"gl64_forward", "gl64_inverse"} & set(names), (op, names)
        assert {"gl64_forward_cols", "gl64_inverse_cols"} & set(names), (op, names)
        for name, args in calls:
            params = [p.strip() for p in decls[name].split(",")]
            assert len(args) == len(params) - 1, name  # the stream comes last
            for param, arg in zip(params, args):
                assert isinstance(arg, torch.Tensor) == ("*" in param), (name, param)
            if name.endswith("_cols"):
                tw, matrices, log_n, width, scale = args[2:]
                assert (log_n, width, tw.shape) == (7, 128, (kmxu64.pass_indices(7).size,))
                assert matrices == 4 and scale in (1, fs.col_params.n_inv)
            if name in ("gl64_cyclic_scaled", "gl64_cached_scaled"):  # the fused row pass
                tw, itw, pre, post, period, batch, log_n = args[3:10]
                assert tw.shape == itw.shape == (kmxu64.pass_indices(7).size,), name
                assert (period, batch, log_n, pre.shape) == (128, 4 * 128, 7, (128, 128))


C_TYPES = {"int": kgl64.ctypes.c_int, "uint64_t": kgl64.ctypes.c_uint64}


def test_load_binds_the_c_signatures_of_the_radix_core(monkeypatch):
    """``load`` types the thirteen radix-core entry points (the row
    forward, the row inverse, the flat products and dot and the row pass's
    four among them) with the C argument types of csrc/gl64.cu, and each
    has its own launch count; those thirteen read per-pass tables: faked
    launches on the CPU hand gl64_product the merged or cyclic per-pass
    tables, gl64_cached and gl64_dot the merged ones and
    gl64_forward_scaled the cyclic one."""
    bound = {}
    monkeypatch.setattr(_plan, "bind", lambda name, argtypes: bound.update(argtypes))
    kgl64.load.__wrapped__()
    source = (_build.CSRC / "gl64.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (gl64_\w+)\(([^)]*)\)', source))
    radix = ("forward", "inverse", "forward_cols", "inverse_cols", "forward_scaled",
             "product", "cached", "cyclic_scaled", "cached_scaled", "dot", "dot_scaled",
             "inverse_scaled", "matvec_scaled")
    assert GoldilocksPlan64.pass_entries == set(radix)
    for suffix in radix:
        params = [p.strip() for p in decls[f"gl64_{suffix}"].split(",")]
        assert len(params) == len(bound[suffix]), suffix
        for param, ty in zip(params, bound[suffix]):
            want = (kgl64.ctypes.c_void_p if "*" in param
                    else C_TYPES[param.rsplit(" ", 1)[0]])
            assert ty is want, (suffix, param)
    assert {"gl64_forward_cols", "gl64_inverse_cols"} <= set(GoldilocksPlan64.launches)
    plan, calls = GoldilocksPlan64(make_params(256, Q), "cpu"), []
    monkeypatch.setattr(plan, "_runs_plain", lambda x: False)
    monkeypatch.setattr(plan, "_launch", lambda entry, out, *args: calls.append(
        (entry, args)) or out)
    a = operands((4, 256), seed=5)
    plan.nwc_poly_mult(a, a)
    plan.cyclic_poly_mult(a, a)
    plan.nwc_poly_mult_cached(a, a)
    plan.ntt_fwd_scaled(a, (a[:2].contiguous(),))
    plan.nwc_dot(a.reshape(2, 2, 256), a.reshape(2, 2, 256))
    plan.nwc_dot_cached(a.reshape(2, 2, 256), a.reshape(2, 2, 256))
    tables = {kind: [plan._transform_table(getattr(plan.plan, f"{kind}{inv}_flat"))[0]
                     for inv in ("", "_inv")] for kind in ("merged", "cyclic")}
    for (entry, args), kind in zip(calls[:3] + calls[4:], ("merged", "cyclic", "merged",
                                                           "merged", "merged")):
        assert args[3] is tables[kind][0] and args[4] is tables[kind][1], (entry, kind)
        assert args[5:7] == ((4, 8) if entry != "dot" else (2, 2)), entry
    assert [entry for entry, _ in calls] == ["product", "product", "cached", "forward_scaled",
                                             "dot", "dot"]
    assert calls[3][1][2] is tables["cyclic"][0] and calls[3][1][4:7] == (2, 4, 8)
    assert [args[7:] for _, args in calls[4:]] == [(8, plan._scale_fresh[0], 0),
                                                   (8, plan._scale_cached[0], 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs this check")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_rows_and_columns_match_plain(cuda_device):
    for n in (32, 256, 4096):
        plan = GoldilocksSubPlan64(make_params(n, Q), cuda_device)
        x = operands((5, n * 8), seed=n).to(cuda_device)
        rows = x.reshape(-1, n)
        for method in ("ntt_fwd", "nwc_ntt_fwd", "ntt_inv", "nwc_ntt_inv", "nwc_spectrum"):
            assert torch.equal(getattr(plan, method)(rows),
                               getattr(plan, method + "_plain")(rows)), (n, method)
        for method in ("ntt_fwd", "nwc_ntt_fwd", "ntt_inv", "nwc_ntt_inv"):
            for width in (1, 3, 8):
                xc = x[:3].reshape(-1)[:3 * n * width].reshape(3, n * width)
                got = getattr(plan, method + "_cols")(xc, width)
                want = getattr(plan, method + "_cols_plain")(xc, width)
                assert torch.equal(got, want), (n, method, width)
        a, b = rows[:10], rows[10:20].contiguous()
        for method in ("nwc_poly_mult", "cyclic_poly_mult"):  # gl64_product
            assert torch.equal(getattr(plan, method)(a, b),
                               getattr(plan, method + "_plain")(a, b)), (n, method)
        spectrum = plan.nwc_spectrum(b)  # gl64_cached
        assert torch.equal(plan.nwc_poly_mult_cached(a, spectrum),
                           plan.nwc_poly_mult_cached_plain(a, spectrum)), n
        a3, b3 = a.reshape(2, 5, n), b.reshape(2, 5, n)  # gl64_dot
        assert torch.equal(plan.nwc_dot(a3, b3), plan.nwc_dot_plain(a3, b3)), n
        spectra = spectrum.reshape(2, 5, n)
        assert torch.equal(plan.nwc_dot_cached(a3, spectra),
                           plan.nwc_dot_cached_plain(a3, spectra)), n
        for period in (1, 5):  # the row forward, both row passes, the row dot
            pre, post = ((t.to(cuda_device),) for t in row_pass_operands(period, n, period,
                                                                         seed=n)[:2])
            assert torch.equal(plan.cyclic_poly_mult_scaled(a, b, pre, post),
                               plan.cyclic_poly_mult_scaled_plain(a, b, pre, post))
            spectrum = plan.ntt_fwd_scaled(b, pre, True)
            assert torch.equal(spectrum, plan.ntt_fwd_scaled_plain(b, pre, True)), (n, period)
            assert torch.equal(plan.ntt_inv_scaled(a, post),  # the row inverse
                               plan.ntt_inv_scaled_plain(a, post)), (n, period)
            assert torch.equal(plan.cyclic_poly_mult_cached_scaled(a, spectrum, pre, post),
                               plan.cyclic_poly_mult_cached_scaled_plain(a, spectrum, pre,
                                                                          post))
            spectra = plan.ntt_fwd_scaled(b3.reshape(-1, n), pre, True).reshape(b3.shape)
            for y, cached in ((b3, False), (spectra, True)):  # gl64_dot_scaled
                assert torch.equal(plan.dot_scaled(a3, y, pre, post, cached),
                                   plan.dot_scaled_plain(a3, y, pre, post, cached)), (n, period)
            mat = spectra.reshape(-1, n)[:2 * period].reshape(2, 1, period, n)  # 2 x 1
            assert torch.equal(plan.matvec_scaled(spectra[:1], mat, post),  # gl64_matvec_scaled
                               plan.matvec_scaled_plain(spectra[:1], mat, post)), (n, period)


# ---------------------------------------------------------------------------
# K2's ablation toggles: the default body's integers
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_k2_split_toggles_give_the_ports_integers():
    """JAX's ``GoldilocksPlan64`` with ``split_left`` and
    ``const_mul_special`` off (the dense left DFT in place of the
    split-radix left transform at n1 = 256, tpu_ntt/kernels/gl64.py:211,
    :216), one product in interpret mode at n = 32768: the port's four-step
    (plain on the CPU, gl64_forward_cols and the row kernels on a card)
    gives the same integers."""
    dense = type("JaxGoldilocksPlan64Dense", (JaxGoldilocksPlan64,),
                 {"split_left": False, "const_mul_special": False})
    jm = dense(jparams.make_params(32768, Q))
    jm.groups_per_step = 1  # keep interpret-mode cost down
    a, b = (operands((7, 32768), seed=s)[6:].clone() for s in (31, 32))
    edges = torch.from_numpy(np.array(EDGES[:6] * 2, dtype=np.uint64).view(np.int64))
    a[0, :12], b[0, -12:] = edges, edges  # the boundary words among random ones
    want = jm.nwc_poly_mult(int64_to_pairs(a), int64_to_pairs(b), interpret=True)
    got = FourStepPlan64(make_params(32768, Q), "cpu").nwc_poly_mult(a, b)
    assert torch.equal(got, pairs_to_int64(np.asarray(want[0]), np.asarray(want[1])))

"""The lazy Goldilocks arithmetic of ``csrc/poseidon.cu`` on a model of its PTX.

The kernels K5a and K5b keep each lane as any 64-bit word congruent to its
value mod q and bring it into [0, q) only at the end, so their correctness
rests on ranges: a 128-bit sum that must not pass 2^128, a fold whose
correction must not wrap, a carry word that must stay small.  Uniform
random states reach a word in [q, 2^64) with probability about 2^-32, so
the permutation checks on the card almost never reach those paths.  This
file runs them here: it reads each ``GL_PTX_*`` carry chain out of
poseidon.cu and executes it on a model of the 32-bit PTX instructions
(``mad.lo.cc``, ``madc.hi``, ``addc``, ``sub.cc``, ...) with its carry flag,
and mirrors the C++ around the chains (the words joined, the k fix, the
layers, the schedule) in the .cu's order.  Each primitive asserts the
range the .cu assumes for it, and its result is held to Python integers
mod q on the boundary operands 0, 1, 2, 2^32 - 1, 2^32, q - 1, q, q + 1,
2^63 - 1, 2^63, 2^64 - 2^32 and 2^64 - 1 (every pair) and on random 64-bit
words; the layers on states of boundary words; one permutation at widths 8
and 12 (default schedule, and rf = 6, rp = 11) and the sponge against
JAX's big-int ``PoseidonRef``.  Tolerance: none, exact integers.  The card
runs the same operands through the core itself (``poseidon_field_probe``,
chip_smoke.py and ``test_torch_poseidon.py``'s ``cuda`` test).
"""

import itertools
import re

import numpy as np
import pytest

import tpu_ntt.poseidon as jposeidon
from tpu_ntt_torch import poseidon
from tpu_ntt_torch.kernels import _build
from tpu_ntt_torch.kernels import poseidon as kposeidon

Q = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1
M32 = (1 << 32) - 1
M64 = (1 << 64) - 1
EDGES = [0, 1, 2, (1 << 32) - 1, 1 << 32, Q - 1, Q, Q + 1, (1 << 63) - 1, 1 << 63,
         (1 << 64) - (1 << 32), M64]


def ptx_chains() -> dict:
    """name -> [(opcode, destination operand, source operands)] of each
    ``#define GL_PTX_<name>`` string of poseidon.cu; a source is ("%", k)
    or ("#", immediate)."""
    chains, name, text = {}, None, []
    for line in (_build.CSRC / "poseidon.cu").read_text().splitlines():
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


CHAINS = ptx_chains()


def run(chain: str, regs: list) -> list:
    """Execute GL_PTX_<chain> on the operand values ``regs`` (32-bit words,
    %k = regs[k]) as PTX does: .cc writes the carry flag (for sub, the
    borrow), addc/subc/madc read it, the destination keeps 32 bits."""
    regs, cf = list(regs), None
    for op, d, srcs in CHAINS[chain]:
        v = [regs[k] if kind == "%" else k for kind, k in srcs]
        assert all(0 <= x <= M32 for x in v), (chain, op, v)
        base = op.split(".")[0]
        carry_in = base in ("addc", "subc", "madc")
        if carry_in:
            assert cf is not None, f"{chain}: {op} reads a carry no instruction set"
        c = cf if carry_in else 0
        if base in ("add", "addc"):
            s = v[0] + v[1] + c
        elif base in ("sub", "subc"):
            s = v[0] - v[1] - c
        elif base in ("mul", "mad", "madc"):
            prod = v[0] * v[1]
            part = prod >> 32 if ".hi" in op else prod & M32
            s = part + (v[2] if base != "mul" else 0) + c
        else:
            raise AssertionError(f"{chain}: no model of {op}")
        assert op.endswith(".u32"), op
        regs[d] = s & M32
        if ".cc" in op:
            cf = int(s < 0) if base in ("sub", "subc") else s >> 32
    return regs


def words(x: int) -> list:
    return [x & M32, (x >> 32) & M32]


def join(w0: int, w1: int) -> int:
    return w0 | w1 << 32


# -- the core, in poseidon.cu's order ---------------------------------------


def acc(x: int) -> tuple:
    return (x & M32, x >> 32, 0)


def acc_value(a: tuple) -> int:
    return a[0] | a[1] << 32 | a[2] << 64


def add(a, b) -> tuple:
    """96-bit a + b (a, b words or Accs): exact, the carry word below 2^32."""
    a = acc(a) if isinstance(a, int) else a
    b = acc(b) if isinstance(b, int) else b
    s = tuple(run("ADD96", [0, 0, 0, *a, *b])[:3])
    assert acc_value(s) == acc_value(a) + acc_value(b), "the carry word overflowed"
    return s


def times4(a: tuple) -> tuple:
    w0, w1, w2 = a
    t = ((w0 << 2) & M32, ((w1 << 2) | (w0 >> 30)) & M32, ((w2 << 2) | (w1 >> 30)) & M32)
    assert acc_value(t) == 4 * acc_value(a), "the carry word overflowed"
    return t


def fold(v: tuple) -> int:
    """A word congruent to the 96-bit v: its fix t + c eps must not wrap."""
    t0, t1, c = run("FOLD96", [0, 0, 0, *v, EPS])[:3]
    pre = (v[0] | v[1] << 32) + v[2] * EPS  # the sum of the first two instructions
    t = join(t0, t1)
    assert c == pre >> 64 and t == (pre & M64) + c * EPS, "fold96's fix wrapped"
    assert t % Q == acc_value(v) % Q
    return t


def mul_add(a: int, b: int, c: int, e: int) -> int:
    """a * b + c + e 2^64 folded; the .cu needs the sum below 2^128."""
    total = a * b + c + e * (1 << 64)
    assert total < 1 << 128, "a product-plus-add passed 2^128"
    r = run("WIDE", [0] * 7 + [*words(a), *words(b), *words(c), e])[:4]
    assert sum(w << (32 * i) for i, w in enumerate(r)) == total
    t0, t1, k = run("FOLD128", [0, 0, 0, *r, EPS])[:3]
    ks = k - (1 << 32) if k >> 31 else k
    x = (r[1] << 32 | r[0]) + r[2] * EPS - r[3]
    assert ks in (-1, 0, 1) and join(t0, t1) + ks * (1 << 64) == x
    kl, kh = (-k) & M32, M32 if ks < 0 else 0  # 0u - k and k >> 31 (arithmetic)
    t0, t1 = run("ADD64", [t0, t1, kl, kh])[:2]
    t = join(t0, t1)
    assert t == x - ks * (1 << 64) + ks * EPS, "the k fix wrapped"
    assert t % Q == total % Q
    return t


def mul(a: int, b: int) -> int:
    return mul_add(a, b, 0, 0)


def mul_add_acc(a: int, b: int, s: tuple) -> int:
    assert b < Q, "the diagonal entry must be below q"
    return mul_add(a, b, s[0] | s[1] << 32, s[2])


def add_reduced(a: int, b: int) -> int:
    assert b < Q, "add_reduced's second operand must be below q"
    t0, t1, c = run("ADD_REDUCED", [0, 0, 0, *words(a), *words(b), EPS])[:3]
    t = join(t0, t1)
    assert c == (a + b) >> 64 and t == a + b - c * (1 << 64) + c * EPS, "the fix wrapped"
    return t


def add_any(a: int, b: int) -> int:
    return fold(add(a, b))


def canonical(x: int) -> int:
    return x - Q if x >= Q else x


def sbox(v: int) -> int:
    v2 = mul(v, v)
    v3 = mul(v2, v)
    v4 = mul(v2, v2)
    return mul(v4, v3)


# -- the layers and the permutation ------------------------------------------

WIDEST = {"external": 0, "internal": 0}  # the largest carry word each layer folded


def m4(x: list) -> list:
    t0 = add(x[0], x[1])
    t1 = add(x[2], x[3])
    t2 = add(add(x[1], x[1]), t1)
    t3 = add(add(x[3], x[3]), t0)
    t4 = add(times4(t1), t3)
    t5 = add(times4(t0), t2)
    return [add(t3, t5), t5, add(t2, t4), t4]


def external(x: list, rc: list) -> list:
    w = len(x)
    m = [y for o in range(0, w, 4) for y in m4(x[o:o + 4])]
    out = list(x)
    for i in range(4):
        s = m[i]
        for o in range(4, w, 4):
            s = add(s, m[o + i])
        for o in range(0, w, 4):
            v = add(add(m[o + i], s), rc[o + i])
            assert v[2] < 65, "an external sum reached 65 * 2^64"
            WIDEST["external"] = max(WIDEST["external"], v[2])
            out[o + i] = fold(v)
    return out


def internal(x: list, diag_m1: list) -> list:
    s = add(x[0], x[1])
    for v in x[2:]:
        s = add(s, v)
    assert s[2] < len(x)
    WIDEST["internal"] = max(WIDEST["internal"], s[2])
    return [mul_add_acc(v, d, s) for v, d in zip(x, diag_m1)]


def permute_state(x: list, c: list, rf: int, rp: int) -> list:
    """poseidon.cu's permute_state on the table c = [rf * W full | rp
    partial | W diagonal minus one | W zeros]."""
    w, half = len(x), rf // 2
    rc_part = c[rf * w:rf * w + rp]
    diag_m1 = c[rf * w + rp:rf * w + rp + w]
    zeros = c[rf * w + rp + w:]
    x = external(x, c[:w])
    for r in range(half):
        x = [sbox(v) for v in x]
        x = external(x, c[(r + 1) * w:(r + 2) * w] if r + 1 < half else zeros)
    for r in range(rp):
        x[0] = sbox(add_reduced(x[0], rc_part[r]))
        x = internal(x, diag_m1)
    x = [add_reduced(v, k) for v, k in zip(x, c[half * w:(half + 1) * w])]
    for r in range(half, rf):
        x = [sbox(v) for v in x]
        x = external(x, c[(r + 1) * w:(r + 2) * w] if r + 1 < rf else zeros)
    return x


def table(h: poseidon.Poseidon2GL) -> list:
    """The kernels' shared-memory table: ``constants_table`` and W zeros."""
    t = h.constants_table("cpu").numpy().view(np.uint64).tolist()
    return t + [0] * h.width


def sponge(h: poseidon.Poseidon2GL, row: list) -> list:
    c, x = table(h), [0] * h.width
    x[4] = len(row)
    for off in range(0, max(len(row), 1), 4):
        for i, v in enumerate(row[off:off + 4]):
            x[i] = add_any(x[i], v)
        x = permute_state(x, c, h.rf, h.rp)
    return [canonical(v) for v in x[:4]]


# -- the tests -----------------------------------------------------------------


def operands(count: int, seed: int) -> list:
    """Every pair of boundary words, then ``count`` random pairs: half
    uniform in [0, 2^64), half in [q - 2^33, 2^64), where the lazy paths
    are."""
    rng = np.random.default_rng(seed)
    pairs = list(itertools.product(EDGES, EDGES))
    lo = rng.integers(0, 1 << 64, size=(count, 2), dtype=np.uint64)
    hi = rng.integers(Q - (1 << 33), M64, size=(count, 2), dtype=np.uint64, endpoint=True)
    pick = rng.integers(0, 2, size=(count, 1)).astype(bool)
    rand = np.where(pick, lo, hi).tolist()
    return pairs + [tuple(p) for p in rand]


def test_ptx_chains_are_the_modelled_ones():
    assert sorted(CHAINS) == ["ADD64", "ADD96", "ADD_REDUCED", "FOLD128", "FOLD96", "WIDE"]
    ops = {op for chain in CHAINS.values() for op, _, _ in chain}
    assert ops <= {"add.cc.u32", "addc.u32", "addc.cc.u32", "sub.cc.u32", "subc.u32",
                   "subc.cc.u32", "mul.lo.u32", "mul.hi.u32", "mad.lo.cc.u32",
                   "madc.lo.cc.u32", "madc.hi.cc.u32", "madc.hi.u32"}
    assert sum(op.startswith(("mul", "mad")) for op, _, _ in CHAINS["WIDE"]) == 8


PRIMITIVES = {
    "add_any": (add_any, lambda a, b: a + b),
    "mul": (mul, lambda a, b: a * b),
    "mul_add (96-bit addend)": (lambda a, b: mul_add_acc(a, canonical(b), add(a, b)),
                                lambda a, b: a * b + a + b),
    "add_reduced": (lambda a, b: add_reduced(a, canonical(b)), lambda a, b: a + b),
    "fold of a 96-bit sum": (lambda a, b: fold(add(times4(add(a, b)), a)),
                             lambda a, b: 5 * a + 4 * b),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_is_congruent_on_the_operand_set(name):
    fn, want = PRIMITIVES[name]
    for a, b in operands(4096, seed=len(name)):
        got = fn(a, b)
        assert 0 <= got <= M64 and got % Q == want(a, b) % Q, (name, a, b)
        assert canonical(got) == want(a, b) % Q


def test_canonical_and_sbox_on_the_boundary_words():
    for a in EDGES + [Q - 2, (1 << 64) - (1 << 32) - 1]:
        assert canonical(a) == a % Q
        assert canonical(sbox(a)) == pow(a, 7, Q)


@pytest.mark.parametrize("width", [8, 12])
def test_layers_on_boundary_states(width):
    """The external layer (with constants) and the internal layer on
    states of boundary words, all 2^64 - 1 first (the widest sums)."""
    rng = np.random.default_rng(width)
    mat = np.kron(np.eye(width // 4, dtype=np.int64) + 1, jposeidon.M4).tolist()
    h = poseidon.Poseidon2GL(width)
    diag_m1 = table(h)[-2 * width:-width]
    WIDEST.update(external=0, internal=0)
    states = [[M64] * width] + [[EDGES[k] for k in rng.integers(0, len(EDGES), width)]
                                for _ in range(40)]
    for x in states:
        rc = [canonical(v) for v in x[::-1]]
        got = external(list(x), rc)
        want = [(sum(m * v for m, v in zip(row, x)) + k) % Q for row, k in zip(mat, rc)]
        assert [canonical(v) for v in got] == want
        got = internal(list(x), diag_m1)
        assert [canonical(v) for v in got] == [(sum(x) + d * v) % Q
                                               for v, d in zip(x, diag_m1)]
    # all 2^64 - 1: 16 (width / 4 + 1) words and a constant, and width words
    assert WIDEST == {"external": 16 * (width // 4 + 1), "internal": width - 1}


@pytest.mark.parametrize("width,rf,rp", [(8, 8, 22), (12, 8, 22), (8, 6, 11), (12, 6, 11)])
def test_permutation_equals_poseidon_ref(width, rf, rp):
    h = poseidon.Poseidon2GL(width, rf, rp)
    jref = jposeidon.PoseidonRef(width, rf, rp)
    rng = np.random.default_rng(width + rf)
    for state in (EDGES[5:5 + width] + EDGES[:max(width - 7, 0)],
                  [int(v) for v in rng.integers(0, Q, width, dtype=np.uint64)]):
        state = state[:width]
        got = permute_state(list(state), table(h), rf, rp)
        assert [canonical(v) for v in got] == jref.permute(state)


@pytest.mark.parametrize("length", [0, 1, 5, 9])
def test_sponge_equals_poseidon_ref(length):
    h = poseidon.Poseidon2GL()
    row = [int(v) for v in np.random.default_rng(length).integers(0, Q, length, dtype=np.uint64)]
    assert sponge(h, row) == jposeidon.PoseidonRef().hash_elements(row)


def probe_rows(a: list, b: list, c: list) -> list:
    """poseidon.cu's probe_kernel on the model, element by element."""
    n, rows = len(a), [[] for _ in range(kposeidon.PROBE_ROWS)]
    for i, (x, y, z) in enumerate(zip(a, b, c)):
        core = [add_any(x, y), mul(x, y), mul_add_acc(x, canonical(y), add(x, z)),
                add_reduced(x, canonical(y))]
        out = [v for r in core for v in (r, canonical(r))] + [canonical(x), canonical(sbox(x))]
        for width in (8, 12):
            lanes = [(a, b, c)[j // 4][(i + j % 4) % n] for j in range(width)]
            d = [canonical(c[(i + j) % n]) for j in range(width)]
            out += [canonical(v) for v in external(list(lanes), d)]
            out += [canonical(v) for v in internal(list(lanes), d)]
        for row, v in zip(rows, out):
            row.append(v)
    return rows


def test_probe_on_the_model_gives_field_probe_want():
    """The rows chip_smoke.py expects of ``poseidon_field_probe``
    (``field_probe_want``) are those of its kernel's model."""
    ops = operands(60, seed=49)
    a, b = [p[0] for p in ops], [p[1] for p in ops]
    c = b[7:] + b[:7]
    want = kposeidon.field_probe_want(a, b, c)
    for k, (got, row) in enumerate(zip(probe_rows(a, b, c), want)):
        assert [v % Q for v in got] == list(row), k
        if k not in kposeidon.PROBE_LAZY_ROWS:
            assert got == list(row), k

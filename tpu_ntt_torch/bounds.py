"""The least time a kernel could take on the card: its roofline bound.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the memory rate, and the
32-bit integer multiplies (IMADs) it needs over the card's IMAD rate.  A
modular product is priced by its form (``MULS``), plus its product by q
unless q has at most three signed binary digits, when that product is shifts
and adds.  ``work`` counts a call of each ported kernel function (the
``nwc32_*``, ``nwc64_*`` and ``gl64_*`` NTT families through ``ntt_work``,
the four-step's row kernels ``nwc64_*_scaled`` with their scale tables,
the ML-KEM ``kyber_*`` functions through ``kyber_work``), ``fourstep_work``
a large-n op through the whole four-step, and ``poseidon_work`` a call of
``poseidon_permute`` or ``poseidon_sponge``, ``a2a_card_work`` an exchange
of ``a2a_exchange`` among logical shards of one card (``a2a_work`` the same
exchange over NVLink on four cards); ``chip_smoke.py`` divides them by the
rates of the card it runs on.

Run as a script, it prints the four-step chains' bounds at the shapes of
bench.py's large-n rows (and the Goldilocks rows beside them), those of the
STARK commitment's LDE and leaf sponge at Plonky2's degree 2^17 (``lde_work``,
``poseidon_work``) and K6's exchange at p60_1048576 on one card and on four,
worked out from the code (not measured) at the H100 SXM's data-sheet
rates::

    python3 -m tpu_ntt_torch.bounds
"""

from __future__ import annotations

from .sharded import default_split

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
IMAD_PER_SM_CLOCK = 64  # 32-bit integer multiplies a clock, compute capability 9.0
H100_SMS, H100_TOP_SM_HZ = 132, 1.98e9  # H100 SXM data sheet, for the script only
# 32-bit multiplies in one modular product, before its product by q:
# Shoup-32 a*w and hi(a*w'); Montgomery-32 the wide a*b (two words) and
# m = lo*q'.  The 64-bit forms build a wide product from four 32 x 32 ones:
# Shoup-64 lo64(a*w) (4) and hi64(a*w') (8); Montgomery-64 a*b (8) and
# lo64(m) (4).  Goldilocks: the full 128-bit a*b (8); 2^64 = 2^32 - 1 mod q
# makes the reduction shifts and adds.
MULS = {"shoup32": 2, "mont32": 3, "shoup64": 12, "mont64": 12, "gl64": 8}
# The product by q: Shoup's lo(t*q), REDC's hi(m*q).
MULS_BY_Q = {"shoup32": 1, "mont32": 1, "shoup64": 4, "mont64": 8, "gl64": 0}

GL_Q = (1 << 64) - (1 << 32) + 1
DOT_TERMS = 4  # K of the dot and k = l of the matvec that chip_smoke.py runs


def naf_weight(q: int) -> int:
    """Nonzero digits of q in signed binary (non-adjacent form)."""
    weight = 0
    while q:
        if q & 1:
            q -= 2 - (q & 3)  # the digit +1 or -1 that leaves q even
            weight += 1
        q >>= 1
    return weight


def muls(form: str, q: int) -> int:
    """The 32-bit multiplies one modular product of ``form`` needs at q.  A
    product by a q of at most three signed binary digits, such as
    2^23 - 2^13 + 1 or 2^60 - 2^14 + 1, is shifts and adds: no multiply."""
    return MULS[form] + (MULS_BY_Q[form] if naf_weight(q) > 3 else 0)


def table_words(form: str) -> int:
    """Words a table entry holds: w and its Shoup companion, or the plain
    w of Goldilocks (Shoup needs q < 2^63)."""
    return 1 if form == "gl64" else 2


def ntt_work(entry: str, n: int, log_n: int, q: int, word: int, batch: int,
             terms: int = DOT_TERMS, forms=None, period: int = 1) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one call of a fused NTT kernel entry
    (``product``, ``cached``, ``forward``, ``inverse``, ``dot`` fresh or,
    as ``dot_cached``, cached, ``matvec``, the column entry points ``forward_cols`` and
    ``inverse_cols`` on ``batch`` columns, and the four-step's row kernels
    ``cyclic_scaled``, ``cached_scaled``, ``forward_scaled`` at scale 1,
    ``inverse_scaled``, ``dot_scaled`` fresh or, as ``dot_cached_scaled``,
    cached, and ``matvec_scaled``) on ``batch`` output rows of n
    ``word``-byte residues:
    each transform needs (n/2) log2 n twiddle products, each slot product
    one Montgomery product, each scale one Shoup product.  ``terms`` is the
    K of the dot and both k and l of the matvec, whose count is the whole
    op: the forward of s and the accumulate-and-inverse (``matvec_alone``
    and ``matvec_scaled``: the accumulate-and-inverse alone, ``batch``
    columns of s, ``batch`` rows of s).  ``period`` is
    the rows of a row kernel's scale tables (and of the matvec's matrix),
    each table (w, w') (w alone for Goldilocks), read once.  ``forms``
    overrides the (twiddle, slot) product forms, which default to Shoup and
    Montgomery of the word size."""
    entry = entry.removesuffix("_cols")  # a column entry point: its row twin's work
    bits = "64" if word == 8 else "32"
    forms = forms or ("shoup" + bits, "mont" + bits)
    shoup, mont = (muls(f, q) for f in forms)
    t = log_n * n // 2
    rows = batch * n * word
    table = table_words(forms[0]) * period * n * word
    if entry == "cyclic_scaled":
        return 3 * rows + 2 * table, batch * (3 * t * shoup + n * (mont + 4 * shoup))
    if entry == "cached_scaled":
        return 3 * rows + 2 * table, batch * (2 * t * shoup + n * (mont + 3 * shoup))
    if entry in ("dot_scaled", "dot_cached_scaled"):
        fresh = 2 if entry == "dot_scaled" else 1  # operands transformed and scaled
        return ((2 * terms + 1) * rows + 2 * table,
                batch * (terms * (fresh * (t + n) * shoup + n * mont)
                         + (t + 2 * n) * shoup))
    if entry == "matvec_scaled":
        return (2 * terms * rows + terms * terms * period * n * word + table,
                batch * terms * (terms * n * mont + (t + 2 * n) * shoup))
    if entry == "forward_scaled":
        return 2 * rows + table, batch * (t + n) * shoup
    if entry == "inverse_scaled":
        return 2 * rows + table, batch * (t + 2 * n) * shoup
    if entry == "product":
        return 3 * rows, batch * (3 * t * shoup + n * (mont + shoup))
    if entry == "cached":
        return 3 * rows, batch * (2 * t * shoup + n * (mont + shoup))
    if entry == "forward":
        return 2 * rows, batch * t * shoup
    if entry == "inverse":
        return 2 * rows, batch * (t + n) * shoup
    if entry in ("dot", "dot_cached"):
        fresh = 2 if entry == "dot" else 1  # operands transformed
        return ((2 * terms + 1) * rows,
                batch * (fresh * terms * t * shoup + terms * n * mont + (t + n) * shoup))
    if entry == "matvec_alone":  # the accumulate-and-inverse on the spectra of s
        return ((terms + terms) * rows + terms * terms * n * word,
                batch * terms * (terms * n * mont + (t + n) * shoup))
    assert entry == "matvec", entry
    return ((terms + terms) * rows + terms * terms * n * word,
            batch * (terms * t * shoup + terms * (terms * n * mont + (t + n) * shoup)))


KYBER_Q, KYBER_N, KYBER_STAGES = 3329, 256, 7  # FIPS 203: seven layers, degree-2 leaves
KYBER_BATCH = 2048 * 8  # bench.py's bench_kyber(batch * 8)
KYBER_K = 3  # ML-KEM-768, FIPS 203's recommended set


def kyber_work(entry: str, batch: int, terms: int = KYBER_K) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one call of a ``csrc/kyber.cu`` entry
    (``forward`` at scale 1, as ``ntt`` calls it, ``inverse``, ``product``,
    ``cached``, ``dot`` fresh, ``dot_cached``, ``matvec``) on ``batch``
    output rows of 256 int32 residues: 7 stages of 128 Shoup butterflies a transform, five
    Montgomery products a slot of the base case, 256 Shoup scales before
    each inverse.  ``terms`` is the K of the dot and both k and l of the
    matvec, whose count is the whole op: the forwards of s, the base cases
    against A's k * l spectra and the k inverses."""
    n, shoup, mont = KYBER_N, muls("shoup32", KYBER_Q), muls("mont32", KYBER_Q)
    t = KYBER_STAGES * n // 2
    base = n // 2 * 5 * mont
    inv = (t + n) * shoup
    rows = batch * n * 4
    if entry == "forward":
        return 2 * rows, batch * t * shoup
    if entry == "inverse":
        return 2 * rows, batch * inv
    if entry == "product":
        return 3 * rows, batch * (2 * t * shoup + base + inv)
    if entry == "cached":
        return 3 * rows, batch * (t * shoup + base + inv)
    if entry in ("dot", "dot_cached"):
        fresh = 2 if entry == "dot" else 1  # operands transformed
        return ((2 * terms + 1) * rows,
                batch * (fresh * terms * t * shoup + terms * base + inv))
    assert entry == "matvec", entry
    return (2 * terms * rows + terms * terms * n * 4,
            batch * (terms * t * shoup + terms * (terms * base + inv)))


def work(kernel: str, p, batch: int, terms: int = DOT_TERMS,
         period: int = 1) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one call of ``kernel`` at the
    parameters p (``nwc32_*``, ``nwc64_*`` or ``gl64_*``; p is not read for
    the fixed ring of ``kyber_*``), ``batch`` output rows; ``period`` rows
    of scale tables for ``nwc64_*_scaled`` and ``gl64_*_scaled``.  Every
    Goldilocks product,
    twiddle, slot or scale, is one ``gl64`` product: its twiddles are plain
    and its forward has no scale (the spectra are plain)."""
    family, entry = kernel.split("_", 1)
    if family == "kyber":
        return kyber_work(entry, batch, terms)
    word = 8 if p.width > 30 else 4
    forms = ("gl64", "gl64") if family == "gl64" else None
    return ntt_work(entry, p.n, p.log_n, p.q, word, batch, terms, forms, period)


def fourstep_work(op: str, n: int, q: int, batch: int,
                  terms: int = DOT_TERMS) -> tuple[int, int, int]:
    """(bytes, bytes as built, 32-bit multiplies) of one large-n op through
    the four-step (``kernels.fourstep64``; the Goldilocks q prices its
    products as ``gl64`` and its tables as plain words) on ``batch`` rows
    of n int64 residues (``batch`` output rows of the dot, ``batch`` columns of s of
    the terms x terms matvec): ``nwc`` (column forward of a and b,
    ``cyclic_scaled``, column inverse), ``cached`` (column forward of a,
    ``cached_scaled``, column inverse), ``dot`` and ``dot_cached`` (column
    forward of each fresh operand, ``dot_scaled``, column inverse),
    ``matvec`` (column forward of s, ``forward_scaled``, ``matvec_scaled``,
    column inverse), ``nwc_fwd`` (column forward, ``forward_scaled``),
    ``spectrum`` (the same, and at a 60-bit q one Shoup product a word by
    2^64) or ``nwc_inv`` (``inverse_scaled``, column inverse).  Bytes: each input
    read once and the output written once, with the mid tables (and the
    matvec's spectra of A); as built, what the kernels move: both families'
    column passes are column entry points (``nwc64_*_cols``,
    ``gl64_*_cols``), priced as their row twins, with no transposes."""
    n1, n2 = default_split(n)
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    data = batch * n * 8
    forms = ("gl64", "gl64") if q == GL_Q else None
    mid = table_words(forms[0] if forms else "shoup64") * n * 8
    tables = 2 * mid  # two mid tables, for every op but the halves

    def col(entry, polys):
        return ntt_work(entry + "_cols", n1, l1, q, 8, polys * n2, forms=forms)

    def row(entry, rows, k=terms):
        return ntt_work(entry, n2, l2, q, 8, rows * n1, k, forms, period=n1)

    if op == "nwc":
        kernels = [col("forward", 2 * batch), row("cyclic_scaled", batch),
                   col("inverse", batch)]
        io = 3 * data
    elif op == "cached":
        kernels = [col("forward", batch), row("cached_scaled", batch),
                   col("inverse", batch)]
        io = 3 * data
    elif op in ("dot", "dot_cached"):
        fresh = 2 if op == "dot" else 1
        entry = "dot_scaled" if op == "dot" else "dot_cached_scaled"
        kernels = [col("forward", fresh * terms * batch), row(entry, batch),
                   col("inverse", batch)]
        io = (2 * terms + 1) * data
    elif op == "matvec":
        kernels = [col("forward", terms * batch), row("forward_scaled", terms * batch),
                   row("matvec_scaled", batch), col("inverse", terms * batch)]
        io = 2 * terms * data + terms * terms * n * 8
    elif op in ("nwc_fwd", "spectrum"):
        kernels = [col("forward", batch), row("forward_scaled", batch)]
        if op == "spectrum" and not forms:  # times 2^64 mod q
            kernels.append((0, batch * n * muls("shoup64", q)))
        tables, io = mid, 2 * data
    else:
        assert op == "nwc_inv", op
        kernels = [row("inverse_scaled", batch), col("inverse", batch)]
        tables, io = mid, 2 * data
    return io + tables, sum(b for b, _ in kernels), sum(m for _, m in kernels)


# ----------------------------------------------------------------------
# Poseidon2-GL, kernels K5a and K5b
# ----------------------------------------------------------------------

POSEIDON_RF, POSEIDON_RP = 8, 22  # tpu_ntt/poseidon.py's defaults
POSEIDON_BATCH = 2048 * 64  # bench.py's bench_poseidon(batch * 64), the Merkle level


def poseidon_products(width: int, rf: int = POSEIDON_RF, rp: int = POSEIDON_RP) -> int:
    """Goldilocks products in one permutation: x^7 is four, each full
    round has one S-box a lane, each partial round one S-box and the
    internal layer's ``width`` diagonal products; the external layer is
    adds."""
    return rf * 4 * width + rp * (4 + width)


def poseidon_work(entry: str, width: int, batch: int, length: int = 0) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one call of ``poseidon_permute`` (a
    (width, batch) state in and out) or ``poseidon_sponge`` (``batch`` rows
    of ``length`` elements in, a 4-lane digest out, max(ceil(length / 4),
    1) permutations a row), at 8 IMADs a Goldilocks product."""
    imads = poseidon_products(width) * muls("gl64", GL_Q)
    if entry == "permute":
        return 2 * width * batch * 8, batch * imads
    assert entry == "sponge", entry
    perms = max(-(-length // 4), 1)
    return batch * (length + 4) * 8, batch * perms * imads


def seconds(nbytes: int, imads: int, imad_per_s: float) -> tuple[float, float]:
    """(bytes time, operations time) at the memory rate and ``imad_per_s``."""
    return nbytes / MEM_BYTES_PER_S, imads / imad_per_s


# ----------------------------------------------------------------------
# The mesh's exchange, and bench.py's large-n rows
# ----------------------------------------------------------------------

P60_32768_Q = 576460752308273153  # bench.py:35


# Kernel K6, the four-step's all-to-all (tpu_ntt/sharded.py:580
# _a2a_pallas_leaf; ShardedNtt :691 runs one a transform, so three a
# product: the forwards of a and b, the inverse): csrc/a2a.cu's
# a2a_exchange, D launches an exchange.  Its bound among D logical shards
# of one card, and on four H100s joined all to all by NVLink.
NVLINK_BYTES_PER_S = 450e9  # each way, from a card to the others (H100 SXM data sheet)
A2A_CARDS, A2A_EXCHANGES = 4, 3


def a2a_card_work(n: int, batch: int, shards: int, word: int = 8) -> tuple[int, int]:
    """(bytes, bytes that change shard) of one exchange of ``batch`` rows of
    n ``word``-byte words among ``shards`` logical shards of one card: every
    word is read once and written once (the outputs are new tensors), and
    all but each shard's own block cross to another shard's buffer."""
    total = batch * n * word
    return 2 * total, total - total // shards


def a2a_work(n: int, batch: int, cards: int = A2A_CARDS) -> tuple[int, int]:
    """(bytes one card holds, bytes that leave it) in one tiled all-to-all
    of ``batch`` rows of n int64 words sharded over ``cards`` cards: each
    card keeps 1 / cards of its share and sends the rest."""
    held = batch * n * 8 // cards
    return held, held - held // cards


LARGE_ROWS = (  # (name, n, q, batch): bench.py:34-40, :145, :150; BENCH_NOTES' Goldilocks A/B
    ("p60_32768", 32768, P60_32768_Q, 256),
    ("p60_1048576", 1 << 20, 576460752364240897, 4),
    ("goldilocks_32768", 32768, GL_Q, 256),
    ("goldilocks_1048576", 1 << 20, GL_Q, 4),
)

# Plonky2's CircuitConfig::standard_recursion_config (plonky2/src/plonk/
# circuit_data.rs): 135 wires, rate_bits = 3 (blowup 8), 28 query rounds;
# degree 2^17, so the LDE domain is N = 2^20
STARK_DEGREE, STARK_BLOWUP, STARK_COLS, STARK_QUERIES = 1 << 17, 8, 135, 28


def lde_work(n: int, blowup: int, cols: int) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of ``stark.LdePlan(order="kernel").extend``
    of ``cols`` degree-< n columns to N = blowup * n points: the
    coefficients and the scale table read once and the evaluations written
    once (with the mid table); n scale products a column, then the
    four-step's negacyclic forward (column forward, ``forward_scaled``),
    every product ``gl64``."""
    big = n * blowup
    nbytes, _, imads = fourstep_work("nwc_fwd", big, GL_Q, cols)
    nbytes += cols * n * 8 + n * 8  # the data is n wide in, N wide out
    nbytes -= cols * big * 8
    return nbytes, imads + cols * n * muls("gl64", GL_Q)


def main() -> None:
    imad_per_s = H100_SMS * IMAD_PER_SM_CLOCK * H100_TOP_SM_HZ
    print(f"worked out from the code, not measured: {MEM_BYTES_PER_S:.3e} B/s, "
          f"{imad_per_s:.4e} IMAD/s (H100 SXM data sheet)")
    for name, n, q, batch in LARGE_ROWS:
        for op in ("nwc", "nwc_fwd", "nwc_inv", "cached"):
            nbytes, built, imads = fourstep_work(op, n, q, batch)
            t_bytes, t_ops = seconds(nbytes, imads, imad_per_s)
            by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"{name} {op}, B = {batch}: {nbytes} bytes {t_bytes * 1e3:.4f} ms "
                  f"({built} as built, {built / MEM_BYTES_PER_S * 1e3:.4f} ms), "
                  f"{imads} IMADs {t_ops * 1e3:.4f} ms; bound "
                  f"{max(t_bytes, t_ops) * 1e3:.4f} ms ({by})")
    n, blowup, cols = STARK_DEGREE, STARK_BLOWUP, STARK_COLS
    for what, (nbytes, imads) in (
            (f"STARK LDE, {cols} columns of degree {n} to N = {n * blowup}",
             lde_work(n, blowup, cols)),
            (f"STARK leaf sponge, {n * blowup} rows of {cols}",
             poseidon_work("sponge", 8, n * blowup, cols))):
        t_bytes, t_ops = seconds(nbytes, imads, imad_per_s)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{what}: {nbytes} bytes {t_bytes * 1e3:.4f} ms, {imads} IMADs "
              f"{t_ops * 1e3:.4f} ms; bound {max(t_bytes, t_ops) * 1e3:.4f} ms ({by})")
    name, n, _, batch = LARGE_ROWS[1]
    nbytes, crossing = a2a_card_work(n, batch, A2A_CARDS)
    t_card = nbytes / MEM_BYTES_PER_S
    held, sent = a2a_work(n, batch)
    t = sent / NVLINK_BYTES_PER_S
    print(f"K6, a2a_exchange: one exchange of {name}, B = {batch}, D = {A2A_CARDS}: on one "
          f"card, {A2A_CARDS} logical shards, {nbytes} bytes read and written ({crossing} "
          f"change shard), {t_card * 1e3:.4f} ms; on {A2A_CARDS} H100s over NVLink, "
          f"{held} bytes a card, {sent} leave it, {t * 1e3:.4f} ms at "
          f"{NVLINK_BYTES_PER_S:.3e} B/s each way; {A2A_EXCHANGES} a product, "
          f"{A2A_EXCHANGES * t_card * 1e3:.4f} and {A2A_EXCHANGES * t * 1e3:.4f} ms")


if __name__ == "__main__":
    main()

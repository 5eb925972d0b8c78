"""Exact modular arithmetic on ``torch.int64`` and ``torch.int32`` tensors.

For q < 2^62 above 30 bits a residue is one int64 element in [0, q).
PyTorch has no uint64 arithmetic on the CPU, and int64 ``*`` wraps past 2^63
while ``>>`` is arithmetic, so a wide product is built here from 32-bit words
held in int64 tensors: a ``Words`` pair ``(hi, lo)`` has both words in
[0, 2^32), and every partial product is taken on 16-bit halves so that no
intermediate reaches 2^63.  Shift-outs are masked with ``& _M32``.

For q < 2^30 a residue is one int32 element in [0, q), the counterpart of
the JAX package's one-``uint32``-word format.  int32 ``*`` wraps and torch
has no uint32 multiply, so the single-word primitives (``add_mod32`` ...
``mont_mul32``) widen to int64, where the product of a residue below 2^31
and a word below 2^32 is exact, and narrow the canonical result to int32.

``Ring64`` and ``Ring32`` bind an ``NttParams`` to the element interface the
transforms use (``add``, ``sub``, ``mul``, ``mul_tw``, ``select``,
``encode_tw``), with the same results as ``tpu_ntt.modmath.Ring64`` and
``Ring32`` under SHOUP, MONTGOMERY and BARRETT; ``make_ring`` picks one as
``tpu_ntt.modmath.make_ring`` does.  A Shoup companion ``floor(w * 2^word /
q)`` can pass the signed range of its word, so it is stored as the int64
(int32) with the same bit pattern; the CUDA kernels read it as ``uint64_t``
(``uint32_t``).

The Goldilocks prime q = 2^64 - 2^32 + 1 (``GoldilocksRing``) is above
2^63, so its residues do not fit the signed range of an int64.  Its element
format: a residue is one ``torch.int64`` holding the residue's 64-bit
pattern, so a residue >= 2^63 reads as a negative int64 (the form
``encode64``, ``split64`` and ``convert.pairs_to_int64`` already give).
Tensors stay (B, n), natural order, canonical values in [0, q); the CUDA
kernels read the same bytes as ``uint64_t`` with no conversion.  Pairs of
32-bit words, JAX's format, would double the bytes and give the kernels
nothing.  No Goldilocks value is compared, added or multiplied as a signed
int64: the ring's arithmetic runs on ``split64`` words (``ge64``,
``sub64``, ``mul64_full``) and reduces a 128-bit product by the phi-fold
(2^96 = -1 and 2^64 = 2^32 - 1 mod q: shifts and adds, no multiply), and
``join64`` builds the wrapped pattern without a signed overflow.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .params import NttParams, Reduction

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF

Words = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo), each in [0, 2^32)


# --------------------------------------------------------------------------
# 32-bit word primitives (int64 tensors holding values below 2^32)
# --------------------------------------------------------------------------


def split64(x) -> Words:
    """64-bit pattern -> (hi, lo) words; right for the wrapped int64 of a
    value >= 2^63 too, because the mask drops the sign extension.  Takes a
    tensor or a Python int."""
    return (x >> 32) & _M32, x & _M32


def join64(w: Words) -> torch.Tensor:
    """(hi, lo) -> the int64 with that 64-bit pattern, for any hi < 2^32: a
    value >= 2^63 comes out wrapped (negative).  hi is first made the signed
    word with its bits, so the product by 2^32 cannot overflow."""
    hi = (w[0] ^ 0x80000000) - 0x80000000
    return hi * (1 << 32) + w[1]


def mul32(a, b) -> Words:
    """Exact 32x32 -> 64 multiply from 16-bit halves: every partial product
    and partial sum stays below 2^33."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + (ll >> 16) + (hl & _M16)
    lo = ((mid & _M16) << 16) | (ll & _M16)
    hi = hh + (hl >> 16) + (mid >> 16)
    return hi, lo


def mullo32(a, b):
    """Low 32 bits of a * b for a, b < 2^32 (products stay below 2^49)."""
    return (a * (b & _M16) + (((a * (b >> 16)) & _M16) << 16)) & _M32


def ge64(a: Words, b: Words) -> torch.Tensor:
    return (a[0] > b[0]) | ((a[0] == b[0]) & (a[1] >= b[1]))


def sub64(a: Words, b: Words) -> Words:
    """(a - b) mod 2^64."""
    lo = a[1] - b[1]
    borrow = (lo < 0).to(torch.int64)
    return (a[0] - b[0] - borrow) & _M32, lo & _M32


def select64(pred: torch.Tensor, t: Words, f: Words) -> Words:
    return torch.where(pred, t[0], f[0]), torch.where(pred, t[1], f[1])


def mul64_full(a: Words, b: Words) -> Tuple[torch.Tensor, ...]:
    """Exact 64x64 -> 128: four words (w3, w2, w1, w0), w0 the lowest."""
    a1, a0 = a
    b1, b0 = b
    h00, l00 = mul32(a0, b0)
    h01, l01 = mul32(a0, b1)
    h10, l10 = mul32(a1, b0)
    h11, l11 = mul32(a1, b1)
    s1 = h00 + l01 + l10  # < 3 * 2^32: the int64 holds the carry
    s2 = h01 + h10 + l11 + (s1 >> 32)
    w3 = (h11 + (s2 >> 32)) & _M32
    return w3, s2 & _M32, s1 & _M32, l00


def mul64_lo(a: Words, b: Words) -> Words:
    """Low 64 bits of a * b (the product mod 2^64)."""
    a1, a0 = a
    b1, b0 = b
    h00, l00 = mul32(a0, b0)
    return (h00 + mullo32(a0, b1) + mullo32(a1, b0)) & _M32, l00


def shr128_to_64(w: Tuple[torch.Tensor, ...], s: int) -> Words:
    """(w3:w2:w1:w0) >> s as a word pair, for 0 <= s < 96; the caller
    guarantees the shifted value fits in 64 bits."""
    w3, w2, w1, w0 = w
    zero = torch.zeros_like(w0)
    words = [w0, w1, w2, w3, zero, zero]
    ws, bs = divmod(s, 32)
    if bs == 0:
        return words[ws + 1], words[ws]
    lo = (words[ws] >> bs) | ((words[ws + 1] << (32 - bs)) & _M32)
    hi = (words[ws + 1] >> bs) | ((words[ws + 2] << (32 - bs)) & _M32)
    return hi, lo


# --------------------------------------------------------------------------
# 64-bit modular products on residues
# --------------------------------------------------------------------------


def mont_mul64(a: torch.Tensor, b, q: int, q_prime: int) -> torch.Tensor:
    """REDC(a * b) = a*b*2^-64 mod q for a, b in [0, q), q < 2^62.

    T = a*b; m = (T mod 2^64) * q' mod 2^64; t = (T + m*q) >> 64 < 2q.
    The low 64 bits of T + m*q are 0 mod 2^64, so they carry out exactly
    when T mod 2^64 is nonzero."""
    t3, t2, t1, t0 = mul64_full(split64(a), split64(b))
    m = mul64_lo((t1, t0), split64(q_prime))
    mq3, mq2, _, _ = mul64_full(m, split64(q))
    carry = ((t1 | t0) != 0).to(torch.int64)
    t = ((t3 + mq3) << 32) + t2 + mq2 + carry  # = (T + m*q) >> 64 < 2^63
    return torch.where(t >= q, t - q, t)


def shoup_mul64(a: torch.Tensor, w, w_shoup, q: int) -> torch.Tensor:
    """(a * w) mod q with w constant and w' = floor(w * 2^64 / q).

    r = a*w - floor(a*w' / 2^64)*q, taken mod 2^64, lies in [0, 2q) for
    any a < 2^64 (Shoup); one conditional subtract makes it canonical."""
    aw_words = split64(a)
    t3, t2, _, _ = mul64_full(aw_words, split64(w_shoup))
    aw = mul64_lo(aw_words, split64(w))
    tq = mul64_lo((t3, t2), split64(q))
    r = join64(sub64(aw, tq))
    return torch.where(r >= q, r - q, r)


def barrett_mul64(a: torch.Tensor, b, q: int, k: int, mu: int) -> torch.Tensor:
    """(a * b) mod q via Barrett with k = bitlen(q), mu = floor(2^2k / q).

    q1 = p >> (k-1); q2 = (q1 * mu) >> (k+1); r = p - q2*q < 3q, which can
    pass 2^63, so the two conditional subtracts run on words."""
    prod = mul64_full(split64(a), split64(b))
    q1 = shr128_to_64(prod, k - 1)
    q2 = shr128_to_64(mul64_full(q1, split64(mu)), k + 1)
    r = sub64((prod[2], prod[3]), mul64_lo(q2, split64(q)))
    for m in (2 * q, q):
        mw = split64(m)
        r = select64(ge64(r, mw), sub64(r, mw), r)
    return join64(r)


# --------------------------------------------------------------------------
# Single-word modular products (q < 2^30; int32 residues, int64 inside)
# --------------------------------------------------------------------------


def _wide(x):
    """A residue tensor (or a Python int) as int64, for exact products."""
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else x


def _word(x):
    """A word stored as the int32 with its bits -> its value in [0, 2^32)."""
    return _wide(x) & _M32


def _narrow(r: torch.Tensor, q: int) -> torch.Tensor:
    """One conditional subtract, then the canonical residue as int32."""
    return torch.where(r >= q, r - q, r).to(torch.int32)


def add_mod32(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a + b) mod q for a, b in [0, q), q < 2^30: the sum fits an int32."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod32(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a - b) mod q for a, b in [0, q)."""
    return torch.where(a >= b, a - b, a + q - b)


def barrett_mul32(a, b, q: int, k: int, mu: int) -> torch.Tensor:
    """(a * b) mod q via Barrett with k = bitlen(q) <= 30, mu = floor(2^2k / q).

    q1 = p >> (k-1) < 2^(k+1); q2 = (q1 * mu) >> (k+1), where q1 * mu <
    2^(2k+2) <= 2^62; r = p - q2*q < 3q, so two conditional subtracts."""
    p = _wide(a) * _wide(b)
    q2 = ((p >> (k - 1)) * mu) >> (k + 1)
    r = p - q2 * q
    r = torch.where(r >= 2 * q, r - 2 * q, r)
    return _narrow(r, q)


def shoup_mul32(a, w, w_shoup, q: int) -> torch.Tensor:
    """(a * w) mod q with w constant and w' = floor(w * 2^32 / q).

    r = a*w - floor(a*w' / 2^32)*q lies in [0, 2q) for any a < 2^32
    (Shoup); a*w' < 2^63 for a residue a < 2^31, so int64 holds it."""
    a = _wide(a)
    r = a * _wide(w) - ((a * _word(w_shoup)) >> 32) * q
    return _narrow(r, q)


def mont_mul32(a, b, q: int, q_prime: int) -> torch.Tensor:
    """REDC(a * b) = a*b*2^-32 mod q for a, b in [0, q), q < 2^30.

    T = a*b; m = (T mod 2^32) * q' mod 2^32; t = (T + m*q) >> 32 < 2q,
    with T + m*q < 2^63."""
    t = _wide(a) * _wide(b)
    m = mullo32(t & _M32, q_prime)
    return _narrow((t + m * q) >> 32, q)


# --------------------------------------------------------------------------
# Host encode
# --------------------------------------------------------------------------


def encode64(values: Sequence[int], device=None) -> torch.Tensor:
    """Python ints below 2^64 -> int64 tensor with the same bit patterns
    (``torch.tensor`` itself overflows at 2^63)."""
    arr = np.asarray([int(v) for v in values], dtype=np.uint64).view(np.int64)
    return torch.from_numpy(arr).to(device)


def encode32(values: Sequence[int], device=None) -> torch.Tensor:
    """Python ints below 2^32 -> int32 tensor with the same bit patterns."""
    arr = np.asarray([int(v) for v in values], dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


# --------------------------------------------------------------------------
# Ring abstraction
# --------------------------------------------------------------------------


class Ring64:
    """Z_q with q < 2^62; elements are int64 tensors of residues in [0, q)."""

    def __init__(self, p: NttParams, reduction: Reduction = Reduction.SHOUP):
        if p.q >= 1 << 62:
            raise ValueError(
                f"Ring64 requires q < 2^62, got a {p.width}-bit modulus")
        self.p = p
        self.q = p.q
        if reduction is Reduction.SIMPLE:
            reduction = Reduction.BARRETT
        self.reduction = reduction
        # Montgomery constants for R = 2^64 whatever p.mont_bits says.
        self._q_prime64 = (-pow(self.q, -1, 1 << 64)) % (1 << 64)
        self._r2_mod_q64 = pow(1 << 64, 2, self.q)

    def add(self, a, b):
        s = a + b
        return torch.where(s >= self.q, s - self.q, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(d < 0, d + self.q, d)

    def _barrett(self, a, b):
        return barrett_mul64(a, b, self.q, self.p.barrett_k, self.p.barrett_mu)

    def mul(self, a, b):
        """Variable * variable product in the standard domain."""
        if self.reduction in (Reduction.MONTGOMERY, Reduction.SHOUP):
            # Shoup applies only to constant operands: double REDC here.
            qp = self._q_prime64
            return mont_mul64(mont_mul64(a, b, self.q, qp), self._r2_mod_q64,
                              self.q, qp)
        return self._barrett(a, b)

    def mul_tw(self, a, tw):
        """Product with a twiddle table made by ``encode_tw``."""
        if self.reduction is Reduction.SHOUP:
            return shoup_mul64(a, tw[0], tw[1], self.q)
        if self.reduction is Reduction.MONTGOMERY:
            return mont_mul64(a, tw, self.q, self._q_prime64)
        return self._barrett(a, tw)

    def select(self, pred, t, f):
        return torch.where(pred, t, f)

    def encode_tw(self, values: Sequence[int], device=None):
        """Twiddle encoding: Shoup stores the (w, floor(w * 2^64 / q)) pair;
        Montgomery stores w * 2^64 mod q so that one REDC gives a*w."""
        if self.reduction is Reduction.SHOUP:
            return (encode64(values, device),
                    encode64([(int(v) << 64) // self.q for v in values], device))
        if self.reduction is Reduction.MONTGOMERY:
            values = [(int(v) << 64) % self.q for v in values]
        return encode64(values, device)


class Ring32:
    """Z_q with q < 2^30; elements are int32 tensors of residues in [0, q)."""

    def __init__(self, p: NttParams, reduction: Reduction = Reduction.SHOUP):
        if p.width > 30:
            raise ValueError("Ring32 requires q < 2^30; use Ring64")
        self.p = p
        self.q = p.q
        self.reduction = reduction

    def add(self, a, b):
        return add_mod32(a, b, self.q)

    def sub(self, a, b):
        return sub_mod32(a, b, self.q)

    def _barrett(self, a, b):
        return barrett_mul32(a, b, self.q, self.p.barrett_k, self.p.barrett_mu)

    def mul(self, a, b):
        """Variable * variable product in the standard domain: a double
        REDC under MONTGOMERY, Barrett otherwise (SHOUP included)."""
        if self.reduction is Reduction.MONTGOMERY:
            qp = self.p.mont_q_prime
            return mont_mul32(mont_mul32(a, b, self.q, qp), self.p.mont_r2_mod_q,
                              self.q, qp)
        return self._barrett(a, b)

    def mul_tw(self, a, tw):
        """Product with a twiddle table made by ``encode_tw``."""
        if self.reduction is Reduction.SHOUP:
            return shoup_mul32(a, tw[0], tw[1], self.q)
        if self.reduction is Reduction.MONTGOMERY:
            return mont_mul32(a, tw, self.q, self.p.mont_q_prime)
        return self._barrett(a, tw)

    def select(self, pred, t, f):
        return torch.where(pred, t, f)

    def encode_tw(self, values: Sequence[int], device=None):
        """Twiddle encoding: Shoup stores the (w, floor(w * 2^32 / q)) pair;
        Montgomery stores w * 2^32 mod q so that one REDC gives a*w."""
        if self.reduction is Reduction.SHOUP:
            return (encode32(values, device),
                    encode32([(int(v) << 32) // self.q for v in values], device))
        if self.reduction is Reduction.MONTGOMERY:
            values = [self.p.to_mont(int(v)) for v in values]
        return encode32(values, device)


# --------------------------------------------------------------------------
# The Goldilocks field, q = 2^64 - 2^32 + 1 (wrapped int64 residues)
# --------------------------------------------------------------------------

GOLDILOCKS_Q = (1 << 64) - (1 << 32) + 1
_GL_EPS = _M32  # 2^64 mod q = 2^32 - 1
_GL_Q_WORDS = (_M32, 1)  # q as (hi, lo)


def _add_words(a: Words, b: Words) -> Tuple[Words, torch.Tensor]:
    """a + b mod 2^64 and its carry out (0 or 1)."""
    lo = a[1] + b[1]
    hi = a[0] + b[0] + (lo >> 32)
    return (hi & _M32, lo & _M32), hi >> 32


def _add_small(a: Words, s) -> Words:
    """a + s mod 2^64 for 0 <= s < 2^32."""
    lo = a[1] + s
    return (a[0] + (lo >> 32)) & _M32, lo & _M32


def _sub_small(a: Words, s) -> Words:
    """a - s mod 2^64 for 0 <= s < 2^32 (>> is arithmetic: -1 on a borrow)."""
    lo = a[1] - s
    return (a[0] + (lo >> 32)) & _M32, lo & _M32


def _gl_canonical(t: Words) -> torch.Tensor:
    """[0, 2^64) -> [0, q) with one conditional subtract (2^64 - q < q)."""
    return join64(select64(ge64(t, _GL_Q_WORDS), sub64(t, _GL_Q_WORDS), t))


def goldilocks_reduce128(w3, w2, w1, w0) -> torch.Tensor:
    """A 128-bit value, four 32-bit words with w0 the lowest, mod q.

    The phi-fold of ``tpu_ntt.modmath.goldilocks_reduce128``: with
    2^96 = -1 and 2^64 = 2^32 - 1 (mod q), w3*2^96 + w2*2^64 + c is
    c - w3 + w2*(2^32 - 1).  A borrow of c - w3 wrapped by 2^64 is undone by
    subtracting 2^32 - 1 (2^64 - (2^32 - 1) = q); w2*(2^32 - 1) is
    (w2 << 32) - w2; a carry out of the sum adds 2^32 - 1 back and cannot
    carry again.  One conditional subtract ends it: shifts and adds only."""
    lo = w0 - w3
    hi = w1 + (lo >> 32)
    borrow = (hi >> 32) & 1
    t0 = _sub_small((hi & _M32, lo & _M32), borrow * _GL_EPS)
    t1 = (w2 - (w2 != 0).to(w2.dtype), (-w2) & _M32)  # w2 * (2^32 - 1)
    t, carry = _add_words(t0, t1)
    return _gl_canonical(_add_small(t, carry * _GL_EPS))


def goldilocks_mul(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod q for wrapped-int64 residues (b a tensor or Python int)."""
    return goldilocks_reduce128(*mul64_full(split64(a), split64(b)))


def goldilocks_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod q: the sum of two residues can pass 2^64, whose carry is
    taken as q + (2^32 - 1), so subtracting q mod 2^64 leaves the residue."""
    s, carry = _add_words(split64(a), split64(b))
    over = (carry == 1) | ge64(s, _GL_Q_WORDS)
    return join64(select64(over, sub64(s, _GL_Q_WORDS), s))


def goldilocks_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod q: a - b mod 2^64, plus q (mod 2^64) where b > a."""
    wa, wb = split64(a), split64(b)
    d = sub64(wa, wb)
    return join64(select64(ge64(wa, wb), d, _add_words(d, _GL_Q_WORDS)[0]))


class GoldilocksRing:
    """Z_q for q = 2^64 - 2^32 + 1, the counterpart of
    ``tpu_ntt.modmath.GoldilocksRing``: elements are int64 tensors holding
    the 64-bit patterns of residues in [0, q) (see the module docstring).

    Every product is ``goldilocks_mul`` (the phi-fold); twiddles are plain
    values, with no Shoup companion, since Shoup's bound needs q < 2^63
    (tpu_ntt/kernels/gl64.py:35-37).  ``reduction`` is SIMPLE, as in JAX:
    the ring has one reduction and no choice."""

    def __init__(self, p: NttParams, reduction: Reduction | None = None):
        if p.q != GOLDILOCKS_Q:
            raise ValueError("GoldilocksRing requires q = 2^64 - 2^32 + 1")
        self.p = p
        self.q = p.q
        self.reduction = Reduction.SIMPLE

    add = staticmethod(goldilocks_add)
    sub = staticmethod(goldilocks_sub)
    mul = staticmethod(goldilocks_mul)
    mul_tw = staticmethod(goldilocks_mul)

    def select(self, pred, t, f):
        return torch.where(pred, t, f)

    def encode_tw(self, values: Sequence[int], device=None):
        """Plain values, wrapped into int64."""
        return encode64(values, device)


def make_ring(p: NttParams, reduction: Reduction | None = None):
    """The ring for a parameter set, as ``tpu_ntt.modmath.make_ring`` picks
    it: the Goldilocks prime -> GoldilocksRing, width <= 30 -> Ring32, else
    Ring64; SHOUP unless asked otherwise."""
    if p.q == GOLDILOCKS_Q:
        return GoldilocksRing(p)
    if p.width <= 30:
        return Ring32(p, reduction or Reduction.SHOUP)
    if p.width > 62:
        raise ValueError(
            f"{p.width}-bit modulus exceeds the 62-bit ring and is not the "
            "Goldilocks prime: split it into RNS channels (not ported yet, "
            "ROADMAP.md Q1.10)")
    return Ring64(p, reduction or Reduction.SHOUP)

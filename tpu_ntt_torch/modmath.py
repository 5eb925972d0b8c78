"""Exact 64-bit modular arithmetic on ``torch.int64`` tensors.

A residue is one int64 element in [0, q), which is exact for every q < 2^62
this module serves.  PyTorch has no uint64 arithmetic on the CPU, and int64
``*`` wraps past 2^63 while ``>>`` is arithmetic, so a wide product is built
here from 32-bit words held in int64 tensors: a ``Words`` pair ``(hi, lo)``
has both words in [0, 2^32), and every partial product is taken on 16-bit
halves so that no intermediate reaches 2^63.  Shift-outs are masked with
``& _M32``.

``Ring64`` binds an ``NttParams`` to the element interface the transforms use
(``add``, ``sub``, ``mul``, ``mul_tw``, ``select``, ``encode_tw``), with the
same results as ``tpu_ntt.modmath.Ring64`` under SHOUP, MONTGOMERY and
BARRETT.  The Shoup companion ``floor(w * 2^64 / q)`` can reach 2^64, so it is
stored as the int64 with the same bit pattern; the CUDA kernel reads it as
``uint64_t``.

``Ring32`` and ``GoldilocksRing`` are not ported yet.
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
    """(hi, lo) -> int64, for values below 2^63 (hi < 2^31)."""
    return (w[0] << 32) | w[1]


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
# Host encode
# --------------------------------------------------------------------------


def encode64(values: Sequence[int], device=None) -> torch.Tensor:
    """Python ints below 2^64 -> int64 tensor with the same bit patterns
    (``torch.tensor`` itself overflows at 2^63)."""
    arr = np.asarray([int(v) for v in values], dtype=np.uint64).view(np.int64)
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

"""Pure-Python golden models for the negacyclic product (oracle only).

The same functions as the NWC half of ``tpu_ntt.reference``:

1.  Plain (cyclic) constant-geometry NTT.  Input is bit-reversed, then
    log2(n) stages of CG Cooley-Tukey butterflies
    ``A[i] = a[2i] + w*a[2i+1]``, ``A[i + n/2] = a[2i] - w*a[2i+1]`` with
    ``w = omega_s^(i // k)``, ``k = n >> stage``, ``omega_s = omega^k``.
    The inverse is the same network with omega^-1 plus a final n^-1 scaling.

2.  Negacyclic (NWC) polynomial multiplication via the psi-twist:
    ``a_i <- a_i * psi^i`` before the forward transform, ``c_i <- c_i *
    psi^-i`` after the inverse.

3.  The FIPS-203 (ML-KEM) incomplete NTT, its inverse, the base-case
    product and the product in Z_3329[x]/(x^256 + 1) built from them.

The ML-DSA goldens are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

from .params import NttParams


def bit_reverse(value: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def bit_reverse_permutation(n: int) -> List[int]:
    """perm[i] = bit_reverse(i); an involution, so it is its own inverse.
    Built by doubling (the reversal of 2i and 2i + 1 over one more bit is
    that of i, then that plus n/2), a tenth of a second at n = 2^20."""
    perm = [0]
    while len(perm) < n:
        perm = [2 * r for r in perm] + [2 * r + 1 for r in perm]
    return perm


def cg_ntt(x: Sequence[int], omega: int, q: int) -> List[int]:
    """Plain cyclic NTT, constant-geometry network, natural-order in and out."""
    n = len(x)
    log_n = n.bit_length() - 1
    perm = bit_reverse_permutation(n)
    a = [x[perm[i]] % q for i in range(n)]
    for stage in range(1, log_n + 1):
        k = n >> stage
        omega_s = pow(omega, k, q)
        nxt = [0] * n
        w = 1
        for i in range(n // 2):
            # w == omega_s^(i // k); update incrementally at group boundaries.
            if i and i % k == 0:
                w = w * omega_s % q
            t = w * a[2 * i + 1] % q
            nxt[i] = (a[2 * i] + t) % q
            nxt[i + n // 2] = (a[2 * i] - t) % q
        a = nxt
    return a


def cg_intt(x: Sequence[int], omega: int, q: int) -> List[int]:
    """Inverse cyclic NTT: forward network with omega^-1, then scale by n^-1."""
    n = len(x)
    a = cg_ntt(x, pow(omega, q - 2, q), q)
    n_inv = pow(n, q - 2, q)
    return [v * n_inv % q for v in a]


def cyclic_poly_mult(a: Sequence[int], b: Sequence[int], p: NttParams) -> List[int]:
    """INTT(NTT(a) ⊙ NTT(b))."""
    fa = cg_ntt(a, p.omega, p.q)
    fb = cg_ntt(b, p.omega, p.q)
    prod = [x * y % p.q for x, y in zip(fa, fb)]
    return cg_intt(prod, p.omega, p.q)


def nwc_poly_mult(a: Sequence[int], b: Sequence[int], p: NttParams) -> List[int]:
    """Negacyclic product via psi-twist + cyclic transform."""
    q, n = p.q, p.n
    at = [a[i] * pow(p.psi, i, q) % q for i in range(n)]
    bt = [b[i] * pow(p.psi, i, q) % q for i in range(n)]
    c = cyclic_poly_mult(at, bt, p)
    return [c[i] * pow(p.psi_inv, i, q) % q for i in range(n)]


def schoolbook_negacyclic(a: Sequence[int], b: Sequence[int], q: int) -> List[int]:
    """O(n^2) negacyclic convolution: x^n = -1."""
    n = len(a)
    out = [0] * n
    for i in range(n):
        if a[i] == 0:
            continue
        for j in range(n):
            k = i + j
            term = a[i] * b[j]
            if k < n:
                out[k] = (out[k] + term) % q
            else:
                out[k - n] = (out[k - n] - term) % q
    return out


# ---------------------------------------------------------------------------
# ML-KEM incomplete NTT: the FIPS-203 section 4.3 golden model
# ---------------------------------------------------------------------------
#
# q = 3329 has 2-adicity 8, so no 512th root of unity exists: FIPS 203 maps
# Z_q[x]/(x^256 + 1) onto 128 quadratic slots Z_q[x]/(x^2 - gamma_i),
# gamma_i = zeta^(2*br7(i)+1), zeta = 17 a primitive 256th root, and ends a
# product with a 2x2 base-case multiply per slot.  Algorithms 9-12, plain
# residues in [0, q) throughout.

KYBER_Q = 3329
KYBER_N = 256
KYBER_ZETA = 17  # primitive 256th root of unity mod 3329


def _br7(i: int) -> int:
    return bit_reverse(i, 7)


def kyber_ntt(f: Sequence[int]) -> List[int]:
    """FIPS-203 Algorithm 9: a 7-layer CT network, natural coefficients in,
    the NTT representation out (the order ML-KEM serializes)."""
    q = KYBER_Q
    a = [v % q for v in f]
    assert len(a) == KYBER_N
    k = 1
    length = 128
    while length >= 2:
        for start in range(0, KYBER_N, 2 * length):
            zeta = pow(KYBER_ZETA, _br7(k), q)
            k += 1
            for j in range(start, start + length):
                t = zeta * a[j + length] % q
                a[j + length] = (a[j] - t) % q
                a[j] = (a[j] + t) % q
        length //= 2
    return a


def kyber_intt(fh: Sequence[int]) -> List[int]:
    """FIPS-203 Algorithm 10: a GS network, then the 128^-1 scale."""
    q = KYBER_Q
    a = [v % q for v in fh]
    assert len(a) == KYBER_N
    k = 127
    length = 2
    while length <= 128:
        for start in range(0, KYBER_N, 2 * length):
            zeta = pow(KYBER_ZETA, _br7(k), q)
            k -= 1
            for j in range(start, start + length):
                t = a[j]
                a[j] = (t + a[j + length]) % q
                a[j + length] = zeta * (a[j + length] - t) % q
        length *= 2
    n_half_inv = pow(128, q - 2, q)  # 3303
    return [v * n_half_inv % q for v in a]


def kyber_basemul(ah: Sequence[int], bh: Sequence[int]) -> List[int]:
    """FIPS-203 Algorithms 11-12: the slotwise product in the NTT domain,
    128 products in Z_q[x]/(x^2 - gamma_i)."""
    q = KYBER_Q
    out = [0] * KYBER_N
    for i in range(128):
        gamma = pow(KYBER_ZETA, 2 * _br7(i) + 1, q)
        a0, a1 = ah[2 * i], ah[2 * i + 1]
        b0, b1 = bh[2 * i], bh[2 * i + 1]
        out[2 * i] = (a0 * b0 + a1 * b1 % q * gamma) % q
        out[2 * i + 1] = (a0 * b1 + a1 * b0) % q
    return out


def kyber_poly_mult(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """The negacyclic product in Z_q[x]/(x^256 + 1) through the incomplete
    NTT; equal to schoolbook_negacyclic(a, b, KYBER_Q)."""
    return kyber_intt(kyber_basemul(kyber_ntt(a), kyber_ntt(b)))

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

The ML-KEM and ML-DSA goldens are not ported yet.
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
    """perm[i] = bit_reverse(i); an involution, so it is its own inverse."""
    bits = n.bit_length() - 1
    return [bit_reverse(i, bits) for i in range(n)]


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

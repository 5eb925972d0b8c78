"""Host twiddle tables as Python ints, the same as ``tpu_ntt.tables``.

* forward table[k] = psi^k mod q for k = 0..n-1
* inverse table[k] = psi^(-k) mod q
* per-stage omega powers of the constant-geometry network

The on-device table generators of ``tpu_ntt.tables`` are not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .params import NttParams


def psi_powers(p: NttParams) -> List[int]:
    """Forward twiddle table: psi^k for k = 0..n-1."""
    out, cur = [], 1
    for _ in range(p.n):
        out.append(cur)
        cur = cur * p.psi % p.q
    return out


def psi_inv_powers(p: NttParams) -> List[int]:
    """Inverse twiddle table: psi^-k for k = 0..n-1."""
    out, cur = [], 1
    for _ in range(p.n):
        out.append(cur)
        cur = cur * p.psi_inv % p.q
    return out


def stage_twiddles(n: int, omega: int, q: int) -> np.ndarray:
    """Per-stage butterfly twiddles for the plain CG network, as Python ints.

    Returns an object-dtype array of shape (log2(n), n//2):
    ``tw[s-1][i] = omega^(k * (i // k))`` with ``k = n >> s`` — the factor
    applied to the odd input of butterfly i at stage s.
    """
    log_n = n.bit_length() - 1
    out = np.empty((log_n, n // 2), dtype=object)
    for s in range(1, log_n + 1):
        k = n >> s
        omega_s = pow(omega, k, q)
        w = 1
        for i in range(n // 2):
            if i and i % k == 0:
                w = w * omega_s % q
            out[s - 1, i] = w
    return out

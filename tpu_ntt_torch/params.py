"""Parameter sets and derived constants for NTT negacyclic polynomial multiplication.

A parameter set is ``(n, q, psi)`` with ``q`` prime and ``psi`` a primitive
2n-th root of unity mod q (``psi^(2n) == 1``, ``psi^n == q - 1``).  ``omega =
psi^2`` is the primitive n-th root used by the plain (cyclic) transform.

Pure Python, field for field the same values as ``tpu_ntt.params``
(tests/test_torch_params.py holds the two equal).  The port keeps its own
copy because importing ``tpu_ntt`` imports JAX, which the CUDA machine does
not have.
"""

from __future__ import annotations

import dataclasses
import enum
import functools


class Reduction(enum.Enum):
    """Modular-multiplication backend.

    All backends compute exactly ``(a * b) % q``; the choice only affects the
    instruction sequence, never the result.
    """

    SIMPLE = "simple"  # direct remainder (golden / host path only)
    BARRETT = "barrett"
    MONTGOMERY = "montgomery"
    # Shoup precomputed-quotient multiply for constant (twiddle) operands:
    # w' = floor(w * 2^word / q) stored alongside w; a*w mod q then needs
    # only mulhi(a, w'), two low multiplies and one conditional subtract.
    # Variable*variable products use Montgomery.
    SHOUP = "shoup"


def _is_probable_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all our moduli)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class NttParams:
    """One (n, q, psi) configuration plus every derived constant."""

    n: int
    q: int
    psi: int
    name: str = ""

    def __post_init__(self):
        if self.n & (self.n - 1) or self.n < 2:
            raise ValueError(f"n must be a power of two >= 2, got {self.n}")
        if not _is_probable_prime(self.q):
            raise ValueError(f"q must be prime, got {self.q}")
        if (self.q - 1) % (2 * self.n):
            raise ValueError("q must satisfy q ≡ 1 (mod 2n) for psi to exist")
        if pow(self.psi, self.n, self.q) != self.q - 1:
            raise ValueError("psi is not a primitive 2n-th root of unity: psi^n != -1")

    # --- basic derived values -------------------------------------------------
    @property
    def log_n(self) -> int:
        return self.n.bit_length() - 1

    @property
    def width(self) -> int:
        """Coefficient bit width = ceil(log2 q)."""
        return self.q.bit_length()

    @property
    def omega(self) -> int:
        """Primitive n-th root of unity: omega = psi^2 mod q."""
        return pow(self.psi, 2, self.q)

    @property
    def psi_inv(self) -> int:
        return pow(self.psi, self.q - 2, self.q)

    @property
    def omega_inv(self) -> int:
        return pow(self.omega, self.q - 2, self.q)

    @property
    def n_inv(self) -> int:
        return pow(self.n, self.q - 2, self.q)

    # --- Barrett constants ----------------------------------------------------
    @property
    def barrett_k(self) -> int:
        return self.q.bit_length()

    @property
    def barrett_mu(self) -> int:
        """mu = floor(2^(2k) / q); q1 = p >> (k-1); q2 = (q1*mu) >> (k+1)."""
        return (1 << (2 * self.barrett_k)) // self.q

    # --- Montgomery constants -------------------------------------------------
    @property
    def mont_bits(self) -> int:
        """R = 2^mont_bits, word-aligned: 32 for q < 2^31, else 64."""
        return 32 if self.width <= 31 else 64

    @property
    def mont_r(self) -> int:
        return 1 << self.mont_bits

    @property
    def mont_q_prime(self) -> int:
        """q' = -q^-1 mod R, used by REDC."""
        r = self.mont_r
        return (-pow(self.q, -1, r)) % r

    @property
    def mont_r_mod_q(self) -> int:
        return self.mont_r % self.q

    @property
    def mont_r2_mod_q(self) -> int:
        """R^2 mod q: one REDC multiply by it enters the Montgomery domain."""
        return (self.mont_r * self.mont_r) % self.q

    def to_mont(self, x: int) -> int:
        return (x * self.mont_r) % self.q

    def validate_roots(self) -> None:
        """Full sanity suite for the roots and inverses."""
        assert pow(self.psi, 2 * self.n, self.q) == 1
        assert pow(self.psi, self.n, self.q) == self.q - 1
        assert pow(self.omega, self.n, self.q) == 1
        assert pow(self.omega, self.n // 2, self.q) == self.q - 1
        assert (self.psi * self.psi_inv) % self.q == 1
        assert (self.n * self.n_inv) % self.q == 1


# --- Shipped parameter sets (the same as tpu_ntt.params) ----------------------

#: Dilithium modulus, n=256.
DILITHIUM_256 = NttParams(n=256, q=8380417, psi=1239911, name="dilithium_256")

#: 1024-point, 24-bit modulus.
P24_1024 = NttParams(n=1024, q=8380417, psi=5548360, name="p24_1024")

#: 4096-point, 24-bit modulus.
P24_4096 = NttParams(n=4096, q=8380417, psi=283817, name="p24_4096")

#: 4096-point, 60-bit modulus q = 2^60 - 2^14 + 1: the headline workload.
P60_4096 = NttParams(
    n=4096, q=1152921504606830593, psi=431606828070683274, name="p60_4096"
)

#: 4096-point, Goldilocks prime 2^64 - 2^32 + 1 (width 64).
GOLDILOCKS_4096 = NttParams(
    n=4096, q=(1 << 64) - (1 << 32) + 1, psi=1532612707718625687,
    name="goldilocks_4096"
)

#: Falcon / FN-DSA modulus q = 12289 = 3*2^12 + 1 at both deployed degrees.
FALCON_512 = NttParams(n=512, q=12289, psi=10302, name="falcon_512")
FALCON_1024 = NttParams(n=1024, q=12289, psi=1945, name="falcon_1024")

PRESETS = {p.name: p for p in (DILITHIUM_256, P24_1024, P24_4096, P60_4096,
                               GOLDILOCKS_4096, FALCON_512, FALCON_1024)}


@functools.lru_cache(maxsize=None)
def find_psi(n: int, q: int) -> int:
    """Find the smallest primitive 2n-th root of unity mod q: g^((q-1)/(2n))
    over generator candidates g, with the primitivity check psi^n == -1."""
    if (q - 1) % (2 * n):
        raise ValueError(f"q={q} does not support n={n} (need 2n | q-1)")
    exp = (q - 1) // (2 * n)
    for g in range(2, 10_000):
        psi = pow(g, exp, q)
        if pow(psi, n, q) == q - 1:
            return psi
    raise ValueError("no psi found")


def make_params(n: int, q: int, psi: int | None = None, name: str = "") -> NttParams:
    """Build a parameter set, deriving psi when not given."""
    if psi is None:
        psi = find_psi(n, q)
    return NttParams(n=n, q=q, psi=psi, name=name or f"w{q.bit_length()}_{n}")

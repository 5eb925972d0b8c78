"""ML-KEM (FIPS 203) on the card: every op of ``tpu_ntt.kernels.kyber.KyberPlan``.

The ring is fixed: Z_q[x]/(x^256 + 1), q = 3329, zeta = 17.  q has
2-adicity 8, so the transform is FIPS 203's incomplete one: 128 quadratic
slots Z_q[x]/(x^2 - gamma_i), gamma_i = zeta^(2 br7(i) + 1), and a product
ends with a 2x2 base case per slot.  Residues are (B, 256) ``torch.int32``
in [0, q) (an int64 tensor raises ``TypeError``); coefficients in natural
order, spectra in FIPS-203 serialization order, slot i at 2i and 2i + 1,
byte-compatible with ML-KEM's encoding.

Each op launches its kernel of ``csrc/kyber.cu`` for a CUDA tensor and runs
its plain version, the ``*_plain`` method beside it, for a CPU tensor; any
other device raises.  Nothing falls back.  The plain versions are the JAX
package's XLA path (tpu_ntt/kyber.py:85-115): the even and odd coefficients
of a row transform as two 128-point negacyclic rows with psi = zeta
(``HALF_PARAMS``), through ``ntt.nwc_fwd_merged``/``nwc_inv_merged``, whose
bit-reversed order is the FIPS order; the base case is ``Ring32`` products.
``basemul`` and ``ntt_domain_blocks`` are elementwise and stay plain torch
ops on both devices, as JAX computes them outside any kernel.  ``kyber_dot``
runs a radix-16 core of its own (two passes of Algorithm 9's seven stages,
``PASSES``) and reads the merged tables in that core's per-pass layout
(``mxu64.pass_table``); the other five read the flat tables.

The cacheable spectrum (``spectrum``, the blocks of ``matvec_spectra`` and
``ntt_domain_blocks``) is the FIPS-order spectrum times 2^32 mod q: JAX's
domain, so ``convert.kyber_spectra_from_jax`` only permutes JAX's [e | o]
lane layout.  ``spectrum_to_fips_perm`` is its map to FIPS order, the
identity.  ``matvec_spectra`` returns (k, l, 256), not JAX's (k, l, 128,
256) tiles (``convert.kyber_blocks_from_jax`` undoes them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import ntt
from ..params import NttParams, Reduction
from ..reference import KYBER_N, KYBER_Q, KYBER_ZETA, _br7
from . import _plan
from .mxu64 import pass_table

#: the ring each parity class of a row transforms in: 256 | q - 1 and
#: zeta = 17 is a primitive 256th root, so this is a negacyclic parameter
#: set at n = 128 (tpu_ntt/kyber.py:55-58)
HALF_PARAMS = NttParams(n=128, q=KYBER_Q, psi=KYBER_ZETA, name="mlkem_half")
MAX_TERMS = _plan.MAX_TERMS  # K of the dot, k and l of the matvec (kyber.py:603, :743)
#: the passes of ``kyber_dot``'s radix-16 core, (first stage, stages) in
#: forward order: stages 0-3 from device memory, then 4-6 on each thread's
#: words 16t ... 16t + 15 (csrc/kyber.cu); its tables' per-pass layout
PASSES = ((0, 4), (4, 3))

#: the C entry points of csrc/kyber.cu, each with its own launch count
KERNELS = ("kyber_product", "kyber_cached", "kyber_forward", "kyber_inverse",
           "kyber_dot", "kyber_matvec")


def gamma_table() -> list[int]:
    """gamma_i = zeta^(2 br7(i) + 1), the modulus x^2 - gamma_i of slot i
    (FIPS-203 Algorithm 12)."""
    return [pow(KYBER_ZETA, 2 * _br7(i) + 1, KYBER_Q) for i in range(128)]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load ``csrc/kyber.cu``, its six entry points typed."""
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    return _plan.bind("kyber", {
        "product": [ptr] * 8 + [i32] + [u32] * 4 + [ptr],
        "cached": [ptr] * 8 + [i32] + [u32] * 4 + [ptr],
        "forward": [ptr] * 4 + [i32] + [u32] * 3 + [ptr],
        "inverse": [ptr] * 4 + [i32] + [u32] * 3 + [ptr],
        "dot": [ptr] * 8 + [i32] * 2 + [u32] * 4 + [i32, ptr],
        "matvec": [ptr] * 8 + [i32] * 3 + [u32] * 4 + [ptr],
    })


def _split(x: torch.Tensor) -> torch.Tensor:
    """(..., 256) -> (..., 2, 128): [..., 0, :] the even coefficients."""
    return x.reshape(x.shape[:-1] + (128, 2)).transpose(-1, -2)


def _join(h: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_split``."""
    return h.transpose(-1, -2).reshape(h.shape[:-2] + (KYBER_N,))


class KyberPlan:
    """Every K4 op on one device; the tables live there."""

    name = "cuda-kyber"
    dtype = torch.int32
    #: launches of each kernel in this process, over all plans; a caller that
    #: must show a run went through a kernel zeroes its count first
    launches = dict.fromkeys(KERNELS, 0)

    def __init__(self, device=None):
        """Tables on ``device``: by default the current CUDA device."""
        self.device = ntt.resolve_device(device)
        self.plan = ntt.NttPlan(HALF_PARAMS, Reduction.SHOUP, self.device)
        self.ring = self.plan.ring
        q, r = KYBER_Q, (1 << 32) % KYBER_Q
        self._q_prime = (-pow(q, -1, 1 << 32)) % (1 << 32)
        gammas = gamma_table()
        self._gamma_tw = self.ring.encode_tw(gammas, self.device)
        self._gamma_mont = torch.tensor([g * r % q for g in gammas],
                                        dtype=torch.int32, device=self.device)
        self._r_tw = self.ring.encode_tw([r], self.device)
        self._r_inv_tw = self.ring.encode_tw([pow(r, -1, q)], self.device)
        half_inv = pow(128, -1, q)  # Algorithm 10's 128^-1 = 3303
        # the kernels' scales: the base case of two fresh spectra leaves
        # 2^-32, of a fresh one with a cached one nothing
        self._scale_fresh = self._shoup_pair(half_inv * r % q)
        self._scale_cached = self._shoup_pair(half_inv)
        self._scale_spectrum = self._shoup_pair(r)
        self._scale_one = self._shoup_pair(1)
        # kyber_dot's tables: the forward and inverse ones in the per-pass
        # layout of its radix-16 core, and gamma_i * 2^32; its scales: its
        # base case sums plain products, so 128^-1 after two fresh spectra,
        # 128^-1 2^-32 against a cached one
        self._dot_tables = (*pass_table(self.plan.merged_flat, schedule=PASSES),
                            *pass_table(self.plan.merged_inv_flat, schedule=PASSES),
                            self._gamma_mont)
        self._dot_scales = (self._shoup_pair(half_inv),
                            self._shoup_pair(half_inv * pow(r, -1, q) % q))

    @staticmethod
    def _shoup_pair(w: int) -> tuple[int, int]:
        return w, (w << 32) // KYBER_Q

    @staticmethod
    def spectrum_to_fips_perm() -> np.ndarray:
        """perm such that fips = spectrum[..., perm] / 2^32 mod q: the
        cacheable spectrum is already in FIPS order, so the identity."""
        return np.arange(KYBER_N)

    # ------------------------------------------------------------------
    # Transforms and the base case
    # ------------------------------------------------------------------

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """FIPS-203 Algorithm 9 on (B, 256): natural coefficients in, the
        plain spectrum in serialization order out."""
        self._check(x, "x", 2)
        if _plan.runs_plain(x):
            return self.ntt_plain(x)
        return self._forward(x, self._scale_one)

    def ntt_plain(self, x):
        return _join(ntt.nwc_fwd_merged(self.plan, _split(x)))

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """FIPS-203 Algorithm 10 on (B, 256) plain spectra."""
        self._check(x, "x", 2)
        if _plan.runs_plain(x):
            return self.intt_plain(x)
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        return self._launch("inverse", out, x, out, *self.plan.merged_inv_flat,
                            x.shape[0], KYBER_Q, *self._scale_cached)

    def intt_plain(self, x):
        return _join(ntt.nwc_inv_merged(self.plan, _split(x)))

    def basemul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """FIPS-203 Algorithms 11-12 on (B, 256) plain spectra: elementwise,
        plain torch ops on either device."""
        self._check_like(a, b)
        return self.basemul_plain(a, b)

    def basemul_plain(self, a, b):
        ring = self.ring
        ah, bh = _split(a), _split(b)
        a0, a1, b0, b1 = ah[..., 0, :], ah[..., 1, :], bh[..., 0, :], bh[..., 1, :]
        c0 = ring.add(ring.mul(a0, b0), ring.mul_tw(ring.mul(a1, b1), self._gamma_tw))
        c1 = ring.add(ring.mul(a0, b1), ring.mul(a1, b0))
        return _join(torch.stack([c0, c1], dim=-2))

    # ------------------------------------------------------------------
    # Products
    # ------------------------------------------------------------------

    def poly_mult(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b in Z_q[x]/(x^256 + 1) for (B, 256) coefficients: two
        forwards, 128 base cases and one inverse in one kernel."""
        self._check_like(a, b)
        if _plan.runs_plain(a):
            return self.poly_mult_plain(a, b)
        return self._product("product", a, b, self._scale_fresh)

    def poly_mult_plain(self, a, b):
        return self.intt_plain(self.basemul_plain(self.ntt_plain(a), self.ntt_plain(b)))

    def spectrum(self, x: torch.Tensor) -> torch.Tensor:
        """The cacheable operand spectrum: ``ntt`` times 2^32 mod q."""
        self._check(x, "x", 2)
        if _plan.runs_plain(x):
            return self.spectrum_plain(x)
        return self._forward(x, self._scale_spectrum)

    def spectrum_plain(self, x):
        return self.ring.mul_tw(self.ntt_plain(x), self._r_tw)

    def poly_mult_cached(self, a: torch.Tensor, spectrum: torch.Tensor) -> torch.Tensor:
        """The product of a with the operand whose ``spectrum`` is given:
        one forward instead of two."""
        self._check_like(a, spectrum)
        if _plan.runs_plain(a):
            return self.poly_mult_cached_plain(a, spectrum)
        return self._product("cached", a, spectrum, self._scale_cached)

    def poly_mult_cached_plain(self, a, spectrum):
        return self.intt_plain(self.basemul_plain(self.ntt_plain(a),
                                                  self._plain_spectrum(spectrum)))

    # ------------------------------------------------------------------
    # Dot and matvec
    # ------------------------------------------------------------------

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """INTT(sum_k NTT(a_k) o NTT(b_k)) for (K, B, 256) stacks, 1 <= K
        <= 8: the ML-KEM decryption inner product, one inverse a row."""
        return self._dot(a, b, cached=False)

    def dot_cached(self, a: torch.Tensor, spectra: torch.Tensor) -> torch.Tensor:
        """The dot against a (K, B, 256) stack of ``spectrum`` outputs."""
        return self._dot(a, spectra, cached=True)

    def dot_plain(self, a, b):
        return self.intt_plain(self._slot_sum(self.ntt_plain(a), self.ntt_plain(b)))

    def dot_cached_plain(self, a, spectra):
        return self.intt_plain(self._slot_sum(self.ntt_plain(a),
                                              self._plain_spectrum(spectra)))

    def matvec_spectra(self, A: torch.Tensor) -> torch.Tensor:
        """The cached spectra of a fixed (k, l, 256) coefficient matrix for
        ``matvec``: ``spectrum`` of each entry, (k, l, 256)."""
        self._check(A, "A", 3)
        if _plan.runs_plain(A):
            return self.matvec_spectra_plain(A)
        return self._forward(A, self._scale_spectrum)

    def matvec_spectra_plain(self, A):
        return self.spectrum_plain(A)

    def ntt_domain_blocks(self, A_hat: torch.Tensor) -> torch.Tensor:
        """The ``matvec`` spectra of a (k, l, 256) matrix given as plain
        FIPS-order spectra, as FIPS-203 Algorithm 13 samples A_hat: times
        2^32 mod q, elementwise, plain torch ops on either device."""
        self._check(A_hat, "A_hat", 3)
        return self.ring.mul_tw(A_hat, self._r_tw)

    def matvec(self, s: torch.Tensor, spectra: torch.Tensor) -> torch.Tensor:
        """A o s over R_q: s is (l, B, 256) coefficients, spectra the
        (k, l, 256) ``matvec_spectra`` or ``ntt_domain_blocks`` of A;
        returns (k, B, 256), out[i] = INTT(sum_j A_hat[i, j] o NTT(s[j]))
        (FIPS-203 Algorithms 13-14).  One kernel: l forwards and k inverses
        a row of the batch."""
        self._check(s, "s", 3)
        self._check(spectra, "spectra", 3)
        k, l = spectra.shape[0], spectra.shape[1]
        if s.shape[0] != l:
            raise ValueError(f"s has {s.shape[0]} rows, A has l={l} columns")
        if not (1 <= l <= MAX_TERMS and 1 <= k <= MAX_TERMS):
            raise ValueError(f"matvec supports 1 <= k, l <= 8, got k={k}, l={l}")
        if _plan.runs_plain(s):
            return self.matvec_plain(s, spectra)
        batch = s.shape[1]
        out = s.new_empty((k, batch, KYBER_N))
        if batch == 0:
            return out
        return self._launch("matvec", out, s, spectra, out, *self._tables(),
                            k, l, batch, KYBER_Q, self._q_prime, *self._scale_cached)

    def matvec_plain(self, s, spectra):
        fs = self.ntt_plain(s)
        plain = self._plain_spectrum(spectra)
        return torch.stack([self.intt_plain(self._slot_sum(fs, plain[i].unsqueeze(1)))
                            for i in range(spectra.shape[0])])

    # ------------------------------------------------------------------
    # Checks and launches
    # ------------------------------------------------------------------

    def _plain_spectrum(self, spectrum):
        """A cacheable spectrum back to the plain one: times 2^-32."""
        return self.ring.mul_tw(spectrum, self._r_inv_tw)

    def _slot_sum(self, fa, fb):
        """sum_k of the base cases of fa[k] and fb[k], canonical after each add."""
        c = self.basemul_plain(fa, fb)
        acc = c[0]
        for k in range(1, c.shape[0]):
            acc = self.ring.add(acc, c[k])
        return acc

    def _dot(self, a, b, cached: bool):
        self._check_like(a, b, 3)
        if not 1 <= a.shape[0] <= MAX_TERMS:
            raise ValueError(f"dot supports 1 <= K <= 8 pairs, got {a.shape[0]}")
        if _plan.runs_plain(a):
            return (self.dot_cached_plain if cached else self.dot_plain)(a, b)
        terms, batch = a.shape[0], a.shape[1]
        out = a.new_empty((batch, KYBER_N))
        if batch == 0:
            return out
        return self._launch("dot", out, a, b, out, *self._dot_tables, terms, batch,
                            KYBER_Q, self._q_prime, *self._dot_scales[cached], int(cached))

    def _check(self, t: torch.Tensor, name: str, dims: int) -> None:
        _plan.check(t, name, dims, self.dtype, KYBER_N, self.device)

    def _check_like(self, a: torch.Tensor, b: torch.Tensor, dims: int = 2) -> None:
        self._check(a, "a", dims)
        self._check(b, "b", dims)
        if a.shape != b.shape:
            raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")

    def _tables(self):
        """The flat forward, inverse and gamma tables, in the kernels' order
        (every entry point but the dot's)."""
        return (*self.plan.merged_flat, *self.plan.merged_inv_flat, self._gamma_mont)

    def _product(self, entry, a, b, scale):
        out = torch.empty_like(a)
        if a.shape[0] == 0:
            return out
        return self._launch(entry, out, a, b, out, *self._tables(), a.shape[0],
                            KYBER_Q, self._q_prime, *scale)

    def _forward(self, x, scale):
        out = torch.empty_like(x)
        rows = x.numel() // KYBER_N
        if rows == 0:
            return out
        return self._launch("forward", out, x, out, *self.plan.merged_flat, rows,
                            KYBER_Q, *scale)

    def _launch(self, entry: str, out: torch.Tensor, *args) -> torch.Tensor:
        return _plan.launch("kyber", load(), entry, self.launches, out, *args)

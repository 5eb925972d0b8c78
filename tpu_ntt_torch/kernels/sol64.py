"""Fused negacyclic product for Solinas trinomial moduli q = 2^a - 2^b + 1.

The counterpart of ``tpu_ntt.kernels.sol64.SolinasPlan64``: the headline
60-bit modulus 2^60 - 2^14 + 1 at 256 <= n <= 8192.  On a CUDA tensor
``nwc_poly_mult`` launches the hand-written kernel ``csrc/nwc64.cu``; on a
CPU tensor it runs the plain version, ``ntt.nwc_poly_mult_merged`` over the
same plan, whose integers it matches bit for bit.  Any other device raises.

The CUDA kernel needs only an odd q < 2^62.  ``covers_q`` nevertheless
accepts exactly the moduli the JAX plan accepts, by re-running the bound
checks of its shift-add fold (``tpu_ntt.kernels.sol64._FoldPlan``), so that
dispatch routes the same (n, q) cases here as the JAX policy routes there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import ntt
from ..params import NttParams, Reduction
from . import _build

_BIAS1 = 1 << 27  # the TPU fold's step-1 lane bias
_BIAS2 = 1 << 24  # the TPU fold's step-3 lane bias
MIN_N, MAX_N = 256, 8192  # the kernel's shared-memory rows: 2 n 8 bytes


def solinas_exponents(q: int) -> tuple[int, int] | None:
    """(a, b) with q = 2^a - 2^b + 1, or None if q is not of that form."""
    a = q.bit_length()
    for b in range(1, a):
        if (1 << a) - (1 << b) + 1 == q:
            return a, b
    return None


def _fold_terms(a: int, b: int, e: int) -> list[tuple[int, int]]:
    """2^e mod q as [(exponent, coeff)], all exponents < a, coeffs exact."""
    pend, out = [(e, 1)], {}
    while pend:
        ee, s = pend.pop()
        if ee < a:
            out[ee] = out.get(ee, 0) + s
        else:
            pend.append((ee - a + b, s))
            pend.append((ee - a, -s))
    return [(ee, c) for ee, c in sorted(out.items()) if c]


def _lane_terms(a: int, b: int, e: int) -> list[tuple[int, int]]:
    """2^e folded onto the 16-bit digit grid as (lane, signed coeff)."""
    return [(ee // 16, c * (1 << (ee % 16))) for ee, c in _fold_terms(a, b, e)]


def _lane_bound(n: int) -> int:
    """Worst-case |carry-save lane| of the TPU kernel's 8-digit matmul."""
    rows = max(n // 128, 128)
    d = 8 * rows * 128 * 128
    return d + ((1 << 16) - 256) + d // 256 + 1


def _fold_bounds_hold(a: int, b: int, q: int, lane_max: int) -> bool:
    """True iff ``tpu_ntt.kernels.sol64._FoldPlan(a, b, lane_max, q)``
    builds: each check below is one of its ``raise ValueError`` lines."""
    if not 48 <= a <= 62 or lane_max >= _BIAS1:
        return False
    src = [_lane_terms(a, b, 16 * j) for j in range(4, 8)]
    c8_terms = _lane_terms(a, b, 128)
    if any(dst > 3 or abs(c) >= 1 << 31
           for terms in (*src, c8_terms) for dst, c in terms):
        return False
    c = 0
    for _ in range(8):
        t = lane_max + _BIAS1 + c
        if t >= 1 << 32:
            return False
        c = t >> 16
    c8_max = c
    vmax, vmin = [2 * 65535] * 4, [0] * 4
    for scale, terms in [(65535, t) for t in src] + [(c8_max, c8_terms)]:
        for dst, coeff in terms:
            if coeff > 0:
                vmax[dst] += coeff * scale
            else:
                vmin[dst] += coeff * scale
    bias2 = max(_BIAS2, 1 << (-min(vmin)).bit_length())
    if any(v >= (1 << 31) - bias2 for v in vmax) or any(
            v <= -(1 << 31) for v in vmin):
        return False
    c = 0
    for k in range(4):
        t = vmax[k] + bias2 + c
        if t >= 1 << 32:
            return False
        c = t >> 16
    vtop_max = ((1 << 32) - 1 >> (a - 32)) + (c << (64 - a))
    lazy_max = (1 << a) + vtop_max * ((1 << b) - 1)
    return not (lazy_max >= 2 * q or lazy_max >= 1 << 62 or (
        q < (1 << 61) - (1 << 40) and lazy_max >= 1 << 61))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("nwc64")
    ptr, u64, i32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    lib.nwc64_launch.argtypes = [ptr] * 7 + [i32, i32] + [u64] * 4 + [ptr]
    lib.nwc64_launch.restype = i32
    lib.nwc64_error_string.argtypes = [i32]
    lib.nwc64_error_string.restype = ctypes.c_char_p
    return lib


class SolinasPlan64:
    """Negacyclic product for one trinomial parameter set on one device."""

    name = "cuda-sol64"
    #: launches of the CUDA kernel in this process, over all plans; a caller
    #: that must show a run went through the kernel zeroes it first
    launches = 0

    @staticmethod
    def covers_q(q: int, n: int) -> bool:
        """Cheap predicate, the same as the JAX plan's: q is a trinomial
        whose TPU fold bounds verify at size n."""
        ab = solinas_exponents(q)
        if ab is None or not 30 < q.bit_length() <= 62:
            return False
        return _fold_bounds_hold(ab[0], ab[1], q, _lane_bound(n))

    def __init__(self, p: NttParams, device=None):
        """Tables on ``device``: by default the current CUDA device."""
        if not MIN_N <= p.n <= MAX_N or not self.covers_q(p.q, p.n):
            raise ValueError(
                f"SolinasPlan64 covers trinomial q at {MIN_N} <= n <= {MAX_N}; "
                f"got n={p.n}, q={p.q}")
        device = ntt.resolve_device(device)
        self.p = p
        self.device = device
        self.plan = ntt.NttPlan(p, Reduction.SHOUP, device)
        q = p.q
        self._q_prime = (-pow(q, -1, 1 << 64)) % (1 << 64)
        # undoes the pointwise REDC's 2^-64 and applies the inverse's n^-1
        scale = p.n_inv * (1 << 64) % q
        self._scale = (scale, (scale << 64) // q)

    def nwc_poly_mult_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version of the kernel, on any device."""
        return ntt.nwc_poly_mult_merged(self.plan, a, b)

    def nwc_poly_mult(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b mod (x^n + 1, q) for (B, n) int64 residues in [0, q),
        natural order.  The kernel on CUDA, the plain version on the CPU."""
        self._check(a, b)
        if a.device.type == "cpu":
            return self.nwc_poly_mult_plain(a, b)
        if a.device.type != "cuda":
            raise ValueError(f"no kernel for device {a.device}")
        return self._launch(a, b)

    def _check(self, a: torch.Tensor, b: torch.Tensor) -> None:
        for name, t in (("a", a), ("b", b)):
            if t.dtype != torch.int64:
                raise TypeError(f"{name} must be torch.int64, got {t.dtype}")
            if t.dim() != 2 or t.shape[1] != self.p.n:
                raise ValueError(
                    f"{name} must have shape (B, {self.p.n}), got {tuple(t.shape)}")
            if t.device != self.device:
                raise ValueError(
                    f"{name} is on {t.device}, the plan on {self.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if a.shape != b.shape:
            raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")

    def _launch(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(a)
        if a.shape[0] == 0:
            return out
        lib = _lib()
        tw, tw_s = self.plan.merged_flat
        itw, itw_s = self.plan.merged_inv_flat
        # the shared-memory attribute and the launch apply to the current
        # device; the context restores the caller's afterwards
        with torch.cuda.device(a.device):
            err = lib.nwc64_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), tw.data_ptr(),
                tw_s.data_ptr(), itw.data_ptr(), itw_s.data_ptr(), a.shape[0],
                self.p.log_n, self.p.q, self._q_prime, *self._scale,
                torch.cuda.current_stream(a.device).cuda_stream)
        if err:
            raise RuntimeError(
                f"nwc64 launch failed: {lib.nwc64_error_string(err).decode()}")
        SolinasPlan64.launches += 1
        return out

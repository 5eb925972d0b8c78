"""The 64-bit families above n = 8192: every op through the four-step.

``FourStepPlan64`` serves the twelve ``dispatch.METHODS`` at 30 < width <= 62
and at the Goldilocks prime q = 2^64 - 2^32 + 1, 8192 < n <= 2^20, on (B, n)
``torch.int64`` residues (Goldilocks ones as 64-bit patterns), natural
order: the sizes where JAX runs its flat split-radix kernels (``nwc``,
``nwc_fwd``, ``nwc_inv`` at 2^16 to 2^19 for q < 2^62, every op at 16384
and 32768 for both families) or its kernel-locals four-step
(``tpu_ntt.dispatch._fourstep_backend``, whose sub-plans are
``GoldilocksPlan64`` at the Goldilocks q).  The port runs one path for all
of them, ``sharded.KernelFourStep`` at ``default_split(n)``: the column pass
on the sub-plan's column entry points ``nwc64_forward_cols`` and
``nwc64_inverse_cols`` (``SubPlan64``'s ``*_cols`` methods) or, at the
Goldilocks q, ``gl64_forward_cols`` and ``gl64_inverse_cols``
(``GoldilocksSubPlan64``'s), no transposes, and the row pass on the
sub-plan's ``cyclic_scaled`` and halves (``csrc/nwc64.cu``'s ``nwc64_*``,
``csrc/gl64.cu``'s ``gl64_*``).  The entry points below name the nwc64
ones; the gl64 ones are the same with the prefix ``gl64_``.

* ``nwc`` and ``cyclic``: column forward, the scaled row product, column
  inverse (three launches).
* ``fwd``, ``nwc_fwd``, ``spectrum`` and ``matvec_spectra``: column
  forward, ``nwc64_forward_scaled``; ``inv`` and ``nwc_inv``:
  ``nwc64_inverse_scaled``, column inverse.
* ``cached``, ``dot`` and ``dot_cached``: column forward of every operand in
  one launch, one row kernel (``nwc64_cached_scaled``, ``nwc64_dot_scaled``)
  for the row forwards, the slot products, their sum and the row inverse,
  one column inverse: three launches, as JAX's dot kernel runs the same
  column / mid / row steps inside one kernel at 16384 and 32768.
* ``matvec``: the forward of s (column pass, ``nwc64_forward_scaled``),
  ``nwc64_matvec_scaled`` (the k * l slot products, sums and row
  inverses), one column inverse: l + k transforms, as K1c.

Spectra are in the flat plans' bit-reversed order (``bitrev_to_natural_perm``;
the four-step emits it, see ``sharded``), and a cached spectrum (``nwc_spectrum``)
is in the family's domain: times 2^64 mod q at 30 < width <= 62, as
``MxuPlan64``'s, so the slot product against it is one Montgomery
reduction; plain for Goldilocks, as ``GoldilocksPlan64``'s.  Each family's
row plan scales its own spectra, so the two never meet.  JAX's spectra at
these sizes are in other layouts and, at n >= 65536, in the plain domain:
``convert.large_spectra64_from_jax``.

The ``*_plain`` version of each op runs the same chain on the sub-plans'
plain versions, on any device.  Launches count in the sub-plan family's
dict (``launches``: ``MxuPlan64.launches`` or ``GoldilocksPlan64.launches``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import ntt, reference
from ..params import NttParams
from ..sharded import (KernelFourStep, _run, column_fwd, column_inv, default_split,
                       fourstep_fwd_kernel, fourstep_inv_kernel,
                       fourstep_nwc_poly_mult_kernel)
from ._plan import check
from .mxu64 import MAX_N, MxuPlan64

MAX_FOURSTEP_N = 1 << 20  # bench.py's largest row; larger n waits for device tables


class FourStepPlan64:
    """Every K1 op at 30 < width <= 62 and every K2 op at the Goldilocks q,
    8192 < n <= 2^20, on one device."""

    name = "cuda-fourstep-64"
    dtype = torch.int64
    #: the 60-bit family's launch counts; a Goldilocks plan counts in
    #: ``GoldilocksPlan64.launches`` (its instance's ``launches``)
    launches = MxuPlan64.launches

    @staticmethod
    def covers(n: int, q: int) -> bool:
        """n a power of two in (8192, 2^20], q of 31 to 62 bits or the
        Goldilocks prime, q = 1 mod 2n, and both ``default_split`` factors
        in the sub-plans' window (``KernelFourStep.sub_plan``)."""
        sub = KernelFourStep.sub_plan(q)
        return (MAX_N < n <= MAX_FOURSTEP_N and not n & (n - 1)
                and (q - 1) % (2 * n) == 0
                and all(sub.covers(m, q) for m in default_split(n)))

    def __init__(self, p: NttParams, device=None):
        """Sub-plans on ``device`` (by default the current CUDA device); the
        mid tables are built by the first op that needs them."""
        if not self.covers(p.n, p.q):
            raise ValueError(f"FourStepPlan64 covers 30 < width <= 62 and q = 2^64 - "
                             f"2^32 + 1 at {MAX_N} < n <= {MAX_FOURSTEP_N}; got "
                             f"n={p.n}, a {p.width}-bit q={p.q}")
        self.p = p
        self.device = ntt.resolve_device(device)
        self.fs = KernelFourStep(p, *default_split(p.n), self.device)
        self.launches = type(self.fs.row_k).launches

    # ------------------------------------------------------------------
    # Layout map
    # ------------------------------------------------------------------

    @functools.cached_property
    def _perm(self) -> torch.Tensor:
        return torch.tensor(reference.bit_reverse_permutation(self.p.n))

    def bitrev_to_natural_perm(self) -> np.ndarray:
        """perm such that natural_spectrum = spectrum[..., perm] (an
        involution, so it also maps natural order to the port's)."""
        return self._perm.numpy().copy()

    def bitrev_to_natural(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., self._perm.to(x.device)]

    natural_to_bitrev = bitrev_to_natural

    # ------------------------------------------------------------------
    # The twelve ops, each beside its plain version
    # ------------------------------------------------------------------

    def nwc_poly_mult(self, a, b):
        self._check_like(a, b)
        return self._product(a, b, True, False)

    def nwc_poly_mult_plain(self, a, b):
        return self._product(a, b, True, True)

    def cyclic_poly_mult(self, a, b):
        self._check_like(a, b)
        return self._product(a, b, False, False)

    def cyclic_poly_mult_plain(self, a, b):
        return self._product(a, b, False, True)

    def ntt_fwd(self, x):
        self._check(x, "x", 2)
        return fourstep_fwd_kernel(self.fs, x)

    def ntt_fwd_plain(self, x):
        return fourstep_fwd_kernel(self.fs, x, plain=True)

    def ntt_inv(self, x):
        self._check(x, "x", 2)
        return fourstep_inv_kernel(self.fs, x)

    def ntt_inv_plain(self, x):
        return fourstep_inv_kernel(self.fs, x, plain=True)

    def nwc_ntt_fwd(self, x):
        self._check(x, "x", 2)
        return self._fwd(x, False, False)

    def nwc_ntt_fwd_plain(self, x):
        return self._fwd(x, False, True)

    def nwc_ntt_inv(self, x):
        self._check(x, "x", 2)
        return self._inv(x, False)

    def nwc_ntt_inv_plain(self, x):
        return self._inv(x, True)

    def nwc_spectrum(self, x):
        self._check(x, "x", 2)
        return self._fwd(x, True, False)

    def nwc_spectrum_plain(self, x):
        return self._fwd(x, True, True)

    def nwc_poly_mult_cached(self, a, spectrum):
        self._check_like(a, spectrum)
        return self._cached(a, spectrum, False)

    def nwc_poly_mult_cached_plain(self, a, spectrum):
        return self._cached(a, spectrum, True)

    def nwc_dot(self, a, b):
        """sum_k a_k * b_k mod (x^n + 1, q) for (K, B, n) stacks: the column
        forwards of both operands in one launch, one row kernel, B column
        inverses."""
        self._check_like(a, b, 3)
        return self._dot(a, b, False, False)

    def nwc_dot_plain(self, a, b):
        return self._dot(a, b, False, True)

    def nwc_dot_cached(self, a, spectra):
        """The dot against a (K, B, n) stack of ``nwc_spectrum`` outputs."""
        self._check_like(a, spectra, 3)
        return self._dot(a, spectra, True, False)

    def nwc_dot_cached_plain(self, a, spectra):
        return self._dot(a, spectra, True, True)

    def nwc_matvec_spectra(self, A):
        self._check(A, "A", 3)
        return self._fwd(A, True, False)

    def nwc_matvec_spectra_plain(self, A):
        return self._fwd(A, True, True)

    def nwc_matvec_cached(self, s, spectra):
        """A @ s: s (l, B, n), spectra the (k, l, n) ``nwc_matvec_spectra``
        of A; (k, B, n) out.  l * B forwards, then one row kernel for the
        k * l slot products, the sums and the row inverses, and k * B column
        inverses."""
        self._check(s, "s", 3)
        self._check(spectra, "spectra", 3)
        if s.shape[0] != spectra.shape[1]:
            raise ValueError(f"s has {s.shape[0]} rows, A has l={spectra.shape[1]} columns")
        if 0 in spectra.shape[:2]:
            raise ValueError(f"A must have k, l >= 1, got {tuple(spectra.shape[:2])}")
        return self._matvec(s, spectra, False)

    def nwc_matvec_cached_plain(self, s, spectra):
        return self._matvec(s, spectra, True)

    # ------------------------------------------------------------------
    # The chains
    # ------------------------------------------------------------------

    def _product(self, a, b, nwc, plain):
        return fourstep_nwc_poly_mult_kernel(self.fs, a, b, nwc, plain)

    def _fwd(self, x, cacheable, plain):
        """The negacyclic forward of (..., n) rows in one launch each pass."""
        flat = x.reshape(x.numel() // self.p.n, self.p.n)
        return fourstep_fwd_kernel(self.fs, flat, True, cacheable, plain).reshape(x.shape)

    def _inv(self, x, plain):
        flat = x.reshape(x.numel() // self.p.n, self.p.n)
        return fourstep_inv_kernel(self.fs, flat, True, plain).reshape(x.shape)

    def _cached(self, a, spectrum, plain):
        fs = self.fs
        c = _run(fs.row_k, "cyclic_poly_mult_cached_scaled", plain,
                 column_fwd(fs, True, plain, a), fs.as_rows(spectrum), fs.kmid_nwc,
                 fs.kmid_inv_nwc)
        return column_inv(fs, c, True, plain).reshape(a.shape)

    def _dot(self, a, b, cached, plain):
        fs, terms, rows = self.fs, a.shape[0], a.shape[1] * self.fs.n1
        flat = [t.reshape(-1, self.p.n) for t in ((a,) if cached else (a, b))]
        m = column_fwd(fs, True, plain, *flat).reshape(len(flat), terms, rows, fs.n2)
        mb = b.reshape(terms, rows, fs.n2) if cached else m[1]
        c = _run(fs.row_k, "dot_scaled", plain, m[0], mb, fs.kmid_nwc, fs.kmid_inv_nwc,
                 cached)
        return column_inv(fs, c, True, plain).reshape(a.shape[1:])

    def _matvec(self, s, spectra, plain):
        fs, (k, l), rows = self.fs, spectra.shape[:2], s.shape[1] * self.fs.n1
        fs_rows = self._fwd(s, False, plain).reshape(l, rows, fs.n2)
        c = _run(fs.row_k, "matvec_scaled", plain, fs_rows,
                 spectra.reshape(k, l, fs.n1, fs.n2), fs.kmid_inv_nwc)
        return column_inv(fs, c.reshape(k * rows, fs.n2), True,
                          plain).reshape(k, *s.shape[1:])

    # ------------------------------------------------------------------
    # Checks
    # ------------------------------------------------------------------

    def _check(self, t: torch.Tensor, name: str, dims: int) -> None:
        check(t, name, dims, self.dtype, self.p.n, self.device)

    def _check_like(self, a: torch.Tensor, b: torch.Tensor, dims: int = 2) -> None:
        self._check(a, "a", dims)
        self._check(b, "b", dims)
        if a.shape != b.shape:
            raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
        if dims == 3 and a.shape[0] < 1:
            raise ValueError("the dot needs K >= 1 terms")

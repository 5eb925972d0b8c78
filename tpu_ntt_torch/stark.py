"""STARK-prover polynomial ops in PyTorch: coset LDE and FRI.

The counterpart of ``tpu_ntt.stark``.  ``LdePlan`` extends degree-< n
coefficient rows to blowup * n evaluations over the coset shift * H_N:

    y_j = sum_i c_i (g w_N^j)^i = CyclicNTT_N(c_i * g^i, zero-padded)

in three orders, as in JAX: ``bitrev`` and ``natural`` run the plain
``ntt.NttPlan`` (``big``) and give JAX's integers slot for slot;
``kernel`` runs the kernel plan's negacyclic forward, whose evaluation
points are the coset psi * H_N, so the shift folds into the scale table as
(shift * psi^-1)^i (tpu_ntt/stark.py:64-73).  For Goldilocks on a CUDA
tensor that is ``gl64_forward`` of ``kernels/csrc/gl64.cu`` up to
N = 8192, and above, up to N = 2^20 (Plonky2's degree 2^17 at blowup 8),
the four-step of ``kernels.fourstep64.FourStepPlan64``
(``gl64_forward_cols`` down the columns of the natural rows, no transposes,
``gl64_forward_scaled`` along the rows), whose
``nwc_ntt_fwd`` is the same evaluation over psi * H_N.  The kernel order's
slots are the port's own layout (``bitrev_to_natural_perm``, bit-reversed
at every N), not the TPU's four-step one, so its raw slots differ from
JAX's and agree with it only through ``spectrum_indices``; ``reorder``
moves between orders.  The kernel order never builds ``big`` (about 40 s
of host tables at N = 2^20): ``reorder`` reads only layouts, and the N
unscale powers of ``interpolate`` are built on its first call.

FRI: ``fri_fold`` folds a bit-reversed codeword over the squared domain in
plain torch over the plan's ring (JAX does it in XLA, with no kernel);
``FriProver`` commits each layer with ``poseidon.Poseidon2GL`` (the sponge
of each value pair, kernel K5b, and a Merkle tree, kernel K5a) and answers
Fiat-Shamir queries derived on the host through ``PoseidonRef``; the
layers and trees stay on the device, and each layer's openings cross to
the host in one copy.  ``fri_verify`` is the JAX package's big-int
verifier, copied with every check.  The card path is
``LdePlan(order="kernel").extend`` -> ``reorder`` to a ``bitrev`` plan ->
``FriProver(bitrev plan).prove``, as in tests/test_stark.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels, ntt, reference
from .modmath import GOLDILOCKS_Q, encode32, encode64, make_ring
from .ntt import NttPlan
from .params import make_params
from .poseidon import Poseidon2GL, PoseidonRef, digest_ints, merkle_levels

_M64 = (1 << 64) - 1


class LdePlan:
    """Reusable coset-LDE plan: degree-< n inputs, N = blowup * n output
    evaluations over shift * H_N, tables on ``device`` (by default the
    current CUDA device).  Requires 2N | q - 1."""

    def __init__(self, n: int, q: int, blowup: int, shift: int = 7,
                 order: str = "bitrev", device=None):
        if blowup < 1 or blowup & (blowup - 1):
            raise ValueError("blowup must be a power of two >= 1")
        if order not in ("bitrev", "natural", "kernel"):
            raise ValueError("order must be 'bitrev', 'natural' or 'kernel'")
        if shift % q == 0:
            raise ValueError("coset shift must be a unit")
        self.n = n
        self.blowup = blowup
        self.N = blowup * n
        self.order = order
        self.shift = shift % q
        self.p = make_params(self.N, q)
        self.ring = make_ring(self.p)
        self.device = ntt.resolve_device(device)
        base = self.shift
        if order == "kernel":
            self._kernel = kernels.plan_for(self.p, self.device)
            if self._kernel is None:
                raise ValueError(
                    f"order='kernel' needs a kernel plan for (n={self.N}, q={q}); "
                    "none covers it")
            perm = self._kernel.bitrev_to_natural_perm()
            self._kernel_layout = np.argsort(perm).astype(np.int64)
            base = self.shift * pow(self.p.psi, -1, q) % q
        self.scale_tw = self.ring.encode_tw([pow(base, i, q) for i in range(n)],
                                            self.device)
        self._perms: dict[str, torch.Tensor] = {}

    @functools.cached_property
    def big(self) -> NttPlan:
        """The plain plan over N points, built on first use: only the
        ``bitrev`` and ``natural`` orders transform through it."""
        return NttPlan(self.p, device=self.device)

    def extend(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients (..., n) -> coset evaluations (..., N)."""
        padded = self.scale_and_pad(x)
        if self.order == "kernel":
            flat = padded.reshape(-1, self.N)
            return self._kernel.nwc_ntt_fwd(flat).reshape(padded.shape)
        if self.order == "bitrev":
            return ntt.ntt_fwd_bitrev(self.big, padded)
        return ntt.ntt_fwd(self.big, padded)

    def extend_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain version of ``extend`` in the kernel order: the same
        scale and pad, then the kernel plan's plain forward, on any
        device (what chip_smoke.py holds the kernels to)."""
        if self.order != "kernel":
            raise ValueError("extend_plain is the kernel order's plain chain")
        padded = self.scale_and_pad(x)
        flat = padded.reshape(-1, self.N)
        return self._kernel.nwc_ntt_fwd_plain(flat).reshape(padded.shape)

    def scale_and_pad(self, x: torch.Tensor) -> torch.Tensor:
        """What ``extend`` runs before its transform, in torch ops (JAX's are
        XLA): x times the coset scale table, zero-padded from n to N."""
        scaled = self.ring.mul_tw(x, self.scale_tw)
        return torch.cat(
            [scaled, scaled.new_zeros(scaled.shape[:-1] + (self.N - self.n,))], dim=-1)

    def interpolate(self, evals: torch.Tensor) -> torch.Tensor:
        """Coset evaluations (..., N) in this plan's order -> the N
        coefficients of the interpolating polynomial (c_i = shift^-i *
        INTT(y)_i); a degree-< n input comes back with its top N - n zero."""
        if self.order == "kernel":
            c = self._kernel.nwc_ntt_inv(evals.reshape(-1, self.N)).reshape(evals.shape)
        elif self.order == "bitrev":
            c = ntt.ntt_inv_bitrev(self.big, evals)
        else:
            c = ntt.ntt_inv(self.big, evals)
        return self.ring.mul_tw(c, self._unscale_tw)

    @functools.cached_property
    def _unscale_tw(self):
        q = self.p.q
        inv_s = pow(self.shift, -1, q)
        if self.order == "kernel":  # undo the folded (shift * psi^-1)^i
            inv_s = inv_s * self.p.psi % q
        return self.ring.encode_tw([pow(inv_s, i, q) for i in range(self.N)],
                                   self.device)

    def reorder(self, evals: torch.Tensor, to: "LdePlan") -> torch.Tensor:
        """This plan's output layout -> ``to``'s (one gather): out[t] = in[s]
        where both slots hold the same domain point."""
        if (self.N, self.p.q, self.shift) != (to.N, to.p.q, to.shift):
            raise ValueError("reorder needs plans over the same domain")
        if to.order not in self._perms:
            pos = np.argsort(self.spectrum_indices())
            self._perms[to.order] = torch.from_numpy(pos[to.spectrum_indices()])
        return evals[..., self._perms[to.order].to(evals.device)]

    # -- host IO --------------------------------------------------------------

    def encode(self, coeffs) -> torch.Tensor:
        """Python ints in [0, q) -> a tensor of the ring's dtype on the
        plan's device (int32 below 2^31, else int64 bit patterns)."""
        arr = np.asarray(coeffs, dtype=object)
        values = [int(v) for v in arr.reshape(-1)]
        enc = encode32 if self.p.width <= 30 else encode64
        return enc(values, self.device).reshape(arr.shape)

    def decode(self, evals: torch.Tensor) -> np.ndarray:
        """A residue tensor -> an object array of Python ints."""
        x = evals.detach().cpu().numpy()
        if x.dtype == np.int64:
            x = x.view(np.uint64)
        return x.astype(object)

    def spectrum_indices(self) -> np.ndarray:
        """Which domain point each output slot holds: slot t carries the
        evaluation at shift * w^idx[t]."""
        if self.order == "natural":
            return np.arange(self.N, dtype=np.int64)
        if self.order == "kernel":
            return self._kernel_layout
        return np.asarray(reference.bit_reverse_permutation(self.N), dtype=np.int64)


# ---------------------------------------------------------------------------
# FRI low-degree proofs (commit phase on the device, verifier independent)
# ---------------------------------------------------------------------------
#
# In bit-reversed evaluation order f(x) and f(-x) sit in adjacent slots, so
# a fold
#
#     f'(x^2) = (f(x) + f(-x))/2 + beta * (f(x) - f(-x))/(2x)
#
# is a pairwise reduction with a precomputed 1/(2x) table, and its output is
# bit-reversed over the squared half-size domain.


def _bitrev_index(i: int, bits: int) -> int:
    return int(f"{i:0{bits}b}"[::-1], 2) if bits else 0


def _fri_domains(lde: LdePlan, final_size: int) -> list[tuple[int, int, int]]:
    """(g_l, w_l, size) of each layer's coset, the final one last."""
    q = lde.p.q
    size, g, w = lde.N, lde.shift, lde.p.omega
    domains = []
    while size > final_size:
        domains.append((g, w, size))
        size, g, w = size // 2, g * g % q, w * w % q
    domains.append((g, w, size))
    return domains


def fri_fold_tables(lde: LdePlan, final_size: int):
    """Per-layer twiddle tables u_i = 1/(2 * g_l * w_l^{br(i)}) in the
    bit-reversed output order (encoded for the plan ring's ``mul_tw``, on
    its device), plus the (g_l, w_l, size) layer domains for the verifier."""
    q = lde.p.q
    half = pow(2, -1, q)
    domains = _fri_domains(lde, final_size)
    tables = []
    for g, w, size in domains[:-1]:
        m = size // 2
        inv_w = pow(w, -1, q)
        nat, acc = [], half * pow(g, -1, q) % q
        for _ in range(m):
            nat.append(acc)
            acc = acc * inv_w % q
        tables.append(lde.ring.encode_tw(
            [nat[j] for j in reference.bit_reverse_permutation(m)], lde.device))
    return tables, domains


def fri_fold(lde: LdePlan, values: torch.Tensor, beta: int, table) -> torch.Tensor:
    """One fold layer: (..., 2m) bit-reversed values -> (..., m) over the
    squared domain (still bit-reversed); beta is the host-side Fiat-Shamir
    challenge."""
    ring, q = lde.ring, lde.p.q
    a, b = values[..., 0::2], values[..., 1::2]
    half_tw = ring.encode_tw([pow(2, -1, q)], values.device)
    beta_tw = ring.encode_tw([beta % q], values.device)
    return ring.add(ring.mul_tw(ring.add(a, b), half_tw),
                    ring.mul_tw(ring.mul_tw(ring.sub(a, b), table), beta_tw))


class FriProver:
    """FRI commit and query phases over a Goldilocks LDE codeword.

    ``prove(values)`` takes the bit-reversed codeword, an (N,) int64 tensor,
    runs the fold and commit cascade on its device and returns the host
    proof dict of ``tpu_ntt.stark.FriProver.prove``: layer Merkle roots,
    the final codeword and ``num_queries`` authenticated query paths, the
    challenges and query positions Fiat-Shamir-derived from the roots
    through ``PoseidonRef``."""

    def __init__(self, lde: LdePlan, final_size: int = 8,
                 num_queries: int = 16, hasher: Poseidon2GL | None = None):
        if lde.p.q != GOLDILOCKS_Q:
            raise ValueError("FRI prove/verify is defined over the "
                             "Goldilocks field (fold alone is ring-generic)")
        if lde.order != "bitrev":
            raise ValueError("FRI consumes the bit-reversed LDE order")
        if final_size < 2 * lde.blowup or final_size & (final_size - 1):
            raise ValueError("final_size must be a power of two >= "
                             "2*blowup (so the degree check is nontrivial)")
        self.lde = lde
        self.final_size = final_size
        self.num_queries = num_queries
        self.hasher = hasher or Poseidon2GL()
        self.tables, self.domains = fri_fold_tables(lde, final_size)

    def _absorb(self, state, elems):
        padded = (list(elems) + [0, 0, 0, 0])[:4]
        return self.hasher.ref.permute(list(state) + padded)[:4]

    def prove(self, values: torch.Tensor) -> dict:
        """Layer codewords and Merkle levels stay on the device; the host
        sees each root, the final codeword and one gather a layer."""
        v = values
        roots, layers = [], []
        transcript = [0, 0, 0, 0]
        for table in self.tables:
            digests = self.hasher.hash_rows(torch.stack([v[0::2], v[1::2]], dim=-1))
            levels = merkle_levels(self.hasher, digests)
            root = digest_ints(levels[-1])
            roots.append(root)
            layers.append((v, levels))
            transcript = self._absorb(transcript, root)
            v = fri_fold(self.lde, v, transcript[0], table)
        final = [x & _M64 for x in v.tolist()]
        # absorb the whole final codeword, so that every element is bound
        # by the query-position challenges
        for off in range(0, len(final), 4):
            transcript = self._absorb(transcript, final[off:off + 4])
        n0 = self.domains[0][2]
        idx0 = [self._absorb(transcript, [qi + 1, 0, 0, 0])[0] & (n0 - 1)
                for qi in range(self.num_queries)]
        opened = [_gather_layer(vals, levels, [i >> li for i in idx0])
                  for li, (vals, levels) in enumerate(layers)]
        queries = []
        for qi in range(self.num_queries):
            chain = []
            for rows in opened:
                path = [[rows[2 + 4 * lvl + k][qi] for k in range(4)]
                        for lvl in range((len(rows) - 2) // 4)]
                chain.append({"pair": (rows[0][qi], rows[1][qi]), "path": path})
            queries.append(chain)
        return {"roots": roots, "final": final, "queries": queries,
                "n0": n0, "blowup": self.lde.blowup,
                "final_size": self.final_size,
                "num_queries": self.num_queries}


def _gather_layer(vals: torch.Tensor, levels, idxs: list[int]) -> list[list[int]]:
    """The openings of one layer in one device-to-host copy: rows 0 and 1
    are the queried pairs' even and odd values, then four rows (one a
    digest lane) for each sibling along each Merkle path, leaf-adjacent
    first; column i is query i."""
    idx = torch.tensor(idxs, dtype=torch.int64, device=vals.device)
    rows = [vals[idx & ~1], vals[idx | 1]]
    node = idx >> 1
    for lvl in levels[:-1]:
        sib = node ^ 1
        rows.extend(d[sib] for d in lvl)
        node = node >> 1
    return [[v & _M64 for v in row] for row in torch.stack(rows).tolist()]


def fri_verify(lde: LdePlan, proof: dict, final_size: int = 8,
               num_queries: int = 16) -> bool:
    """Independent verifier: big-int folds and ``PoseidonRef`` hashing only
    (no device code), a copy of ``tpu_ntt.stark.fri_verify``.  Checks every
    Merkle path, the fold consistency of every query chain, and that the
    final codeword interpolates to degree < final_size / blowup on its
    coset.  Every soundness-critical parameter comes from the verifier's
    side (the domain and blowup from ``lde``, the final size and query
    count from the arguments), and the fold schedule is re-derived here and
    enforced against the proof's structure before any hashing."""
    q = lde.p.q
    ref = PoseidonRef()

    def absorb(state, elems):
        padded = (list(elems) + [0, 0, 0, 0])[:4]
        return ref.permute(list(state) + padded)[:4]

    if final_size < 2 * lde.blowup or final_size & (final_size - 1):
        raise ValueError("final_size must be a power of two >= 2*blowup")
    domains = _fri_domains(lde, final_size)
    n_layers = len(domains) - 1
    # structural schedule checks (verifier-derived, not proof-claimed)
    if len(proof["roots"]) != n_layers:
        return False
    if len(proof["queries"]) != num_queries:
        return False
    final = proof["final"]
    m = domains[-1][2]
    if len(final) != m or m != final_size:
        return False
    n0 = domains[0][2]  # == lde.N by construction
    for layers in proof["queries"]:
        if len(layers) != n_layers:
            return False
        for li, layer in enumerate(layers):
            # layer li has size/2 committed pairs -> path of log2 length
            size = domains[li][2]
            if len(layer["path"]) != (size // 2).bit_length() - 1:
                return False
    transcript = [0, 0, 0, 0]
    betas = []
    for root in proof["roots"]:
        transcript = absorb(transcript, root)
        betas.append(transcript[0])

    for off in range(0, len(final), 4):
        transcript = absorb(transcript, final[off:off + 4])

    # the final codeword must be a degree < final_size/blowup polynomial on
    # its coset: inverse-NTT the (bit-reversed) values and check that the
    # top coefficients vanish; blowup comes from the verifier's lde
    g_f, w_f, _ = domains[-1]
    bits = m.bit_length() - 1
    nat = [0] * m
    for i, val in enumerate(final):
        nat[_bitrev_index(i, bits)] = val
    n_inv = pow(m, -1, q)
    coeffs = []
    w_inv = pow(w_f, -1, q)
    for k in range(m):
        acc, wk, step = 0, 1, pow(w_inv, k, q)
        for j in range(m):
            acc = (acc + nat[j] * wk) % q
            wk = wk * step % q
        coeffs.append(acc * n_inv % q * pow(g_f, -(k) % (q - 1), q) % q)
    if any(c for c in coeffs[m // lde.blowup:]):
        return False

    half = pow(2, -1, q)
    for qi, layers in enumerate(proof["queries"]):
        seed = absorb(transcript, [qi + 1, 0, 0, 0])
        idx = seed[0] & (n0 - 1)
        prev_fold = None
        for li, layer in enumerate(layers):
            a, b = layer["pair"]
            if prev_fold is not None and prev_fold != (b if idx & 1 else a):
                return False
            # Merkle path to the layer root
            node = idx >> 1
            dig = ref.hash_elements([a, b])
            for sib in layer["path"]:
                if node & 1:
                    dig = ref.compress(sib, dig)
                else:
                    dig = ref.compress(dig, sib)
                node >>= 1
            if dig != proof["roots"][li]:
                return False
            # fold to the next layer
            g_l, w_l, size = domains[li]
            mbits = (size // 2).bit_length() - 1
            e = _bitrev_index(idx >> 1, mbits)
            inv_x = pow(g_l * pow(w_l, e, q) % q, -1, q)
            prev_fold = (half * (a + b)
                         + betas[li] * half % q * inv_x % q * (a - b)) % q
            idx >>= 1
        if prev_fold != final[idx]:
            return False
    return True

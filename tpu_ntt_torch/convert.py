"""Bridge between the JAX package's element layout and the port's.

``tpu_ntt`` holds a 64-bit residue as a (hi, lo) pair of uint32 arrays
(``tpu_ntt.dispatch`` splits a (B, n) uint64 array that way); the port holds
one (B, n) ``torch.int64`` tensor.  Below 2^31 both hold one word: uint32
there, ``torch.int32`` here.  These functions take numpy arrays only, so
they import no JAX: a test hands them what the JAX package returned.

State a user keeps crosses too: the kernels' cached spectra (24-bit
``tpu_ntt.kernels.mxu.MxuPlan.nwc_spectrum``, times 2^32 mod q; 60-bit
``MxuPlan64``/``SolinasPlan64.nwc_spectrum``, (hi, lo) pairs times 2^64 mod
q; Goldilocks ``GoldilocksPlan64.nwc_spectrum``, (hi, lo) pairs in the plain
domain; all in four-step layout) and their ``nwc_matvec_spectra`` blocks
tiled over an MXU group become the port's (the same domain, bit-reversed
order; see ``kernels/_plan.py``), so a key or public matrix transformed once
by the JAX package gives the same products in the port.  A Goldilocks
residue >= 2^63 becomes the wrapped int64 with its bits (``pairs_to_int64``)
and goes back unchanged (``int64_to_pairs``): these two are the port's
counterparts of ``tpu_ntt.poseidon``'s ``to_pairs`` and ``from_pairs``.  The same holds for
ML-KEM's cacheable spectra and matvec blocks (``kyber_spectra_from_jax``,
``kyber_blocks_from_jax``).

Above n = 8192 (``kernels.fourstep64.FourStepPlan64``) JAX has two more
layouts, and the port's spectra stay bit-reversed, so
``large_spectra64_from_jax`` takes the JAX layout's map:
``kernel_fourstep_to_natural_perm`` for its kernel four-step at
n >= 65536 (spectrum, cached, dot_cached, matvec_spectra/matvec, fwd/inv),
``split_to_natural_perm`` for its flat plan at n <= 2^19 (every op at 16384
and 32768, nwc_fwd/nwc_inv above).  The four-step's spectra are in the
plain domain (its row ``ntt_fwd``), the flat plan's cached ones in the
Montgomery-64 domain, as the port's cached spectra are at every n.  The
Goldilocks prime takes the same two maps (JAX's ``GoldilocksPlan64`` at
16384 and 32768 inherits the split layout of ``MxuPlan64``, and its kernel
four-step serves every op from 65536 on) with ``q=None``: both packages'
Goldilocks spectra, cached ones too, are plain, so only the order changes.

A sharded JAX array (``tpu_ntt.sharded``'s ``shard_batch`` or
``ShardedNtt.put_natural`` and its ops' outputs) becomes the port's
``sharded.ShardedTensor`` through ``shards_from_jax``: the same mesh shape,
axis names and spec, one shard a mesh position.
"""

from __future__ import annotations

import numpy as np
import torch

from .modmath import shoup_mul64
from .reference import bit_reverse_permutation
from .sharded import ShardedTensor, default_split, make_mesh

LANES = 128  # the TPU kernel's lane width, which sets its four-step layout


def pairs_to_int64(hi, lo, device=None) -> torch.Tensor:
    """(hi, lo) uint32 numpy arrays -> int64 tensor with the same 64-bit
    patterns (a value >= 2^63 comes out as its wrapped int64)."""
    hi = np.asarray(hi).astype(np.uint64)
    lo = np.asarray(lo).astype(np.uint64)
    return torch.from_numpy(((hi << np.uint64(32)) | lo).view(np.int64)).to(device)


def int64_to_pairs(x: torch.Tensor):
    """int64 tensor -> (hi, lo) uint32 numpy arrays."""
    v = x.detach().cpu().numpy().view(np.uint64)
    return ((v >> np.uint64(32)).astype(np.uint32),
            (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _table(enc, device):
    """One encoded JAX table: a (hi, lo) pair, or for SHOUP the pair of
    pairs ((w_hi, w_lo), (ws_hi, ws_lo)) -> a tensor or a (w, ws) tuple."""
    if isinstance(enc[0], tuple):
        return tuple(pairs_to_int64(*e, device=device) for e in enc)
    return pairs_to_int64(*enc, device=device)


def tables_from_jax(plan, device=None) -> dict:
    """The tables of a ``tpu_ntt.ntt.NttPlan`` over ``Ring64``, in the form
    the port's ``NttPlan`` holds them, keyed by the port's attribute names."""
    out = {
        "bitrev": torch.from_numpy(np.asarray(plan.bitrev, dtype=np.int64)).to(device),
        "psi_pows": _table(plan.psi_pows, device),
        "psi_inv_pows": _table(plan.psi_inv_pows, device),
        "n_inv_tw": _table(plan.n_inv_tw, device),
    }
    for name in ("stage_tw", "stage_tw_inv", "merged_tw", "merged_tw_inv"):
        out[name] = [_table(t, device) for t in getattr(plan, name)]
    return out


def uint32_to_int32(x, device=None) -> torch.Tensor:
    """A uint32 numpy array -> the int32 tensor with the same bits (a
    residue below 2^31 keeps its value)."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def int32_to_uint32(x: torch.Tensor) -> np.ndarray:
    """int32 tensor -> the uint32 numpy array with the same bits."""
    return x.detach().cpu().contiguous().numpy().view(np.uint32)


def fourstep_to_bitrev_perm(n: int) -> np.ndarray:
    """perm with port_spectrum = jax_spectrum[..., perm]: tpu_ntt's four-step
    order (position k1*128 + k2 holds X[k2*n1 + k1], n1 = n/128) to the
    port's bit-reversed order (position j holds X[bitrev(j)])."""
    n1 = n // LANES
    fourstep_to_natural = np.arange(n).reshape(n1, LANES).T.reshape(-1)
    return fourstep_to_natural[bit_reverse_permutation(n)]


def spectra_from_jax(spectra, device=None) -> torch.Tensor:
    """(..., n) uint32 spectra of ``tpu_ntt.kernels.mxu.MxuPlan.nwc_spectrum``
    -> the port's ``nwc_spectrum`` of the same operands, int32."""
    x = np.asarray(spectra, dtype=np.uint32)
    return uint32_to_int32(x[..., fourstep_to_bitrev_perm(x.shape[-1])], device)


def matvec_spectra_from_jax(blocks, n: int, device=None) -> torch.Tensor:
    """(k, l, 128, 128) uint32 blocks of ``MxuPlan.nwc_matvec_spectra`` ->
    the port's (k, l, n) ``nwc_matvec_spectra``.  Each block tiles one
    spectrum over the 128/n1 polynomials of an MXU group; the first copy,
    rows [0, n1), is the spectrum in four-step layout."""
    x = np.asarray(blocks, dtype=np.uint32)
    k, l = x.shape[:2]
    return spectra_from_jax(x[:, :, : n // LANES, :].reshape(k, l, n), device)


def spectra64_from_jax(hi, lo, device=None) -> torch.Tensor:
    """(..., n) (hi, lo) uint32 spectra of ``tpu_ntt.kernels.mxu64``
    ``MxuPlan64.nwc_spectrum`` or ``SolinasPlan64.nwc_spectrum`` (the same
    Montgomery-64 domain), or of ``tpu_ntt.kernels.gl64``
    ``GoldilocksPlan64.nwc_spectrum`` (the plain domain, the same four-step
    layout) -> the port's ``nwc_spectrum`` of the same operands, int64: a
    permutation only."""
    x = pairs_to_int64(hi, lo)
    return x[..., fourstep_to_bitrev_perm(x.shape[-1])].contiguous().to(device)


def matvec_spectra64_from_jax(blocks, n: int, device=None) -> torch.Tensor:
    """The (hi, lo) pair of (k, l, rows, 128) uint32 blocks of
    ``MxuPlan64.nwc_matvec_spectra`` -> the port's (k, l, n)
    ``nwc_matvec_spectra``.  As in ``matvec_spectra_from_jax``, rows
    [0, n/128) of each block hold the spectrum in four-step layout."""
    hi, lo = (np.asarray(w, dtype=np.uint32) for w in blocks)
    k, l = hi.shape[:2]
    rows = n // LANES
    return spectra64_from_jax(hi[:, :, :rows].reshape(k, l, n),
                              lo[:, :, :rows].reshape(k, l, n), device)


def kyber_spectra_from_jax(spectra, device=None) -> torch.Tensor:
    """(..., 256) uint32 rows of ``tpu_ntt.kyber.spectrum`` -> the port's
    ``kyber.spectrum`` of the same operands, int32.

    JAX's rows come from its default parity-matrix kernel
    (``tpu_ntt.kernels.kyber.KyberPlan`` with ``parity_matrices``): lane i
    holds slot i's even value e_hat[i] and lane 128 + i its odd value
    o_hat[i], [e_hat (128) | o_hat (128)].  The port's rows are in FIPS-203
    serialization order, e_hat[i] at 2i and o_hat[i] at 2i + 1.  Both are
    times 2^32 mod q, so this only permutes."""
    x = np.asarray(spectra, dtype=np.uint32)
    lanes = np.arange(2 * LANES).reshape(2, LANES).T.reshape(-1)  # 2i -> i, 2i+1 -> 128+i
    return uint32_to_int32(x[..., lanes], device)


def kyber_blocks_from_jax(blocks, device=None) -> torch.Tensor:
    """(k, l, 128, 256) uint32 blocks of ``tpu_ntt.kyber.matvec_spectra`` or
    ``ntt_domain_blocks`` -> the port's (k, l, 256) matvec spectra, int32.
    Each JAX block repeats one [e_hat | o_hat] spectrum row over the 128
    batch rows of an MXU group; its first row, in FIPS order, is the port's
    entry."""
    x = np.asarray(blocks, dtype=np.uint32)
    return kyber_spectra_from_jax(x[:, :, 0, :], device)


def _lanes_to_natural(m: int) -> np.ndarray:
    """tpu_ntt's flat four-step order at m points: natural = x[..., perm]
    (``MxuPlan64.fourstep_to_natural_perm``, mxu64.py:2440)."""
    return np.arange(m).reshape(max(m // LANES, 1), min(m, LANES)).T.reshape(-1)


def kernel_fourstep_to_natural_perm(n: int) -> np.ndarray:
    """perm with natural = jax_spectrum[..., perm] for the spectra of
    tpu_ntt's kernel four-step at n (``sharded.KernelFourStep`` at
    ``default_split(n)``): position [j1, j2] holds X[pos2[j2] * n1 +
    pos1[j1]], pos the sub-kernels' four-step order
    (``KernelFourStep.spectrum_indices``, tpu_ntt/sharded.py:410-417)."""
    n1, n2 = default_split(n)
    pos1, pos2 = (np.argsort(_lanes_to_natural(m)) for m in (n1, n2))
    return np.argsort((pos2[None, :] * n1 + pos1[:, None]).reshape(-1))


def split_to_natural_perm(n: int) -> np.ndarray:
    """perm with natural = jax_spectrum[..., perm] for the spectra of
    tpu_ntt's flat ``MxuPlan64`` at 256 <= n <= 2^19
    (``nwc_fourstep_to_natural_perm``, mxu64.py:1864-1875): the four-step
    order, its n/128 rows permuted by pi_d under the split-radix left
    transform of depth d = log2(n) - 14 from n = 32768 on (mxu64.py:1852)."""
    n1 = n // LANES
    depth = max(n.bit_length() - 1 - 14, 0)
    r = np.arange(n1)
    pi = (r % LANES) << depth
    for k in range(depth):
        pi += ((r >> (7 + k)) & 1) << (depth - 1 - k)
    j = np.arange(n)
    return np.argsort(pi)[j % n1] * LANES + j // n1


def large_spectra64_from_jax(hi, lo, to_natural, q: int | None = None,
                             device=None) -> torch.Tensor:
    """(..., n) (hi, lo) uint32 spectra in a JAX layout whose map is
    ``to_natural`` (natural = x[..., to_natural]) -> the same spectra in
    the port's bit-reversed order, int64.  Given q, a plain-domain spectrum
    (JAX's four-step ``spectrum``) is also taken to the port's cached domain,
    times 2^64 mod q; without, the values pass unchanged (JAX's transforms,
    and its flat cached spectra, already times 2^64)."""
    x = pairs_to_int64(hi, lo)
    x = x[..., np.asarray(to_natural)[bit_reverse_permutation(x.shape[-1])]]
    if q is not None:
        r = (1 << 64) % q
        x = shoup_mul64(x, r, (r << 64) // q, q)
    return x.contiguous().to(device)


def shards_from_jax(x, device=None) -> ShardedTensor:
    """A sharded JAX array of uint32 words, or a (hi, lo) pair of them ->
    the port's ``ShardedTensor`` of int32 (or int64) shards: each device's
    ``addressable_shards`` entry in mesh order, through ``uint32_to_int32``
    (or ``pairs_to_int64``), on a ``sharded.make_mesh`` of the JAX mesh's
    shape and axis names over ``device`` (by default the current CUDA
    device), with the array's ``PartitionSpec``."""
    pair = isinstance(x, tuple)
    lead = x[0] if pair else x
    jmesh = lead.sharding.mesh
    spec = tuple(lead.sharding.spec) + (None,) * (lead.ndim - len(lead.sharding.spec))
    if any(not (name is None or isinstance(name, str)) for name in spec):
        raise ValueError(f"spec {spec}: one mesh axis a dimension at most")
    mesh = make_mesh(jmesh.devices.shape, jmesh.axis_names, device)
    words = [{s.device: np.array(s.data) for s in a.addressable_shards}
             for a in (x if pair else (x,))]
    shards = []
    for jdev, dev in zip(jmesh.devices.flat, mesh.device_list()):
        if pair:
            shards.append(pairs_to_int64(words[0][jdev], words[1][jdev], dev))
        else:
            shards.append(uint32_to_int32(words[0][jdev], dev))
    return ShardedTensor(mesh, spec, shards)

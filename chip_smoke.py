#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port, ``tpu_ntt_torch``.

Run it from the root of a checkout on a machine with an NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

It drives the port's kernel families on every op: the 60-bit family
(``kernels/csrc/nwc64.cu``: P60_4096, a trinomial q on ``SolinasPlan64``,
and the generic prime 576460752308273153 at n = 4096 on ``MxuPlan64``), the
24-bit family (``kernels/csrc/nwc32.cu``: P24_4096 and the
ML-DSA-44-shaped DILITHIUM_256 4 x 4 matvec), ML-KEM
(``kernels/csrc/kyber.cu``: every ``tpu_ntt_torch.kyber`` entry point at
ML-KEM-768's shapes, B = 16384), the Goldilocks field
(``kernels/csrc/gl64.cu``: every op at goldilocks_4096) and Poseidon2-GL
(``kernels/csrc/poseidon.cu``), and the STARK commitment built on the last
two, at degree 2^10 (the flat kernel order) and at Plonky2's degree 2^17,
N = 2^20, and both 64-bit families above n = 8192 through the four-step
(``kernels/fourstep64.py``: bench.py's p60_32768 at B = 256, every op, and
p60_1048576 at B = 4; goldilocks_32768 and Goldilocks at 2^20 at the same
batches, on gl64.cu's row kernels), and the mesh (``sharded.ShardedNtt`` on
logical shards of the card, its stage exchange on ``kernels/csrc/a2a.cu``,
kernel K6).  Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi), its SM count and
   top SM clock;
2. build: nvcc builds the six CUDA sources from csrc/, in parallel;
   ptxas's registers and spills (poseidon.cu's kernels must spill
   nothing); the SASS length of each poseidon.cu kernel and the
   instructions one width-8 permutation issues (cuobjdump); the
   instructions a thread issues after its first barrier at n = 4096 in
   nwc64.cu's and gl64.cu's radix-8 kernels, in the fused
   ``nwc64_product`` and ``gl64_product`` (fresh and
   cached) at n = 4096, the fused ``nwc64_cyclic_scaled`` and
   ``gl64_cyclic_scaled``, the row forwards ``nwc64_forward_scaled``
   and ``gl64_forward_scaled`` and the row inverses
   ``nwc64_inverse_scaled`` and ``gl64_inverse_scaled`` at n = 128 and
   1024, the fused dots' row passes ``nwc64_dot_scaled`` and
   ``gl64_dot_scaled`` at n = 128 and the flat ``nwc64_dot`` and
   ``gl64_dot`` at n = 4096 (a step of its loop, one forward, and the
   rest), nwc64.cu's matvec ``nwc64_matvec`` at n = 4096 and gl64.cu's
   matvec row pass ``gl64_matvec_scaled`` at n = 128 (a step of its loop
   of l, and the rest), and nwc32.cu's radix-16 forward and inverse at
   n = 256, 4096 and 16384 and its fused product, fresh and cached, at
   n = 4096, with their shared-memory instructions, and its fused dot at
   n = 4096, fresh and cached, counted as the flat dots, and its matvec
   ``radix_matvec_kernel<8>`` and kyber.cu's radix-16 dot, fresh and
   cached at K = 3, counted as the matvecs (a step, after the loop, in
   all); the radix
   kernels of the four files, 36 transforms, 9 row forwards and 9 row
   inverses in each 64-bit one, nwc64.cu's 18 fused products, 18 fused row
   passes, 36 fused dots (18 row passes, 18 flat) and 9 matvecs, gl64.cu's
   36 fused products (18 flat, 18 row passes), 36 fused dots (18 flat,
   18 row passes) and 9 matvec row passes, and nwc32.cu's 7 radix-16
   forwards, 7 inverses, 14 fused products, 14 fused dots and 7 matvecs,
   and kyber.cu's 2 dots, must spill nothing; the
   blocks an SM of both flat dots, gl64.cu's row-pass dot and its flat
   product, by ptxas's registers and their shared memory;
3. kernel vs plain: each kernel function equals its plain PyTorch version
   bit for bit on the card, with boundary rows of 0, 1 and q - 1: the
   radix-8 cores (``nwc64_forward``, ``nwc64_inverse`` on rows and
   ``nwc64_forward_cols``, ``nwc64_inverse_cols`` on every column of
   (R, n, width) matrices, against the transposes around the plain
   transform, at P60_4096's q, the generic q and 2^62 - 2^16 + 1; the same
   four ``gl64_*`` at the Goldilocks q, boundary rows 0, 1, q - 1,
   2^63 - 1, 2^63 and 2^64 - 2^32) at every n from 32 to 8192, B = 1, 3
   and 2048 rows, widths 1, 3, 8, 128 and 1024, cyclic and merged tables,
   the forward at scale 1 and 2^64 mod q, the inverse at n^-1 and 1; the
   products fused on those cores (``nwc64_product`` and ``nwc64_cached``
   at the three 60-bit q; the row passes ``nwc64_cyclic_scaled``,
   ``nwc64_cached_scaled`` and ``nwc64_dot_scaled``, fresh and cached,
   K = 1 and 4, and the row forward ``nwc64_forward_scaled`` at scale 1
   and 2^64 mod q, at the same q; ``gl64_product`` and ``gl64_cached``,
   ``gl64_cyclic_scaled``, ``gl64_cached_scaled`` and the row forward
   ``gl64_forward_scaled`` at scale 1 and q - 1 at the Goldilocks q; the
   row kernels with random pre and post tables at period 1, 3 and 256) at
   every n from 32 to 8192, B = 1, 3 and 2048, boundary rows first, on
   cyclic tables, and on merged ones at n = 4096 (the Goldilocks flat
   products at every n; the dot at K = 4 and B = 2048 at n = 128 alone);
   the flat dot
   ``nwc64_dot`` on merged tables, fresh and cached, K = 1 and 4, at the
   same n, q and B (K = 4 at B = 2048 at n = 128 alone); ``gl64_dot`` on
   gl64.cu's radix-8 core, fresh and cached, K = 1 and 4, n = 32 to 8192,
   B = 1, 3 and 512, and K = 4 at B = 2048 at n = 4096, boundary rows
   first; the row inverses ``nwc64_inverse_scaled`` at the three 60-bit q
   and ``gl64_inverse_scaled`` at the Goldilocks q, n = 32 to 8192, B = 1,
   3 and 2048, periods 1 and 3 (1 and 256 at 2048); the matvec's
   accumulate-and-inverse ``nwc64_matvec`` alone at the three 60-bit q,
   n = 256 to 8192, (k, l) = (1, 1), (4, 4), (8, 8) and (3, 5), B = 1, 3
   and 256, against the plain matvec; the matvec's row pass
   ``gl64_matvec_scaled`` alone at the Goldilocks q, n = 32 to 8192, the
   same (k, l) and B, periods 1 and 3 (1 and 256 at B = 256), S's and A's
   first words 0, 1, q - 1, 2^63 - 1, 2^63 and 2^64 - 2^32, against the
   plain row pass; the dot's row pass ``gl64_dot_scaled``, fresh and cached, K = 1
   and 4, n = 32 to 8192, B = 1 and 3, periods 1 and 3, and K = 4 at
   B = 2048 at n = 128 (period 256) and 1024 (period 1024) and at B = 264
   at n = 8192; ``nwc32_forward`` on nwc32.cu's radix-16 core at n = 256 to
   16384 (q = 8380417 to 4096, q = 16580609, q = 12289 to 2048), B = 1, 3
   and 2048, merged and cyclic tables, scale 1 and 2^32 mod q;
   ``nwc32_inverse`` on the same core at the same n, q and B, merged and
   cyclic tables, scale n^-1 and 1; the
   products and the dot fused on it at the same n and q, boundary rows
   first: ``nwc32_product`` on merged and cyclic tables and
   ``nwc32_cached`` at B = 1, 3 and 2048, ``nwc32_dot`` fresh and cached
   at K = 1, 4 and 8, B = 1, 3 and 512; ``nwc32_matvec`` alone at the same
   n and q, (k, l) = (1, 1), (4, 4), (8, 8) and (3, 5), B = 1, 3 and 37,
   s's rows 0, 1 and q - 1 first and A's first row all q - 1, against the
   plain matvec; ``kyber_dot`` on kyber.cu's radix-16 core, fresh and
   cached, K = 1 to 8, B = 1, 3, 9 and 16384, rows 0, 1 and q - 1 first;
   every op
   at P60_4096, B = 2048 (the dot at K = 4, B = 512, the matvec 4 x 4 at
   B = 256), the product, forward and inverse at n = 256 and 8192, the dot
   at n = 8192 (three rows of shared memory), every op at the generic q;
   every K3a entry at P24_4096, B = 2048; the product at FALCON_1024 and at
   n = 16384 (q = 16580609), B = 2048; the dot and the cached dot at
   P24_4096, K = 4, B = 512; the matvec spectra and the 4 x 4 matvec at
   DILITHIUM_256, B = 8192; every ``kyber_*`` function at B = 16384 (the
   dot at K = 3, fresh and cached; the matvec 3 x 3 from ``matvec_spectra``
   and from ``ntt_domain_blocks``), and the 2 x 2 and 4 x 4 matvecs of
   ML-KEM-512 and -1024 at B = 2048; every ``gl64_*`` function at
   goldilocks_4096, B = 2048, with rows of 0, 1, q - 1, 2^63 and 2^63 - 1
   (the dot at K = 4, B = 512, the matvec 4 x 4 at B = 256), the product,
   forward and inverse at n = 256 and 8192 and the dot at n = 8192;
   ``poseidon_permute`` at widths 8 and 12 on B = 131072 columns (bench.py's
   batch) and ``poseidon_sponge`` at both widths over (131072, 8) rows and
   rows of 0, 1 and 5, with columns and rows against ``PoseidonRef``, and
   both again at rf = 6, rp = 11 (rows of 9); ``poseidon_field_probe``, the
   kernels' arithmetic core on any 64-bit words (every pair of 0, 1, 2,
   2^32 - 1, 2^32, q - 1, q, q + 1, 2^63 - 1, 2^63, 2^64 - 2^32, 2^64 - 1,
   65536 random triples and 16384 near 2^64), against Python integers;
   the four-step's row kernels (``nwc64_cyclic_scaled``,
   ``nwc64_forward_scaled``, also times 2^64, ``nwc64_inverse_scaled``,
   ``nwc64_cached_scaled``) and its column passes (``nwc64_forward_cols``,
   ``nwc64_inverse_cols`` at 256 and 1024 points) at the shapes p60_32768 B = 256
   and p60_1048576 B = 4 give them, after the mid tables are built (their
   time printed), ``nwc64_dot_scaled`` (fresh and cached) and
   ``nwc64_matvec_scaled`` at p60_32768's K = 4 and 4 x 4, B = 64; the same
   six ``gl64_*_scaled`` row kernels and gl64's column passes
   (``gl64_forward_cols``, ``gl64_inverse_cols``) at
   goldilocks_32768 B = 256 and goldilocks_1048576 B = 4 (the dot and the
   matvec at B = 64 and 4); and the product at n = 16384 (128 x 128), 1024
   (32 x 32) and 2048 (64 x 32) against its plain chain at both q;
   ``a2a_exchange`` against ``all_to_all_plain``, both directions, D = 2, 4
   and 8, int64 and int32 words of every pattern in (3, 40, 24) leaves
   (blocks of 24 down to 3 words, so 16-, 8- and 4-byte vectors), and
   p60_1048576's B = 4 column and row leaves at D = 4 with Goldilocks
   residues >= 2^63;
4. oracle: c(x) == a(x) * b(x) mod q at x = psi^(2k+1), a root of x^n + 1,
   by Python-int Horner evaluation, and one row against the golden model,
   at P60_4096, the generic q, P24_4096 and goldilocks_4096; inv(fwd(x))
   == x, cyclic and negacyclic, at P60_4096, P24_4096 and goldilocks_4096; one P60_4096 dot row equal to the
   sum of its golden products; ML-KEM rows equal to the FIPS-203 goldens
   (``reference.kyber_ntt``, ``kyber_intt``, ``kyber_poly_mult``, a 3 x 3
   matvec row as a sum of golden products), one product row equal to
   ``reference.schoolbook_negacyclic``, and intt(ntt(x)) == x at B = 16384;
   the psi^(2k+1) evaluations of the four-step product at p60_32768 and
   goldilocks_32768 (rows 2-5) and at 2^20 (rows 2-3), and its round trips;
   the sharded product at p60_1048576 on 4 logical shards (row 2) and the
   sharded DILITHIUM_256 product against ``reference.schoolbook_negacyclic``
   (rows 0-3);
5. main path: ``dispatch.best(p, op)`` for each of the twelve ops at
   P60_4096, at the generic q, at P24_4096 and at goldilocks_4096, then
   ``dispatch.best_nwc_matvec`` at P60_4096 (4 x 4, B = 256) and at
   DILITHIUM_256, then the eleven ``tpu_ntt_torch.kyber`` entry points at
   B = 16384, each run with the launch counts set to 0 just before it and
   read just after: each goes through its kernel (``basemul`` and
   ``ntt_domain_blocks``, elementwise, through none), stays in [0, q) and
   returns what its plain version returns; then the STARK commitment:
   ``stark.LdePlan(1024, q, 8, order="kernel").extend`` of 135 columns
   (Plonky2's recursion width at degree 2^10, N = 8192: the check of the
   flat kernels' order), ``reorder`` to the bitrev plan,
   ``Poseidon2GL.hash_rows`` of the 8192 rows of 135 into leaves,
   ``merkle_levels``, ``FriProver(final_size=32, num_queries=28).prove`` of
   column 0 and ``fri_verify`` on the host, with the counts zeroed before
   it: ``gl64_forward``, ``poseidon_sponge`` and ``poseidon_permute`` each
   launch, the proof verifies, the LDE equals the plain bitrev LDE and a
   big-int Horner evaluation at six points, the leaves and the root equal
   their plain versions, and the time of each stage is printed; then
   ``dispatch.best`` for the twelve ops at p60_32768 and goldilocks_32768
   (B = 256, the dot at K = 4, B = 64, the matvec 4 x 4 at B = 64) and for
   ``nwc``, ``nwc_fwd`` then ``nwc_inv`` of its output, ``spectrum`` then
   ``cached`` at p60_1048576 and goldilocks_1048576 (B = 4): each launches
   its four-step kernels (the column pass on the column entry points,
   never the row transforms) and equals its plain chain; then the mesh:
   ``sharded.ShardedNtt(fused_exchange=True)`` on FourStepPlan64's own
   ``KernelFourStep`` at p60_1048576 B = 4 over 4 logical shards of the card
   (1024 x 1024, blocks of 256 rows or columns), its eight ops, each with
   the counts zeroed before it: D ``a2a_exchange`` launches an exchange call
   (two a product, one a transform) and its four-step kernels, the result
   gathered equal to ``FourStepPlan64``'s (spectra in its bit-reversed
   order and domain) and to the ``fused_exchange=False`` run; ``nwc``,
   ``spectrum`` and ``cached`` at Goldilocks 2^20 B = 4 on a 2 x 2 batch x
   coeff mesh; the DILITHIUM_256 product at 16 x 16 on 8 shards through
   the plain locals and K6 (B = 2048, against the K3 kernel); ``batch_pjit``
   of ``best_nwc_poly_mult`` at P60_4096 B = 2048 over 4 batch shards,
   one ``nwc64_product`` a shard, equal to the unsharded call; with two
   cards or more, the p60 product and forward again with the shards on
   distinct cards (with one, a line says it did not run); then the commitment at
   Plonky2's ``standard_recursion_config`` uncut (bounds.STARK_*: degree
   2^17, 135 columns, blowup 8, N = 2^20, 28 queries), the same stages with
   the counts zeroed before them: ``gl64_forward_cols``,
   ``gl64_forward_scaled``, ``poseidon_sponge`` and ``poseidon_permute``
   each launch and ``gl64_forward``/``gl64_inverse`` never, ``fri_verify``
   accepts, the LDE equals its plain chain (``LdePlan.extend_plain``, 15
   columns at a time to bound memory) and big-int Horner at 8 points, the
   leaves of a fixed 8192-row slice equal the plain sponge (which takes
   9.5 s for 8192 rows, so not all 2^20), the root equals the plain tree's,
   two leaves equal ``PoseidonRef`` and their Merkle paths verify;
6. timing: each kernel function, through the main path, in turns plain,
   kernel, kernel, plain: its device time by the replay of its calls
   captured in a CUDA graph (``benchlib.graph_seconds_per_call``, the
   line's ``ms``), its time per call back to back by CUDA events, host
   time included, and the host's time to enqueue a call; the plain version
   by CUDA events, with few iterations.  Products, forward transforms and
   matvecs per second for the headline rows, and ML-KEM products, forward
   NTTs and 3 x 3 matvecs per second at B = 16384, Goldilocks products and
   transforms, permutations at widths 8 and 12 and STARK leaf rows per
   second, from the back-to-back times: what a caller of the entry point
   gets.  The Poseidon kernels are timed through their wrappers
   (``kernels.poseidon.permute`` at width 8, B = 131072, and ``sponge`` on
   the STARK leaves), the plain sponge of the leaves once a turn.  The
   four-step's row kernels at p60_32768 and goldilocks_32768, and its
   chains (nwc, nwc_fwd, nwc_inv, cached, dot, dot_cached, matvec at both,
   spectrum at p60_32768; nwc and cached at both 2^20 rows) against their
   plain chains, the cached dots at P60_4096, P24_4096, goldilocks_4096
   and ML-KEM-768 beside the fresh ones, the three matvecs' accumulate-
   and-inverse kernels alone beside their ops (``nwc64_matvec``,
   ``gl64_matvec`` at B = 256 and ``nwc32_matvec`` at DILITHIUM_256,
   B = 8192, on the spectra of s; their bounds ``bounds.ntt_work``'s
   ``matvec_alone``), with the product chain's parts by graph replay: column
   forward, row kernel, column inverse (beside the chain, the transpose
   route the column entry points replace, and the five transposes
   alone); ``nwc64_forward_cols``,
   ``nwc64_inverse_cols``, ``gl64_forward_cols`` and ``gl64_inverse_cols``
   at p60_32768's and goldilocks_32768's column passes; the degree-2^17
   commitment's LDE (and its parts: the torch coset scale and pad, the
   four-step) and its leaf
   sponge by graph replay against their bounds; ``a2a_exchange`` each way
   at p60_1048576 B = 4, D = 4, against its plain version, its bound on one
   card (``bounds.a2a_card_work``) and on four over NVLink
   (``bounds.a2a_work``, worked out), the ``fused_exchange=False`` exchange
   by graph replay (the kernel line's ``library_ms``: D^2 ``Tensor.copy_``
   calls, since no one PyTorch call exchanges logical shards), and the
   sharded product chain with either exchange against the single-device
   chain, two turns, with the sanity band of twice the single chain.

The line before the last lists each kernel with its launches on the main
path, its largest difference from its plain version, its device time, its
plain version's time, its bound (``tpu_ntt_torch/bounds.py``: the larger of
its bytes over 3.35 TB/s and its 32-bit multiplies over the card's IMAD rate,
its SMs x 64 a clock x its top SM clock) and the time of the PyTorch call
beside it (null but for ``a2a_exchange``).  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result.  pytest cannot run on a machine without JAX
(tests/conftest.py imports it), so this script is the check of the port on
the card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np

BATCH = 2048  # bench.py's full batch for the p60_4096 and p24_4096 rows
DOT_BATCH = 512  # the dot runs K = bounds.DOT_TERMS = 4 terms
DOT_BATCH_8192 = 256
MATVEC_BATCH = 8192  # bench.py's batch for the dilithium_256 matvec row
MATVEC_BATCH_60 = 256  # bench.py:153, the p60_4096 matvec row
Q_GENERIC = 576460752308273153  # bench.py:35: a 60-bit prime, not a trinomial
GOLDILOCKS_Q = (1 << 64) - (1 << 32) + 1
KYBER_SMALL_BATCH = 2048  # the ML-KEM-512 and -1024 matvecs, checked only
# the STARK commitment at Plonky2's recursion config (bounds.STARK_*: 135
# wires, blowup 8, 28 queries) at degree 2^10, N = 8192, the flat kernel
# order's check, beside the one at Plonky2's degree 2^17 (bounds.STARK_DEGREE)
GL_LDE_N = 1024
GL_FINAL = 32  # FRI's final codeword
LEAF_SLICE = 8192  # rows of the 2^20 leaves held against the plain sponge (9.5 s)
LDE_CHECK_COLS = 15  # columns of the 2^20 LDE held against its plain chain at a time
FOURSTEP_DOT_BATCH = 64  # the dot at K = 4 and the 4 x 4 matvec at n = 32768
Q62_MAX = 4611686018427322369  # 2^62 - 2^16 + 1: the largest prime q < 2^62, q = 1 mod 2^14
COLUMN_WIDTHS = (1, 3, 8, 128, 1024)  # the column entry points' widths checked
SOURCES = {"nwc64": "tpu_ntt_torch/kernels/csrc/nwc64.cu",
           "nwc32": "tpu_ntt_torch/kernels/csrc/nwc32.cu",
           "kyber": "tpu_ntt_torch/kernels/csrc/kyber.cu",
           "gl64": "tpu_ntt_torch/kernels/csrc/gl64.cu",
           "poseidon": "tpu_ntt_torch/kernels/csrc/poseidon.cu",
           "a2a": "tpu_ntt_torch/kernels/csrc/a2a.cu"}
#: the TPU kernel body each function replaces
REPLACES = {
    "nwc64_product": "tpu_ntt/kernels/mxu64.py:1442",  # _nwc_kernel (+ _cyclic_kernel :1474), K1a
    "nwc64_cached": "tpu_ntt/kernels/mxu64.py:1691",  # _nwc_cached_kernel, K1a
    "nwc64_forward": "tpu_ntt/kernels/mxu64.py:1715",  # _nwc_fwd_kernel (+ :1544, :1675), K1a
    "nwc64_inverse": "tpu_ntt/kernels/mxu64.py:1733",  # _nwc_inv_kernel (+ _inv_kernel :1559), K1a
    "nwc64_dot": "tpu_ntt/kernels/mxu64.py:1599",  # _make_dot_kernel, K1b
    "nwc64_matvec": "tpu_ntt/kernels/mxu64.py:1639",  # _make_matvec_kernel, K1c
    # K1a's large-n bodies: the four-step's row pass (with the column pass,
    # the split bodies' function, :1217-1409 and :1877-1949)
    "nwc64_cyclic_scaled": "tpu_ntt/kernels/mxu64.py:1501",  # _cyclic_scaled_kernel
    "nwc64_forward_scaled": "tpu_ntt/kernels/mxu64.py:1877",  # _make_nwc_fwd_split_kernel
    "nwc64_inverse_scaled": "tpu_ntt/kernels/mxu64.py:1897",  # _make_nwc_inv_split_kernel
    "nwc64_cached_scaled": "tpu_ntt/kernels/mxu64.py:1918",  # _make_nwc_cached_split_kernel
    # the dot's and the matvec's bodies at n = 16384 and 32768, K1b and K1c
    "nwc64_dot_scaled": "tpu_ntt/kernels/mxu64.py:1599",  # _make_dot_kernel via _dot_call
    "nwc64_matvec_scaled": "tpu_ntt/kernels/mxu64.py:1639",  # _make_matvec_kernel
    # the four-step's column pass: the same bodies down the columns (JAX
    # moves the axis in XLA around them, tpu_ntt/sharded.py:419-442)
    "nwc64_forward_cols": "tpu_ntt/kernels/mxu64.py:1715",  # _nwc_fwd_kernel (+ :1544), K1a
    "nwc64_inverse_cols": "tpu_ntt/kernels/mxu64.py:1733",  # _nwc_inv_kernel (+ :1559), K1a
    "nwc32_product": "tpu_ntt/kernels/mxu.py:480",  # _nwc_kernel, K3a
    "nwc32_cached": "tpu_ntt/kernels/mxu.py:596",  # _nwc_cached_kernel, K3a
    "nwc32_forward": "tpu_ntt/kernels/mxu.py:615",  # _nwc_fwd_kernel (+ :584), K3a
    "nwc32_inverse": "tpu_ntt/kernels/mxu.py:627",  # _nwc_inv_kernel, K3a
    "nwc32_dot": "tpu_ntt/kernels/mxu.py:506",  # _make_dot_kernel, K3b
    "nwc32_matvec": "tpu_ntt/kernels/mxu.py:544",  # _make_matvec_kernel, K3c
    "kyber_forward": "tpu_ntt/kernels/kyber.py:388",  # _transform_kernel (+ :291), K4a
    "kyber_inverse": "tpu_ntt/kernels/kyber.py:388",  # _transform_kernel (intt), K4a
    "kyber_product": "tpu_ntt/kernels/kyber.py:277",  # _poly_mult_kernel_v2, K4b
    "kyber_cached": "tpu_ntt/kernels/kyber.py:301",  # _cached_kernel_v2, K4b
    "kyber_dot": "tpu_ntt/kernels/kyber.py:311",  # _make_dot_kernel_v2, K4c
    "kyber_matvec": "tpu_ntt/kernels/kyber.py:336",  # _make_matvec_kernel_v2, K4d
    # K2: GoldilocksPlan64 (tpu_ntt/kernels/gl64.py:59) runs K1's bodies
    "gl64_product": "tpu_ntt/kernels/mxu64.py:1442",  # _nwc_kernel (+ :1474), K2
    "gl64_cached": "tpu_ntt/kernels/mxu64.py:1691",  # _nwc_cached_kernel, K2
    "gl64_forward": "tpu_ntt/kernels/mxu64.py:1715",  # _nwc_fwd_kernel (+ :1544, :1675), K2
    "gl64_inverse": "tpu_ntt/kernels/mxu64.py:1733",  # _nwc_inv_kernel (+ :1559), K2
    "gl64_dot": "tpu_ntt/kernels/mxu64.py:1599",  # _make_dot_kernel, K2
    "gl64_matvec": "tpu_ntt/kernels/mxu64.py:1639",  # _make_matvec_kernel, K2
    # K2 above n = 8192: K1a's large-n bodies, K1b and K1c through
    # GoldilocksPlan64 (flat at 16384 and 32768, sub-plans of the kernel
    # four-step above), the four-step's row pass at the Goldilocks q
    "gl64_cyclic_scaled": "tpu_ntt/kernels/mxu64.py:1501",  # _cyclic_scaled_kernel
    "gl64_forward_scaled": "tpu_ntt/kernels/mxu64.py:1877",  # _make_nwc_fwd_split_kernel
    "gl64_inverse_scaled": "tpu_ntt/kernels/mxu64.py:1897",  # _make_nwc_inv_split_kernel
    "gl64_cached_scaled": "tpu_ntt/kernels/mxu64.py:1918",  # _make_nwc_cached_split_kernel
    "gl64_dot_scaled": "tpu_ntt/kernels/mxu64.py:1599",  # _make_dot_kernel via _dot_call
    "gl64_matvec_scaled": "tpu_ntt/kernels/mxu64.py:1639",  # _make_matvec_kernel
    # the four-step's column pass at the Goldilocks q: K2's transforms down
    # the columns (JAX moves the axis in XLA, tpu_ntt/sharded.py:419-442)
    "gl64_forward_cols": "tpu_ntt/kernels/mxu64.py:1715",  # _nwc_fwd_kernel (+ :1544), K2
    "gl64_inverse_cols": "tpu_ntt/kernels/mxu64.py:1733",  # _nwc_inv_kernel (+ :1559), K2
    "poseidon_permute": "tpu_ntt/kernels/poseidon.py:193",  # _compiled, K5a
    "poseidon_sponge": "tpu_ntt/kernels/poseidon.py:218",  # _compiled_sponge, K5b
    "a2a_exchange": "tpu_ntt/sharded.py:580",  # _a2a_pallas_leaf (pallas_call :669), K6
}
#: which entry points of its family's source each dispatch op launches
OP_ENTRIES = {
    "nwc": ["product"], "cyclic": ["product"], "fwd": ["forward"],
    "inv": ["inverse"], "nwc_fwd": ["forward"], "nwc_inv": ["inverse"],
    "spectrum": ["forward"], "cached": ["cached"], "dot": ["dot"],
    "dot_cached": ["dot"], "matvec_spectra": ["forward"],
    "matvec": ["forward", "matvec"],
}
#: the same for the four-step (kernels/fourstep64.py): entries of its
#: sub-plans' source, nwc64.cu or gl64.cu
_FWD, _INV = ["forward", "forward_scaled"], ["inverse_scaled", "inverse"]
FOURSTEP_ENTRIES = {
    "nwc": ["forward", "cyclic_scaled", "inverse"],
    "cyclic": ["forward", "cyclic_scaled", "inverse"], "fwd": _FWD, "inv": _INV,
    "nwc_fwd": _FWD, "nwc_inv": _INV, "spectrum": _FWD,
    "cached": ["forward", "cached_scaled", "inverse"],
    "dot": ["forward", "dot_scaled", "inverse"],
    "dot_cached": ["forward", "dot_scaled", "inverse"], "matvec_spectra": _FWD,
    "matvec": _FWD + ["matvec_scaled", "inverse"],
}


def fourstep_entries(lib: str, op: str) -> list:
    """The kernels a four-step op launches: the column pass is the column
    entry points of nwc64.cu or gl64.cu (no transposes)."""
    col = {"forward": "forward_cols", "inverse": "inverse_cols"}
    return [f"{lib}_{col.get(e, e)}" for e in FOURSTEP_ENTRIES[op]]


def row_transforms(lib: str) -> list:
    """The row transforms a four-step's column pass must not launch."""
    return [f"{lib}_forward", f"{lib}_inverse"]


def operands(q: int, n: int, rows: int, rng: np.random.Generator, dtype=np.int64):
    """Random (rows, n) residues with boundary rows: a's rows 0-3 are all
    0, all 1, all q - 1 and [0, 1, q - 1] cycled; b holds the same rows in
    reverse order at 0-3 and again at 4-7, against random a rows."""
    a = rng.integers(0, q, size=(rows, n), dtype=np.int64)
    b = rng.integers(0, q, size=(rows, n), dtype=np.int64)
    edge = np.stack([np.zeros(n, np.int64), np.ones(n, np.int64),
                     np.full(n, q - 1, np.int64),
                     np.resize(np.array([0, 1, q - 1], np.int64), n)])
    a[:4] = edge[:rows]
    b[:4] = edge[::-1][:rows]
    b[4:8] = edge[:max(rows - 4, 0)]
    return a.astype(dtype), b.astype(dtype)


def gl_operands(n: int, rows: int, rng: np.random.Generator):
    """Random (rows, n) Goldilocks residues as int64 bit patterns, with
    boundary rows as in ``operands`` plus rows >= 2^63: a's rows 0-5 are all
    0, 1, q - 1, 2^63, 2^63 - 1 and those five cycled; b holds them in
    reverse order at 0-5 and again at 6-11."""
    q = GOLDILOCKS_Q
    a = rng.integers(0, q, size=(rows, n), dtype=np.uint64)
    b = rng.integers(0, q, size=(rows, n), dtype=np.uint64)
    ends = [0, 1, q - 1, 1 << 63, (1 << 63) - 1]
    edge = np.array([[v] * n for v in ends] + [np.resize(ends, n).tolist()],
                    dtype=np.uint64)
    k = min(len(edge), rows)
    a[:k] = edge[:k]
    b[:k] = edge[::-1][:k]
    b[k:2 * k] = edge[:min(k, rows - k)]
    return a.view(np.int64), b.view(np.int64)


def ints(t) -> list:
    """A tensor of residues -> nested lists of Python ints, a Goldilocks
    bit pattern >= 2^63 unwrapped."""
    x = np.ascontiguousarray(t.cpu().numpy())
    return (x.view(np.uint64) if x.dtype == np.int64 else x).tolist()


def canonical(t, q: int):
    """Whether every residue of t lies in [0, q); a Goldilocks residue is a
    64-bit pattern, in range as an int64 if >= 0 or below q - 2^64."""
    if q < 1 << 63:
        return bool(((t >= 0) & (t < q)).all())
    return bool(((t >= 0) | (t < q - (1 << 64))).all())


def horner(coeffs, x: int, q: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % q
    return acc


def check_evaluations(name: str, p, a_rows, b_rows, c_rows, rng) -> None:
    """c(x) == a(x) b(x) at x = psi^(2k+1), three k for each row."""
    for row, (av, bv, cv) in enumerate(zip(a_rows, b_rows, c_rows)):
        for k in rng.integers(0, p.n, size=3).tolist():
            x = pow(p.psi, 2 * k + 1, p.q)  # x^n = psi^(n(2k+1)) = -1
            if horner(cv, x, p.q) != horner(av, x, p.q) * horner(bv, x, p.q) % p.q:
                raise AssertionError(f"{name}: c(x) != a(x) b(x) at row {row}, k={k}")


def sass_listing(lib) -> dict:
    """Each kernel of a built library in ``cuobjdump -sass``: its name with
    its template arguments -> [(address, instruction)]."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    kernels, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : .*?\d+([a-z][a-z_]*_kernel)(?:I((?:L[ib]\d+E)+)E)?", line)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            name = f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)
            kernels[name] = []
        elif name and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)):
            kernels[name].append((int(m.group(1), 16), m.group(2).strip()))
    return kernels


def sass_loops(listing, whole: bool = False) -> list:
    """The loops of a kernel after its first barrier (``whole``: in all of
    it), in the address order of their backward branches: (first address,
    branch address, instructions)."""
    start = 0 if whole else next(i for i, (_, ins) in enumerate(listing)
                                 if ins.startswith("BAR.SYNC"))
    code = listing[start:]
    loops = [(int(m.group(1), 16), at) for at, ins in code
             if (m := re.search(r"\bBRA (0x[0-9a-f]+)", ins)) and int(m.group(1), 16) < at]
    return [(lo, hi, sum(lo <= at <= hi for at, _ in code)) for lo, hi in loops]


def issued_per_thread(listing, trips, whole: bool = False) -> int | None:
    """Instructions a thread issues after its block barrier (``whole``: from
    its first instruction), up to its last EXIT: each instruction once for
    every trip of each loop around it (a backward branch; ``trips[i]`` for
    the i-th in address order, so nested loops multiply); None where the
    loops are not as many as ``trips``."""
    start = 0 if whole else next(i for i, (_, ins) in enumerate(listing)
                                 if ins.startswith("BAR.SYNC"))
    end = max(i for i, (_, ins) in enumerate(listing) if "EXIT" in ins)
    code = listing[start:end + 1]
    loops = sass_loops(listing, whole)
    if len(loops) != len(trips):
        return None
    return sum(int(np.prod([t for (lo, hi, _), t in zip(loops, trips) if lo <= at <= hi]))
               for at, _ in code)


def issued_with_loop(listing, trips: int) -> tuple | None:
    """A fused dot's instructions, its one loop holding its first barrier:
    one trip's (the loop's first instruction to its backward branch), those
    after the loop up to the last EXIT, and what a thread issues after its
    first barrier in ``trips`` trips (every trip but the part of the first
    before the barrier, then the rest); None where the kernel has not one
    loop."""
    start = next(i for i, (_, ins) in enumerate(listing) if ins.startswith("BAR.SYNC"))
    end = max(i for i, (_, ins) in enumerate(listing) if "EXIT" in ins)
    loops = [(int(m.group(1), 16), at) for at, ins in listing
             if (m := re.search(r"\bBRA (0x[0-9a-f]+)", ins)) and int(m.group(1), 16) < at]
    if len(loops) != 1:
        return None
    lo, hi = loops[0]
    addresses = [at for at, _ in listing]
    trip = sum(lo <= at <= hi for at in addresses)
    before = sum(lo <= at <= hi for at in addresses[:start])
    rest = sum(at > hi for at in addresses[:end + 1])
    return trip, rest, trips * trip - before + rest


def ptxas_registers(log: str) -> dict:
    """The registers ptxas gave each kernel of a build log (``-Xptxas -v``):
    its mangled name from the kernel's own name on -> registers."""
    registers, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '\S*?\d+([a-z][a-z_]*_kernel\S*?)'", line):
            name = m.group(1)
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            registers[name] = int(m.group(1))
            name = None
    return registers


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from tpu_ntt_torch import dispatch, kyber, reference, stark
    from tpu_ntt_torch import poseidon as gl_poseidon
    from tpu_ntt_torch.benchlib import (device_seconds_per_call, graph_seconds_per_call,
                                        host_seconds_per_call)
    from tpu_ntt_torch import sharded
    from tpu_ntt_torch.bounds import (A2A_CARDS, DOT_TERMS, IMAD_PER_SM_CLOCK, KYBER_BATCH,
                                      KYBER_K, LARGE_ROWS, NVLINK_BYTES_PER_S,
                                      POSEIDON_BATCH, STARK_BLOWUP, STARK_COLS,
                                      STARK_DEGREE, STARK_QUERIES, a2a_card_work,
                                      a2a_work, fourstep_work, lde_work, poseidon_work,
                                      seconds, work)
    from tpu_ntt_torch.kernels import _build, a2a
    from tpu_ntt_torch.kernels import poseidon as kposeidon
    from tpu_ntt_torch.kernels.fourstep64 import FourStepPlan64
    from tpu_ntt_torch.kernels.gl64 import GoldilocksPlan64, GoldilocksSubPlan64
    from tpu_ntt_torch.kernels.kyber import KyberPlan
    from tpu_ntt_torch.kernels.mxu import MxuPlan
    from tpu_ntt_torch.kernels.mxu64 import MxuPlan64, SubPlan64
    from tpu_ntt_torch.kernels.sol64 import SolinasPlan64
    from tpu_ntt_torch.modmath import join64
    from tpu_ntt_torch.sharded import (KernelFourStep, column_fwd, column_inv,
                                       fourstep_nwc_poly_mult_kernel)
    from tpu_ntt_torch.params import (DILITHIUM_256, FALCON_1024, GOLDILOCKS_4096,
                                      P24_4096, P60_4096, make_params)

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    imad_per_s = sms * IMAD_PER_SM_CLOCK * sm_mhz * 1e6
    print(f"device: {kind}; count {torch.cuda.device_count()}; {sms} SMs, top SM "
          f"clock {sm_mhz:.0f} MHz, {imad_per_s:.4e} IMAD/s; nvidia-smi name, "
          "power.limit on the next line")
    print(card)

    # 2. build, one nvcc for each source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {name}: {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    ptxas: {line.strip()}")

    # poseidon.cu's kernels spill nothing; the unrolled width-8 permutation's
    # length in SASS (one permutation, its loads and stores)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        libs["poseidon"].with_suffix(".log").read_text())
    if not spills or any(int(st) or int(ld) for st, ld in spills):
        raise AssertionError(f"poseidon.cu spills registers: {spills}")
    print(f"build: poseidon.cu's {len(spills)} kernels spill nothing")
    listing = sass_listing(libs["poseidon"])
    for kernel, code in listing.items():
        print(f"  sass: poseidon.cu {kernel}: {len(code)} instructions")
    per_perm = issued_per_thread(listing["permute_kernel<8>"], (4, 22, 4))
    print(f"  sass: one width-8 permutation at rf = 8, rp = 22 (its loads and stores "
          f"with it): {per_perm or 'loops not recognised, not'} counted instructions")
    # nwc64.cu's radix-8 core at n = 4096, 512 threads a row: the
    # instructions a thread issues after its first barrier (the radix
    # kernels are unrolled); the row forward and the row inverse at n = 128
    # and 1024
    nwc_sass = sass_listing(libs["nwc64"])
    radix = [k for k in nwc_sass if k.startswith("transform_kernel<")]
    print(f"  sass: nwc64.cu's {len(radix)} radix-8 kernels, "
          f"{min(len(nwc_sass[k]) for k in radix)} to {max(len(nwc_sass[k]) for k in radix)} "
          "instructions each")
    for kernel, trips in (("transform_kernel<12, 0, 0>", ()), ("transform_kernel<12, 1, 0>", ()),
                          ("transform_kernel<8, 0, 1>", ()), ("transform_kernel<10, 0, 1>", ()),
                          ("product_kernel<12, 0>", ()), ("product_kernel<12, 1>", ()),
                          ("cyclic_scaled_kernel<7, 0>", ()), ("cyclic_scaled_kernel<10, 0>", ()),
                          ("cyclic_scaled_kernel<7, 1>", ()), ("forward_scaled_kernel<7>", ()),
                          ("forward_scaled_kernel<10>", ()), ("inverse_scaled_kernel<7>", ()),
                          ("inverse_scaled_kernel<10>", ())):
        code = nwc_sass[kernel]
        issued = issued_per_thread(code, trips)
        print(f"  sass: nwc64.cu {kernel}: {len(code)} instructions; after its first barrier "
              f"a thread issues {issued or 'not counted:'} "
              + ("" if issued else f"loops (first, branch, instructions) {sass_loops(code)}"))
    # the fused dot's row pass at p60_32768's n2 = 128 and the flat dot at
    # P60_4096's n = 4096, fresh: a step of the loop (one forward: b's or
    # a's of a term), the inverse and the store after it, and a thread's
    # count at K = 4 (2K steps)
    def print_dot(lib, listing, kernel, steps):
        code = listing[kernel]
        counted = issued_with_loop(code, steps)
        print(f"  sass: {lib}.cu {kernel}: {len(code)} instructions; "
              + (f"a step's trip {counted[0]}, after the steps {counted[1]}; at K = "
                 f"{DOT_TERMS} a thread issues {counted[2]} after its first barrier"
                 if counted else f"loops not one: {sass_loops(code)}"))

    for kernel in ("dot_scaled_kernel<7, 0, 1>", "dot_scaled_kernel<12, 0, 0>"):
        print_dot("nwc64", nwc_sass, kernel, 2 * DOT_TERMS)
    # the matvec at P60_4096 (n = 4096), its loop of l steps (a term's loads
    # and slot products) before its first barrier: a step's trip, what comes
    # after the loop, and a thread's whole count at l = 4 (the 4 x 4 matvec)
    code = nwc_sass["matvec_kernel<12>"]
    counted = issued_with_loop(code, DOT_TERMS)
    upto_exit = max(i for i, (_, ins) in enumerate(code) if "EXIT" in ins) + 1
    print(f"  sass: nwc64.cu matvec_kernel<12>: {len(code)} instructions; "
          + (f"a step's trip {counted[0]}, after the loop {counted[1]}; at l = {DOT_TERMS} a "
             f"thread issues {upto_exit + (DOT_TERMS - 1) * counted[0]} in all, "
             f"{issued_per_thread(code, ())} after its first barrier"
             if counted else f"loops not one: {sass_loops(code)}"))
    # gl64.cu's radix-8 core, counted the same way: the transforms, the flat
    # product fresh and cached at n = 4096, the row pass, the row forward and
    # the row inverse at n = 128 and 1024
    gl_sass = sass_listing(libs["gl64"])
    radix = [k for k in gl_sass if k.startswith("transform_kernel<")]
    print(f"  sass: gl64.cu's {len(radix)} radix-8 kernels, "
          f"{min(len(gl_sass[k]) for k in radix)} to {max(len(gl_sass[k]) for k in radix)} "
          "instructions each")
    for kernel, trips in (("transform_kernel<12, 0, 0>", ()), ("transform_kernel<12, 1, 0>", ()),
                          ("transform_kernel<8, 0, 1>", ()), ("transform_kernel<10, 1, 1>", ()),
                          ("cyclic_scaled_kernel<12, 0, 0>", ()),
                          ("cyclic_scaled_kernel<12, 1, 0>", ()),
                          ("cyclic_scaled_kernel<7, 0, 1>", ()),
                          ("cyclic_scaled_kernel<10, 0, 1>", ()),
                          ("cyclic_scaled_kernel<7, 1, 1>", ()), ("forward_scaled_kernel<7>", ()),
                          ("forward_scaled_kernel<10>", ()), ("inverse_scaled_kernel<7>", ()),
                          ("inverse_scaled_kernel<10>", ())):
        code = gl_sass[kernel]
        issued = issued_per_thread(code, trips)
        print(f"  sass: gl64.cu {kernel}: {len(code)} instructions; after its first barrier "
              f"a thread issues {issued or 'not counted:'} "
              + ("" if issued else f"loops (first, branch, instructions) {sass_loops(code)}"))
    # gl64.cu's flat dot on the radix-8 core at n = 4096, fresh (2K steps)
    # and cached (K), and its row-pass dot at n = 128, fresh, counted as
    # nwc64.cu's; nwc32.cu's radix-16 forward at n = 256, 4096 and 16384
    # and its fused product at n = 4096, fresh and cached (unrolled), and
    # their shared-memory accesses (the last pass's exchange as 16-byte
    # vectors); its fused dot at n = 4096, fresh and cached, as the others
    print_dot("gl64", gl_sass, "dot_kernel<12, 0, 0>", 2 * DOT_TERMS)
    print_dot("gl64", gl_sass, "dot_kernel<12, 1, 0>", DOT_TERMS)
    print_dot("gl64", gl_sass, "dot_kernel<7, 0, 1>", 2 * DOT_TERMS)
    # gl64.cu's matvec row pass at goldilocks_32768's n2 = 128, its loop of l
    # steps (a term's loads and slot products) before its first barrier, as
    # nwc64.cu's matvec
    code = gl_sass["radix_matvec_kernel<7>"]
    counted = issued_with_loop(code, DOT_TERMS)
    upto_exit = max(i for i, (_, ins) in enumerate(code) if "EXIT" in ins) + 1
    print(f"  sass: gl64.cu radix_matvec_kernel<7>: {len(code)} instructions; "
          + (f"a step's trip {counted[0]}, after the loop {counted[1]}; at l = {DOT_TERMS} a "
             f"thread issues {upto_exit + (DOT_TERMS - 1) * counted[0]} in all, "
             f"{issued_per_thread(code, ())} after its first barrier"
             if counted else f"loops not one: {sass_loops(code)}"))
    w32_sass = sass_listing(libs["nwc32"])
    print_dot("nwc32", w32_sass, "dot_kernel<12, 0>", 2 * DOT_TERMS)
    print_dot("nwc32", w32_sass, "dot_kernel<12, 1>", DOT_TERMS)

    def print_loops(lib, listing, kernel, trips, what):
        """A kernel whose loops each run ``trips`` steps: each loop's body
        (a step), the code before the first loop and after the last, and
        what a thread issues in all: the code outside the loops once, each
        loop's body trips times, or trips - 1 where the compiler peeled the
        first step into the code before the loop (that code then holds the
        step's global loads, two fewer at most); a step with two arms (the
        fresh kyber dot's: b's store or a's base case) counts both, so its
        count is an upper bound."""
        code = listing[kernel]
        end = max(i for i, (_, ins) in enumerate(code) if "EXIT" in ins)
        addresses = [at for at, _ in code[:end + 1]]
        loops = sass_loops(code, whole=True)

        def loads(lo, hi):
            return sum(lo <= at <= hi and ins.startswith("LDG") for at, ins in code)

        total, peeled, prev = 0, [], -1
        for lo, hi, body in loops:
            peeled.append(loads(prev + 1, lo - 1) >= loads(lo, hi) - 2)
            total += body * (trips - peeled[-1])
            prev = hi
        total += sum(not any(lo <= at <= hi for lo, hi, _ in loops) for at in addresses)
        barrier = any(ins.startswith("BAR.SYNC") for _, ins in code)
        print(f"  sass: {lib}.cu {kernel}: {len(code)} instructions; {len(loops)} loop(s), "
              f"a step {[body for *_, body in loops]} (first step peeled: {peeled}); before "
              f"the first {sum(at < loops[0][0] for at in addresses)}, after the last "
              f"{sum(at > loops[-1][1] for at in addresses)}; at {what} a thread issues "
              f"{total} in all"
              + (f", {issued_per_thread(code, ())} after its first barrier" if barrier else ""))

    # nwc32.cu's matvec at DILITHIUM_256's n = 256 (two loops of l steps,
    # one a half of a thread's words: a term's loads and multiply-adds, then
    # the REDCs, n^-1 and the inverse) and kyber.cu's dot, fresh (2K steps)
    # and cached (K) at ML-KEM-768's K = 3 (a step a forward and, for a's,
    # the base case; then the inverse)
    print_loops("nwc32", w32_sass, "radix_matvec_kernel<8>", DOT_TERMS, f"l = {DOT_TERMS}")
    kyber_sass = sass_listing(libs["kyber"])
    print_loops("kyber", kyber_sass, "dot_kernel<0>", 2 * KYBER_K, f"K = {KYBER_K} fresh")
    print_loops("kyber", kyber_sass, "dot_kernel<1>", KYBER_K, f"K = {KYBER_K} cached")
    for kernel in ("radix_forward_kernel<8>", "radix_forward_kernel<12>",
                   "radix_forward_kernel<14>", "radix_inverse_kernel<8>",
                   "radix_inverse_kernel<12>", "radix_inverse_kernel<14>",
                   "product_kernel<12, 0>", "product_kernel<12, 1>"):
        code = w32_sass[kernel]
        issued = issued_per_thread(code, ())
        shared = {op: sum(ins.startswith(op + " ") for _, ins in code)
                  for op in ("LDS", "LDS.128", "STS", "STS.128")}
        print(f"  sass: nwc32.cu {kernel}: {len(code)} instructions; after its first barrier "
              f"a thread issues {issued or 'not counted:'} "
              + ("" if issued else f"loops (first, branch, instructions) {sass_loops(code)}")
              + f"; shared-memory instructions {shared}")
    # the radix kernels of the three files spill nothing: 36 transforms (a
    # log n from 5 to 13, each direction and layout), 9 row forwards and 9
    # row inverses (a log n) in each 64-bit file, nwc64.cu's 18 fused
    # products (each log n, fresh and cached), 18 fused row passes, 36 fused
    # dots (the row passes' 18 and the flat dot's 18) and 9 matvecs,
    # gl64.cu's 36 fused products (the flat product's 18 and the row pass's
    # 18, fresh and cached), 36 fused dots (the flat dot's 18 and the row
    # pass's 18) and 9 matvec row passes, nwc32.cu's 7 radix-16 forwards
    # and 7 inverses (a log n from 8 to 14), 14 fused products and 14 fused
    # dots (each log n, fresh and cached) and 7 matvecs, and kyber.cu's 2
    # radix-16 dots (fresh and cached)
    for lib, kernels in (("nwc64", (("transform_kernel", 36), ("product_kernel", 18),
                                    ("cyclic_scaled_kernel", 18), ("forward_scaled_kernel", 9),
                                    ("inverse_scaled_kernel", 9), ("dot_scaled_kernel", 36),
                                    ("matvec_kernel", 9))),
                         ("gl64", (("transform_kernel", 36), ("cyclic_scaled_kernel", 36),
                                   ("forward_scaled_kernel", 9), ("inverse_scaled_kernel", 9),
                                   ("dot_kernel", 36), ("radix_matvec_kernel", 9))),
                         ("nwc32", (("radix_forward_kernel", 7), ("radix_inverse_kernel", 7),
                                    ("product_kernel", 14), ("dot_kernel", 14),
                                    ("radix_matvec_kernel", 7))),
                         ("kyber", (("dot_kernel", 2),))):
        log = libs[lib].with_suffix(".log").read_text()
        for kernel, count in kernels:
            spills = re.findall(rf"Function properties for \S*{kernel}I\S*\n[^\n]*?(\d+) "
                                r"bytes spill stores, (\d+) bytes spill loads", log)
            if len(spills) != count or any(int(st) or int(ld) for st, ld in spills):
                raise AssertionError(f"{lib}.cu's {kernel}s: {count} expected, none "
                                     f"spilling; ptxas says {spills}")
            print(f"build: {lib}.cu's {len(spills)} radix {kernel}s spill nothing")
    # the blocks an SM of nwc64.cu's and gl64.cu's flat dots, gl64.cu's
    # row-pass dot and its flat product: their registers (ptxas), their tiles
    # of shared memory (a dot three fresh, two cached; the product one, b's
    # spectrum waiting in the output row; of max(n, 1024) words) and the SM's 64 Ki
    # registers, 228 KiB (1 KiB reserved a block), 2048 threads and 32 blocks
    for lib, what, kernel, tiles, tail in (
            ("nwc64", "flat dot", "dot_scaled_kernel", (3, 2), "Lb0EE"),
            ("gl64", "flat dot", "dot_kernel", (3, 2), "Lb0EE"),
            ("gl64", "row-pass dot", "dot_kernel", (3, 2), "Lb1EE"),
            ("gl64", "flat product", "cyclic_scaled_kernel", (1, 1), "Lb0EE")):
        registers = ptxas_registers(libs[lib].with_suffix(".log").read_text())
        for log_n in range(5, 14):
            for cached in (0, 1):
                regs = next(v for k, v in registers.items()
                            if k.startswith(f"{kernel}ILi{log_n}ELb{cached}E{tail}"))
                threads = max(1 << log_n, 1024) // 8
                smem = tiles[cached] * max(1 << log_n, 1024) * 8
                by_regs = 65536 // (-(-regs // 8) * 8 * threads)
                by_smem = 233472 // (smem + 1024)
                print(f"build: {lib}.cu's {what} at n = {1 << log_n}"
                      f"{' cached' if cached else ''}: {regs} registers, {threads} threads and "
                      f"{smem // 1024} KiB a block: {min(by_regs, by_smem, 2048 // threads, 32)} "
                      f"blocks an SM (registers allow {by_regs}, shared memory {by_smem})")

    print(f"phase: build done at {time.perf_counter() - t_start:.1f} s (wall clock)")

    # 3. kernel vs plain version, bit for bit
    rng = np.random.default_rng(args.seed)
    errs: dict[str, int] = {}

    def compare(name: str, label: str, got, want) -> None:
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errs[name] = max(errs.get(name, 0), err)
        ok = torch.equal(got, want)
        print(f"kernel vs plain: {name} {label} shape {tuple(got.shape)} equal={ok} "
              f"max_abs_err={err}")
        if not ok:
            raise AssertionError(f"{name} differs from its plain version at {label}")
        return got

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in arrays]

    def check_op(plan, op: str, label: str, inputs):
        """One op of a plan, kernel against plain; returns the kernel's."""
        method = dispatch.METHODS[op]
        got = getattr(plan, method)(*inputs)
        kernel = f"{plan.lib_name}_{OP_ENTRIES[op][-1]}"
        compare(kernel, f"{op} {label}", got, getattr(plan, method + "_plain")(*inputs))
        return got

    def op_inputs(plan, a, b, a3, b3, s, mat):
        """Inputs of every op: (B, n) a and b, (K, B, n) a3 and b3, and the
        (l, B, n) s of the matvec against the (k, l, n) matrix mat; the
        spectra come from the kernels (each checked against its plain)."""
        return {
            "nwc": (a, b), "cyclic": (a, b), "fwd": (a,), "inv": (a,),
            "nwc_fwd": (a,), "nwc_inv": (a,), "spectrum": (b,),
            "cached": (a, plan.nwc_spectrum(b)), "dot": (a3, b3),
            "dot_cached": (a3, plan.nwc_spectrum(b3.reshape(-1, plan.p.n))
                           .reshape(b3.shape)),
            "matvec_spectra": (mat,), "matvec": (s, plan.nwc_matvec_spectra(mat)),
        }

    def family_operands(p, dtype, batch, dot_batch, mv_batch):
        def gen(rows):
            if p.q == GOLDILOCKS_Q:
                return gl_operands(p.n, rows, rng)
            return operands(p.q, p.n, rows, rng, dtype)

        a, b = on_card(*gen(batch))
        a3, b3 = (t.reshape(DOT_TERMS, dot_batch, p.n) for t in on_card(
            *gen(DOT_TERMS * dot_batch)))
        s_np, m_np = gen(4 * mv_batch)
        s, mat = on_card(s_np.reshape(4, mv_batch, p.n), m_np[:16].reshape(4, 4, p.n))
        return a, b, a3, b3, s, mat

    # the 60-bit family: every op at P60_4096 (SolinasPlan64) and at the
    # generic q (MxuPlan64), the product, forward, inverse and dot at the
    # ends of its n window
    p_gen = make_params(4096, Q_GENERIC, name="q576460752308273153_4096")
    plan60, plan_gen = SolinasPlan64(P60_4096, device), MxuPlan64(p_gen, device)
    inputs60 = op_inputs(plan60, *family_operands(
        P60_4096, np.int64, BATCH, DOT_BATCH, MATVEC_BATCH_60))
    inputs_gen = op_inputs(plan_gen, *family_operands(
        p_gen, np.int64, BATCH, DOT_BATCH, MATVEC_BATCH_60))
    out60, out_gen = {}, {}
    for plan, inputs, outs, label in (
            (plan60, inputs60, out60, "P60_4096"),
            (plan_gen, inputs_gen, out_gen, f"q={Q_GENERIC} n=4096")):
        for op, x in inputs.items():
            outs[op] = check_op(plan, op, label, x)
    for n in (256, 8192):
        p = make_params(n, P60_4096.q)
        plan = SolinasPlan64(p, device)
        x, y = on_card(*operands(p.q, n, BATCH, rng))
        for op in ("nwc", "nwc_fwd", "nwc_inv"):
            check_op(plan, op, f"n={n} B={BATCH}", (x, y) if op == "nwc" else (x,))
        if n == 8192:
            x3, y3 = (t.reshape(DOT_TERMS, DOT_BATCH_8192, n) for t in on_card(
                *operands(p.q, n, DOT_TERMS * DOT_BATCH_8192, rng)))
            check_op(plan, "dot", f"n=8192 K={DOT_TERMS} B={DOT_BATCH_8192}", (x3, y3))

    # the radix-8 cores: nwc64_forward and nwc64_inverse on rows and their
    # column entry points on every column of (R, n, width) matrices, at every
    # log n of the sub-plans' window, B in (1, 3, 2048) rows and widths in
    # COLUMN_WIDTHS, P60_4096's q, the generic q and the largest 62-bit q
    # (rows and columns of 0, 1 and q - 1 first); then gl64_forward,
    # gl64_inverse and their column twins at the Goldilocks q (rows and
    # columns of 0, 1, q - 1, 2^63 - 1, 2^63 and 2^64 - 2^32 first); cyclic
    # and merged tables, the forward at scale 1 and at 2^64 mod q (a 60-bit
    # spectrum's), the inverse at n^-1 and at 1: each against its plain
    # version (on columns, the transposes around it), bit for bit
    def radix_check(plan, entry, x, flat, want, scale, width=None):
        """One launch of a radix-8 core (``entry`` on rows, or its column
        twin with ``width``) against ``want``, the plain version at scale 1
        (forward) or n^-1 (inverse), times the scale."""
        n, log_n, q = plan.p.n, plan.p.log_n, plan.p.q
        factor = scale[0] if entry == "forward" else scale[0] * n % q
        if factor != 1:
            want = plan.ring.mul_tw(want, plan.ring.encode_tw([factor], device))
        out = torch.empty_like(x)
        name, shape = (f"{entry}_cols", (x.numel() // (n * width), log_n, width)) if width \
            else (entry, (x.shape[0], log_n))
        plan._launch(name, out, x, out, *plan._transform_table(flat), *shape,
                     *plan._q_args(False), *scale)
        torch.cuda.synchronize()
        name = f"{plan.lib_name}_{name}"
        errs[name] = max(errs.get(name, 0), int((out - want).abs().max()))
        if not torch.equal(out, want):
            raise AssertionError(f"{name} differs from its plain version at n={n} q={q} "
                                 f"scale={scale[0]} shape {tuple(x.shape)} width={width}")

    def card_operands(q, n, rows, gen):
        """(rows, n) residues drawn on the card, boundary rows first: 0, 1
        and q - 1, and for Goldilocks also 2^63 - 1, 2^63 and 2^64 - 2^32."""
        if q == GOLDILOCKS_Q:  # 64-bit patterns; the words >= q redrawn below 2^31
            x = torch.randint(-(1 << 63), (1 << 63) - 1, (rows, n), generator=gen,
                              device=device, dtype=torch.int64)
            x = torch.where((x < 0) & (x >= q - (1 << 64)), x & 0x7FFFFFFF, x)
            ends = [0, 1, q - 1, (1 << 63) - 1, 1 << 63, (1 << 64) - (1 << 32)]
        else:
            x = torch.randint(0, q, (rows, n), generator=gen, device=device, dtype=torch.int64)
            ends = [0, 1, q - 1]
        for k, v in enumerate(ends[:rows]):
            x[k] = v - (1 << 64) if v >= 1 << 63 else v
        return x

    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(args.seed)
    for q in (P60_4096.q, Q_GENERIC, Q62_MAX, GOLDILOCKS_Q):
        t_q = time.perf_counter()
        sub = GoldilocksSubPlan64 if q == GOLDILOCKS_Q else SubPlan64
        for log_n in range(5, 14):
            n = 1 << log_n
            plan = sub(make_params(n, q), device)
            rows = card_operands(q, n, BATCH, gen)
            mats = {w: card_operands(q, n * w, max(1, min(3, (1 << 22) // (n * w))), gen)
                    for w in COLUMN_WIDTHS}
            spectrum = plan._scale_args((1 << 64) % q)
            checks = 0
            for entry, flat, plain, scales in (
                    ("forward", plan.plan.merged_flat, plan.nwc_ntt_fwd_plain,
                     (plan._scale_one, spectrum)),
                    ("forward", plan.plan.cyclic_flat, plan.ntt_fwd_plain,
                     (plan._scale_one, spectrum)),
                    ("inverse", plan.plan.merged_inv_flat, plan.nwc_ntt_inv_plain,
                     (plan._scale_cached, plan._scale_one)),
                    ("inverse", plan.plan.cyclic_inv_flat, plan.ntt_inv_plain,
                     (plan._scale_cached, plan._scale_one))):
                wants = [(rows[:b], None, plain(rows[:b])) for b in (1, 3, BATCH)] + [
                    (x, w, plan._cols_plain(plain, x, w, None)) for w, x in mats.items()]
                for scale in scales:
                    for x, width, want in wants:
                        radix_check(plan, entry, x, flat, want, scale, width)
                        checks += 1
            print(f"kernel vs plain: {plan.lib_name}_forward, {plan.lib_name}_inverse and their "
                  f"column entry points at n={n} q={q}: {checks} launches equal (rows B = 1, 3, "
                  f"{BATCH}; widths {COLUMN_WIDTHS}, up to 3 matrices of 2^22 words in all)")
        print(f"kernel vs plain: the radix-8 core at q={q} checked in "
              f"{time.perf_counter() - t_q:.1f} s")
    print(f"kernel vs plain: the radix-8 cores checked in {time.perf_counter() - t0:.1f} s")

    # the products fused on the radix-8 cores: nwc64_product and nwc64_cached
    # at the three 60-bit q, gl64_product and gl64_cached at the Goldilocks
    # q; the four-step's row passes, nwc64_cyclic_scaled and
    # nwc64_cached_scaled there, gl64_cyclic_scaled and gl64_cached_scaled
    # at the Goldilocks q, with random pre and post tables at period 1, 3
    # and p60_32768's and goldilocks_32768's n1 = 256; cyclic tables (the
    # four-step's) at every log n of the sub-plans' window, merged ones (the
    # same kernels on other tables) at n = 4096 alone (the Goldilocks flat
    # products at every n: K2's own tables), B = 1, 3 and 2048 rows,
    # boundary rows first (b's reversed against a's); and nwc64_dot_scaled,
    # fresh and cached, at K = 1 (the row pass's rows, no plain dot) and
    # K = 4 at the last period of B = 1 and 3, and at B = 2048 at
    # p60_32768's n2 = 128 alone (the plain dot's cost); the row forwards
    # nwc64_forward_scaled at scale 1 and 2^64 mod q and gl64_forward_scaled
    # at scale 1 and q - 1 on the same tables; the flat dot nwc64_dot on
    # merged tables, fresh and cached, at
    # K = 1, and K = 4 at B = 1 and 3 (at B = 2048 at n = 128 alone, as the
    # row pass's dot: the plain dot's cost); each launch against its plain
    # version, bit for bit
    def shoup_table(w, q):
        """(w, floor(w 2^64 / q)) of canonical words on their device, by 64
        steps of long division (remainders below 2q < 2^63)."""
        r, halves = w.clone(), []
        for _ in range(2):
            h = torch.zeros_like(w)
            for _ in range(32):
                r = r * 2
                bit = r >= q
                r = torch.where(bit, r - q, r)
                h = h * 2 + bit.long()
            halves.append(h)
        return w, join64(tuple(halves))

    def fused_check(plan, entry, label, want, operands, tables, *args):
        out = torch.empty_like(want)
        plan._launch(entry, out, *operands, out,
                     *(w for t in tables for w in plan._table_of(entry, t)), *args)
        torch.cuda.synchronize()
        name = f"{plan.lib_name}_{entry}"
        errs[name] = max(errs.get(name, 0), int((out - want).abs().max()))
        if not torch.equal(out, want):
            raise AssertionError(f"{name} differs from its plain version at {label}")

    t0 = time.perf_counter()
    for q in (P60_4096.q, Q_GENERIC, Q62_MAX, GOLDILOCKS_Q):
        t_q, checks = time.perf_counter(), 0
        gl = q == GOLDILOCKS_Q
        for log_n in range(5, 14):
            n = 1 << log_n
            plan = (GoldilocksSubPlan64 if gl else SubPlan64)(make_params(n, q), device)
            a, b = card_operands(q, n, BATCH, gen), card_operands(q, n, BATCH, gen)
            ends = 6 if gl else 3  # the boundary rows
            b[:ends] = b[:ends].flip(0).clone()
            layouts = {"merged": (plan.plan.merged_flat, plan.plan.merged_inv_flat,
                                  plan.nwc_ntt_fwd_plain, plan.nwc_poly_mult_plain),
                       "cyclic": (plan.plan.cyclic_flat, plan.plan.cyclic_inv_flat,
                                  plan.ntt_fwd_plain, plan.cyclic_poly_mult_plain)}
            if log_n != 12 and not gl:
                del layouts["merged"]
            for rows in (1, 3, BATCH):
                x, y = a[:rows], b[:rows].contiguous()
                for layout, (tw, itw, fwd, product) in layouts.items():
                    label = f"n={n} q={q} B={rows} {layout} tables"
                    want = product(x, y)
                    spectrum = plan.ring.mul_tw(fwd(y), plan._r_tw)  # times 2^64 mod q
                    fused_check(plan, "product", label, want, (x, y), (tw, itw), rows,
                                log_n, *plan._q_args(True), *plan._scale_fresh)
                    fused_check(plan, "cached", label, want, (x, spectrum), (tw, itw), rows,
                                log_n, *plan._q_args(True), *plan._scale_cached)
                    checks += 2
                    if layout == "merged":  # the row passes: the four-step's tables
                        continue
                    # the 60-bit row passes at B = 2048 at period 256 alone: period 1
                    # and 3 are B = 1's and 3's
                    periods = {1: (1,), 3: (1, 3)}.get(rows, (1, 256) if gl else (256,))
                    for period in periods:
                        pre, post = (card_operands(q, n, period + ends, gen)[ends:]
                                     for _ in range(2))  # random rows, past the boundary
                        pre, post = ((pre,), (post,)) if gl else (shoup_table(pre, q),
                                                                  shoup_table(post, q))
                        want = plan._rows_times(product(plan._rows_times(x, pre),
                                                        plan._rows_times(y, pre)), post)
                        # the row forward, then times 2^64 mod q (the cached spectrum's
                        # domain) or, for Goldilocks, whose r is 1, times q - 1
                        fwd_y = fwd(plan._rows_times(y, pre))
                        spectrum = plan.ring.mul_tw(fwd_y, plan._r_tw)
                        other = q - 1 if gl else plan._scale_spectrum[0]
                        for scale in (1, other):
                            z = fwd_y if scale == 1 else plan.ring.mul_tw(
                                fwd_y, plan.ring.encode_tw([scale], device))
                            fused_check(plan, "forward_scaled",
                                        f"{label} period {period} scale {scale}", z, (y,),
                                        (tw,), *pre, period, rows, log_n,
                                        *plan._q_args(False), *plan._scale_args(scale))
                        checks += 2
                        for entry, z, scale in (("cyclic_scaled", y, plan._scale_fresh),
                                                ("cached_scaled", spectrum, plan._scale_cached)):
                            fused_check(plan, entry, f"{label} period {period}", want, (x, z),
                                        (tw, itw), *pre, *post, period, rows, log_n,
                                        *plan._q_args(True), *scale)
                        checks += 2
                        if gl:
                            continue
                        terms = [(x[None], y[None], spectrum[None], want)]
                        if period == periods[-1] and (rows < BATCH or log_n == 7):
                            x4, y4 = (card_operands(q, n, DOT_TERMS * rows, gen)
                                      .reshape(DOT_TERMS, rows, n) for _ in range(2))
                            s4 = plan.ntt_fwd_scaled_plain(y4.reshape(-1, n), pre, True)
                            terms.append((x4, y4, s4.reshape(y4.shape),
                                          plan.dot_scaled_plain(x4, y4, pre, post)))
                        for x3, y3, s3, want3 in terms:
                            for z, cached, scale in ((y3, 0, plan._scale_fresh),
                                                     (s3, 1, plan._scale_cached)):
                                fused_check(plan, "dot_scaled",
                                            f"{label} period {period} K={x3.shape[0]}"
                                            + (" cached" if cached else ""), want3, (x3, z),
                                            (tw, itw), *pre, *post, period, x3.shape[0], rows,
                                            log_n, *plan._q_args(True), *scale, cached)
                                checks += 1
                if gl:
                    continue
                tw, itw = plan.plan.merged_flat, plan.plan.merged_inv_flat  # the flat dot
                for terms in (1, DOT_TERMS) if rows < BATCH or log_n == 7 else (1,):
                    x3, y3 = ((x[None], y[None]) if terms == 1 else
                              (card_operands(q, n, terms * rows, gen).reshape(terms, rows, n)
                               for _ in range(2)))
                    s3 = plan.nwc_spectrum_plain(y3.reshape(-1, n)).reshape(y3.shape)
                    for z, cached, want3, scale in (
                            (y3, 0, plan.nwc_dot_plain(x3, y3), plan._scale_fresh),
                            (s3, 1, plan.nwc_dot_cached_plain(x3, s3), plan._scale_cached)):
                        fused_check(plan, "dot", f"n={n} q={q} B={rows} K={terms}"
                                    + (" cached" if cached else ""), want3, (x3, z), (tw, itw),
                                    terms, rows, log_n, *plan._q_args(True), *scale, cached)
                        checks += 1
        print(f"kernel vs plain: the fused products at q={q} ("
              + ("gl64_product, gl64_cached, gl64_cyclic_scaled, gl64_cached_scaled, "
                 "gl64_forward_scaled" if gl else
                 "nwc64_product, nwc64_cached, nwc64_cyclic_scaled, nwc64_cached_scaled, "
                 "nwc64_dot_scaled, nwc64_forward_scaled, nwc64_dot")
              + f"), n = 32 to 8192: {checks} launches equal in "
              f"{time.perf_counter() - t_q:.1f} s")
    print(f"kernel vs plain: the fused products checked in {time.perf_counter() - t0:.1f} s")

    def silent_check(name: str, label: str, got, want) -> None:
        torch.cuda.synchronize()
        errs[name] = max(errs.get(name, 0), int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version at {label}")

    # gl64_dot on gl64.cu's radix-8 core: fresh and cached, K = 1 and 4, at
    # every log n of the sub-plans' window, B = 1, 3 and DOT_BATCH, and the
    # K = 4 loop at B = 2048 at n = 4096; boundary rows first (b's reversed)
    t0, checks = time.perf_counter(), 0
    for log_n in range(5, 14):
        n = 1 << log_n
        plan = GoldilocksSubPlan64(make_params(n, GOLDILOCKS_Q), device)
        shapes = [(terms, rows) for terms in (1, DOT_TERMS) for rows in (1, 3, DOT_BATCH)]
        for terms, rows in shapes + ([(DOT_TERMS, BATCH)] if n == 4096 else []):
            x3, y3 = (card_operands(GOLDILOCKS_Q, n, terms * rows, gen).reshape(terms, rows, n)
                      for _ in range(2))
            y3 = y3.flip(1).contiguous()
            s3 = plan.nwc_spectrum_plain(y3.reshape(-1, n)).reshape(y3.shape)
            label = f"n={n} K={terms} B={rows}"
            silent_check("gl64_dot", label, plan.nwc_dot(x3, y3), plan.nwc_dot_plain(x3, y3))
            silent_check("gl64_dot", label + " cached", plan.nwc_dot_cached(x3, s3),
                         plan.nwc_dot_cached_plain(x3, s3))
            checks += 2
    print(f"kernel vs plain: gl64_dot, fresh and cached, K = 1 and {DOT_TERMS}, n = 32 to 8192, "
          f"B = 1, 3, {DOT_BATCH} (and {BATCH} at n = 4096, K = {DOT_TERMS}): {checks} launches "
          f"equal in {time.perf_counter() - t0:.1f} s")

    # gl64_dot_scaled, the dot's row pass on the same loop with the scales:
    # fresh and cached, K = 1 and 4, at every log n at B = 1 (period 1) and
    # 3 (periods 1 and 3), the K = 4 loop at B = 2048 at n = 128 (period
    # 256, goldilocks_32768's rows) and 1024 (period 1024, 2^20's) and at
    # B = 264 at n = 8192 (period 3); random pre and post tables, boundary
    # rows first (b's reversed)
    t0, checks = time.perf_counter(), 0
    for log_n in range(5, 14):
        n = 1 << log_n
        plan = GoldilocksSubPlan64(make_params(n, GOLDILOCKS_Q), device)
        shapes = [(terms, rows, period) for terms in (1, DOT_TERMS)
                  for rows, period in ((1, 1), (3, 1), (3, 3))]
        shapes += {7: [(DOT_TERMS, BATCH, 256)], 10: [(DOT_TERMS, BATCH, 1024)],
                   13: [(DOT_TERMS, 264, 3)]}.get(log_n, [])
        for terms, rows, period in shapes:
            x3, y3 = (card_operands(GOLDILOCKS_Q, n, terms * rows, gen).reshape(terms, rows, n)
                      for _ in range(2))
            y3 = y3.flip(1).contiguous()
            pre, post = ((card_operands(GOLDILOCKS_Q, n, period + 6, gen)[6:],)
                         for _ in range(2))  # random rows, past the boundary
            s3 = plan.ntt_fwd_scaled_plain(y3.reshape(-1, n), pre, True).reshape(y3.shape)
            label = f"n={n} K={terms} B={rows} period {period}"
            silent_check("gl64_dot_scaled", label, plan.dot_scaled(x3, y3, pre, post),
                         plan.dot_scaled_plain(x3, y3, pre, post))
            silent_check("gl64_dot_scaled", label + " cached",
                         plan.dot_scaled(x3, s3, pre, post, True),
                         plan.dot_scaled_plain(x3, s3, pre, post, True))
            checks += 2
    print(f"kernel vs plain: gl64_dot_scaled, fresh and cached, K = 1 and {DOT_TERMS}, n = 32 to "
          f"8192, B = 1 and 3 at periods 1 and 3, K = {DOT_TERMS} at B = {BATCH} at n = 128 and "
          f"1024 and at B = 264 at n = 8192: {checks} launches equal in "
          f"{time.perf_counter() - t0:.1f} s")

    # the row inverses on the radix-8 cores: nwc64_inverse_scaled at the
    # three 60-bit q and gl64_inverse_scaled at the Goldilocks q, every log
    # n, B = 1, 3 and 2048 rows (boundary rows first) taken as bit-reversed
    # spectra, random post tables at period 1 and 3 (1 and 256 at B =
    # 2048), cyclic per-pass tables, n^-1
    t0, checks = time.perf_counter(), 0
    for q in (P60_4096.q, Q_GENERIC, Q62_MAX, GOLDILOCKS_Q):
        gl = q == GOLDILOCKS_Q
        ends = 6 if gl else 3  # the boundary rows
        for log_n in range(5, 14):
            n = 1 << log_n
            plan = (GoldilocksSubPlan64 if gl else SubPlan64)(make_params(n, q), device)
            x = card_operands(q, n, BATCH, gen)
            for rows, periods in ((1, (1,)), (3, (1, 3)), (BATCH, (1, 256))):
                for period in periods:
                    post = card_operands(q, n, period + ends, gen)[ends:]  # random rows
                    post = (post,) if gl else shoup_table(post, q)
                    fused_check(plan, "inverse_scaled", f"n={n} q={q} B={rows} period {period}",
                                plan.ntt_inv_scaled_plain(x[:rows], post), (x[:rows],),
                                (plan.plan.cyclic_inv_flat,), *post, period, rows, log_n,
                                *plan._q_args(False), *plan._scale_cached)
                    checks += 1
    print(f"kernel vs plain: nwc64_inverse_scaled at three q and gl64_inverse_scaled, n = 32 to "
          f"8192, B = 1, 3, {BATCH}, periods 1, 3 and 256: {checks} launches equal in "
          f"{time.perf_counter() - t0:.1f} s")

    # nwc64_matvec alone, the matvec's accumulate-and-inverse on nwc64.cu's
    # radix-8 core, on the spectra of s that nwc64_forward makes, against the
    # plain matvec of s (its own forward): at the three 60-bit q, n = 256 to
    # 8192, (k, l) = (1, 1), (4, 4), (8, 8) and (3, 5), B = 1, 3 and
    # MATVEC_BATCH_60 (the first B rows of s: out's batch row r reads s's row
    # r alone, so one plain matvec serves the three); s's rows 0, 1 and
    # q - 1 first, A's first row all q - 1
    t0, checks = time.perf_counter(), 0
    for q in (P60_4096.q, Q_GENERIC, Q62_MAX):
        for log_n in range(8, 14):
            n = 1 << log_n
            plan = MxuPlan64(make_params(n, q), device)
            for k, l in ((1, 1), (4, 4), (8, 8), (3, 5)):
                spectra = plan.nwc_matvec_spectra_plain(
                    card_operands(q, n, k * l + 2, gen)[2:].reshape(k, l, n))
                s_mv = card_operands(q, n, l * MATVEC_BATCH_60, gen).reshape(l, -1, n)
                want = plan.nwc_matvec_cached_plain(s_mv, spectra)
                for rows in (1, 3, MATVEC_BATCH_60):
                    s_rows = s_mv[:, :rows].contiguous()
                    fs_mv = plan.nwc_ntt_fwd(s_rows.reshape(-1, n)).reshape(s_rows.shape)
                    silent_check("nwc64_matvec", f"n={n} q={q} {k} x {l} B={rows}",
                                 plan._matvec(fs_mv, spectra), want[:, :rows])
                    checks += 1
    print(f"kernel vs plain: nwc64_matvec alone at three q, n = 256 to 8192, (k, l) = (1, 1), "
          f"(4, 4), (8, 8), (3, 5), B = 1, 3, {MATVEC_BATCH_60}: {checks} launches equal in "
          f"{time.perf_counter() - t0:.1f} s")

    # gl64_matvec_scaled, the Goldilocks four-step's matvec row pass on
    # gl64.cu's radix-8 core, alone: every log n, (k, l) = (1, 1), (4, 4),
    # (8, 8) and (3, 5), B = 1, 3 and MATVEC_BATCH_60 rows of s (periods 1
    # and 3, and 1 and 256 at the last), S's and A's first words 0, 1, q - 1,
    # 2^63 - 1, 2^63 and 2^64 - 2^32, random post tables; against the plain
    # row pass
    def boundary_words(x):
        """x with its first six words the boundary words."""
        x.view(-1)[:6] = card_operands(GOLDILOCKS_Q, 1, 6, gen).view(-1)
        return x

    t0, checks = time.perf_counter(), 0
    for log_n in range(5, 14):
        n = 1 << log_n
        plan = GoldilocksSubPlan64(make_params(n, GOLDILOCKS_Q), device)
        for k, l in ((1, 1), (4, 4), (8, 8), (3, 5)):
            for rows, periods in ((1, (1,)), (3, (1, 3)), (MATVEC_BATCH_60, (1, 256))):
                for period in periods:
                    s_mv = boundary_words(card_operands(GOLDILOCKS_Q, n, l * rows, gen)
                                          .reshape(l, rows, n))
                    mat = boundary_words(card_operands(GOLDILOCKS_Q, n, k * l * period, gen)
                                         .reshape(k, l, period, n))
                    post = (card_operands(GOLDILOCKS_Q, n, period + 6, gen)[6:],)  # random rows
                    silent_check("gl64_matvec_scaled", f"n={n} {k} x {l} B={rows} period {period}",
                                 plan.matvec_scaled(s_mv, mat, post),
                                 plan.matvec_scaled_plain(s_mv, mat, post))
                    checks += 1
    print(f"kernel vs plain: gl64_matvec_scaled alone, n = 32 to 8192, (k, l) = (1, 1), (4, 4), "
          f"(8, 8), (3, 5), B = 1, 3, {MATVEC_BATCH_60}, periods 1, 3 and 256: {checks} launches "
          f"equal in {time.perf_counter() - t0:.1f} s")

    # nwc32_forward on nwc32.cu's radix-16 core: n = 256 to 16384 at
    # q = 16580609, to 4096 at P24_4096's and DILITHIUM_256's q = 8380417
    # and to 2048 at FALCON's q = 12289; B = 1, 3 and 2048, boundary rows
    # first; merged and cyclic tables, scale 1 and 2^32 mod q (a cached
    # spectrum's domain)
    t0, checks = time.perf_counter(), 0
    for q in (8380417, 16580609, 12289):
        for log_n in range(8, 15):
            n = 1 << log_n
            if (q - 1) % (2 * n):
                continue
            plan = MxuPlan(make_params(n, q), device)
            x = card_operands(q, n, BATCH, gen).to(torch.int32)
            for flat, plain in ((plan.plan.merged_flat, plan.nwc_ntt_fwd_plain),
                                (plan.plan.cyclic_flat, plan.ntt_fwd_plain)):
                for rows in (1, 3, BATCH):
                    want = plain(x[:rows])
                    for scale in (plan._scale_one, plan._scale_spectrum):
                        if scale[0] != 1:
                            want = plan.ring.mul_tw(want, plan._r_tw)
                        out = torch.empty_like(x[:rows])
                        plan._launch("forward", out, x[:rows], out,
                                     *plan._table_of("forward", flat), rows, log_n,
                                     *plan._q_args(False), *scale)
                        silent_check("nwc32_forward", f"n={n} q={q} B={rows} scale {scale[0]}",
                                     out, want)
                        checks += 1
    print(f"kernel vs plain: nwc32_forward, merged and cyclic tables, scale 1 and 2^32 mod q, "
          f"n = 256 to 16384, q = 8380417, 16580609, 12289, B = 1, 3, {BATCH}: {checks} "
          f"launches equal in {time.perf_counter() - t0:.1f} s")

    # nwc32_inverse on the radix-16 core at the forward's n and q, B = 1, 3
    # and 2048 bit-reversed spectra (boundary rows first), merged and cyclic
    # tables, scale n^-1 and 1
    t0, checks = time.perf_counter(), 0
    for q in (8380417, 16580609, 12289):
        for log_n in range(8, 15):
            n = 1 << log_n
            if (q - 1) % (2 * n):
                continue
            plan = MxuPlan(make_params(n, q), device)
            x = card_operands(q, n, BATCH, gen).to(torch.int32)
            for flat, plain in ((plan.plan.merged_inv_flat, plan.nwc_ntt_inv_plain),
                                (plan.plan.cyclic_inv_flat, plan.ntt_inv_plain)):
                for rows in (1, 3, BATCH):
                    want = plain(x[:rows])
                    for scale in (plan._scale_cached, plan._scale_one):
                        if scale[0] == 1:  # the plain inverse times n
                            want = plan.ring.mul_tw(want, plan.ring.encode_tw([n], device))
                        out = torch.empty_like(x[:rows])
                        plan._launch("inverse", out, x[:rows], out,
                                     *plan._table_of("inverse", flat), rows, log_n,
                                     *plan._q_args(False), *scale)
                        silent_check("nwc32_inverse", f"n={n} q={q} B={rows} scale {scale[0]}",
                                     out, want)
                        checks += 1
    print(f"kernel vs plain: nwc32_inverse, merged and cyclic tables, scale n^-1 and 1, "
          f"n = 256 to 16384, q = 8380417, 16580609, 12289, B = 1, 3, {BATCH}: {checks} "
          f"launches equal in {time.perf_counter() - t0:.1f} s")

    # nwc32_product, nwc32_cached and nwc32_dot fused on the radix-16 core,
    # at the forward's n and q: the negacyclic and cyclic products (merged
    # and cyclic tables) and the product against a cached spectrum at B = 1,
    # 3 and 2048, the dot fresh and cached at K = 1, 4 and 8, B = 1, 3 and
    # DOT_BATCH; boundary rows first, b's reversed against a's
    t0, checks = time.perf_counter(), 0
    for q in (8380417, 16580609, 12289):
        for log_n in range(8, 15):
            n = 1 << log_n
            if (q - 1) % (2 * n):
                continue
            plan = MxuPlan(make_params(n, q), device)
            a, b = (card_operands(q, n, BATCH, gen).to(torch.int32) for _ in range(2))
            b[:3] = b[:3].flip(0).clone()
            for rows in (1, 3, BATCH):
                x, y = a[:rows], b[:rows].contiguous()
                spectrum = plan.nwc_spectrum_plain(y)
                label = f"n={n} q={q} B={rows}"
                for method in ("nwc_poly_mult", "cyclic_poly_mult"):
                    silent_check("nwc32_product", f"{method} {label}", getattr(plan, method)(x, y),
                                 getattr(plan, method + "_plain")(x, y))
                silent_check("nwc32_cached", label, plan.nwc_poly_mult_cached(x, spectrum),
                             plan.nwc_poly_mult_cached_plain(x, spectrum))
                checks += 3
            for terms in (1, DOT_TERMS, 8):
                for rows in (1, 3, DOT_BATCH):
                    x3, y3 = (card_operands(q, n, terms * rows, gen).to(torch.int32)
                              .reshape(terms, rows, n) for _ in range(2))
                    y3 = y3.flip(1).contiguous()
                    s3 = plan.nwc_spectrum_plain(y3.reshape(-1, n)).reshape(y3.shape)
                    label = f"n={n} q={q} K={terms} B={rows}"
                    silent_check("nwc32_dot", label, plan.nwc_dot(x3, y3),
                                 plan.nwc_dot_plain(x3, y3))
                    silent_check("nwc32_dot", label + " cached", plan.nwc_dot_cached(x3, s3),
                                 plan.nwc_dot_cached_plain(x3, s3))
                    checks += 2
    print(f"kernel vs plain: nwc32_product (negacyclic and cyclic), nwc32_cached at B = 1, 3, "
          f"{BATCH}, nwc32_dot fresh and cached at K = 1, {DOT_TERMS}, 8, B = 1, 3, {DOT_BATCH}, "
          f"n = 256 to 16384, q = 8380417, 16580609, 12289: {checks} launches equal in "
          f"{time.perf_counter() - t0:.1f} s")

    # nwc32_matvec alone, the matvec's accumulate-and-inverse on the
    # radix-16 core, on the spectra of s that nwc32_forward makes, against
    # the plain matvec of s (its own forward): at the forward's n and q,
    # (k, l) = (1, 1), (4, 4), (8, 8) and (3, 5), B = 1, 3 and 37 (k B output
    # rows not a multiple of the tile but at k = 8: out's batch row r reads
    # s's row r alone, so one plain matvec serves the three); s's rows 0, 1
    # and q - 1 first, A's first row all q - 1
    t0, checks = time.perf_counter(), 0
    for q in (8380417, 16580609, 12289):
        for log_n in range(8, 15):
            n = 1 << log_n
            if (q - 1) % (2 * n):
                continue
            plan = MxuPlan(make_params(n, q), device)
            for k, l in ((1, 1), (4, 4), (8, 8), (3, 5)):
                mat = card_operands(q, n, k * l + 2, gen)[2:].reshape(k, l, n)
                mat[0, 0] = q - 1
                spectra = plan.nwc_matvec_spectra_plain(mat.to(torch.int32))
                s_mv = card_operands(q, n, l * 37, gen).to(torch.int32).reshape(l, -1, n)
                want = plan.nwc_matvec_cached_plain(s_mv, spectra)
                for rows in (1, 3, 37):
                    s_rows = s_mv[:, :rows].contiguous()
                    fs_mv = plan.nwc_ntt_fwd(s_rows.reshape(-1, n)).reshape(s_rows.shape)
                    silent_check("nwc32_matvec", f"n={n} q={q} {k} x {l} B={rows}",
                                 plan._matvec(fs_mv, spectra), want[:, :rows])
                    checks += 1
    print(f"kernel vs plain: nwc32_matvec alone, n = 256 to 16384, q = 8380417, 16580609, "
          f"12289, (k, l) = (1, 1), (4, 4), (8, 8), (3, 5), B = 1, 3, 37: {checks} launches "
          f"equal in {time.perf_counter() - t0:.1f} s")

    # K1a's large-n bodies, and K2's: the four-step at bench.py's p60_32768,
    # B = 256, p60_1048576, B = 4, and the Goldilocks rows of the same shapes
    # (bounds.LARGE_ROWS); its row kernels and column passes against their
    # plain versions at the shapes its product gives them, after the plan
    # and the mid tables are built; then the dot's and the matvec's row
    # kernels at K = 4 and 4 x 4; the product at n = 16384 (128 x 128
    # points) and at the least sub-sizes against its plain chain
    large = {}
    for name, n, q, batch in LARGE_ROWS:
        p = make_params(n, q, name=name)
        t0 = time.perf_counter()
        plan = FourStepPlan64(p, device)
        fs = plan.fs
        lib = fs.row_k.lib_name
        mids = (fs.kmid_nwc, fs.kmid_inv_nwc, fs.kmid, fs.kmid_inv)
        torch.cuda.synchronize()
        print(f"tables: {name} FourStepPlan64 ({fs.n1} x {fs.n2}) and its {len(mids)} "
              f"mid tables in {time.perf_counter() - t0:.3f} s (host clock)")

        def gen(rows, n=n, q=q):
            if q == GOLDILOCKS_Q:
                return gl_operands(n, rows, rng)
            return operands(q, n, rows, rng)

        a_l, b_l = on_card(*gen(batch))
        # the column pass: on the column-tile kernels of nwc64.cu or gl64.cu,
        # held to the transposes around the plain transform
        label = f"{name} column pass of a and b ({2 * batch * fs.n2} columns of {fs.n1})"
        m = compare(f"{lib}_forward_cols", label, column_fwd(fs, True, False, a_l, b_l),
                    column_fwd(fs, True, True, a_l, b_l))
        ma, mb = m.chunk(2)
        rk, pre, post = fs.row_k, fs.kmid_nwc, fs.kmid_inv_nwc
        label = f"{name} rows ({ma.shape[0]} of {fs.n2}, period {fs.n1})"
        c_rows = compare(f"{lib}_cyclic_scaled", label,
                         rk.cyclic_poly_mult_scaled(ma, mb, pre, post),
                         rk.cyclic_poly_mult_scaled_plain(ma, mb, pre, post))
        for cacheable in (False, True):
            compare(f"{lib}_forward_scaled", label + (" cacheable" if cacheable else ""),
                    rk.ntt_fwd_scaled(ma, pre, cacheable),
                    rk.ntt_fwd_scaled_plain(ma, pre, cacheable))
        compare(f"{lib}_inverse_scaled", label, rk.ntt_inv_scaled(ma, post),
                rk.ntt_inv_scaled_plain(ma, post))
        spec_rows = rk.ntt_fwd_scaled(mb, pre, True)  # the row half of nwc_spectrum(b)
        compare(f"{lib}_cached_scaled", label,
                rk.cyclic_poly_mult_cached_scaled(ma, spec_rows, pre, post),
                rk.cyclic_poly_mult_cached_scaled_plain(ma, spec_rows, pre, post))
        c_l = compare(f"{lib}_inverse_cols",
                      f"{name} inverse column pass ({batch * fs.n2} columns of {fs.n1})",
                      column_inv(fs, c_rows, True, False), column_inv(fs, c_rows, True, True))
        large[name] = {"p": p, "plan": plan, "lib": lib, "a": a_l, "b": b_l, "c": c_l,
                       "ma": ma, "mb": mb, "c_rows": c_rows, "spec_rows": spec_rows}
        if name == "p60_1048576":
            continue
        # the dot's and the matvec's row kernels at K = 4 and 4 x 4, B =
        # FOURSTEP_DOT_BATCH (4 at 2^20), as the main path below calls them
        run, batch = large[name], min(FOURSTEP_DOT_BATCH, batch)
        a3_l, b3_l = (t.reshape(DOT_TERMS, batch, n) for t in on_card(
            *gen(DOT_TERMS * batch)))
        mat_l = a3_l.reshape(-1, n)[:16].reshape(4, 4, n)  # a 4 x 4 matrix of rows
        rows_d = batch * fs.n1
        m3 = column_fwd(fs, True, False, a3_l.reshape(-1, n), b3_l.reshape(-1, n))
        ma3, mb3 = m3.reshape(2, DOT_TERMS, rows_d, fs.n2)
        spec3 = rk.ntt_fwd_scaled(mb3.reshape(-1, fs.n2), pre, True).reshape(mb3.shape)
        label = f"{name} rows (K={DOT_TERMS}, {rows_d} of {fs.n2}, period {fs.n1})"
        compare(f"{lib}_dot_scaled", label, rk.dot_scaled(ma3, mb3, pre, post),
                rk.dot_scaled_plain(ma3, mb3, pre, post))
        compare(f"{lib}_dot_scaled", label + " cached",
                rk.dot_scaled(ma3, spec3, pre, post, True),
                rk.dot_scaled_plain(ma3, spec3, pre, post, True))
        s_rows = rk.ntt_fwd_scaled(ma3.reshape(-1, fs.n2), pre).reshape(ma3.shape)
        mat_rows = plan.nwc_matvec_spectra(mat_l).reshape(4, 4, fs.n1, fs.n2)
        compare(f"{lib}_matvec_scaled", f"{name} rows (4x4, {rows_d} of {fs.n2})",
                rk.matvec_scaled(s_rows, mat_rows, post),
                rk.matvec_scaled_plain(s_rows, mat_rows, post))
        run.update(ma3=ma3, mb3=mb3, spec3=spec3, s_rows=s_rows, mat_rows=mat_rows,
                   a3=a3_l, b3=b3_l, mat=mat_l)
    for q, gen in ((Q_GENERIC, lambda n: operands(Q_GENERIC, n, 64, rng)),
                   (GOLDILOCKS_Q, lambda n: gl_operands(n, 64, rng))):
        p16 = make_params(16384, q)
        plan16 = FourStepPlan64(p16, device)
        x, y = on_card(*gen(16384))
        compare("four-step chain", f"nwc n=16384 (128 x 128) q={q} B=64",
                plan16.nwc_poly_mult(x, y), plan16.nwc_poly_mult_plain(x, y))
        for n1, n2 in ((32, 32), (64, 32)):  # the least sub-sizes the kernels take
            fs = KernelFourStep(make_params(n1 * n2, q), n1, n2, device)
            x, y = on_card(*gen(n1 * n2))
            compare("four-step chain", f"nwc {n1} x {n2} q={q} B=64",
                    fourstep_nwc_poly_mult_kernel(fs, x, y),
                    fourstep_nwc_poly_mult_kernel(fs, x, y, plain=True))

    # K6: a2a_exchange against all_to_all_plain, both directions, D = 2, 4
    # and 8, int64 and int32 words of every pattern (Goldilocks residues
    # >= 2^63 among them) in (3, 40, 24) leaves (blocks of 24 down to 3
    # words: 16-, 8- and 4-byte vectors), then at p60_1048576 B = 4, D = 4
    # the leaves of the sharded product's exchanges, Goldilocks residues
    def exchange_check(label, shards):
        for split in (2, 1):
            compare("a2a_exchange", f"{label} split_from_end={split}",
                    torch.stack(a2a.all_to_all(shards, split)),
                    torch.stack(a2a.all_to_all_plain(shards, split)))

    for peers in (2, 4, 8):
        bits = rng.integers(0, 1 << 64, size=(peers, 3, 40, 24), dtype=np.uint64)
        for name, words in (("int64", bits.view(np.int64)),
                            ("int32", bits.astype(np.uint32).view(np.int32))):
            exchange_check(f"D={peers} {name} (3, 40, 24)", list(on_card(*words)))
    fs20 = large["p60_1048576"]["plan"].fs
    a2a_cols = on_card(*gl_operands(fs20.n1 * A2A_CARDS, LARGE_ROWS[1][3] * fs20.n2 // A2A_CARDS,
                                    rng)[0].reshape(A2A_CARDS, LARGE_ROWS[1][3], fs20.n1, -1))
    a2a_rows = [x.reshape(LARGE_ROWS[1][3], fs20.n1 // A2A_CARDS, fs20.n2) for x in a2a_cols]
    exchange_check(f"p60_1048576 column leaves D={A2A_CARDS}", a2a_cols)
    exchange_check(f"p60_1048576 row leaves D={A2A_CARDS}", a2a_rows)

    # the 24-bit family
    p24 = MxuPlan(P24_4096, device)
    q24, n24 = P24_4096.q, P24_4096.n
    a_np, b_np = operands(q24, n24, BATCH, rng, np.int32)
    a, b = on_card(a_np, b_np)
    spec_b = p24.nwc_spectrum(b)
    label = f"P24_4096 B={BATCH}"
    for op, inputs in (("nwc", (a, b)), ("cyclic", (a, b)), ("fwd", (a,)),
                       ("inv", (a,)), ("nwc_fwd", (a,)), ("nwc_inv", (a,)),
                       ("spectrum", (b,)), ("cached", (a, spec_b))):
        got = check_op(p24, op, label, inputs)
        if op == "nwc":
            c24 = got
    for p in (FALCON_1024, make_params(16384, 16580609)):
        plan = MxuPlan(p, device)
        x, y = on_card(*operands(p.q, p.n, BATCH, rng, np.int32))
        check_op(plan, "nwc", f"{p.name} B={BATCH}", (x, y))
    a3, b3 = (t.reshape(DOT_TERMS, DOT_BATCH, n24) for t in on_card(
        *operands(q24, n24, DOT_TERMS * DOT_BATCH, rng, np.int32)))
    spec3 = p24.nwc_spectrum(b3.reshape(-1, n24)).reshape(b3.shape)
    label = f"K={DOT_TERMS} B={DOT_BATCH}"
    check_op(p24, "dot", label, (a3, b3))
    check_op(p24, "dot_cached", label, (a3, spec3))
    pdil = MxuPlan(DILITHIUM_256, device)
    s_np, mat_np = operands(DILITHIUM_256.q, 256, 4 * MATVEC_BATCH, rng, np.int32)
    s_dil, mat_dil = on_card(s_np.reshape(4, MATVEC_BATCH, 256),
                             mat_np[:16].reshape(4, 4, 256))
    spec_dil = check_op(pdil, "matvec_spectra", "DILITHIUM_256 4x4", (mat_dil,))
    mv_dil = check_op(pdil, "matvec", f"DILITHIUM_256 4x4 B={MATVEC_BATCH}",
                      (s_dil, spec_dil))

    # ML-KEM: every kyber.cu function at ML-KEM-768's shapes, B = 16384
    kp, kq, kb_ = KyberPlan(device), kyber.Q, KYBER_BATCH

    def check_kyber(method: str, entry: str, label: str, inputs):
        got = getattr(kp, method)(*inputs)
        compare(f"kyber_{entry}", f"{method} {label}", got,
                getattr(kp, method + "_plain")(*inputs))
        return got

    def kyber_stack(terms: int, batch: int):
        return [t.reshape(terms, batch, kyber.N) for t in on_card(
            *operands(kq, kyber.N, terms * batch, rng, np.int32))]

    ka, kb = on_card(*operands(kq, kyber.N, kb_, rng, np.int32))
    ka3, kb3 = kyber_stack(KYBER_K, kb_)
    kA, kA_hat = kyber_stack(KYBER_K, KYBER_K)  # A, and a matrix sampled as NTT-domain
    label = f"B={kb_}"
    kout = {
        "ntt": check_kyber("ntt", "forward", label, (ka,)),
        "intt": check_kyber("intt", "inverse", label, (ka,)),
        "spectrum": check_kyber("spectrum", "forward", label, (kb,)),
        "poly_mult": check_kyber("poly_mult", "product", label, (ka, kb)),
    }
    kspec = kout["spectrum"]
    kout["poly_mult_cached"] = check_kyber("poly_mult_cached", "cached", label,
                                           (ka, kspec))
    kspec3 = kp.spectrum(kb3.reshape(-1, kyber.N)).reshape(kb3.shape)
    label = f"K={KYBER_K} B={kb_}"
    kout["dot"] = check_kyber("dot", "dot", label, (ka3, kb3))
    kout["dot_cached"] = check_kyber("dot_cached", "dot", label, (ka3, kspec3))
    kout["matvec_spectra"] = check_kyber("matvec_spectra", "forward",
                                         f"{KYBER_K}x{KYBER_K}", (kA,))
    kblocks = kp.ntt_domain_blocks(kA_hat)
    label = f"{KYBER_K}x{KYBER_K} B={kb_}"
    kout["matvec"] = check_kyber("matvec", "matvec", label,
                                 (ka3, kout["matvec_spectra"]))
    check_kyber("matvec", "matvec", f"{label} from ntt_domain_blocks", (ka3, kblocks))
    for k in (2, 4):  # ML-KEM-512 and ML-KEM-1024
        s_k, b_k = kyber_stack(k, KYBER_SMALL_BATCH)
        A_k = b_k[:, :k].contiguous()
        check_kyber("matvec", "matvec", f"{k}x{k} B={KYBER_SMALL_BATCH}",
                    (s_k, kp.matvec_spectra(A_k)))

    # kyber_dot on its radix-16 core, fresh and cached, K = 1 to 8, B = 1, 3,
    # 9 (a partial tile of eight rows) and KYBER_BATCH, rows of 0, 1 and
    # q - 1 first (b's reversed against a's, so 0 meets q - 1)
    t0, checks = time.perf_counter(), 0
    kgen = torch.Generator(device).manual_seed(args.seed)
    for terms in range(1, 9):
        x3, y3 = (card_operands(kq, kyber.N, terms * kb_, kgen).to(torch.int32)
                  .reshape(terms, kb_, kyber.N) for _ in range(2))
        y3[0, :3] = y3[0, :3].flip(0).clone()
        s3 = kp.spectrum_plain(y3.reshape(-1, kyber.N)).reshape(y3.shape)
        for rows in (1, 3, 9, kb_):
            a_r, b_r, s_r = (t[:, :rows].contiguous() for t in (x3, y3, s3))
            label = f"K={terms} B={rows}"
            silent_check("kyber_dot", label, kp.dot(a_r, b_r), kp.dot_plain(a_r, b_r))
            silent_check("kyber_dot", label + " cached", kp.dot_cached(a_r, s_r),
                         kp.dot_cached_plain(a_r, s_r))
            checks += 2
    print(f"kernel vs plain: kyber_dot fresh and cached, K = 1 to 8, B = 1, 3, 9, {kb_}: "
          f"{checks} launches equal in {time.perf_counter() - t0:.1f} s")

    # K2: every gl64 function at goldilocks_4096 (bench.py:147) with rows of
    # 0, 1, q - 1, 2^63 and 2^63 - 1, B = 2048 (the dot at K = 4, B = 512, the
    # matvec 4 x 4 at B = 256); the product, forward and inverse at n = 256
    # and 8192, the dot at n = 8192
    plan_gl = GoldilocksPlan64(GOLDILOCKS_4096, device)
    inputs_gl = op_inputs(plan_gl, *family_operands(
        GOLDILOCKS_4096, np.int64, BATCH, DOT_BATCH, MATVEC_BATCH_60))
    out_gl = {op: check_op(plan_gl, op, f"goldilocks_4096 B={BATCH}", x)
              for op, x in inputs_gl.items()}
    for n in (256, 8192):
        p = make_params(n, GOLDILOCKS_Q)
        plan = GoldilocksPlan64(p, device)
        x, y = on_card(*gl_operands(n, BATCH, rng))
        for op in ("nwc", "nwc_fwd", "nwc_inv"):
            check_op(plan, op, f"goldilocks n={n} B={BATCH}", (x, y) if op == "nwc" else (x,))
        if n == 8192:
            x3, y3 = (t.reshape(DOT_TERMS, DOT_BATCH_8192, n) for t in on_card(
                *gl_operands(n, DOT_TERMS * DOT_BATCH_8192, rng)))
            check_op(plan, "dot", f"goldilocks n=8192 K={DOT_TERMS} B={DOT_BATCH_8192}",
                     (x3, y3))

    # K5a and K5b: the permutation at widths 8 and 12 on B = 131072 columns
    # (bench.py:159), the sponge over (131072, 8) and rows of 0, 1 and 5; the
    # STARK leaves' sponge, (8192, 135), is checked on the main path below
    hashers = {w: gl_poseidon.Poseidon2GL(w) for w in (8, 12)}
    gl_states = {}
    for w, h in hashers.items():
        x = on_card(np.ascontiguousarray(gl_operands(w, POSEIDON_BATCH, rng)[0].T))[0]
        gl_states[w] = x
        got = torch.stack(h.permute(list(x)))
        compare("poseidon_permute", f"width {w} B={POSEIDON_BATCH}", got,
                torch.stack(h.permute_plain(list(x))))
        cols = ints(x[:, :6].T)
        if ints(got[:, :6].T) != [h.ref.permute(c) for c in cols]:
            raise AssertionError(f"poseidon_permute width {w} differs from PoseidonRef")
    rows8 = on_card(gl_operands(8, POSEIDON_BATCH, rng)[0])[0]
    for w, h in hashers.items():
        for label, rows in ((f"rows of 8, B={POSEIDON_BATCH}", rows8),
                            *((f"rows of {L}, B=4096", rows8[:4096, :L].contiguous())
                              for L in (0, 1, 5))):
            got = torch.stack(h.hash_rows(rows))
            compare("poseidon_sponge", f"width {w} {label}", got,
                    torch.stack(h.hash_rows_plain(rows)))
            if ints(got[:, :3].T) != [h.ref.hash_elements(r) for r in ints(rows[:3])]:
                raise AssertionError(f"poseidon_sponge width {w} {label} differs "
                                     "from PoseidonRef")
    print("oracle: poseidon_permute columns 0-5 and poseidon_sponge rows 0-2 equal "
          "PoseidonRef at widths 8 and 12")
    # a schedule other than (rf, rp) = (8, 22): the rounds' loops take any
    rows9 = on_card(gl_operands(9, 4096, rng)[0])[0]  # two staged chunks, the last short
    for w in (8, 12):
        h = gl_poseidon.Poseidon2GL(w, rf=6, rp=11)
        x = gl_states[w]
        got = torch.stack(h.permute(list(x)))
        compare("poseidon_permute", f"width {w} rf=6 rp=11 B={POSEIDON_BATCH}", got,
                torch.stack(h.permute_plain(list(x))))
        sponged = torch.stack(h.hash_rows(rows9))
        compare("poseidon_sponge", f"width {w} rf=6 rp=11 rows of 9, B=4096", sponged,
                torch.stack(h.hash_rows_plain(rows9)))
        if (ints(got[:, :2].T) != [h.ref.permute(c) for c in ints(x[:, :2].T)]
                or ints(sponged[:, :2].T) != [h.ref.hash_elements(r)
                                              for r in ints(rows9[:2])]):
            raise AssertionError(f"width {w} rf=6 rp=11 differs from PoseidonRef")
    print("oracle: rf=6 rp=11 columns 0-1 and rows 0-1 equal PoseidonRef at widths 8 "
          "and 12")
    # the arithmetic core on any 64-bit words (poseidon_field_probe): every
    # pair of boundary words, 65536 random triples and 16384 near 2^64
    edges = [0, 1, 2, (1 << 32) - 1, 1 << 32, GOLDILOCKS_Q - 1, GOLDILOCKS_Q,
             GOLDILOCKS_Q + 1, (1 << 63) - 1, 1 << 63, (1 << 64) - (1 << 32), (1 << 64) - 1]
    pairs = np.array([(u, v) for u in edges for v in edges], dtype=np.uint64)
    ops = np.concatenate([np.column_stack([pairs, pairs[::-1, 0]]),
                          rng.integers(0, 1 << 64, size=(65536, 3), dtype=np.uint64),
                          rng.integers(GOLDILOCKS_Q - (1 << 33), 1 << 64, size=(16384, 3),
                                       dtype=np.uint64)])
    got = kposeidon.field_probe(*on_card(*(ops[:, k].view(np.int64) for k in range(3))))
    got = got.cpu().numpy().view(np.uint64).astype(object)
    for k, row in enumerate(kposeidon.field_probe_want(*(ops[:, k].tolist()
                                                         for k in range(3)))):
        lazy = k in kposeidon.PROBE_LAZY_ROWS
        if not ((got[k] % GOLDILOCKS_Q == row) if lazy else (got[k] == row)).all():
            raise AssertionError(f"poseidon_field_probe row {k} differs from Python "
                                 "integers mod q")
    print(f"probe: poseidon_field_probe on {len(ops)} operand triples "
          f"({len(pairs)} boundary pairs): all {kposeidon.PROBE_ROWS} rows equal Python "
          f"integers mod q (rows {kposeidon.PROBE_LAZY_ROWS} congruent, lazy)")

    print(f"phase: kernel vs plain done at {time.perf_counter() - t_start:.1f} s (wall clock)")
    # 4. independent oracle: evaluation at roots of x^n + 1, and the golden
    for name, p, (av, bv), cv in (
            ("P60_4096", P60_4096, inputs60["nwc"], out60["nwc"]),
            (p_gen.name, p_gen, inputs_gen["nwc"], out_gen["nwc"]),
            ("P24_4096", P24_4096, (a, b), c24),
            ("goldilocks_4096", GOLDILOCKS_4096, inputs_gl["nwc"], out_gl["nwc"])):
        a_rows, b_rows, c_rows = ints(av[:8]), ints(bv[:8]), ints(cv[:8])
        check_evaluations(name, p, a_rows[2:6], b_rows[2:6], c_rows[2:6], rng)
        if reference.nwc_poly_mult(a_rows[4], b_rows[4], p) != c_rows[4]:
            raise AssertionError(f"{name}: row 4 differs from reference.nwc_poly_mult")
        print(f"oracle: {name} c(x) == a(x) b(x) at x = psi^(2k+1), rows 2-5, 3 k "
              "each; row 4 equals reference.nwc_poly_mult")
    for name, plan, x in (("P60_4096", plan60, inputs60["nwc"][0]),
                          ("P24_4096", p24, a),
                          ("goldilocks_4096", plan_gl, inputs_gl["nwc"][0])):
        for fwd, inv in (("nwc_ntt_fwd", "nwc_ntt_inv"), ("ntt_fwd", "ntt_inv")):
            if not torch.equal(getattr(plan, inv)(getattr(plan, fwd)(x)), x):
                raise AssertionError(f"{inv}({fwd}(x)) != x at {name}")
        print(f"oracle: nwc_ntt_inv(nwc_ntt_fwd(x)) == x and ntt_inv(ntt_fwd(x)) == x, "
              f"{name} B={BATCH}")
    a3_60, b3_60 = inputs60["dot"]
    row = 5
    want = [0] * P60_4096.n
    for k in range(DOT_TERMS):
        prod = reference.nwc_poly_mult(a3_60[k, row].cpu().tolist(),
                                       b3_60[k, row].cpu().tolist(), P60_4096)
        want = [(u + v) % P60_4096.q for u, v in zip(want, prod)]
    if out60["dot"][row].cpu().tolist() != want:
        raise AssertionError("P60_4096 dot row 5 differs from its golden products")
    print(f"oracle: P60_4096 dot row {row} equals the sum of {DOT_TERMS} "
          "reference.nwc_poly_mult products")
    ka_rows, kb_rows = ka[:6].tolist(), kb[:6].tolist()
    for name, got, want in (
            ("ntt", kout["ntt"], reference.kyber_ntt),
            ("intt", kout["intt"], reference.kyber_intt),
            ("poly_mult", kout["poly_mult"],
             lambda x, r: reference.kyber_poly_mult(x, kb_rows[r]))):
        for r in range(6):
            args = (ka_rows[r], r) if name == "poly_mult" else (ka_rows[r],)
            if got[r].tolist() != want(*args):
                raise AssertionError(f"ML-KEM {name} row {r} differs from the golden")
    if kout["poly_mult"][4].tolist() != reference.schoolbook_negacyclic(
            ka_rows[4], kb_rows[4], kq):
        raise AssertionError("ML-KEM poly_mult row 4 differs from the schoolbook product")
    row, want = 5, []
    for i in range(KYBER_K):
        acc = [0] * kyber.N
        for j in range(KYBER_K):
            prod = reference.kyber_poly_mult(kA[i, j].tolist(), ka3[j, row].tolist())
            acc = [(u + v) % kq for u, v in zip(acc, prod)]
        want.append(acc)
    if kout["matvec"][:, row].tolist() != want:
        raise AssertionError("ML-KEM 3x3 matvec row 5 differs from its golden products")
    if not torch.equal(kp.intt(kout["ntt"]), ka):
        raise AssertionError("ML-KEM intt(ntt(x)) != x")
    print("oracle: ML-KEM rows 0-5 of ntt, intt and poly_mult equal reference.kyber_ntt, "
          "kyber_intt and kyber_poly_mult; poly_mult row 4 equals "
          "reference.schoolbook_negacyclic; 3x3 matvec row 5 equals the sums of its "
          f"golden products; intt(ntt(x)) == x at B={kb_}")

    for name, rows in (("p60_32768", slice(2, 6)), ("p60_1048576", slice(2, 4)),
                       ("goldilocks_32768", slice(2, 6)),
                       ("goldilocks_1048576", slice(2, 4))):
        run = large[name]
        p, plan, a_l, b_l = run["p"], run["plan"], run["a"], run["b"]
        check_evaluations(name, p, ints(a_l[rows]), ints(b_l[rows]), ints(run["c"][rows]),
                          rng)
        if not torch.equal(plan.nwc_poly_mult(a_l, b_l), run["c"]):
            raise AssertionError(f"{name}: the product differs from its parts' product")
        pairs = [("nwc_ntt_fwd", "nwc_ntt_inv")]
        if p.n == 32768:
            pairs.append(("ntt_fwd", "ntt_inv"))
        for fwd, inv in pairs:
            if not torch.equal(getattr(plan, inv)(getattr(plan, fwd)(a_l)), a_l):
                raise AssertionError(f"{inv}({fwd}(x)) != x at {name}")
        print(f"oracle: {name} four-step c(x) == a(x) b(x) at x = psi^(2k+1), rows "
              f"{rows.start}-{rows.stop - 1}, 3 k each; "
              + " and ".join(f"{inv}({fwd}(x)) == x" for fwd, inv in pairs))

    print(f"phase: oracle done at {time.perf_counter() - t_start:.1f} s (wall clock)")
    # 5. main paths, through the entry points a user calls
    counts = (MxuPlan.launches, MxuPlan64.launches, KyberPlan.launches,
              GoldilocksPlan64.launches, kposeidon.launches, a2a.launches)

    def zero_counts():
        for c in counts:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counts for k, v in c.items()}
    launches: dict[str, int] = {}

    def drive(label, q, via, fn, inputs, plain, expect, want=None, forbid=()):
        """Run fn with the counts at 0, read them, check against plain; with
        no kernel to expect, no kernel may launch, and none of ``forbid``
        ever."""
        zero_counts()
        out = fn(*inputs)
        torch.cuda.synchronize()
        seen = read_counts()
        if any(seen[k] < 1 for k in expect) or (not expect and any(seen.values())):
            raise AssertionError(f"main path {label} did not launch {expect}: {seen}")
        if any(seen[k] for k in forbid):
            raise AssertionError(f"main path {label} launched one of {forbid}: {seen}")
        if not torch.equal(out, plain(*inputs)):
            raise AssertionError(f"main path {label} differs from its plain version")
        if want is not None and not torch.equal(out, want):
            raise AssertionError(f"main path {label} differs from the checked result")
        if not canonical(out, q):
            raise AssertionError(f"main path {label} leaves [0, q)")
        for k, v in seen.items():
            launches[k] = launches.get(k, 0) + v
        print(f"main path: {label} via {via}, launches "
              f"{ {k: v for k, v in seen.items() if v} }, shape {tuple(out.shape)}")
        return out

    mat24 = a3[:, :4].permute(1, 0, 2).contiguous()  # a 4 x 4 matrix of rows
    inputs24 = {
        "nwc": (a, b), "cyclic": (a, b), "fwd": (a,), "inv": (a,), "nwc_fwd": (a,),
        "nwc_inv": (a,), "spectrum": (b,), "cached": (a, spec_b), "dot": (a3, b3),
        "dot_cached": (a3, spec3), "matvec_spectra": (mat24,),
        "matvec": (b3, p24.nwc_matvec_spectra(mat24)),
    }
    best = {}
    for p, plan, inputs, checked in ((P60_4096, plan60, inputs60, out60),
                                     (p_gen, plan_gen, inputs_gen, out_gen),
                                     (P24_4096, p24, inputs24, {}),
                                     (GOLDILOCKS_4096, plan_gl, inputs_gl, out_gl)):
        for op in dispatch.OPS:
            if dispatch.impl_name(p, op) != plan.name:
                raise AssertionError(f"{op} at {p.name} is not served by {plan.name}")
            best[p.name, op] = dispatch.best(p, op)
            drive(f"best({p.name}, {op!r})", p.q, plan.name, best[p.name, op], inputs[op],
                  getattr(plan, dispatch.METHODS[op] + "_plain"),
                  [f"{plan.lib_name}_{e}" for e in OP_ENTRIES[op]], checked.get(op))
    drive(f"best_nwc_matvec(P60_4096) 4x4 B={MATVEC_BATCH_60}", P60_4096.q,
          plan60.name, dispatch.best_nwc_matvec(P60_4096), inputs60["matvec"],
          plan60.nwc_matvec_cached_plain, ["nwc64_forward", "nwc64_matvec"],
          out60["matvec"])
    spectra_fn = dispatch.best_nwc_matvec_spectra(DILITHIUM_256)
    matvec_fn = dispatch.best_nwc_matvec(DILITHIUM_256)
    drive("best_nwc_matvec_spectra(DILITHIUM_256)", DILITHIUM_256.q, pdil.name, spectra_fn,
          (mat_dil,), pdil.nwc_matvec_spectra_plain, ["nwc32_forward"], spec_dil)
    drive(f"best_nwc_matvec(DILITHIUM_256) 4x4 B={MATVEC_BATCH}", DILITHIUM_256.q,
          pdil.name, matvec_fn, (s_dil, spec_dil), pdil.nwc_matvec_cached_plain,
          ["nwc32_forward", "nwc32_matvec"], mv_dil)
    kntt_b = kp.ntt(kb)
    kyber_main = {  # entry point: (inputs, plain version, kernels it launches)
        "ntt": ((ka,), kp.ntt_plain, ["kyber_forward"]),
        "intt": ((ka,), kp.intt_plain, ["kyber_inverse"]),
        "basemul": ((kout["ntt"], kntt_b), kp.basemul_plain, []),
        "poly_mult": ((ka, kb), kp.poly_mult_plain, ["kyber_product"]),
        "spectrum": ((kb,), kp.spectrum_plain, ["kyber_forward"]),
        "poly_mult_cached": ((ka, kspec), kp.poly_mult_cached_plain, ["kyber_cached"]),
        "dot": ((ka3, kb3), kp.dot_plain, ["kyber_dot"]),
        "dot_cached": ((ka3, kspec3), kp.dot_cached_plain, ["kyber_dot"]),
        "matvec_spectra": ((kA,), kp.matvec_spectra_plain, ["kyber_forward"]),
        # A's blocks from its plain spectra are those from its coefficients
        "ntt_domain_blocks": ((kp.ntt(kA.reshape(-1, kyber.N)).reshape(kA.shape),),
                              lambda _: kp.matvec_spectra_plain(kA), []),
        "matvec": ((ka3, kout["matvec_spectra"]), kp.matvec_plain, ["kyber_matvec"]),
    }
    for name, (inputs, plain, expect) in kyber_main.items():
        drive(f"kyber.{name} B={kb_}", kq, kyber.impl_name(), getattr(kyber, name),
              inputs, plain, expect, kout.get(name))

    # the STARK commitment (kernels K2, K5b, K5a) at Plonky2's
    # CircuitConfig::standard_recursion_config (plonky2/src/plonk/
    # circuit_data.rs: 135 wires, rate_bits = 3, 28 query rounds): extend on
    # the kernel order, reorder to bitrev, hash the rows into leaves, build
    # the tree, FRI-prove column 0, verify on the host; first at degree 2^10
    # (N = 8192, the flat kernels' order), after the four-step below at
    # Plonky2's degree 2^17 (N = 2^20) uncut
    commit_hasher = gl_poseidon.Poseidon2GL()
    ref = commit_hasher.ref

    def commitment(degree, expect, forbid=()):
        """The commitment of STARK_COLS random columns of ``degree``
        coefficients, its stages timed on the host clock and the counts
        zeroed before them and read after; then each stage held to its
        plain version: the LDE to ``LdePlan.extend_plain`` LDE_CHECK_COLS
        columns at a time (and, up to N = 8192, to the plain bitrev plan of
        N points), the leaves of a fixed LEAF_SLICE-row slice to the plain
        sponge (9.5 s for 8192 rows, so not all 2^20), the root to the plain
        tree's; big-int Horner at 8 coset points, two leaves against
        ``PoseidonRef`` and their Merkle paths."""
        big, stage = degree * STARK_BLOWUP, {}
        t0 = time.perf_counter()
        pk, pb = (stark.LdePlan(degree, GOLDILOCKS_Q, STARK_BLOWUP, order=order,
                                device=device) for order in ("kernel", "bitrev"))
        prover = stark.FriProver(pb, final_size=GL_FINAL, num_queries=STARK_QUERIES,
                                 hasher=commit_hasher)
        coeffs = on_card(gl_operands(degree, STARK_COLS, rng)[0])[0]
        torch.cuda.synchronize()
        stage["plans and tables"] = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        evals = pk.reorder(pk.extend(coeffs), pb)  # a first extend builds its mid table
        torch.cuda.synchronize()
        stage["extend + reorder"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = evals.T.contiguous()
        leaves = commit_hasher.hash_rows(rows)
        torch.cuda.synchronize()
        stage["leaf sponges"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        levels = gl_poseidon.merkle_levels(commit_hasher, leaves)
        root = gl_poseidon.digest_ints(levels[-1])
        stage["Merkle tree"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        proof = prover.prove(evals[0])
        stage["FRI prove"] = time.perf_counter() - t0
        seen = read_counts()
        t0 = time.perf_counter()
        verified = stark.fri_verify(pb, proof, final_size=GL_FINAL,
                                    num_queries=STARK_QUERIES)
        stage["FRI verify (host, big-int)"] = time.perf_counter() - t0
        label = f"the degree-{degree} STARK commitment"
        if any(seen[k] < 1 for k in expect) or any(seen[k] for k in forbid):
            raise AssertionError(f"{label} did not launch {expect}, or launched one of "
                                 f"{forbid}: {seen}")
        if not verified:
            raise AssertionError(f"fri_verify rejected the proof of {label}")
        if not canonical(evals, GOLDILOCKS_Q):
            raise AssertionError(f"the LDE of {label} leaves [0, q)")
        t_plain = 0.0
        for c0 in range(0, STARK_COLS, LDE_CHECK_COLS):  # bounded memory for the plain chain
            part = slice(c0, c0 + LDE_CHECK_COLS)
            t0 = time.perf_counter()
            want = pk.reorder(pk.extend_plain(coeffs[part]), pb)
            torch.cuda.synchronize()
            t_plain += time.perf_counter() - t0
            if not torch.equal(evals[part], want):
                raise AssertionError(f"the LDE of {label}, columns {c0}-"
                                     f"{c0 + LDE_CHECK_COLS - 1}, differs from its plain chain")
        if big <= 8192 and not torch.equal(evals, pb.extend(coeffs)):
            raise AssertionError(f"the LDE of {label} differs from the plain bitrev LDE")
        idx = pb.spectrum_indices()
        for col, slot in zip(rng.integers(0, STARK_COLS, 8).tolist(),
                             rng.integers(0, big, 8).tolist()):
            x = pb.shift * pow(pb.p.omega, int(idx[slot]), GOLDILOCKS_Q) % GOLDILOCKS_Q
            if horner(ints(coeffs[col]), x, GOLDILOCKS_Q) != ints(evals[col, slot:slot + 1])[0]:
                raise AssertionError(f"{label}: LDE column {col} slot {slot} differs from "
                                     "Horner")
        start = (big - LEAF_SLICE) // 2
        leaf_slice = slice(start, start + LEAF_SLICE)
        compare("poseidon_sponge", f"STARK leaves, rows {start}-{start + LEAF_SLICE - 1} of "
                f"{big} rows of {STARK_COLS}", torch.stack(leaves)[:, leaf_slice],
                torch.stack(commit_hasher.hash_rows_plain(rows[leaf_slice])))
        plain_level = list(leaves)
        while plain_level[0].shape[0] > 1:
            plain_level = commit_hasher.permute_plain(
                [d[0::2] for d in plain_level] + [d[1::2] for d in plain_level])[:4]
        if gl_poseidon.digest_ints(plain_level) != root:
            raise AssertionError(f"the Merkle root of {label} differs from the plain version's")
        leaf_ids = (0, big // 2 + 1)
        for i in leaf_ids:
            if ref.hash_elements(ints(rows[i])) != gl_poseidon.digest_ints(
                    [d[i:i + 1] for d in leaves]):
                raise AssertionError(f"{label}: leaf {i} differs from PoseidonRef")
            if not gl_poseidon.merkle_verify(ref, root, i, ints(torch.stack(
                    [d[i] for d in leaves])), gl_poseidon.merkle_open(levels, i)):
                raise AssertionError(f"{label}: the Merkle path of leaf {i} does not verify")
        for k, v in seen.items():
            launches[k] = launches.get(k, 0) + v
        print(f"main path: STARK commitment, {STARK_COLS} columns, degree {degree}, blowup "
              f"{STARK_BLOWUP} (N={big}, kernel order on "
              f"{dispatch.impl_name(pk.p, 'nwc_fwd')}), FRI to {GL_FINAL} with "
              f"{STARK_QUERIES} queries: fri_verify True, "
              f"{len(proof['roots'])} layers; the LDE equals its plain chain "
              f"({t_plain:.3f} s in all, {LDE_CHECK_COLS} columns at a time)"
              + (" and the plain bitrev LDE" if big <= 8192 else "")
              + f" and Horner at 8 points; leaves {start}-{start + LEAF_SLICE - 1} equal "
              f"the plain sponge, the root the plain tree's; leaves {leaf_ids} equal "
              f"PoseidonRef and their paths verify; launches "
              f"{ {k: v for k, v in seen.items() if v} }")
        print(f"main path: degree-{degree} STARK stage times (s, host clock, synchronized): "
              + ", ".join(f"{k} {v:.4f}" for k, v in stage.items()))
        return {"pk": pk, "coeffs": coeffs, "rows": rows, "plain_s": t_plain}

    small_commit = commitment(GL_LDE_N, ("gl64_forward", "poseidon_sponge",
                                         "poseidon_permute"))
    lde_rows = small_commit["rows"]

    # the four-step: every op at p60_32768 and goldilocks_32768 through
    # dispatch; at p60_1048576 and goldilocks_1048576 the product, the
    # forward then the inverse of its output, the spectrum then the cached
    # product against it
    inputs_large = {}
    for name in ("p60_32768", "goldilocks_32768"):
        run = large[name]
        p, plan, lib, a_l, b_l = run["p"], run["plan"], run["lib"], run["a"], run["b"]
        a3_l, b3_l, mat_l, n = run["a3"], run["b3"], run["mat"], p.n
        spec_l = plan.nwc_spectrum(b_l)
        inputs_large[name] = inputs = {
            "nwc": (a_l, b_l), "cyclic": (a_l, b_l), "fwd": (a_l,), "inv": (a_l,),
            "nwc_fwd": (a_l,), "nwc_inv": (a_l,), "spectrum": (b_l,),
            "cached": (a_l, spec_l), "dot": (a3_l, b3_l),
            "dot_cached": (a3_l, plan.nwc_spectrum(b3_l.reshape(-1, n)).reshape(b3_l.shape)),
            "matvec_spectra": (mat_l,), "matvec": (b3_l, plan.nwc_matvec_spectra(mat_l)),
        }
        for op in dispatch.OPS:
            if dispatch.impl_name(p, op) != plan.name:
                raise AssertionError(f"{op} at {p.name} is not served by {plan.name}")
            best[p.name, op] = dispatch.best(p, op)
            drive(f"best({p.name}, {op!r})", p.q, plan.name, best[p.name, op],
                  inputs[op], getattr(plan, dispatch.METHODS[op] + "_plain"),
                  fourstep_entries(lib, op),
                  run["c"] if op == "nwc" else None, row_transforms(lib))

    def drive_m(run, op, inputs, want=None):
        p, plan = run["p"], run["plan"]
        best[p.name, op] = dispatch.best(p, op)
        return drive(f"best({p.name}, {op!r})", p.q, plan.name, best[p.name, op],
                     inputs, getattr(plan, dispatch.METHODS[op] + "_plain"),
                     fourstep_entries(run["lib"], op), want, row_transforms(run["lib"]))
    for name in ("p60_1048576", "goldilocks_1048576"):
        run = large[name]
        a_m, b_m = run["a"], run["b"]
        drive_m(run, "nwc", (a_m, b_m), run["c"])
        drive_m(run, "nwc_inv", (drive_m(run, "nwc_fwd", (a_m,)),), a_m)
        spec_m = drive_m(run, "spectrum", (b_m,))
        drive_m(run, "cached", (a_m, spec_m), run["c"])
        inputs_large[name] = {"nwc": (a_m, b_m), "nwc_fwd": (a_m,), "cached": (a_m, spec_m)}

    # the mesh (kernel K6 on the path): ShardedNtt on FourStepPlan64's own
    # KernelFourStep (its 2^20 mid tables built once), the shards logical
    # shards of this card; each op with the counts zeroed before it: D
    # a2a_exchange launches an exchange of each group of D peers, the
    # four-step's kernels, the single-device plan's result, the
    # fused_exchange=False run's
    def drive_sharded(label, q, sn, method, inputs, want, exchanges, expect, sn_plain=None,
                      forbid=()):
        zero_counts()
        out = getattr(sn, method)(*inputs)
        torch.cuda.synchronize()
        seen = read_counts()
        if any(seen[k] for k in forbid):
            raise AssertionError(f"sharded {label} launched one of {forbid}: {seen}")
        # each shard is a source once an exchange: D launches a group of peers
        if (seen["a2a_exchange"] != sn.mesh.size * exchanges
                or any(seen[k] < 1 for k in expect)):
            raise AssertionError(f"sharded {label} did not launch {sn.mesh.size} x "
                                 f"{exchanges} a2a_exchange and {expect}: {seen}")
        got = out.gather()
        if not torch.equal(got.reshape(want.shape), want):
            raise AssertionError(f"sharded {label} differs from the single-device result")
        if sn_plain is not None and not torch.equal(
                getattr(sn_plain, method)(*inputs).gather(), got):
            raise AssertionError(f"sharded {label} differs from its fused_exchange=False run")
        if not canonical(got, q):
            raise AssertionError(f"sharded {label} leaves [0, q)")
        for k, v in seen.items():
            launches[k] = launches.get(k, 0) + v
        print(f"main path: sharded {label}, launches "
              f"{ {k: v for k, v in seen.items() if v} }, shape {tuple(got.shape)}"
              + ("; equals the fused_exchange=False run" if sn_plain else ""))
        return out

    def sharded_ops(name, mesh, batch_axis=None, ops=None):
        """The eight ShardedNtt ops (or ``ops``) of large[name]'s rows on
        ``mesh``, each against FourStepPlan64 and the plain exchange."""
        run = large[name]
        p, plan, lib = run["p"], run["plan"], run["lib"]
        fs, (a_m, b_m) = plan.fs, (run["a"], run["b"])
        sn = sharded.ShardedNtt(fs, mesh, batch_axis=batch_axis, fused_exchange=True)
        sn_x = sharded.ShardedNtt(fs, mesh, batch_axis=batch_axis)
        mat = lambda t, *lead: t.reshape(*lead, -1, fs.n1, fs.n2)  # noqa: E731
        a_s, b_s = sn.put_natural(mat(a_m)), sn.put_natural(mat(b_m))
        a3, b3 = torch.stack([a_m, b_m]), torch.stack([b_m, a_m])
        a3_s, b3_s = (sn.put_natural(mat(t, 2), stacked=True) for t in (a3, b3))
        spec = plan.nwc_spectrum(b_m)
        col, inv = fourstep_entries(lib, "nwc")[0], fourstep_entries(lib, "nwc")[-1]
        fwd = [col]
        table = {  # op: (method, inputs, want, exchange calls, kernels)
            "nwc": ("nwc_poly_mult", (a_s, b_s), run["c"], 2,
                    [col, f"{lib}_cyclic_scaled", inv]),
            "cyclic": ("cyclic_poly_mult", (a_s, b_s), plan.cyclic_poly_mult(a_m, b_m), 2,
                       [col, f"{lib}_cyclic_scaled", inv]),
            "fwd": ("ntt_fwd", (a_s,), plan.ntt_fwd(a_m), 1, fwd + [f"{lib}_forward_scaled"]),
            "spectrum": ("nwc_spectrum", (b_s,), spec, 1, fwd + [f"{lib}_forward_scaled"]),
            "cached": ("nwc_poly_mult_cached", (a_s, None), run["c"], 2,
                       [col, f"{lib}_cached_scaled", inv]),
            "dot": ("nwc_dot", (a3_s, b3_s), plan.nwc_dot(a3, b3), 2,
                    [col, f"{lib}_dot_scaled", inv]),
            "dot_cached": ("nwc_dot_cached", (a3_s, None), None, 2,
                           [col, f"{lib}_dot_scaled", inv]),
            "inv": ("ntt_inv", (None,), a_m, 1, [f"{lib}_inverse_scaled", inv]),
        }
        outs = {}
        for op in ops or table:
            method, inputs, want, exchanges, expect = table[op]
            if op == "cached":
                inputs = (a_s, outs["spectrum"])
            elif op == "dot_cached":
                spectra = torch.stack([sn.nwc_spectrum(sn.put_natural(mat(t))).gather()
                                       for t in b3])
                inputs, want = (a3_s, sharded.shard(mesh, sn.spec_fourstep(stacked=True),
                                                    spectra)), table["dot"][2]
            elif op == "inv":
                inputs = (outs["fwd"],)
            outs[op] = drive_sharded(f"{name} {method} on {mesh!r}", p.q, sn, method,
                                     inputs, want, exchanges, expect, sn_x, row_transforms(lib))
        return sn, outs

    shard_mesh = sharded.make_mesh((A2A_CARDS,), ("coeff",), device)
    sn20, outs20 = sharded_ops("p60_1048576", shard_mesh)
    p20 = large["p60_1048576"]["p"]
    c20 = outs20["nwc"].gather().reshape(-1, p20.n)
    check_evaluations("sharded p60_1048576", p20, ints(large["p60_1048576"]["a"][2:3]),
                      ints(large["p60_1048576"]["b"][2:3]), ints(c20[2:3]), rng)
    print(f"oracle: sharded p60_1048576 on {A2A_CARDS} logical shards c(x) == a(x) b(x) at "
          "x = psi^(2k+1), row 2, 3 k; ntt_inv(ntt_fwd(x)) == x (above)")
    sharded_ops("goldilocks_1048576",
                sharded.make_mesh((2, 2), ("batch", "coeff"), device), "batch",
                ("nwc", "spectrum", "cached"))
    # DILITHIUM_256 at 16 x 16 on 8 shards: the plain locals (torch ops)
    # with K6 between them, against the schoolbook product and the K3 kernel
    dil_fs = sharded.FourStepPlan(DILITHIUM_256, 16, 16, device)
    dil_sn = sharded.ShardedNtt(dil_fs, sharded.make_mesh((8,), ("coeff",), device),
                                fused_exchange=True)
    a_dil, b_dil = on_card(*operands(DILITHIUM_256.q, 256, BATCH, rng, np.int32))
    dil_want = dispatch.best(DILITHIUM_256, "nwc")(a_dil, b_dil)
    dil_out = drive_sharded(
        f"DILITHIUM_256 16 x 16 nwc_poly_mult B={BATCH}, plain locals on 8 shards",
        DILITHIUM_256.q, dil_sn, "nwc_poly_mult",
        tuple(dil_sn.put_natural(t.reshape(-1, 16, 16)) for t in (a_dil, b_dil)),
        dil_want, 2, [])
    dil_rows = dil_out.gather().reshape(-1, 256)
    for r in range(4):
        if ints(dil_rows[r]) != reference.schoolbook_negacyclic(
                ints(a_dil[r]), ints(b_dil[r]), DILITHIUM_256.q):
            raise AssertionError(f"sharded DILITHIUM_256 row {r} differs from the schoolbook")
    print("oracle: sharded DILITHIUM_256 rows 0-3 equal reference.schoolbook_negacyclic")
    # batch_pjit: P60_4096 at B = 2048 over 4 batch shards, each through
    # best_nwc_poly_mult on its shard, no exchange
    zero_counts()
    pjit = sharded.batch_pjit(P60_4096, lambda p, x, y: dispatch.best_nwc_poly_mult(p)(x, y),
                              sharded.make_mesh((4,), ("batch",), device))
    got = pjit(*inputs60["nwc"]).gather()
    torch.cuda.synchronize()
    seen = read_counts()
    if seen["nwc64_product"] != 4 or seen["a2a_exchange"] or not torch.equal(got, out60["nwc"]):
        raise AssertionError(f"batch_pjit over 4 shards differs from the unsharded call: {seen}")
    for k, v in seen.items():
        launches[k] = launches.get(k, 0) + v
    print(f"main path: batch_pjit(P60_4096, best_nwc_poly_mult) B={BATCH} over 4 batch shards, "
          f"launches { {k: v for k, v in seen.items() if v} }; equals the unsharded call")
    cards = torch.cuda.device_count()
    if cards >= 2:
        spread = sharded.make_mesh((A2A_CARDS,), ("coeff",),
                                   [torch.device("cuda", i % cards) for i in range(A2A_CARDS)])
        sharded_ops("p60_1048576", spread, ops=("nwc", "fwd"))
    else:
        print(f"sharded: torch.cuda.device_count() == {cards}: the p60_1048576 run with its "
              "shards on distinct cards needs two or more, so it did not run")

    big_commit = commitment(STARK_DEGREE, ("gl64_forward_cols", "gl64_forward_scaled",
                                          "poseidon_sponge", "poseidon_permute"),
                            row_transforms("gl64"))
    pk2, coeffs2, rows2 = big_commit["pk"], big_commit["coeffs"], big_commit["rows"]
    big_n, t_plain_lde = STARK_DEGREE * STARK_BLOWUP, big_commit["plain_s"]

    print(f"phase: main path done at {time.perf_counter() - t_start:.1f} s (wall clock)")
    # 6. timing, in turns: plain, kernel (through the main path), kernel, plain
    # each entry: (what is timed, kernel fn, plain fn, inputs, (bytes,
    # 32-bit multiplies) of a call, plain iteration counts, plain repeats)
    SLOW, ONE = ((1, 2), 1), ((0, 1), 1)  # plain versions of 0.2 s, and of seconds

    def nwc_timed(kernel, p, op, plan, inputs, out_rows, fn=None):
        plain_iters = SLOW if p.width > 30 else ((1, 3), 3)
        return (f"{op} at {p.name}", fn or best[p.name, op],
                getattr(plan, dispatch.METHODS[op] + "_plain"), inputs[op],
                work(kernel, p, out_rows, DOT_TERMS), *plain_iters)

    def kyber_timed(kernel, entry):
        inputs, plain, _ = kyber_main[entry]
        return (f"kyber.{entry} B={kb_}", getattr(kyber, entry), plain, inputs,
                work(kernel, None, kb_, KYBER_K), (1, 3), 3)

    def permute_timed(w):
        h = hashers[w]
        return (f"Poseidon2GL({w}).permute B={POSEIDON_BATCH}",
                functools.partial(kposeidon.permute, h),
                lambda x: torch.stack(h.permute_plain(list(x))), (gl_states[w],),
                poseidon_work("permute", w, POSEIDON_BATCH), *SLOW)

    def sponge_timed(rows, plain_iters):
        return (f"Poseidon2GL(8).hash_rows {tuple(rows.shape)}",
                functools.partial(kposeidon.sponge, commit_hasher),
                lambda r: torch.stack(commit_hasher.hash_rows_plain(r)), (rows,),
                poseidon_work("sponge", 8, *rows.shape), *plain_iters)

    timed = {
        name: nwc_timed(name, p, op, plan, inputs, out_rows)
        for family, p, plan, inputs in (("nwc64", P60_4096, plan60, inputs60),
                                        ("nwc32", P24_4096, p24, inputs24),
                                        ("gl64", GOLDILOCKS_4096, plan_gl, inputs_gl))
        for name, op, out_rows in ((f"{family}_product", "nwc", BATCH),
                                   (f"{family}_forward", "nwc_fwd", BATCH),
                                   (f"{family}_inverse", "nwc_inv", BATCH),
                                   (f"{family}_cached", "cached", BATCH),
                                   (f"{family}_dot", "dot", DOT_BATCH),
                                   (f"{family}_matvec", "matvec", MATVEC_BATCH_60))
    }
    timed["nwc32_matvec"] = nwc_timed("nwc32_matvec", DILITHIUM_256, "matvec", pdil,
                                      {"matvec": (s_dil, spec_dil)}, MATVEC_BATCH,
                                      matvec_fn)
    for kernel, entry in (("kyber_forward", "ntt"), ("kyber_inverse", "intt"),
                          ("kyber_product", "poly_mult"),
                          ("kyber_cached", "poly_mult_cached"), ("kyber_dot", "dot"),
                          ("kyber_matvec", "matvec")):
        timed[kernel] = kyber_timed(kernel, entry)
    timed["poseidon_permute"] = permute_timed(8)  # the Merkle trees' width
    timed["poseidon_sponge"] = sponge_timed(lde_rows, ONE)  # the STARK leaves
    # not kernel functions of their own: the product at the generic q, the
    # cached dots at P60_4096 and goldilocks_4096, the permutation at width
    # 12 and the sponge
    # over bench.py's rows of 8
    timed["generic-q product"] = nwc_timed("nwc64_product", p_gen, "nwc", plan_gen,
                                           inputs_gen, BATCH)
    timed["nwc64_dot cached"] = nwc_timed("nwc64_dot_cached", P60_4096, "dot_cached", plan60,
                                          inputs60, DOT_BATCH)
    timed["gl64_dot cached"] = nwc_timed("gl64_dot_cached", GOLDILOCKS_4096, "dot_cached",
                                         plan_gl, inputs_gl, DOT_BATCH)
    timed["nwc32_dot cached"] = nwc_timed("nwc32_dot_cached", P24_4096, "dot_cached", p24,
                                          inputs24, DOT_BATCH)
    timed["kyber_dot cached"] = kyber_timed("kyber_dot_cached", "dot_cached")
    # the matvecs' accumulate-and-inverse kernels alone (the ops above time
    # the forward of s with them), on the spectra of s that forward makes;
    # beside them the op's plain version
    for family, p, plan, (s_mv, spectra_mv), batch in (
            ("nwc64", P60_4096, plan60, inputs60["matvec"], MATVEC_BATCH_60),
            ("gl64", GOLDILOCKS_4096, plan_gl, inputs_gl["matvec"], MATVEC_BATCH_60),
            ("nwc32", DILITHIUM_256, pdil, (s_dil, spec_dil), MATVEC_BATCH)):
        fs_mv = plan.nwc_ntt_fwd(s_mv.reshape(-1, p.n)).reshape(s_mv.shape)
        timed[f"{family}_matvec kernel"] = (
            f"the matvec kernel alone at {p.name}, 4x4 B={batch}",
            functools.partial(lambda plan, fs, _s, spectra: plan._matvec(fs, spectra), plan,
                              fs_mv),
            plan.nwc_matvec_cached_plain, (s_mv, spectra_mv),
            work(f"{family}_matvec_alone", p, batch, DOT_TERMS), *(SLOW if p.width > 30 else
                                                                 ((1, 3), 3)))
    # the four-step's row kernels at p60_32768 and goldilocks_32768, B = 256,
    # as its product calls them, then its chains, not kernel functions of
    # their own

    def row_timed(name):
        run = large[name]
        fs, lib = run["plan"].fs, run["lib"]
        rk, ma, mb = fs.row_k, run["ma"], run["mb"]
        rows_l, rows_d, period = ma.shape[0], run["ma3"].shape[1], fs.n1
        pre, post = fs.kmid_nwc, fs.kmid_inv_nwc

        def entry(kernel, what, fn, plain, inputs, rows):
            return (f"{name} {what}", fn, plain, inputs,
                    work(f"{lib}_{kernel}", fs.row_params, rows, period=period), *SLOW)
        return {
            f"{lib}_cyclic_scaled": entry(
                "cyclic_scaled", f"row pass, {rows_l} rows of {fs.n2}",
                lambda x, y: rk.cyclic_poly_mult_scaled(x, y, pre, post),
                lambda x, y: rk.cyclic_poly_mult_scaled_plain(x, y, pre, post), (ma, mb),
                rows_l),
            f"{lib}_forward_scaled": entry(
                "forward_scaled", f"row forward, {rows_l} rows",
                lambda x: rk.ntt_fwd_scaled(x, pre), lambda x: rk.ntt_fwd_scaled_plain(x, pre),
                (ma,), rows_l),
            f"{lib}_inverse_scaled": entry(
                "inverse_scaled", f"row inverse, {rows_l} rows",
                lambda x: rk.ntt_inv_scaled(x, post),
                lambda x: rk.ntt_inv_scaled_plain(x, post), (ma,), rows_l),
            f"{lib}_cached_scaled": entry(
                "cached_scaled", f"row pass against a cached spectrum, {rows_l} rows",
                lambda x, y: rk.cyclic_poly_mult_cached_scaled(x, y, pre, post),
                lambda x, y: rk.cyclic_poly_mult_cached_scaled_plain(x, y, pre, post),
                (ma, run["spec_rows"]), rows_l),
            f"{lib}_dot_scaled": entry(
                "dot_scaled", f"dot row pass, K={DOT_TERMS}, {rows_d} rows",
                lambda x, y: rk.dot_scaled(x, y, pre, post),
                lambda x, y: rk.dot_scaled_plain(x, y, pre, post),
                (run["ma3"], run["mb3"]), rows_d),
            f"{lib}_dot_scaled cached": entry(
                "dot_cached_scaled", f"dot row pass, cached, K={DOT_TERMS}, {rows_d} rows",
                lambda x, y: rk.dot_scaled(x, y, pre, post, True),
                lambda x, y: rk.dot_scaled_plain(x, y, pre, post, True),
                (run["ma3"], run["spec3"]), rows_d),
            f"{lib}_matvec_scaled": entry(
                "matvec_scaled", f"4x4 matvec row pass, {rows_d} rows",
                lambda x, y: rk.matvec_scaled(x, y, post),
                lambda x, y: rk.matvec_scaled_plain(x, y, post),
                (run["s_rows"], run["mat_rows"]), rows_d),
        }
    for name in ("p60_32768", "goldilocks_32768"):
        timed.update(row_timed(name))
    # the column entry points at p60_32768 and goldilocks_32768, B = 256, as
    # their products call them: the forward down the (256, 128) matrices of
    # a, the inverse down those of the row pass's product
    for name in ("p60_32768", "goldilocks_32768"):
        run = large[name]
        fs32, lib = run["plan"].fs, run["lib"]
        col32 = fs32.col_k
        for entry, method, x in (("forward_cols", "nwc_ntt_fwd_cols", run["a"]),
                                 ("inverse_cols", "nwc_ntt_inv_cols",
                                  run["c_rows"].reshape(run["a"].shape))):
            timed[f"{lib}_{entry}"] = (
                f"{name} column pass, {x.shape[0] * fs32.n2} columns of {fs32.n1}",
                functools.partial(getattr(col32, method), width=fs32.n2),
                functools.partial(getattr(col32, method + "_plain"), width=fs32.n2), (x,),
                work(f"{lib}_{entry}", fs32.col_params, x.shape[0] * fs32.n2), *SLOW)
    chain_bytes = {}
    chains = [(name, op) for name in ("p60_32768", "goldilocks_32768")
              for op in ("nwc", "nwc_fwd", "nwc_inv", "cached", "dot", "dot_cached",
                         "matvec")]
    chains += [("p60_32768", "spectrum")]
    chains += [(name, op) for name in ("p60_1048576", "goldilocks_1048576")
               for op in ("nwc", "cached")]
    for name, op in chains:
        p, plan, inputs = large[name]["p"], large[name]["plan"], inputs_large[name]
        rows = inputs[op][0].shape[-2]  # B: output rows, or columns of s
        nbytes, built, imads = fourstep_work(op, p.n, p.q, rows)
        chain_bytes[f"{name} {op} chain"] = built
        timed[f"{name} {op} chain"] = (
            f"four-step {op} at {name}, B={rows}", best[name, op],
            getattr(plan, dispatch.METHODS[op] + "_plain"), inputs[op],
            (nbytes, imads), *SLOW)
    timed["width-12 permute"] = permute_timed(12)
    timed["rows-of-8 sponge"] = sponge_timed(rows8, SLOW)
    # K6: one exchange of p60_1048576's B = 4 leaves among 4 logical shards,
    # each way (the forward's leaves are the column pass's, the inverse's
    # the row pass's); the bound reads and writes every word once
    p20_batch = LARGE_ROWS[1][3]
    a2a_bytes = a2a_card_work(p20.n, p20_batch, A2A_CARDS)[0]
    for name, split, leaves in (("a2a_exchange", 2, a2a_cols),
                                ("a2a_exchange inverse", 1, a2a_rows)):
        timed[name] = (
            f"one exchange, split_from_end={split}, p60_1048576 B={p20_batch}, "
            f"{A2A_CARDS} shards of {tuple(leaves[0].shape)}",
            functools.partial(lambda split, *s: a2a.all_to_all(list(s), split), split),
            functools.partial(lambda split, *s: a2a.all_to_all_plain(list(s), split), split),
            tuple(leaves), (a2a_bytes, 0), (4, 20), 3)
    # the PyTorch call beside K6: the fused_exchange=False exchange, D^2
    # Tensor.copy_ calls (no one PyTorch call exchanges logical shards), by
    # graph replay
    library = {"a2a_exchange": graph_seconds_per_call(
        lambda *s: a2a.all_to_all_plain(list(s), 2), *a2a_cols)}

    def time_turns(kernel_fn, plain_fn, inputs, plain_iters, repeats):
        """Turns plain, kernel, kernel, plain; a kernel turn takes the
        device time of the calls by graph replay and the time per call of
        back-to-back calls by events, host time included."""
        times = {"graph": [], "events": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                times["graph"].append(graph_seconds_per_call(kernel_fn, *inputs))
                times["events"].append(device_seconds_per_call(kernel_fn, *inputs,
                                                               iters=(4, 20)))
            else:
                times["plain"].append(device_seconds_per_call(
                    plain_fn, *inputs, iters=plain_iters, repeats=repeats))
        return times

    rows, per_call, device_s = [], {}, {}
    for name, (what, fn, plain, inputs, (nbytes, imads), plain_iters,
               repeats) in timed.items():
        times = time_turns(fn, plain, inputs, plain_iters, repeats)
        t_kernel, t_plain = min(times["graph"]), min(times["plain"])
        t_host = host_seconds_per_call(fn, *inputs)
        t_bytes, t_ops = seconds(nbytes, imads, imad_per_s)
        per_call[name], device_s[name] = min(times["events"]), t_kernel
        print(f"timing {name} ({what}, s/call): kernel by graph replay "
              f"{times['graph']}, by events {times['events']}, host enqueue "
              f"{t_host:.4e}; plain {times['plain']}; bound: {nbytes} bytes "
              f"{t_bytes:.4e} s, {imads} IMADs {t_ops:.4e} s")
        if name not in REPLACES:
            continue
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name.split("_")[0]],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # no PyTorch call computes an NTT, its product mod q or a hash
            "library_ms": library[name] * 1e3 if name in library else None,
        })
    per_s = {name: 1 / t for name, t in per_call.items()}  # back to back, host included
    # the chains' parts, device time by graph replay: where a four-step
    # product's time goes; the column passes are the column entry points,
    # beside them (not in the chain) the transpose route they replace, the
    # flat radix kernel between torch transposes
    for name, *_ in LARGE_ROWS:
        run = large[name]
        plan, fs, lib = run["plan"], run["plan"].fs, run["lib"]
        col_k, rk, pre, post = fs.col_k, fs.row_k, fs.kmid_nwc, fs.kmid_inv_nwc
        parts = {
            f"column forward (a and b) on {lib}_forward_cols": (
                lambda x, y: column_fwd(fs, True, False, x, y), (run["a"], run["b"])),
            f"row {lib}_cyclic_scaled": (
                lambda x, y: rk.cyclic_poly_mult_scaled(x, y, pre, post),
                (run["ma"], run["mb"])),
            f"column inverse on {lib}_inverse_cols": (
                lambda y: column_inv(fs, y, True, False), (run["c_rows"],)),
        }
        total = 0.0
        for part, (fn, inputs) in parts.items():
            t = graph_seconds_per_call(fn, *inputs)
            total += t
            print(f"timing parts: {name} nwc chain, {part}: {t * 1e3:.4f} ms by graph replay, "
                  f"host enqueue {host_seconds_per_call(fn, *inputs):.4e} s")
        print(f"timing parts: {name} nwc chain, sum of its three parts {total * 1e3:.4f} ms; "
              f"bytes as built {chain_bytes[f'{name} nwc chain']}")
        route = {
            f"column forward (a and b) by the transposes, to_cols, {lib}_forward, from_cols":
                (lambda x, y: fs.from_cols(col_k.nwc_ntt_fwd(fs.to_cols(x, y))),
                 (run["a"], run["b"])),
            f"column inverse by the transposes, to_cols, {lib}_inverse, from_cols":
                (lambda y: fs.from_cols(col_k.nwc_ntt_inv(fs.to_cols(y))), (run["c_rows"],)),
            "of which the five transposes alone":
                (lambda x, y, z: (fs.from_cols(fs.to_cols(x, y)), fs.from_cols(fs.to_cols(z))),
                 (run["a"], run["b"], run["c"])),
        }
        for part, (fn, inputs) in route.items():
            t = graph_seconds_per_call(fn, *inputs)
            print(f"timing parts: {name}, not on the path: {part}: {t * 1e3:.4f} ms by "
                  "graph replay")
    # the sharded product on 4 logical shards against the single-device
    # chain, graph replay in two turns; the sanity band: the single chain
    # plus the bytes of three exchanges, under twice the single chain
    run20 = large["p60_1048576"]
    a_s, b_s = (sn20.put_natural(t.reshape(-1, fs20.n1, fs20.n2)) for t in (run20["a"], run20["b"]))
    sn20_x = sharded.ShardedNtt(fs20, shard_mesh)
    chains20 = {
        "single-device chain (FourStepPlan64)": lambda x: best["p60_1048576", "nwc"](x, run20["b"]),
        "sharded, fused_exchange=True (a2a_exchange)": lambda _: sn20.nwc_poly_mult(a_s, b_s),
        "sharded, fused_exchange=False (all_to_all_plain)":
            lambda _: sn20_x.nwc_poly_mult(a_s, b_s),
    }
    t20 = {}
    for _ in range(2):
        for what, fn in chains20.items():
            t = graph_seconds_per_call(fn, run20["a"])
            t20[what] = min(t, t20.get(what, t))
    single, fused = t20["single-device chain (FourStepPlan64)"], t20[
        "sharded, fused_exchange=True (a2a_exchange)"]
    for what, t in t20.items():
        print(f"timing sharded: p60_1048576 nwc B={p20_batch} on {A2A_CARDS} logical shards, "
              f"{what}: {t * 1e3:.4f} ms by graph replay ({t / single:.3f} x the single-device "
              f"chain); card {card}")
    t_x = (device_s["a2a_exchange"] + device_s["a2a_exchange inverse"]) / 2
    held, sent = a2a_work(p20.n, p20_batch)
    print(f"timing sharded: expected about the single chain plus three exchanges' bytes, "
          f"{(single + 3 * t_x) * 1e3:.4f} ms (an exchange {t_x * 1e3:.4f} ms, the mean of "
          f"both ways by graph replay); "
          f"{'within' if fused <= 2 * single else 'OUTSIDE'} the band of twice the single chain; "
          f"the exchange's bound {seconds(a2a_bytes, 0, 1)[0] * 1e3:.4f} ms on one card "
          f"({a2a_bytes} bytes at 3.35 TB/s), {sent / NVLINK_BYTES_PER_S * 1e3:.4f} ms on "
          f"{A2A_CARDS} cards over NVLink ({sent} of {held} bytes a card leave it, worked out, "
          f"not measured); card {card}")
    # the degree-2^17 commitment's two device stages by graph replay (few
    # calls: each holds gigabytes), against their bounds
    stark2 = {
        "LdePlan.extend (kernel order, the four-step)": (
            pk2.extend, (coeffs2,), lde_work(STARK_DEGREE, STARK_BLOWUP, STARK_COLS)),
        "leaf sponge (poseidon_sponge)": (
            functools.partial(kposeidon.sponge, commit_hasher), (rows2,),
            poseidon_work("sponge", 8, big_n, STARK_COLS)),
    }
    for what, (fn, inputs, (nbytes, imads)) in stark2.items():
        t = graph_seconds_per_call(fn, *inputs, calls=(1, 3))
        t_bytes, t_ops = seconds(nbytes, imads, imad_per_s)
        per_s[what] = 1 / t
        print(f"timing STARK degree {STARK_DEGREE}, {STARK_COLS} columns, N={big_n}: {what}: "
              f"{t * 1e3:.4f} ms by graph replay; bound: {nbytes} bytes {t_bytes * 1e3:.4f} "
              f"ms, {imads} IMADs {t_ops * 1e3:.4f} ms; share of bound "
              f"{max(t_bytes, t_ops) / t * 100:.1f} %")
    # the LDE's two parts: the coset scale and the zero pad (torch ops, as
    # JAX's are XLA), then the four-step's negacyclic forward of N points
    padded2 = pk2.scale_and_pad(coeffs2)
    lde_parts = {
        "coset scale and pad (torch)": (pk2.scale_and_pad, coeffs2),
        "four-step nwc_fwd (gl64_forward_cols, gl64_forward_scaled)": (
            dispatch.best(pk2.p, "nwc_fwd"), padded2),
    }
    for part, (fn, x) in lde_parts.items():
        t = graph_seconds_per_call(fn, x, calls=(1, 3))
        print(f"timing parts: STARK LDE at N={big_n}, {STARK_COLS} columns, {part}: "
              f"{t * 1e3:.4f} ms by graph replay")
    del padded2
    print(f"timing STARK degree {STARK_DEGREE}: the LDE's plain chain took {t_plain_lde:.3f} s "
          f"for all {STARK_COLS} columns ({LDE_CHECK_COLS} at a time, host clock, synchronized)")
    print(f"nwc_poly_mult_p60_32768_per_sec: "
          f"{large['p60_32768']['a'].shape[0] * per_s['p60_32768 nwc chain']:.1f} (B=256); "
          f"nwc_poly_mult_p60_1048576_per_sec: "
          f"{large['p60_1048576']['a'].shape[0] * per_s['p60_1048576 nwc chain']:.1f} (B=4); "
          f"nwc_poly_mult_goldilocks_32768_per_sec: "
          f"{large['goldilocks_32768']['a'].shape[0] * per_s['goldilocks_32768 nwc chain']:.1f}"
          f" (B=256); nwc_poly_mult_goldilocks_1048576_per_sec: "
          f"{large['goldilocks_1048576']['a'].shape[0] * per_s['goldilocks_1048576 nwc chain']:.1f}"
          f" (B=4); stark_leaf_rows_of_{STARK_COLS}_at_2^20_per_sec (device): "
          f"{big_n * per_s['leaf sponge (poseidon_sponge)']:.1f}; card {card}")
    print(f"nwc_poly_mult_p60_4096_per_sec: {BATCH * per_s['nwc64_product']:.1f}; "
          f"fwd_ntt_p60_4096_per_sec: {BATCH * per_s['nwc64_forward']:.1f}; "
          f"p60_4096_matvec_4x4_per_sec: {MATVEC_BATCH_60 * per_s['nwc64_matvec']:.1f}; "
          f"p60_4096_dot_K{DOT_TERMS}_per_sec: {DOT_BATCH * per_s['nwc64_dot']:.1f}, cached "
          f"{DOT_BATCH * per_s['nwc64_dot cached']:.1f} (B={DOT_BATCH}); "
          f"nwc_poly_mult_q576460752308273153_4096_per_sec: "
          f"{BATCH * per_s['generic-q product']:.1f}; "
          f"nwc_poly_mult_p24_4096_per_sec: {BATCH * per_s['nwc32_product']:.1f}; "
          f"fwd_ntt_p24_4096_per_sec: {BATCH * per_s['nwc32_forward']:.1f}; "
          f"p24_4096_dot_K{DOT_TERMS}_per_sec: {DOT_BATCH * per_s['nwc32_dot']:.1f}, cached "
          f"{DOT_BATCH * per_s['nwc32_dot cached']:.1f} (B={DOT_BATCH}); "
          f"dilithium_256_matvec_4x4_per_sec: {MATVEC_BATCH * per_s['nwc32_matvec']:.1f}; "
          f"B={BATCH} (p60 matvec B={MATVEC_BATCH_60}, dilithium matvec "
          f"B={MATVEC_BATCH}); mlkem_3329_poly_mult_per_sec: "
          f"{kb_ * per_s['kyber_product']:.1f}; mlkem_3329_ntt_per_sec: "
          f"{kb_ * per_s['kyber_forward']:.1f}; mlkem_768_matvec_3x3_per_sec: "
          f"{kb_ * per_s['kyber_matvec']:.1f}; B={kb_}; "
          f"nwc_poly_mult_goldilocks_4096_per_sec: {BATCH * per_s['gl64_product']:.1f}; "
          f"fwd_ntt_goldilocks_4096_per_sec: {BATCH * per_s['gl64_forward']:.1f}; "
          f"B={BATCH}; goldilocks_4096_dot_K{DOT_TERMS}_per_sec: "
          f"{DOT_BATCH * per_s['gl64_dot']:.1f}, cached {DOT_BATCH * per_s['gl64_dot cached']:.1f}"
          f" (B={DOT_BATCH}); poseidon2_w8_perm_per_sec: "
          f"{POSEIDON_BATCH * per_s['poseidon_permute']:.1f}; poseidon2_w12_perm_per_sec: "
          f"{POSEIDON_BATCH * per_s['width-12 permute']:.1f}; B={POSEIDON_BATCH}; "
          f"stark_leaf_rows_of_{STARK_COLS}_per_sec: "
          f"{lde_rows.shape[0] * per_s['poseidon_sponge']:.1f}; card {card}")
    print(f"wall time: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

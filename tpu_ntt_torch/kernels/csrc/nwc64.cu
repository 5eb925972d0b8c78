// nwc64.cu: the double-word NTT kernels of the 60-bit family, hand-written
// for Hopper (sm_90a).
//
// Replaces the dense bodies of kernel K1 of tpu_ntt/kernels/mxu64.py
// (MxuPlan64: any q of 31 to 62 bits, and its subclass SolinasPlan64 of
// tpu_ntt/kernels/sol64.py for trinomial q), all three of its pallas_calls:
//   nwc64_product  _nwc_kernel (:1442) through MxuPlan64._call (:1981): the
//                  negacyclic product and, with cyclic tables, _cyclic_kernel
//                  (:1474, cyclic_poly_mult)
//   nwc64_cached   _nwc_cached_kernel (:1691), the same launcher
//   nwc64_forward  _nwc_fwd_kernel (:1715: nwc_ntt_fwd), _fwd_kernel (:1544:
//                  ntt_fwd, with cyclic tables) and _nwc_spec_kernel (:1675:
//                  nwc_spectrum, by its scale)
//   nwc64_inverse  _nwc_inv_kernel (:1733: nwc_ntt_inv) and _inv_kernel
//                  (:1559: ntt_inv)
//   nwc64_forward_cols, nwc64_inverse_cols  the same two on every column of
//                  (R, n, width) natural rows: the four-step's column pass
//                  (tpu_ntt_torch/sharded.py), where JAX moves the axis in
//                  XLA around the same two kernels (tpu_ntt/sharded.py:419-442)
//   nwc64_dot      _make_dot_kernel (:1599) through MxuPlan64._dot_call
//                  (:2238), fresh or cached
//   nwc64_matvec   _make_matvec_kernel (:1639) through nwc_matvec_cached
//                  (:2305), after nwc64_forward has transformed s
// and, as the row pass of the four-step that serves 8192 < n <= 2^20
// (tpu_ntt_torch/sharded.py, where nwc64_forward_cols and nwc64_inverse_cols
// run the column pass), K1a's large-n bodies:
//   nwc64_cyclic_scaled   _cyclic_scaled_kernel (:1501): post . INTT(NTT(pre
//                  . a) o NTT(pre . b)), row r scaled by table row r % period;
//                  with the column pass it computes what the split-radix
//                  products _nwc_kernel_split{,2,3,4,5} (:1409, :1378,
//                  :1217, :1348, :1318) compute
//   nwc64_forward_scaled, nwc64_inverse_scaled  its two halves (entry scale
//                  then the cyclic forward; the cyclic inverse then the exit
//                  scale): with the column pass, the standalone split
//                  kernels _make_nwc_{fwd,inv,spec}_split_kernel (:1877,
//                  :1897, :1949)
//   nwc64_cached_scaled  the scaled product against the rows of a cached
//                  spectrum: _make_nwc_cached_split_kernel (:1918)
//   nwc64_dot_scaled, nwc64_matvec_scaled  the row passes of the dot and
//                  the matvec, whose TPU bodies (_make_dot_kernel :1599,
//                  _make_matvec_kernel :1639) run the same column / mid /
//                  row decomposition inside one kernel at these n
// Residues are uint64 in [0, q), (B, n) rows, natural order; a spectrum is in
// bit-reversed order.  Each function computes what tpu_ntt_torch.kernels
// MxuPlan64's plain version of it computes, bit for bit: the TPU kernel's
// function, not its algorithm.  The TPU's eight balanced int8 digits,
// carry-save lanes, REDC96, Solinas fold and four-step layout exist only
// because Mosaic has no 64-bit integers (mxu64.py:1-35); none of them is
// carried over.  Correct for any odd q < 2^62 and 32 <= n <= 8192 (the
// public window is 256 <= n <= 8192; below it, the four-step's sub-sizes).
//
// Two cores.  Thirteen entry points run the radix-8 core below ("The
// radix-8 core"): nwc64_forward, nwc64_inverse and their column entry
// points, and, fused onto it ("The product on the radix-8 core"),
// nwc64_product and nwc64_cached, both forwards, the slot product and the
// inverse in one kernel a launch, the four-step's row passes
// nwc64_cyclic_scaled, nwc64_cached_scaled and nwc64_dot_scaled ("The
// four-step's row passes fused"), the same with the scales at entry and
// exit and, for the dot, a sum of terms before the one inverse, and on the
// same two kernels' code the row forward nwc64_forward_scaled, the row
// inverse nwc64_inverse_scaled, the flat dot nwc64_dot (the dot without
// scales, on the negacyclic tables) and the matvec's accumulate-and-inverse
// nwc64_matvec (the row inverse with an l-term sum of slot products in
// place of its one load).  The other one, nwc64_matvec_scaled, runs the
// first core, correct first and simple (the design of nwc32.cu's first
// kernels on 64-bit words), until it moves onto the radix-8 one:
// * One thread block per output row, the row in dynamic shared memory, 8n
//   bytes, so device memory sees each operand and each result once.  n / 8
//   threads (at most 1024) run four butterflies each up to n = 8192 (below
//   n = 256, a warp, or n / 2).
// * A Gentleman-Sande inverse (bit-reversed in, natural out),
//   __syncthreads between stages.  The stage with m groups reads entry
//   m + g of a flat length-n table for group g, beside its Shoup companion
//   w' = floor(w * 2^64 / q); a constant multiply is Shoup with __umul64hi.
//   The cyclic ops take the tables with omega powers (ntt.py, "bitrev").
// * The slot product is Montgomery-64 (one REDC): a*b*2^-64.  Its 2^-64 and
//   the inverse's n^-1 are cancelled by one Shoup multiply with the scale the
//   wrapper passes (n^-1 against cached spectra, which hold their 2^64
//   already).  Montgomery serves every odd q < 2^62 in three wide
//   multiplies; the TPU's Solinas fold exists only because Mosaic has no
//   64-bit multiply.
// * Every value stays canonical in [0, q), also through the accumulation
//   (one conditional subtract after each add: two residues below q < 2^62
//   sum below 2^63).
// * The matvec's row pass keeps the l + k transforms of mxu64.py:1639
//   without holding A in shared memory (k * l * n * 8 bytes): the
//   four-step's wrapper transforms the rows of s with nwc64_forward_scaled,
//   and nwc64_matvec_scaled accumulates sum_j REDC(S_j * A_ij) from device
//   memory (A stays in L2), runs one inverse per output row and one Shoup
//   multiply more, by a table row, at exit.  Row r of a launch reads row
//   r % period of the (period, n) tables (w, w'): a batch of B polynomials
//   of n1 rows each passes period = n1, every row of a polynomial in one
//   launch.  The exit product leaves canonical words, as strict Shoup does
//   for q < 2^62.
//
// What bounds the first core on this card.  Not the 64-bit multiplies it was
// first thought to be: Hopper builds a 64 x 64 product from 32-bit IMADs,
// about twelve for a Shoup-64 or Montgomery-64 product, and at P60_4096,
// B = 2048 the product's 3 transforms and slot pass need 2.0e9 of them,
// 0.12 ms at 132 SMs x 64 IMADs a clock x 1.98 GHz, against 201 MB of
// operands and result, 0.06 ms at 3.35 TB/s.  Its product took about four
// times that bound (PERF.md): what holds it back is instruction issue and
// latency between barriers (index arithmetic, shared loads and stores,
// twiddle loads and conditional subtracts around each product) and the
// __syncthreads of every stage.  The radix-8 core's header says what it
// does about each.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t s = a + b;  // a, b < q < 2^62: no wrap
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b, uint64_t q) {
  return a >= b ? a - b : a + q - b;
}

// a * w mod q for a constant w with w_shoup = floor(w * 2^64 / q).
__device__ __forceinline__ uint64_t shoup_mul(uint64_t a, uint64_t w,
                                              uint64_t w_shoup, uint64_t q) {
  const uint64_t r = a * w - __umul64hi(a, w_shoup) * q;  // in [0, 2q)
  return r >= q ? r - q : r;
}

// REDC(a * b) = a * b * 2^-64 mod q, with q_prime = -q^-1 mod 2^64.
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b, uint64_t q,
                                             uint64_t q_prime) {
  const uint64_t lo = a * b;
  const uint64_t m = lo * q_prime;
  // lo + low64(m * q) is 0 mod 2^64 and carries out exactly when lo != 0.
  const uint64_t t = __umul64hi(a, b) + __umul64hi(m, q) + (lo != 0);  // < 2q
  return t >= q ? t - q : t;
}

struct Table {
  const uint64_t* w;
  const uint64_t* w_shoup;
};

// Gentleman-Sande inverse of one row, in place: stage s has m = 2^s groups
// of 2t values, t = n >> (s + 1), butterfly j pairing u = 2t * (j / t) +
// j % t with u + t, the stages from the last to the first.  No n^-1: the
// caller's scale carries it.
__device__ void inverse(uint64_t* x, int log_n, Table itw, uint64_t q) {
  const int n = 1 << log_n;
  for (int s = log_n - 1; s >= 0; --s) {
    const int lt = log_n - 1 - s;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
      const int g = j >> lt;
      const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
      const int v = u + (1 << lt);
      const uint64_t w = __ldg(itw.w + (1 << s) + g);
      const uint64_t ws = __ldg(itw.w_shoup + (1 << s) + g);
      const uint64_t xu = x[u], xv = x[v];
      x[u] = add_mod(xu, xv, q);
      x[v] = shoup_mul(sub_mod(xu, xv, q), w, ws, q);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The radix-8 core: nwc64_forward, nwc64_inverse, nwc64_forward_cols and
// nwc64_inverse_cols.  The same integers as a transform of one stage a
// barrier (a canonical result is unique), by another schedule:
//
// * Passes in registers.  A thread holds kWords = 8 words and a pass runs
//   three stages on them with no barrier between them: stage s + d of a
//   radix-8 group pairs its registers k and k + 2^(2 - d).  log n = 12 takes
//   four passes and three barriers instead of twelve of each.  The first
//   pass (in forward order) takes log n mod 3 stages, 3 if that is 0, and
//   there each thread holds 8 / 2^stages groups; it is the pass at stage 0,
//   where every group has the same twiddles (hi = 0 below).  Shapes, pass
//   stages and table offsets are template constants (kLogN): one kernel
//   for each log n from 5 to 13 and direction and layout, every loop
//   unrolled, no index arithmetic left to run but the thread's own.
// * Device memory once.  The forward's first pass loads straight from
//   device memory (register k of group j is element k * n / 2^stages + j:
//   a warp's 8-byte loads cover 256 contiguous bytes of a row), and its last
//   pass stores straight to it, the correction and the scale folded into
//   its registers (a thread's eight words are adjacent there: four 16-byte
//   stores on rows).  The inverse runs the passes in reverse order, so it
//   loads 16-byte vectors and stores 8-byte ones.  Shared memory is only the
//   exchange between passes: each pass reads and then writes the same eight
//   words of each thread, so one barrier a pass suffices.
// * No bank conflicts.  Word a of the tile (g * n + i on rows, i * tile + g
//   on columns) lives at a ^ ((a >> 3) & 15): bits 3 to 6 flip the low four
//   (within each 16 words, and one to one: bit 6 is never flipped, so bit
//   3 is known again, and with it bit 0).  Every pass's 8-byte accesses of
//   every half-warp then hit 16 distinct bank pairs, the two wavefronts 256
//   bytes need (tests/test_torch_nwc64_radix.py counts them at every n
//   from 32 to 8192, both layouts), for two instructions an address; a
//   first swizzle of six cost more than the conflicts it saved (PERF.md).
//   Not tried: warp shuffles of
//   the two 32-bit halves, two shuffles a word where shared memory costs a
//   store and a load, with the barrier between warps needed all the same.
// * Lazy butterflies (Harvey).  Forward lanes stay in [0, 4q): the CT
//   butterfly brings x under 2q with one compare, leaves the Shoup product
//   in [0, 2q), and returns x + v and x + 2q - v.  Inverse lanes stay in
//   [0, 2q): the GS butterfly corrects x + y once and leaves the Shoup
//   product of x + 2q - y in [0, 2q).  One correction to [0, q) at the
//   store: two compares for the forward at scale 1, else one Shoup product
//   of the lane as it is (any a < 2^64) and one compare.  q < 2^62 keeps
//   4q < 2^64, so no lane wraps.  Each invariant stands beside its step.
// * Twiddles a pass at a time, host-built (mxu64.pass_table): pass (s, R)
//   holds its stages' twiddles as 2^(R - 1) columns of 16-byte pairs of
//   twiddles for each of its 2^s groups, w and w' in two tables of the same
//   layout:
//   column 0 (stage s, then a pad word), column 1 (stage s + 1's two),
//   columns 2 and 3 (stage s + 2's four).  A stage loads what it uses, one
//   16-byte vector per two twiddles, and a warp's loads are 512 contiguous
//   bytes (consecutive groups, in the last pass) or one broadcast word (one
//   group, in the first).  Host-built rather than staged in shared memory:
//   at n = 4096 a block holds one row, so a staged table would be read once
//   a block all the same and would cost 75 KB of shared memory beside the
//   row's 32 KB; the per-pass tables (4680 words each of w and w' at
//   n = 4096, 1.14 n) stay in L2.
// * Several transforms a block, at least 128 threads.  On rows, a block
//   takes 1024 / n rows up to n = 1024 (n / 8 threads a row); on columns, a
//   tile of max(8, 1024 / n) adjacent columns (at least 64 bytes of each
//   row of the tile) up to n = 1024, then 8192 / n.  A tile holds at most
//   64 KiB.  A width below the tile is handled: the tile's transforms run on
//   into the next matrix of the batch.  __launch_bounds__ caps a thread at
//   64 registers, so 1024 threads of an SM stay resident.
//
// What bounds it on this card.  At P60_4096, B = 2048 a forward moves 134 MB
// (0.040 ms at 3.35 TB/s) and needs 0.6e9 IMADs for its 2048 x 24576 Shoup
// products (about 0.036 ms): both bounds lie close, and the first core took
// four times them, bound by issue.  This core issues 2.3 (forward) and 2.7
// (inverse) times fewer instructions (no index arithmetic left, no shared
// memory inside a pass, one compare a butterfly instead of three) and takes
// 2.8 times the bound.
// What is left, by tools/nwc64_variants.py on the H100 (PERF.md): a quarter
// of the forward is the Shoup product's 64-bit high half, and a fifth the
// loads and stores that the SM's other block does not hide (two blocks of
// 512 threads at 64 registers); the passes alone take 0.81 of the time,
// the device memory alone 0.50.

constexpr int kWords = 8;  // words a thread holds in every pass

__host__ __device__ constexpr int first_stages(int log_n) {
  return log_n - 3 * ((log_n - 1) / 3);
}
__host__ __device__ constexpr int passes(int log_n) { return (log_n - 1) / 3 + 1; }
// the first stage of pass p (forward order) and its stages
__host__ __device__ constexpr int pass_stage(int log_n, int p) {
  return p == 0 ? 0 : first_stages(log_n) + 3 * (p - 1);
}
__host__ __device__ constexpr int pass_stages(int log_n, int p) {
  return p == 0 ? first_stages(log_n) : 3;
}
// pass p's table begins after 2^(stages + stage) words of each earlier pass
__host__ __device__ constexpr int pass_offset(int log_n, int p) {
  int off = 0;
  for (int k = 0; k < p; ++k) {
    off += 1 << (pass_stages(log_n, k) + pass_stage(log_n, k));
  }
  return off;
}
// transforms a block: rows, or columns of the tile
__host__ __device__ constexpr int tile(int log_n, bool cols) {
  const int n = 1 << log_n;
  if (!cols) {
    return n >= 1024 ? 1 : 1024 / n;
  }
  const int least = 1024 / n > 8 ? 1024 / n : 8;
  return least < 8192 / n ? least : 8192 / n;
}
__host__ __device__ constexpr int block_threads(int log_n, bool cols) {
  return tile(log_n, cols) * ((1 << log_n) / kWords);
}

// Lazy arithmetic: q < 2^62, every lane a uint64_t below 4q < 2^64.

// a * w mod q up to one q: in [0, 2q) for ANY a < 2^64, given w < q and
// ws = floor(w * 2^64 / q) (a * ws / 2^64 falls short of a * w / q by less
// than a / 2^64 + 1 < 2).
__device__ __forceinline__ uint64_t shoup_lazy(uint64_t a, uint64_t w, uint64_t ws,
                                               uint64_t q) {
  return a * w - __umul64hi(a, ws) * q;
}

__device__ __forceinline__ uint64_t csub(uint64_t x, uint64_t m) {
  return x >= m ? x - m : x;
}

// Cooley-Tukey: x, y in [0, 4q) in, and out; with kFresh (the forward's
// first stage), x < 2q in, which skips the compare: words from device
// memory ([0, q)), or after a row pass's lazy entry scale ([0, 2q)).
template <bool kFresh>
__device__ __forceinline__ void ct(uint64_t& x, uint64_t& y, uint64_t w, uint64_t ws,
                                   uint64_t q) {
  const uint64_t q2 = 2 * q;
  const uint64_t u = kFresh ? x : csub(x, q2);  // x < 4q (kFresh: 2q): u in [0, 2q)
  const uint64_t v = shoup_lazy(y, w, ws, q);  // y < 4q < 2^64: v in [0, 2q)
  x = u + v;                                   // [0, 4q)
  y = u + q2 - v;                              // (0, 4q)
}

// Gentleman-Sande: x, y in [0, 2q) in, and out.
__device__ __forceinline__ void gs(uint64_t& x, uint64_t& y, uint64_t w, uint64_t ws,
                                   uint64_t q) {
  const uint64_t q2 = 2 * q;
  const uint64_t u = x, v = y;
  x = csub(u + v, q2);                      // u + v < 4q: [0, 2q)
  y = shoup_lazy(u + q2 - v, w, ws, q);     // u + 2q - v in (0, 4q): [0, 2q)
}

// Stage s + d's 2^d twiddles of group hi in pass tables w, ws at stage s:
// column 0 for d = 0, columns [2^(d - 1), 2^d) after.
template <int kS, int kD>
__device__ __forceinline__ void stage_twiddles(const uint64_t* tw, const uint64_t* tws,
                                               int hi, uint64_t (&w)[4], uint64_t (&ws)[4]) {
  constexpr int kFirst = kD == 0 ? 0 : (1 << kD) / 2;
  constexpr int kCount = kD == 0 ? 1 : (1 << kD) / 2;
  const ulonglong2* pw = reinterpret_cast<const ulonglong2*>(tw);
  const ulonglong2* ps = reinterpret_cast<const ulonglong2*>(tws);
#pragma unroll
  for (int m = 0; m < kCount; ++m) {
    const ulonglong2 a = __ldg(pw + ((kFirst + m) << kS) + hi);
    const ulonglong2 b = __ldg(ps + ((kFirst + m) << kS) + hi);
    w[2 * m] = a.x;
    w[2 * m + 1] = a.y;
    ws[2 * m] = b.x;
    ws[2 * m + 1] = b.y;
  }
}

// One stage of a pass: register k of each group of 2^kR meets k + span;
// kFresh: the forward's first stage, on lanes below 2q (ct).
template <int kS, int kR, int kD, bool kInverse, bool kFresh = false>
__device__ __forceinline__ void stage(uint64_t (&x)[kWords], const uint64_t* tw,
                                      const uint64_t* tws, int hi, uint64_t q) {
  constexpr int kGroup = 1 << kR, kSpan = kGroup >> (kD + 1);
  uint64_t w[4], ws[4];
  stage_twiddles<kS, kD>(tw, tws, hi, w, ws);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    const int k = r % kGroup;
    if (!(k & kSpan)) {
      const int e = k >> (kR - kD);  // the group's twiddle at this stage
      if constexpr (kInverse) {
        gs(x[r], x[r + kSpan], w[e], ws[e], q);
      } else {
        ct<kFresh>(x[r], x[r + kSpan], w[e], ws[e], q);
      }
    }
  }
}

// Pass (kS, kR): the forward's stages in order, the inverse's reversed.
template <int kS, int kR, bool kInverse, bool kFresh = false>
__device__ __forceinline__ void run_pass(uint64_t (&x)[kWords], const uint64_t* tw,
                                         const uint64_t* tws, int hi, uint64_t q) {
  if constexpr (kInverse) {
    if constexpr (kR > 2) stage<kS, kR, 2, true>(x, tw, tws, hi, q);
    if constexpr (kR > 1) stage<kS, kR, 1, true>(x, tw, tws, hi, q);
    stage<kS, kR, 0, true>(x, tw, tws, hi, q);
  } else {
    stage<kS, kR, 0, false, kFresh>(x, tw, tws, hi, q);
    if constexpr (kR > 1) stage<kS, kR, 1, false>(x, tw, tws, hi, q);
    if constexpr (kR > 2) stage<kS, kR, 2, false>(x, tw, tws, hi, q);
  }
}

// Element of register r in pass (kS, kR) for thread t of its transform:
// register c * 2^kR + k holds element k of group j = t + c * n / 8, which
// is hi * 2^kR * T + k * T + lo with T = n >> (kS + kR), (hi, lo) = j / T,
// j % T.
template <int kLogN, int kS, int kR>
__device__ __forceinline__ int element(int t, int r) {
  constexpr int kT = (1 << kLogN) >> (kS + kR);
  const int j = t + (r >> kR) * ((1 << kLogN) / kWords);
  return (j / kT) * (kT << kR) + (r % (1 << kR)) * kT + j % kT;
}

// The group of thread t in a pass of three stages at kS (its twiddles' hi).
template <int kLogN, int kS>
__device__ __forceinline__ int group(int t) {
  return t / ((1 << kLogN) >> (kS + 3));
}

// Word a of the tile in shared memory, swizzled (the core's header).
template <int kLogN, bool kCols>
__device__ __forceinline__ int tile_word(int g, int i) {
  const int a = kCols ? i * tile(kLogN, true) + g : g * (1 << kLogN) + i;
  return a ^ ((a >> 3) & 15);
}

template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void to_shared(const uint64_t (&x)[kWords], uint64_t* smem, int g,
                                          int t) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    smem[tile_word<kLogN, kCols>(g, element<kLogN, kS, kR>(t, r))] = x[r];
  }
}

template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void from_shared(uint64_t (&x)[kWords], const uint64_t* smem, int g,
                                            int t) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = smem[tile_word<kLogN, kCols>(g, element<kLogN, kS, kR>(t, r))];
  }
}

// Pass kP's words from device memory: row (or column) `at`, `stride`
// words between elements; on rows in the last pass, four 16-byte vectors.
template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void load(uint64_t (&x)[kWords], const uint64_t* in, size_t at,
                                     size_t stride, int t, bool live) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
  if constexpr (!kCols && kS + kR == kLogN && kR == 3) {  // element 8t + r
    const ulonglong2* v = reinterpret_cast<const ulonglong2*>(in + at + kWords * t);
#pragma unroll
    for (int m = 0; m < kWords / 2; ++m) {
      const ulonglong2 p = live ? v[m] : make_ulonglong2(0, 0);
      x[2 * m] = p.x;
      x[2 * m + 1] = p.y;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = live ? in[at + element<kLogN, kS, kR>(t, r) * stride] : 0;
  }
}

template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void store(const uint64_t (&x)[kWords], uint64_t* out, size_t at,
                                      size_t stride, int t, bool live) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
  if (!live) {
    return;
  }
  if constexpr (!kCols && kS + kR == kLogN && kR == 3) {
    ulonglong2* v = reinterpret_cast<ulonglong2*>(out + at + kWords * t);
#pragma unroll
    for (int m = 0; m < kWords / 2; ++m) {
      v[m] = make_ulonglong2(x[2 * m], x[2 * m + 1]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    out[at + element<kLogN, kS, kR>(t, r) * stride] = x[r];
  }
}

// v, which the compiler must take as new, so that it computes the
// swizzled shared-memory addresses of a thread's words again from it
// rather than keep earlier ones live (eight registers an exchange).  Where
// a thread has 64 registers, at 1024 threads a block (n = 8192) or an SM,
// the kernels spill without it (ptxas): each pass takes new indices at
// n = 8192 (opaque_passes), each phase of the fused product (b's forward,
// a's, the inverse: the same words) at n = 8192 and against a cached
// spectrum (opaque_phases).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
__host__ __device__ constexpr bool opaque_passes(int log_n) { return log_n == 13; }
__host__ __device__ constexpr bool opaque_phases(int log_n, bool cached) {
  return cached || log_n == 13;
}

// Passes kP, kP + 1, ... of the forward, each after the exchange with the
// pass before it.
template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void forward_passes(uint64_t (&x)[kWords], uint64_t* smem,
                                               const uint64_t* tw, const uint64_t* tws, int g,
                                               int t, uint64_t q) {
  if constexpr (kP < passes(kLogN)) {
    constexpr int kS = pass_stage(kLogN, kP), kOff = pass_offset(kLogN, kP);
    if constexpr (opaque_passes(kLogN)) {
      g = opaque(g);
      t = opaque(t);
    }
    to_shared<kLogN, kCols, kP - 1>(x, smem, g, t);
    __syncthreads();
    from_shared<kLogN, kCols, kP>(x, smem, g, t);
    run_pass<kS, 3, false>(x, tw + kOff, tws + kOff, group<kLogN, kS>(t), q);
    forward_passes<kLogN, kCols, kP + 1>(x, smem, tw, tws, g, t, q);
  }
}

// Passes kP, kP - 1, ... 0 of the inverse.
template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void inverse_passes(uint64_t (&x)[kWords], uint64_t* smem,
                                               const uint64_t* tw, const uint64_t* tws, int g,
                                               int t, uint64_t q) {
  if constexpr (kP >= 0) {
    constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
    constexpr int kOff = pass_offset(kLogN, kP);
    if constexpr (opaque_passes(kLogN)) {
      g = opaque(g);
      t = opaque(t);
    }
    to_shared<kLogN, kCols, kP + 1>(x, smem, g, t);
    __syncthreads();
    from_shared<kLogN, kCols, kP>(x, smem, g, t);
    run_pass<kS, kR, true>(x, tw + kOff, tws + kOff, kP == 0 ? 0 : group<kLogN, kS>(t), q);
    inverse_passes<kLogN, kCols, kP - 1>(x, smem, tw, tws, g, t, q);
  }
}

// The forward's store: lanes in [0, 4q) to [0, q), times `scale` (one lazy
// Shoup product of the lane as it is) unless it is 1 (two compares).
__device__ __forceinline__ void forward_out(uint64_t (&x)[kWords], uint64_t q, uint64_t scale,
                                            uint64_t scale_shoup) {
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = scale == 1 ? csub(csub(x[r], 2 * q), q)
                      : csub(shoup_lazy(x[r], scale, scale_shoup, q), q);
  }
}

// The transforms of `transforms` rows (kCols false: row r at r * n) or
// columns (column c of matrix m at m * n * width + c, `width` words between
// its elements) from `in` to `out`, each then times `scale` (the forward
// skips scale 1).  Tables: the per-pass layout of mxu64.pass_table.
template <int kLogN, bool kInverse, bool kCols>
__global__ void __launch_bounds__(block_threads(kLogN, kCols),
                                  1024 / block_threads(kLogN, kCols))
    transform_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, Table pt,
                     long long transforms, int width, uint64_t q, uint64_t scale,
                     uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, kCols);
  constexpr int kLast = passes(kLogN) - 1;
  const int tid = threadIdx.x;
  const int g = kCols ? tid % kTile : tid / kPer;
  const int t = kCols ? tid / kTile : tid % kPer;
  const long long tg = static_cast<long long>(blockIdx.x) * kTile + g;
  const bool live = tg < transforms;
  const size_t at = !live ? 0
                    : kCols ? static_cast<size_t>(tg / width) * kN * width + tg % width
                            : static_cast<size_t>(tg) * kN;
  const size_t stride = kCols ? width : 1;
  uint64_t x[kWords];
  if constexpr (!kInverse) {
    // lanes in [0, q) from device memory: inside the forward's [0, 4q)
    load<kLogN, kCols, 0>(x, in, at, stride, t, live);
    run_pass<0, first_stages(kLogN), false, true>(x, pt.w, pt.w_shoup, 0, q);
    forward_passes<kLogN, kCols, 1>(x, smem, pt.w, pt.w_shoup, g, t, q);
    forward_out(x, q, scale, scale_shoup);
    store<kLogN, kCols, kLast>(x, out, at, stride, t, live);
  } else {
    // lanes in [0, q) from device memory: inside the inverse's [0, 2q)
    load<kLogN, kCols, kLast>(x, in, at, stride, t, live);
    constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
    run_pass<kS, 3, true>(x, pt.w + kOff, pt.w_shoup + kOff, group<kLogN, kS>(t), q);
    inverse_passes<kLogN, kCols, kLast - 1>(x, smem, pt.w, pt.w_shoup, g, t, q);
#pragma unroll
    for (int r = 0; r < kWords; ++r) {  // [0, 2q) -> [0, q)
      x[r] = csub(shoup_lazy(x[r], scale, scale_shoup, q), q);
    }
    store<kLogN, kCols, 0>(x, out, at, stride, t, live);
  }
}

// The product on the radix-8 core, fused (nwc64_product, nwc64_cached): the
// forward of b, the forward of a, the slot product in registers, the
// inverse; device memory sees each operand and the result once.  After the
// forward's last pass thread t holds spectrum words 8t ... 8t + 7 of its
// row, the words the inverse's first pass starts from, so the slot product
// needs no exchange and no barrier.  The spectrum of b waits while the
// forward of a runs either in eight more registers a thread or, with
// kSpectrumInRegisters false, in the output row, at the thread's own words
// (16-byte vectors written after b's forward and read back, mostly from L2,
// before the slot product; the result overwrites them).  A cached b is a
// spectrum, loaded as 16-byte vectors where a's forward leaves its words,
// and transformed not at all.  tools/nwc64_variants.py times the places
// (PERF.md; a second shared-memory tile, tried too, spilled at 64 registers).
constexpr bool kSpectrumInRegisters = true;

// Whether b's spectrum waits in registers at log n: at 1024 threads a block
// (n = 8192) 64 registers a thread are all an SM has, so there it waits in
// the output row whatever kSpectrumInRegisters says.
__host__ __device__ constexpr bool spectrum_in_registers(int log_n) {
  return kSpectrumInRegisters && block_threads(log_n, false) < 1024;
}
// Blocks an SM for __launch_bounds__: 1024 threads at 64 registers, or 512
// (128 registers) when b's spectrum takes its eight registers more.
__host__ __device__ constexpr int product_blocks(int log_n, bool cached) {
  const int threads = block_threads(log_n, false);
  if (cached || !spectrum_in_registers(log_n)) {
    return 1024 / threads;
  }
  return threads > 384 ? 1 : 512 / threads;
}

// REDC(a * b) for a * b < q * 2^64: in [0, 2q), no compare (mont_mul's t).
__device__ __forceinline__ uint64_t mont_lazy(uint64_t a, uint64_t b, uint64_t q,
                                              uint64_t q_prime) {
  const uint64_t lo = a * b;
  const uint64_t m = lo * q_prime;
  return __umul64hi(a, b) + __umul64hi(m, q) + (lo != 0);  // (a b + m q) / 2^64 < 2q
}

// out = INTT(NTT(a) . NTT(b)) * scale on `rows` rows (b a spectrum with
// kCached).  Tables: the per-pass layout of mxu64.pass_table.
template <int kLogN, bool kCached>
__global__ void __launch_bounds__(block_threads(kLogN, false), product_blocks(kLogN, kCached))
    product_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                   uint64_t* __restrict__ out, Table tw, Table itw, int rows, uint64_t q,
                   uint64_t q_prime, uint64_t scale, uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  constexpr int kLast = passes(kLogN) - 1;
  constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
  constexpr bool kInRegisters = spectrum_in_registers(kLogN);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  uint64_t y[kWords];
  if constexpr (!kCached) {
    // lanes in [0, q) from device memory: inside the forward's [0, 4q)
    load<kLogN, false, 0>(y, b, at, 1, t, live);
    run_pass<0, first_stages(kLogN), false, true>(y, tw.w, tw.w_shoup, 0, q);
    forward_passes<kLogN, false, 1>(y, smem, tw.w, tw.w_shoup, g, t, q);
#pragma unroll
    for (int r = 0; r < kWords; ++r) {  // [0, 4q) -> [0, 2q): the slot's lane
      y[r] = csub(y[r], 2 * q);
    }
    if constexpr (!kInRegisters) {
      store<kLogN, false, kLast>(y, out, at, 1, t, live);  // words 8t ... 8t + 7
    }
    __syncthreads();  // a's first exchange overwrites the words b's last pass read
  }
  constexpr bool kOpaque = opaque_phases(kLogN, kCached);
  const int ga = kOpaque ? opaque(g) : g, ta = kOpaque ? opaque(t) : t;  // a's forward
  uint64_t x[kWords];
  load<kLogN, false, 0>(x, a, at, 1, ta, live);
  run_pass<0, first_stages(kLogN), false, true>(x, tw.w, tw.w_shoup, 0, q);
  forward_passes<kLogN, false, 1>(x, smem, tw.w, tw.w_shoup, ga, ta, q);
  if constexpr (kCached) {
    load<kLogN, false, kLast>(y, b, at, 1, ta, live);  // [0, q), times 2^64
  } else if constexpr (!kInRegisters) {
    load<kLogN, false, kLast>(y, out, at, 1, ta, live);  // this thread's own words
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    // x and y in [0, 2q), or with kCached x in [0, 4q) and y in [0, q): x y
    // < 4 q^2 < q 2^64 (q < 2^62), so the lazy REDC is in [0, 2q), the
    // inverse's range
    x[r] = mont_lazy(kCached ? x[r] : csub(x[r], 2 * q), y[r], q, q_prime);
  }
  const int gi = kOpaque ? opaque(g) : g, ti = kOpaque ? opaque(t) : t;  // the inverse
  run_pass<kS, 3, true>(x, itw.w + kOff, itw.w_shoup + kOff, group<kLogN, kS>(ti), q);
  inverse_passes<kLogN, false, kLast - 1>(x, smem, itw.w, itw.w_shoup, gi, ti, q);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, 2q) -> [0, q), n^-1 (and 2^64) folded in
    x[r] = csub(shoup_lazy(x[r], scale, scale_shoup, q), q);
  }
  store<kLogN, false, 0>(x, out, at, 1, ti, live);
}

// The four-step's row passes fused on the radix-8 core (nwc64_cyclic_scaled,
// nwc64_cached_scaled, nwc64_dot_scaled): product_kernel on cyclic tables
// between an entry scale pre[r % period] and an exit scale post[r % period],
// each a (period, n) table of Shoup pairs (w, w'); device memory sees each
// operand and the result once.  The entry scale is one lazy Shoup product a
// word on the words the first pass loads (any word in, [0, 2q) out: the
// first stage's range), pre's words read at the same positions, once for
// each forward; `scale` (n^-1 2^64 after two fresh spectra, n^-1 against a
// cached one) one lazy Shoup product at the slot; post one more and one
// compare at the store.  pre and post come from L2 where they fit (2 x 512
// KiB at p60_32768's period 256; at p60_1048576 2 x 16 MiB, each row read
// by B rows 1024 blocks apart, from L2 or device memory).  A cached b holds
// the rows of a cached spectrum (times 2^64), used as they are: neither
// scaled nor transformed.  A fresh b's spectrum waits in the output row at
// the thread's own words (16-byte vectors, read back mostly from L2) while
// a's forward runs: eight registers more ran slower, and pre's words kept
// in registers from b's forward to a's spilled at n = 8192
// (tools/nwc64_variants.py; the times are in PERF.md section 5).
//
// Registers.  Each table word comes with its Shoup companion, so a scale's
// words take 32 registers a thread beside the eight lanes' 16.  The row
// passes run at 512 threads an SM (128 registers), but at n = 8192, whose
// 1024 threads a block leave a thread 64, where the compiler would issue all
// of a scale's loads at once and spill (ptxas).  There (`tight`) each scale
// reads its words in two halves, the second half's addresses offset by a
// compare on the first half's last product that is always false (`after`),
// so that they wait for it, and each phase takes its thread indices and
// tables anew (opaque).  (A cached b's words staged in shared memory from
// the start spilled more there: 216 bytes at n = 8192,
// tools/nwc64_variants.py, PERF.md.)  tools/nwc64_variants.py times the
// threads an SM and the tight schedule at every n.
// Threads an SM of the row passes below n = 8192, for __launch_bounds__.
constexpr int kRowThreads = 512;
// Threads an SM from which a row pass runs `tight`.
constexpr int kTightFrom = 1024;

__host__ __device__ constexpr int scaled_blocks(int log_n) {
  const int threads = block_threads(log_n, false);
  return threads > kRowThreads / 2 ? 1 : kRowThreads / threads;
}
// Whether a thread has 64 registers (1024 threads an SM, or kTightFrom).
__host__ __device__ constexpr bool tight(int log_n) {
  return scaled_blocks(log_n) * block_threads(log_n, false) >= kTightFrom;
}

// v, which the compiler must take as new (opaque, on 64 bits): table words
// and twiddles are read again from it, not kept from an earlier phase.
__device__ __forceinline__ size_t opaque_row(size_t v) {
  asm volatile("" : "+l"(v));
  return v;
}
__device__ __forceinline__ Table opaque_table(Table t) {
  uintptr_t w = reinterpret_cast<uintptr_t>(t.w), ws = reinterpret_cast<uintptr_t>(t.w_shoup);
  asm volatile("" : "+l"(w), "+l"(ws));
  return Table{reinterpret_cast<const uint64_t*>(w), reinterpret_cast<const uint64_t*>(ws)};
}
// 0, from a lane v the caller knows below `bound`: an address offset by it
// waits for v.
__device__ __forceinline__ size_t after(uint64_t v, uint64_t bound) { return v >= bound; }

// x times table row `srow`'s words at the first pass's positions (the
// store's), lazily: any words in, [0, 2q) out.  With kHalves = 2 the second
// four words' table words are read after the first four's products.
template <int kLogN, int kHalves>
__device__ __forceinline__ void times_row(uint64_t (&x)[kWords], Table table, size_t srow,
                                          int t, uint64_t q) {
  constexpr int kHalf = kWords / kHalves;
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    const size_t row = h == 0 ? srow : srow + after(x[h * kHalf - 1], 2 * q);
#pragma unroll
    for (int r = h * kHalf; r < (h + 1) * kHalf; ++r) {
      const int e = element<kLogN, 0, first_stages(kLogN)>(t, r);
      x[r] = shoup_lazy(x[r], __ldg(table.w + row + e), __ldg(table.w_shoup + row + e), q);
    }
  }
}

// The forward of row `at` of `in`, its words times pre's (with kScaled;
// without, the flat dot's canonical words as they are): lanes in [0, 4q)
// out, spectrum words 8t ... 8t + 7.
template <int kLogN, int kHalves, bool kScaled = true>
__device__ __forceinline__ void scaled_forward(uint64_t (&x)[kWords], const uint64_t* in,
                                               size_t at, Table pre, size_t srow, uint64_t* smem,
                                               Table tw, int g, int t, bool live, uint64_t q) {
  load<kLogN, false, 0>(x, in, at, 1, t, live);
  if constexpr (kScaled) {
    times_row<kLogN, kHalves>(x, pre, srow, t, q);  // [0, 2q): the first stage's range
  }  // else [0, q) from device memory: inside it too
  run_pass<0, first_stages(kLogN), false, true>(x, tw.w, tw.w_shoup, 0, q);
  forward_passes<kLogN, false, 1>(x, smem, tw.w, tw.w_shoup, g, t, q);
}

// The inverse from x (lanes in [0, 2q): the slot's words, times `scale`)
// and the store of row `at`, times post's words at the store's positions
// (with kScaled), one compare.
template <int kLogN, bool kScaled = true>
__device__ __forceinline__ void scaled_inverse(uint64_t (&x)[kWords], uint64_t* out, size_t at,
                                               Table post, size_t srow, uint64_t* smem,
                                               Table itw, int g, int t, bool live, uint64_t q) {
  constexpr int kLast = passes(kLogN) - 1;
  constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
  run_pass<kS, 3, true>(x, itw.w + kOff, itw.w_shoup + kOff, group<kLogN, kS>(t), q);
  inverse_passes<kLogN, false, kLast - 1>(x, smem, itw.w, itw.w_shoup, g, t, q);
  if constexpr (kScaled) {
    times_row<kLogN, tight(kLogN) ? 2 : 1>(x, post, srow, t, q);
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, 2q) -> [0, q)
    x[r] = csub(x[r], q);
  }
  store<kLogN, false, 0>(x, out, at, 1, t, live);
}

// The four-step's row forward on the radix-8 core (nwc64_forward_scaled):
// out = NTT(pre . in) * scale on `rows` rows, row r scaled by row r % period
// of the (period, n) Shoup table pre: scaled_forward (pre's lazy product on
// the words the first pass loads), then the transforms' store (`scale` one
// lazy Shoup product where it is not 1: a cacheable spectrum, times 2^64)
// of spectrum words 8t ... 8t + 7.  Rows tile a block as in the
// transforms, at the row passes' threads an SM (scaled_blocks) and, where
// tight, pre's words in two halves: at the transforms' 1024 threads an SM
// it spilled at n = 512 and ran about 1 % faster at n = 128, 4 % slower at
// 1024 (tools/nwc64_variants.py, PERF.md section 5).
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN, false), scaled_blocks(kLogN))
    forward_scaled_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, Table tw,
                          Table pre, int period, int rows, uint64_t q, uint64_t scale,
                          uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  const size_t srow = live ? static_cast<size_t>(row % period) * kN : 0;
  uint64_t x[kWords];
  scaled_forward<kLogN, tight(kLogN) ? 2 : 1>(x, in, at, pre, srow, smem, tw, g, t, live, q);
  forward_out(x, q, scale, scale_shoup);
  store<kLogN, false, passes(kLogN) - 1>(x, out, at, 1, t, live);
}

// The four-step's row inverse on the radix-8 core (nwc64_inverse_scaled):
// out = post . INTT(in) * scale on `rows` bit-reversed spectra, row r scaled
// by row r % period of the (period, n) Shoup table post.  The spectrum's
// words 8t ... 8t + 7 (the inverse's first pass; 16-byte vectors), one lazy
// Shoup product by `scale` (n^-1) on them, then scaled_inverse: the passes,
// post's lazy product at the store's positions (in halves where tight) and
// one compare.  Rows tile a block as in the transforms, at the row passes'
// threads an SM (scaled_blocks).
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN, false), scaled_blocks(kLogN))
    inverse_scaled_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, Table itw,
                          Table post, int period, int rows, uint64_t q, uint64_t scale,
                          uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  const size_t srow = live ? static_cast<size_t>(row % period) * kN : 0;
  uint64_t x[kWords];
  load<kLogN, false, passes(kLogN) - 1>(x, in, at, 1, t, live);  // words 8t ... 8t + 7
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // any word times n^-1: [0, 2q), the inverse's range
    x[r] = shoup_lazy(x[r], scale, scale_shoup, q);
  }
  scaled_inverse<kLogN>(x, out, at, post, srow, smem, itw, g, t, live, q);
}

// The slot's REDC(x y) of a's lane x in [0, 4q) and b's y, in [0, 2q)
// (fresh, after its compare) or [0, q) (cached): one compare on x against
// a fresh y, so that x y < 4 q^2 < q 2^64 (q < 2^62) either way and the
// lazy REDC is in [0, 2q), the inverse's range.
template <bool kCached>
__device__ __forceinline__ uint64_t slot(uint64_t x, uint64_t y, uint64_t q, uint64_t q_prime) {
  return mont_lazy(kCached ? x : csub(x, 2 * q), y, q, q_prime);
}

// out = post . INTT(NTT(pre . a) o NTT(pre . b)) * scale on `rows` rows (b
// a cached spectrum's rows with kCached), row r scaled by row r % period.
// Tables: the per-pass layout of mxu64.pass_table.
template <int kLogN, bool kCached>
__global__ void __launch_bounds__(block_threads(kLogN, false), scaled_blocks(kLogN))
    cyclic_scaled_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                         uint64_t* __restrict__ out, Table tw, Table itw, Table pre, Table post,
                         int period, int rows, uint64_t q, uint64_t q_prime, uint64_t scale,
                         uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  constexpr int kLast = passes(kLogN) - 1;
  constexpr bool kTight = tight(kLogN);
  constexpr int kHalves = kTight ? 2 : 1;
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  const size_t srow = live ? static_cast<size_t>(row % period) * kN : 0;
  uint64_t y[kWords];
  if constexpr (!kCached) {
    scaled_forward<kLogN, kHalves>(y, b, at, pre, srow, smem, tw, g, t, live, q);
#pragma unroll
    for (int r = 0; r < kWords; ++r) {  // [0, 4q) -> [0, 2q): the slot's lane
      y[r] = csub(y[r], 2 * q);
    }
    store<kLogN, false, kLast>(y, out, at, 1, t, live);  // words 8t ... 8t + 7
    __syncthreads();  // a's first exchange overwrites the words b's last pass read
  }
  const int ga = kTight ? opaque(g) : g, ta = kTight ? opaque(t) : t;  // a's forward
  uint64_t x[kWords];
  scaled_forward<kLogN, kHalves>(x, a, at, pre, kCached ? srow : opaque_row(srow), smem,
                                 kTight ? opaque_table(tw) : tw, ga, ta, live, q);
  if constexpr (kCached) {
    load<kLogN, false, kLast>(y, b, at, 1, ta, live);  // [0, q), times 2^64
  } else {
    load<kLogN, false, kLast>(y, out, at, 1, ta, live);  // this thread's own words
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, 2q) times scale: [0, 2q)
    x[r] = shoup_lazy(slot<kCached>(x[r], y[r], q, q_prime), scale, scale_shoup, q);
  }
  const int gi = kTight ? opaque(g) : g, ti = kTight ? opaque(t) : t;  // the inverse
  scaled_inverse<kLogN>(x, out, at, post, srow, smem, kTight ? opaque_table(itw) : itw, gi, ti,
                        live, q);
}

// The dot's row pass on the radix-8 core: out = post . INTT(sum_k NTT(pre .
// a_k) o NTT(pre . b_k)) * scale for (terms, rows, n) stacks a and b (b
// cached spectra's rows with kCached), one output row per row.  One loop
// of steps, each one forward: for a fresh term b's forward, whose spectrum
// waits in a tile of shared memory at the thread's own words (8t ...
// 8t + 7, where the slot's lanes are: no barrier), then a's, whose slot
// product adds into the sum, in a second tile at the same words; a cached
// term's b words are read after a's forward.  The sum stays in [0, 2q)
// by one compare after each add (two lanes below 2q sum below 4q); after
// the last term its words times `scale`, then one inverse.  A thread holds
// only the forward's lanes through it, and each step takes its thread
// indices and tables anew (opaque), so that the compiler keeps no address
// or twiddle of the loop live across it.  The row pass's blocks an SM and tight schedule (where
// tight, the slot takes the sum's words one at a time, so that no read of a
// later word passes the store of an earlier one).
//
// With kScaled false the same loop is the flat dot (nwc64_dot, K1b at
// n <= 8192): out = INTT(sum_k NTT(a_k) o NTT(b_k)) * scale on the
// negacyclic tables, no pre or post product (pre, post and period unused):
// the first pass takes the rows' canonical words, the store one compare.
// Its three tiles take 24 KiB a block up to n = 1024, 48 KiB at 2048, 96
// KiB at 4096 and 192 KiB at 8192: room for two blocks of 512 threads at
// n = 4096, which the row pass's 512 threads an SM left to one (ptxas gave
// a thread 96 registers).  Without scale tables the dot's tight schedule
// fits 64 registers, so from n = 128 the flat dot runs 1024 threads an SM
// and tight, 3.5 % faster fresh and 5.6 % cached at n = 4096; at n = 32
// and 64 that spilled 8 bytes, and there it keeps 512
// (tools/nwc64_variants.py, PERF.md section 5).

// Tiles of shared memory a dot block holds: the exchange's, the sum's, and
// a fresh b's spectrum's.
__host__ __device__ constexpr int dot_tiles(bool cached) { return cached ? 2 : 3; }

// Blocks an SM of a dot for __launch_bounds__: the row pass's, or the flat
// dot's 1024 threads an SM from n = 128.
__host__ __device__ constexpr int dot_blocks(int log_n, bool scaled) {
  return scaled || log_n < 7 ? scaled_blocks(log_n) : 1024 / block_threads(log_n, false);
}

template <int kLogN, bool kCached, bool kScaled>
__global__ void __launch_bounds__(block_threads(kLogN, false), dot_blocks(kLogN, kScaled))
    dot_scaled_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                      uint64_t* __restrict__ out, Table tw, Table itw, Table pre, Table post,
                      int period, int terms, int rows, uint64_t q, uint64_t q_prime,
                      uint64_t scale, uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  constexpr int kLast = passes(kLogN) - 1;
  constexpr int kHalves = tight(kLogN) ? 2 : 1;
  // 64 registers a thread: the slot takes the sum's words one at a time
  constexpr bool kTight = dot_blocks(kLogN, kScaled) * block_threads(kLogN, false) >= kTightFrom;
  uint64_t* const sum = smem + kTile * kN;
  uint64_t* const spectrum = smem + 2 * kTile * kN;
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  const size_t srow = live ? static_cast<size_t>(row % period) * kN : 0;
  uint64_t x[kWords];
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = 0;
  }
  to_shared<kLogN, false, kLast>(x, sum, g, t);
  const int steps = kCached ? terms : 2 * terms;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const int k = kCached ? step : step / 2;
    const bool of_b = !kCached && step % 2 == 0;  // b's forward of a fresh term
    const size_t ak = live ? (static_cast<size_t>(k) * rows + row) * kN : 0;
    const int gs = opaque(g), ts = opaque(t);
    scaled_forward<kLogN, kHalves, kScaled>(x, of_b ? b : a, ak, pre, opaque_row(srow), smem,
                                            opaque_table(tw), gs, ts, live, q);
    if (of_b) {
#pragma unroll
      for (int r = 0; r < kWords; ++r) {  // [0, 4q) -> [0, 2q): the slot's lane
        x[r] = csub(x[r], 2 * q);
      }
      to_shared<kLogN, false, kLast>(x, spectrum, gs, ts);
    } else if constexpr (kTight) {
      uint64_t y[kWords];
      if constexpr (kCached) {
        load<kLogN, false, kLast>(y, b, ak, 1, ts, live);  // [0, q), times 2^64
      }
#pragma unroll
      for (int r = 0; r < kWords; ++r) {  // [0, 2q) + [0, 2q) < 4q -> [0, 2q)
        const int e = tile_word<kLogN, false>(gs, kWords * ts + r);
        const uint64_t p = slot<kCached>(x[r], kCached ? y[r] : spectrum[e], q, q_prime);
        sum[e] = csub(sum[e] + p, 2 * q);
      }
    } else {
      uint64_t y[kWords], acc[kWords];
      if constexpr (kCached) {
        load<kLogN, false, kLast>(y, b, ak, 1, ts, live);  // [0, q), times 2^64
      } else {
        from_shared<kLogN, false, kLast>(y, spectrum, gs, ts);  // [0, 2q)
      }
      from_shared<kLogN, false, kLast>(acc, sum, gs, ts);
#pragma unroll
      for (int r = 0; r < kWords; ++r) {  // [0, 2q) + [0, 2q) < 4q -> [0, 2q)
        acc[r] = csub(acc[r] + slot<kCached>(x[r], y[r], q, q_prime), 2 * q);
      }
      to_shared<kLogN, false, kLast>(acc, sum, gs, ts);
    }
    if (step + 1 < steps) {
      __syncthreads();  // the next step's first exchange overwrites the words this one's read
    }
  }
  const int gi = opaque(g), ti = opaque(t);  // the inverse
  from_shared<kLogN, false, kLast>(x, sum, gi, ti);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, 2q) -> [0, 2q)
    x[r] = shoup_lazy(x[r], scale, scale_shoup, q);
  }
  scaled_inverse<kLogN, kScaled>(x, out, at, post, srow, smem, opaque_table(itw), gi, ti, live,
                                 q);
}

// The matvec's accumulate-and-inverse on the radix-8 core (nwc64_matvec,
// K1c): out[i, r] = INTT(sum_j S[j, r] o A[i, j]) * scale for the (cols,
// batch, n) plain spectra S of s (the wrapper's nwc64_forward) and the
// (rows, cols, n) cached spectra A (times 2^64, so each REDC gives the
// plain product), on the per-pass tables of mxu64.pass_table.  Thread t of
// output row (i, r) loads, for each j, words 8t ... 8t + 7 of S[j, r] and
// of A[i, j] as 16-byte vectors: both are canonical bit-reversed spectra,
// and those are the words the inverse's first pass starts from, so no
// exchange comes before it.  Their slot product mont_lazy is in [0, 2q)
// (s a < q^2 < q 2^64), added into a sum kept below 2q by one compare a
// term, as the dot's; then `scale` one lazy Shoup product and
// scaled_inverse without post: the passes, one compare, the natural-order
// store.  The k output rows of one batch row r are adjacent (output row o
// = r * rows + i, rows tiling a block as in the transforms), so the words
// of S a block reads come from device memory once and from L2 k - 1
// times; A (k l n words, 512 KiB at 4 x 4, n = 4096) stays in L2.
// Registers: at the transforms' 1024 threads an SM a thread has 64, which
// the sum and a term's two operands (48) nearly fill: the sum waits in a
// tile of shared memory private to each thread (word w of thread i at
// w * threads + i: a warp's accesses 256 contiguous bytes), and at
// n = 8192 (opaque_passes) each step takes its thread index anew and the
// inverse its indices and table (opaque), so that the compiler keeps no
// address of one phase live into the next.  In registers the sum spilled
// 8 to 16 bytes at three log n, with or without opaque, and at 512 threads
// an SM at n = 8192, which also ran 11 % slower; the tile without opaque
// spilled 8 bytes at n = 8192 alone, and opaque at every n cost 1.3 % at
// n = 4096 (tools/nwc64_variants.py, PERF.md).
__host__ __device__ constexpr int matvec_blocks(int log_n) {
  return 1024 / block_threads(log_n, false);
}

template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN, false), matvec_blocks(kLogN))
    matvec_kernel(const uint64_t* __restrict__ spectra, const uint64_t* __restrict__ mat,
                  uint64_t* __restrict__ out, Table itw, int rows, int cols, int batch,
                  uint64_t q, uint64_t q_prime, uint64_t scale, uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  constexpr int kThreads = block_threads(kLogN, false), kLast = passes(kLogN) - 1;
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int o = blockIdx.x * kTile + g;
  const bool live = o < rows * batch;
  const int r = live ? o / rows : 0, i = live ? o % rows : 0;  // batch row, row of A
  uint64_t* const sum = smem + kTile * kN + threadIdx.x;  // word w at sum[w * kThreads]
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    sum[w * kThreads] = 0;
  }
#pragma unroll 1
  for (int j = 0; j < cols; ++j) {
    const int tj = opaque_passes(kLogN) ? opaque(t) : t;  // the step's words 8t ... 8t + 7
    uint64_t s[kWords], a[kWords];
    load<kLogN, false, kLast>(s, spectra, (static_cast<size_t>(j) * batch + r) * kN, 1, tj,
                              live);  // [0, q)
    load<kLogN, false, kLast>(a, mat, (static_cast<size_t>(i) * cols + j) * kN, 1, tj,
                              live);  // [0, q), times 2^64
#pragma unroll
    for (int w = 0; w < kWords; ++w) {  // [0, 2q) + [0, 2q) < 4q -> [0, 2q)
      sum[w * kThreads] = csub(sum[w * kThreads] + mont_lazy(s[w], a[w], q, q_prime), 2 * q);
    }
  }
  uint64_t x[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {  // [0, 2q) -> [0, 2q)
    x[w] = shoup_lazy(sum[w * kThreads], scale, scale_shoup, q);
  }
  constexpr bool kOpaque = opaque_passes(kLogN);
  const int gv = kOpaque ? opaque(g) : g, tv = kOpaque ? opaque(t) : t;  // the inverse
  scaled_inverse<kLogN, false>(x, out, (static_cast<size_t>(i) * batch + r) * kN, Table{}, 0,
                               smem, kOpaque ? opaque_table(itw) : itw, gv, tv, live, q);
}

// The four-step's row pass of the matvec, on the first core: block (r, i)
// accumulates sum_j REDC(S[j, r] . A[i, j]) canonically (a mont_mul and an
// add_mod a term) into its row in shared memory, times `scale`, runs the
// first core's inverse and the exit scale post[r % period].  S holds the
// rows of the spectra of s (their row forward done by nwc64_forward_scaled),
// A the (rows, cols, period, n) rows of A's cached spectra, row r reading
// A's row r % period.
__global__ void matvec_scaled_kernel(const uint64_t* __restrict__ spectra,
                                     const uint64_t* __restrict__ mat,
                                     uint64_t* __restrict__ out, Table itw,
                                     Table post, int period, int cols,
                                     int batch, int log_n, uint64_t q,
                                     uint64_t q_prime, uint64_t scale,
                                     uint64_t scale_shoup) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t r = blockIdx.x, i = blockIdx.y, p = blockIdx.x % period;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    uint64_t acc = 0;
    for (int j = 0; j < cols; ++j) {
      const uint64_t s = spectra[(j * batch + r) * n + e];
      const uint64_t m = __ldg(mat + ((i * cols + j) * period + p) * n + e);
      acc = add_mod(acc, mont_mul(s, m, q, q_prime), q);
    }
    x[e] = shoup_mul(acc, scale, scale_shoup, q);
  }
  __syncthreads();
  inverse(x, log_n, itw, q);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    out[(i * batch + r) * n + e] = shoup_mul(x[e], __ldg(post.w + p * n + e),
                                             __ldg(post.w_shoup + p * n + e), q);
  }
}

// n / 8 threads from n = 256 on (four butterflies each), at most 1024;
// below, a warp, or one thread a butterfly where n / 2 is less.
int threads_for(int log_n) {
  const int n = 1 << log_n;
  const int least = n / 2 < 32 ? n / 2 : 32;
  const int eighth = n / 8 > least ? n / 8 : least;
  return eighth < 1024 ? eighth : 1024;
}

bool bad_shape(int batch, int log_n) {
  return batch < 1 || log_n < 5 || log_n > 13;
}

// Lifts the kernel's dynamic shared memory cap to `words` uint64 values.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int words) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              words * static_cast<int>(sizeof(uint64_t)));
}

Table table(const void* w, const void* w_shoup) {
  return Table{static_cast<const uint64_t*>(w),
               static_cast<const uint64_t*>(w_shoup)};
}

// A fused kernel of log n = kLogN on `batch` rows, tile(kLogN) rows a
// block, with `tiles` tiles of shared memory.
template <int kLogN, typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int tiles, int batch, cudaStream_t stream, Args... args) {
  constexpr int kTile = tile(kLogN, false);
  const int smem = tiles * kTile * (1 << kLogN) * static_cast<int>(sizeof(uint64_t));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<(batch + kTile - 1) / kTile, block_threads(kLogN, false), smem, stream>>>(args...);
  return cudaGetLastError();
}

// Whether any of the pointers is not 16-byte aligned (the tables' vectors,
// a spectrum's, the rows' in the last pass).
bool misaligned(std::initializer_list<const void*> pointers) {
  uintptr_t bits = 0;
  for (const void* p : pointers) {
    bits |= reinterpret_cast<uintptr_t>(p);
  }
  return bits % 16;
}

// The fused product's entry: log n from 5 to 13, every pointer 16-byte
// aligned.
template <bool kCached>
int launch_product(const void* a, const void* b, void* out, const void* tw,
                   const void* tw_shoup, const void* itw, const void* itw_shoup,
                   int batch, int log_n, uint64_t q, uint64_t q_prime,
                   uint64_t scale, uint64_t scale_shoup, void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({a, b, out, tw, tw_shoup, itw, itw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const uint64_t* pa = static_cast<const uint64_t*>(a);
  const uint64_t* pb = static_cast<const uint64_t*>(b);
  uint64_t* po = static_cast<uint64_t*>(out);
  const Table ptw = table(tw, tw_shoup), pitw = table(itw, itw_shoup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC64_LOG_N(L)                                                                    \
  case L:                                                                                 \
    return launch_rows<L>(product_kernel<L, kCached>, 1, batch, s, pa, pb, po, ptw, pitw, \
                          batch, q, q_prime, scale, scale_shoup);
    NWC64_LOG_N(5) NWC64_LOG_N(6) NWC64_LOG_N(7) NWC64_LOG_N(8) NWC64_LOG_N(9)
    NWC64_LOG_N(10) NWC64_LOG_N(11) NWC64_LOG_N(12) NWC64_LOG_N(13)
#undef NWC64_LOG_N
  }
  return cudaErrorInvalidValue;
}

// The fused row passes' entry (the product, cached with kCached, or with
// kDot the dot over `terms` (terms, batch, n) rows; kScaled false: the flat
// dot, no scale tables): log n from 5 to 13, whole periods, every pointer
// 16-byte aligned.
template <bool kCached, bool kDot, bool kScaled = true>
int launch_scaled(const void* a, const void* b, void* out, const void* tw,
                  const void* tw_shoup, const void* itw, const void* itw_shoup,
                  const void* pre, const void* pre_shoup, const void* post,
                  const void* post_shoup, int period, int terms, int batch, int log_n,
                  uint64_t q, uint64_t q_prime, uint64_t scale, uint64_t scale_shoup,
                  void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period || terms < 1) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({a, b, out, tw, tw_shoup, itw, itw_shoup, pre, pre_shoup, post, post_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const uint64_t* pa = static_cast<const uint64_t*>(a);
  const uint64_t* pb = static_cast<const uint64_t*>(b);
  uint64_t* po = static_cast<uint64_t*>(out);
  const Table ptw = table(tw, tw_shoup), pitw = table(itw, itw_shoup);
  const Table ppre = table(pre, pre_shoup), ppost = table(post, post_shoup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC64_LOG_N(L)                                                                        \
  case L:                                                                                     \
    if constexpr (kDot) {                                                                     \
      return launch_rows<L>(dot_scaled_kernel<L, kCached, kScaled>, dot_tiles(kCached),       \
                            batch, s, pa, pb, po, ptw, pitw, ppre, ppost, period, terms,      \
                            batch, q, q_prime, scale, scale_shoup);                           \
    } else {                                                                                  \
      return launch_rows<L>(cyclic_scaled_kernel<L, kCached>, 1, batch, s, pa, pb, po,        \
                            ptw, pitw, ppre, ppost, period, batch, q, q_prime, scale,         \
                            scale_shoup);                                                     \
    }
    NWC64_LOG_N(5) NWC64_LOG_N(6) NWC64_LOG_N(7) NWC64_LOG_N(8) NWC64_LOG_N(9)
    NWC64_LOG_N(10) NWC64_LOG_N(11) NWC64_LOG_N(12) NWC64_LOG_N(13)
#undef NWC64_LOG_N
  }
  return cudaErrorInvalidValue;
}

template <int kLogN, bool kInverse, bool kCols>
int launch_transform(const void* in, void* out, Table pt, long long transforms, int width,
                     uint64_t q, uint64_t scale, uint64_t scale_shoup, void* stream) {
  constexpr int kTile = tile(kLogN, kCols);
  constexpr int kSmem = kTile * (1 << kLogN) * static_cast<int>(sizeof(uint64_t));
  const long long blocks = (transforms + kTile - 1) / kTile;
  if (blocks > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  auto kernel = transform_kernel<kLogN, kInverse, kCols>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<static_cast<unsigned>(blocks), block_threads(kLogN, kCols), kSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), pt, transforms, width, q,
      scale, scale_shoup);
  return cudaGetLastError();
}

// The radix-8 core's entry: log n from 5 to 13, every pointer 16-byte
// aligned (the tables' vectors, and the rows' in the last pass).
template <bool kInverse, bool kCols>
int launch_core(const void* in, void* out, const void* tw, const void* tw_shoup, int batch,
              int log_n, int width, uint64_t q, uint64_t scale, uint64_t scale_shoup,
              void* stream) {
  if (bad_shape(batch, log_n) || width < 1) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({in, out, tw, tw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const Table pt = table(tw, tw_shoup);
  const long long transforms = static_cast<long long>(batch) * width;
  switch (log_n) {
#define NWC64_LOG_N(L)                                                                  \
  case L:                                                                               \
    return launch_transform<L, kInverse, kCols>(in, out, pt, transforms, width, q,      \
                                                scale, scale_shoup, stream);
    NWC64_LOG_N(5) NWC64_LOG_N(6) NWC64_LOG_N(7) NWC64_LOG_N(8) NWC64_LOG_N(9)
    NWC64_LOG_N(10) NWC64_LOG_N(11) NWC64_LOG_N(12) NWC64_LOG_N(13)
#undef NWC64_LOG_N
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Every entry point launches on `stream`, which must belong to the current
// device, and returns the CUDA error code (0 on success).  A launch the
// device refuses (too much shared memory, a bad shape) never runs, so the
// caller must check the code.

// The product of (batch, n) rows of a and b, and of a with the rows of a
// cached spectrum, on the radix-8 core, fused: the tables are those of
// mxu64.pass_table, scale the product's (n^-1 2^64 for two fresh operands,
// n^-1 against a cached spectrum); out overlaps neither operand (at
// n = 8192 it holds b's spectrum while a's forward runs).
extern "C" int nwc64_product(const void* a, const void* b, void* out,
                             const void* tw, const void* tw_shoup,
                             const void* itw, const void* itw_shoup, int batch,
                             int log_n, uint64_t q, uint64_t q_prime,
                             uint64_t scale, uint64_t scale_shoup, void* stream) {
  return launch_product<false>(a, b, out, tw, tw_shoup, itw, itw_shoup, batch,
                               log_n, q, q_prime, scale, scale_shoup, stream);
}

extern "C" int nwc64_cached(const void* a, const void* spectrum, void* out,
                            const void* tw, const void* tw_shoup,
                            const void* itw, const void* itw_shoup, int batch,
                            int log_n, uint64_t q, uint64_t q_prime,
                            uint64_t scale, uint64_t scale_shoup, void* stream) {
  return launch_product<true>(a, spectrum, out, tw, tw_shoup, itw, itw_shoup,
                              batch, log_n, q, q_prime, scale, scale_shoup,
                              stream);
}

// The forward and the inverse of (batch, n) rows on the radix-8 core.  The
// tables are those of mxu64.pass_table: the flat table (w, w') of the first
// core in the per-pass layout; the forward skips scale 1.
extern "C" int nwc64_forward(const void* in, void* out, const void* tw,
                             const void* tw_shoup, int batch, int log_n,
                             uint64_t q, uint64_t scale, uint64_t scale_shoup,
                             void* stream) {
  return launch_core<false, false>(in, out, tw, tw_shoup, batch, log_n, 1, q, scale,
                                   scale_shoup, stream);
}

extern "C" int nwc64_inverse(const void* in, void* out, const void* itw,
                             const void* itw_shoup, int batch, int log_n,
                             uint64_t q, uint64_t scale, uint64_t scale_shoup,
                             void* stream) {
  return launch_core<true, false>(in, out, itw, itw_shoup, batch, log_n, 1, q, scale,
                                  scale_shoup, stream);
}

// The same on every column of `batch` natural (n, width) matrices, in
// place of the transposes around a row transform: column c of matrix m is
// the n words m * n * width + c + i * width; the forward's spectrum comes
// out down the same column, in bit-reversed order.
extern "C" int nwc64_forward_cols(const void* in, void* out, const void* tw,
                                  const void* tw_shoup, int batch, int log_n, int width,
                                  uint64_t q, uint64_t scale, uint64_t scale_shoup,
                                  void* stream) {
  return launch_core<false, true>(in, out, tw, tw_shoup, batch, log_n, width, q, scale,
                                  scale_shoup, stream);
}

extern "C" int nwc64_inverse_cols(const void* in, void* out, const void* itw,
                                  const void* itw_shoup, int batch, int log_n, int width,
                                  uint64_t q, uint64_t scale, uint64_t scale_shoup,
                                  void* stream) {
  return launch_core<true, true>(in, out, itw, itw_shoup, batch, log_n, width, q, scale,
                                 scale_shoup, stream);
}

// The dot of (terms, batch, n) stacks a and b, 1 <= terms <= 8 (b holds
// spectra with `cached`), one output row per row of the batch: the loop of
// nwc64_dot_scaled without its scale tables, on the tables of
// mxu64.pass_table.
extern "C" int nwc64_dot(const void* a, const void* b, void* out,
                         const void* tw, const void* tw_shoup, const void* itw,
                         const void* itw_shoup, int terms, int batch, int log_n,
                         uint64_t q, uint64_t q_prime, uint64_t scale,
                         uint64_t scale_shoup, int cached, void* stream) {
  if (terms > 8) {
    return cudaErrorInvalidValue;
  }
  return cached ? launch_scaled<true, true, false>(a, b, out, tw, tw_shoup, itw, itw_shoup,
                                                   nullptr, nullptr, nullptr, nullptr, 1, terms,
                                                   batch, log_n, q, q_prime, scale, scale_shoup,
                                                   stream)
                : launch_scaled<false, true, false>(a, b, out, tw, tw_shoup, itw, itw_shoup,
                                                    nullptr, nullptr, nullptr, nullptr, 1, terms,
                                                    batch, log_n, q, q_prime, scale, scale_shoup,
                                                    stream);
}

// The matvec's accumulate-and-inverse: the (cols, batch, n) plain spectra
// of s against the (rows, cols, n) cached spectra of A, 1 <= rows, cols <=
// 8; (rows, batch, n) out, on the radix-8 core with the inverse tables of
// mxu64.pass_table; every pointer 16-byte aligned.
extern "C" int nwc64_matvec(const void* spectra, const void* mat, void* out,
                            const void* itw, const void* itw_shoup, int rows,
                            int cols, int batch, int log_n, uint64_t q,
                            uint64_t q_prime, uint64_t scale,
                            uint64_t scale_shoup, void* stream) {
  if (bad_shape(batch, log_n) || rows < 1 || rows > 8 || cols < 1 || cols > 8 ||
      batch > 0x7fffffff / rows) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({spectra, mat, out, itw, itw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const uint64_t* ps = static_cast<const uint64_t*>(spectra);
  const uint64_t* pm = static_cast<const uint64_t*>(mat);
  uint64_t* po = static_cast<uint64_t*>(out);
  const Table pitw = table(itw, itw_shoup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC64_LOG_N(L)                                                                     \
  case L:                                                                                  \
    return launch_rows<L>(matvec_kernel<L>, 2, rows * batch, s, ps, pm, po, pitw, rows,    \
                          cols, batch, q, q_prime, scale, scale_shoup);
    NWC64_LOG_N(5) NWC64_LOG_N(6) NWC64_LOG_N(7) NWC64_LOG_N(8) NWC64_LOG_N(9)
    NWC64_LOG_N(10) NWC64_LOG_N(11) NWC64_LOG_N(12) NWC64_LOG_N(13)
#undef NWC64_LOG_N
  }
  return cudaErrorInvalidValue;
}

// The row pass of the four-step: `period` rows of scales pre and post, each
// n values beside their Shoup companions; batch must be a multiple of it.
// On the radix-8 core, fused, on the tables of mxu64.pass_table; out
// overlaps neither operand (it holds b's spectrum while a's forward runs).
extern "C" int nwc64_cyclic_scaled(const void* a, const void* b, void* out,
                                   const void* tw, const void* tw_shoup,
                                   const void* itw, const void* itw_shoup,
                                   const void* pre, const void* pre_shoup,
                                   const void* post, const void* post_shoup,
                                   int period, int batch, int log_n, uint64_t q,
                                   uint64_t q_prime, uint64_t scale,
                                   uint64_t scale_shoup, void* stream) {
  return launch_scaled<false, false>(a, b, out, tw, tw_shoup, itw, itw_shoup, pre,
                                     pre_shoup, post, post_shoup, period, 1, batch, log_n, q,
                                     q_prime, scale, scale_shoup, stream);
}

// The same against the rows of a cached spectrum.
extern "C" int nwc64_cached_scaled(const void* a, const void* spectrum,
                                   void* out, const void* tw,
                                   const void* tw_shoup, const void* itw,
                                   const void* itw_shoup, const void* pre,
                                   const void* pre_shoup, const void* post,
                                   const void* post_shoup, int period,
                                   int batch, int log_n, uint64_t q,
                                   uint64_t q_prime, uint64_t scale,
                                   uint64_t scale_shoup, void* stream) {
  return launch_scaled<true, false>(a, spectrum, out, tw, tw_shoup, itw, itw_shoup, pre,
                                    pre_shoup, post, post_shoup, period, 1, batch, log_n, q,
                                    q_prime, scale, scale_shoup, stream);
}

// The row forward: NTT(pre . in) times `scale` (1, or 2^64 for a cacheable
// spectrum), on the radix-8 core with the tables of mxu64.pass_table.
extern "C" int nwc64_forward_scaled(const void* in, void* out, const void* tw,
                                    const void* tw_shoup, const void* pre,
                                    const void* pre_shoup, int period,
                                    int batch, int log_n, uint64_t q,
                                    uint64_t scale, uint64_t scale_shoup,
                                    void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({in, out, tw, tw_shoup, pre, pre_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const uint64_t* pin = static_cast<const uint64_t*>(in);
  uint64_t* po = static_cast<uint64_t*>(out);
  const Table ptw = table(tw, tw_shoup), ppre = table(pre, pre_shoup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC64_LOG_N(L)                                                                     \
  case L:                                                                                  \
    return launch_rows<L>(forward_scaled_kernel<L>, 1, batch, s, pin, po, ptw, ppre, period, \
                          batch, q, scale, scale_shoup);
    NWC64_LOG_N(5) NWC64_LOG_N(6) NWC64_LOG_N(7) NWC64_LOG_N(8) NWC64_LOG_N(9)
    NWC64_LOG_N(10) NWC64_LOG_N(11) NWC64_LOG_N(12) NWC64_LOG_N(13)
#undef NWC64_LOG_N
  }
  return cudaErrorInvalidValue;
}

// The row inverse: post . INTT(in) times `scale` (n^-1) for bit-reversed
// spectra, on the radix-8 core with the tables of mxu64.pass_table.
extern "C" int nwc64_inverse_scaled(const void* in, void* out, const void* itw,
                                    const void* itw_shoup, const void* post,
                                    const void* post_shoup, int period,
                                    int batch, int log_n, uint64_t q,
                                    uint64_t scale, uint64_t scale_shoup,
                                    void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({in, out, itw, itw_shoup, post, post_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const uint64_t* pin = static_cast<const uint64_t*>(in);
  uint64_t* po = static_cast<uint64_t*>(out);
  const Table pitw = table(itw, itw_shoup), ppost = table(post, post_shoup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC64_LOG_N(L)                                                                     \
  case L:                                                                                  \
    return launch_rows<L>(inverse_scaled_kernel<L>, 1, batch, s, pin, po, pitw, ppost,     \
                          period, batch, q, scale, scale_shoup);
    NWC64_LOG_N(5) NWC64_LOG_N(6) NWC64_LOG_N(7) NWC64_LOG_N(8) NWC64_LOG_N(9)
    NWC64_LOG_N(10) NWC64_LOG_N(11) NWC64_LOG_N(12) NWC64_LOG_N(13)
#undef NWC64_LOG_N
  }
  return cudaErrorInvalidValue;
}

// The dot's row pass: (terms, batch, n) stacks a and b (b cached spectra
// with `cached`), one output row per row of the batch, on the radix-8 core,
// fused, on the tables of mxu64.pass_table.
extern "C" int nwc64_dot_scaled(const void* a, const void* b, void* out,
                                const void* tw, const void* tw_shoup,
                                const void* itw, const void* itw_shoup,
                                const void* pre, const void* pre_shoup,
                                const void* post, const void* post_shoup,
                                int period, int terms, int batch, int log_n,
                                uint64_t q, uint64_t q_prime, uint64_t scale,
                                uint64_t scale_shoup, int cached, void* stream) {
  return cached ? launch_scaled<true, true>(a, b, out, tw, tw_shoup, itw, itw_shoup, pre,
                                            pre_shoup, post, post_shoup, period, terms, batch,
                                            log_n, q, q_prime, scale, scale_shoup, stream)
                : launch_scaled<false, true>(a, b, out, tw, tw_shoup, itw, itw_shoup, pre,
                                             pre_shoup, post, post_shoup, period, terms, batch,
                                             log_n, q, q_prime, scale, scale_shoup, stream);
}

// The matvec's row pass: the (cols, batch, n) row spectra of s against the
// (rows, cols, period, n) cached spectra of A; (rows, batch, n) out.
extern "C" int nwc64_matvec_scaled(const void* spectra, const void* mat,
                                   void* out, const void* itw,
                                   const void* itw_shoup, const void* post,
                                   const void* post_shoup, int period,
                                   int rows, int cols, int batch, int log_n,
                                   uint64_t q, uint64_t q_prime, uint64_t scale,
                                   uint64_t scale_shoup, void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period || rows < 1 ||
      rows > 65535 || cols < 1) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(matvec_scaled_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  matvec_scaled_kernel<<<dim3(batch, rows), threads_for(log_n),
                         n * sizeof(uint64_t),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(spectra), static_cast<const uint64_t*>(mat),
      static_cast<uint64_t*>(out), table(itw, itw_shoup),
      table(post, post_shoup), period, cols, batch, log_n, q, q_prime, scale,
      scale_shoup);
  return cudaGetLastError();
}

extern "C" const char* nwc64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// nwc32.cu: the single-word NTT kernels of the 24-bit family, hand-written for
// Hopper (sm_90a).
//
// Replaces kernel K3 of tpu_ntt/kernels/mxu.py (MxuPlan: q < 2^24,
// 256 <= n <= 16384), all three of its pallas_calls:
//   nwc32_product  _nwc_kernel (:480) through MxuPlan._call (:697): the
//                  negacyclic product and, with cyclic tables,
//                  cyclic_poly_mult (:728)
//   nwc32_cached   _nwc_cached_kernel (:596), the same launcher
//   nwc32_forward  _nwc_fwd_kernel (:615: nwc_ntt_fwd, and ntt_fwd :978 with
//                  cyclic tables) and _nwc_spec_kernel (:584: nwc_spectrum)
//   nwc32_inverse  _nwc_inv_kernel (:627: nwc_ntt_inv, and ntt_inv :993)
//   nwc32_dot      _make_dot_kernel (:506) through MxuPlan._dot_call (:824)
//   nwc32_matvec   _make_matvec_kernel (:544) through nwc_matvec_cached
//                  (:921), after nwc32_forward has transformed s
// Residues are uint32 in [0, q), (B, n) rows, natural order; a spectrum is in
// bit-reversed order.  Each function computes what tpu_ntt_torch.kernels.mxu
// MxuPlan's plain version of it computes, bit for bit: the TPU kernel's
// function, not its algorithm.  The TPU's int8 limbs, zero-point corrections,
// 128 x 128 DFT matrices and four-step layout exist only because of Mosaic
// (mxu.py:10-35); none of them is carried over.  Correct for any odd
// q < 2^30 and 256 <= n <= 16384.
//
// One core, the radix-16 one ("The radix-16 core" below): nwc64.cu's
// radix-8 schedule on 32-bit lanes, four stages a pass in registers.
// nwc32_forward and nwc32_inverse run it alone; nwc32_product, nwc32_cached
// and nwc32_dot fuse their forwards, the slot products and the inverse on
// it; nwc32_matvec is the matvec's accumulate-and-inverse on it.  Spectra
// are in the bit-reversed order the forward writes; the cyclic ops take the
// tables with omega powers (ntt.py, "bitrev").  The slot product is
// Montgomery-32 (one REDC): a*b*2^-32.  Its 2^-32 and the inverse's n^-1
// are cancelled by one Shoup multiply with the scale the wrapper passes
// (n^-1 against a cached spectrum, which holds its 2^32).  The matvec keeps
// the l + k transforms of mxu.py:544-551 without holding l + 1 rows in
// shared memory (576 KiB at n = 16384, l = 8): the wrapper transforms the
// l * B rows of s with nwc32_forward into a scratch tensor, and
// nwc32_matvec sums S_j * A_ij from device memory, one REDC of the sum a
// word, and runs one inverse per output row.
//
// What bounds it on this card.  Per transform of one row, n/2 log2 n
// butterflies, each one Shoup multiply: a*w and hi(a*w'), two 32-bit
// multiplies, since the product by q = 8380417 = 2^23 - 2^13 + 1 is shifts
// and adds.  At P24_4096, B = 2048, the product's 3 transforms and slot pass
// need 3.4e8 IMADs, 0.021 ms at 132 SMs x 64 IMADs a clock x 1.98 GHz,
// against 101 MB of operands and result, 0.030 ms at 3.35 TB/s: device
// memory bounds it, and the fused kernels move nothing twice.  A forward
// alone moves 67 MB at P24_4096, B = 2048 (0.020 ms) and needs 1.0e8 IMADs
// (0.006 ms).  A core of one butterfly a thread between barriers, a
// butterfly of about 30 instructions (index arithmetic, shared loads and
// stores, twiddle loads, conditional subtracts) between 12 barriers a
// transform, took about 5.5x the bound for its inverse on an H100 SXM at
// 700 W (PERF.md); the radix-16 core's header says what it does about
// each.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

struct Table {
  const uint32_t* w;
  const uint32_t* w_shoup;
};

// ---------------------------------------------------------------------------
// The radix-16 core: nwc32_forward, nwc32_inverse, and fused on it
// nwc32_product, nwc32_cached, nwc32_dot and nwc32_matvec.  The schedule of
// nwc64.cu's radix-8 core on 32-bit lanes; a canonical result is unique, so
// it computes the integers of the plain versions in their orders:
// * Passes in registers.  A thread holds kWords = 16 words, 16 registers as
//   nwc64.cu's eight 64-bit ones, and a pass runs four stages on them with
//   no barrier between them: stage s + d of a radix-16 group pairs its
//   registers k and k + 2^(3 - d).  log n = 12 takes three passes and two
//   barriers instead of twelve of each.  The first pass takes log n mod 4
//   stages, 4 if that is 0 (then each thread holds 16 / 2^stages groups);
//   it is the pass at stage 0, where every group has the same twiddles.
//   The inverse runs the passes in reverse order, each pass's stages
//   reversed.  Shapes, pass stages and table offsets are template constants
//   (kLogN): one kernel a log n from 8 to 14, every loop but the dot's and
//   the matvec's (over their terms) unrolled.  Sixteen words a thread keep
//   n = 16384 at 1024 threads a row, where eight would need 2048: every n
//   of the window runs the same core.
// * Device memory once.  A forward's first pass loads straight from device
//   memory (register k of group j is element k * n / 2^stages + j: a warp's
//   4-byte loads cover 128 contiguous bytes of a row), and the inverse's
//   last pass stores there from the same positions.  The forward's last
//   pass leaves a thread spectrum words 16t ... 16t + 15, adjacent: the
//   forward kernel stores them as four 16-byte vectors, a cached spectrum's
//   arrive there as four 16-byte loads, and the inverse's first pass starts
//   from them, so a fused kernel's slot product needs no exchange and no
//   barrier.  Shared memory is only the exchange between passes: each pass
//   reads and then writes the same sixteen words of each thread, so one
//   barrier a pass suffices.
// * No swizzle.  Word i of row g of the tile lives at g * n + i.  The
//   first passes' 4-byte accesses of a warp conflict at most two ways, and
//   in the last pass a thread's sixteen words are adjacent (16t ...
//   16t + 15), which the compiler moves as 16-byte vectors
//   (tests/test_torch_nwc32_radix.py counts the conflicts at every n from
//   256 to 16384, both directions).  nwc64.cu's kind of swizzle, a ^ ((a >> 4) & 31) here,
//   conflict-free on 4-byte words but sixteen scalar accesses a pass, ran
//   0.1 to 8 % slower at every shape timed (tools/nwc32_variants.py,
//   PERF.md): the kernel waits on device memory, not on shared memory.
// * Lazy butterflies (Harvey).  q < 2^30 keeps 4q < 2^32, so a lane is a
//   uint32_t in [0, 4q): the CT butterfly brings x under 2q with one
//   compare, leaves the Shoup product (a * w - hi(a * w') q, __umulhi) in
//   [0, 2q), and returns x + v and x + 2q - v; the first stage takes the
//   words of device memory, below q, as they are.  The GS butterfly keeps
//   its lanes in [0, 2q): x + y with one compare, and the Shoup product of
//   x + 2q - y.  One correction to [0, q) at the forward's store: two
//   compares at scale 1, else one lazy Shoup product of the lane as it is
//   and one compare; one compare at the inverse's.
// * Twiddles a pass at a time, host-built (mxu64.pass_table with four
//   stages a pass): pass (s, R) holds 2^(R - 1) columns of 8-byte pairs of
//   twiddles for each of its 2^s groups, w and w' in two tables of the same
//   layout: column 0 (stage s, then a pad word), column 1 (stage s + 1's
//   two), columns 2 and 3 (stage s + 2's four), columns 4 to 7 (stage
//   s + 3's eight).  A stage loads what it uses, one 8-byte vector per two
//   twiddles; a warp's loads are 256 contiguous bytes (consecutive groups,
//   in the last pass) or one broadcast word.  The inverse reads the inverse
//   table in the same layout.
// * Several rows a block, at least 128 threads: 2048 / n rows up to
//   n = 2048 (n / 16 threads a row, so eight rows of 256 a block, the
//   DILITHIUM_256 matvec's shape), one row of n / 16 threads above (blocks
//   of 1024 threads, 64 rows of 256, ran 51 to 54 % slower).  A tile holds at
//   most 64 KiB.  __launch_bounds__ caps a thread at 64 registers, so 1024
//   threads of an SM stay resident.
// ---------------------------------------------------------------------------

constexpr int kWords = 16;  // words a thread holds in every pass
constexpr int kRadix = 4;   // stages a pass

__host__ __device__ constexpr int first_stages(int log_n) {
  return log_n - kRadix * ((log_n - 1) / kRadix);
}
__host__ __device__ constexpr int passes(int log_n) { return (log_n - 1) / kRadix + 1; }
// the first stage of pass p (forward order) and its stages
__host__ __device__ constexpr int pass_stage(int log_n, int p) {
  return p == 0 ? 0 : first_stages(log_n) + kRadix * (p - 1);
}
__host__ __device__ constexpr int pass_stages(int log_n, int p) {
  return p == 0 ? first_stages(log_n) : kRadix;
}
// pass p's table begins after 2^(stages + stage) words of each earlier pass
__host__ __device__ constexpr int pass_offset(int log_n, int p) {
  int off = 0;
  for (int k = 0; k < p; ++k) {
    off += 1 << (pass_stages(log_n, k) + pass_stage(log_n, k));
  }
  return off;
}
// rows a block
__host__ __device__ constexpr int tile(int log_n) {
  return log_n >= 11 ? 1 : 2048 >> log_n;
}
__host__ __device__ constexpr int block_threads(int log_n) {
  return tile(log_n) * ((1 << log_n) / kWords);
}

// a * w mod q up to one q: in [0, 2q) for ANY a < 2^32, given w < q and
// ws = floor(w * 2^32 / q) (a * ws / 2^32 falls short of a * w / q by less
// than a / 2^32 + 1 < 2); 2q < 2^32, so nothing wraps.
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w, uint32_t ws, uint32_t q) {
  return a * w - __umulhi(a, ws) * q;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) { return x >= m ? x - m : x; }

// Cooley-Tukey: x, y in [0, 4q) in, and out; with kFresh (the forward's
// first stage), x < q in, which skips the compare.
template <bool kFresh>
__device__ __forceinline__ void ct(uint32_t& x, uint32_t& y, uint32_t w, uint32_t ws,
                                   uint32_t q) {
  const uint32_t q2 = 2 * q;
  const uint32_t u = kFresh ? x : csub(x, q2);  // [0, 2q)
  const uint32_t v = shoup_lazy(y, w, ws, q);  // y < 4q < 2^32: [0, 2q)
  x = u + v;                                   // [0, 4q)
  y = u + q2 - v;                              // (0, 4q)
}

// Gentleman-Sande: x, y in [0, 2q) in, and out.
__device__ __forceinline__ void gs(uint32_t& x, uint32_t& y, uint32_t w, uint32_t ws, uint32_t q) {
  const uint32_t q2 = 2 * q;
  const uint32_t u = x, v = y;
  x = csub(u + v, q2);                   // u + v < 4q < 2^32: [0, 2q)
  y = shoup_lazy(u + q2 - v, w, ws, q);  // u + 2q - v in (0, 4q): [0, 2q)
}

// Stage s + d's 2^d twiddles of group hi in the pass tables at stage s:
// column 0 for d = 0, columns [2^(d - 1), 2^d) after.
template <int kS, int kD>
__device__ __forceinline__ void stage_twiddles(const uint32_t* tw, const uint32_t* tws, int hi,
                                               uint32_t (&w)[8], uint32_t (&ws)[8]) {
  constexpr int kFirst = kD == 0 ? 0 : (1 << kD) / 2;
  constexpr int kCount = kD == 0 ? 1 : (1 << kD) / 2;
  const uint2* pw = reinterpret_cast<const uint2*>(tw);
  const uint2* ps = reinterpret_cast<const uint2*>(tws);
#pragma unroll
  for (int m = 0; m < kCount; ++m) {
    const uint2 a = __ldg(pw + ((kFirst + m) << kS) + hi);
    const uint2 b = __ldg(ps + ((kFirst + m) << kS) + hi);
    w[2 * m] = a.x;
    w[2 * m + 1] = a.y;
    ws[2 * m] = b.x;
    ws[2 * m + 1] = b.y;
  }
}

// One stage of a pass: register k of each group of 2^kR meets k + span;
// kFresh: the first stage of a forward (ct).
template <int kS, int kR, int kD, bool kInverse, bool kFresh = false>
__device__ __forceinline__ void stage(uint32_t (&x)[kWords], const uint32_t* tw,
                                      const uint32_t* tws, int hi, uint32_t q) {
  constexpr int kGroup = 1 << kR, kSpan = kGroup >> (kD + 1);
  uint32_t w[8], ws[8];
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
__device__ __forceinline__ void run_pass(uint32_t (&x)[kWords], const uint32_t* tw,
                                         const uint32_t* tws, int hi, uint32_t q) {
  if constexpr (kInverse) {
    if constexpr (kR > 3) stage<kS, kR, 3, true>(x, tw, tws, hi, q);
    if constexpr (kR > 2) stage<kS, kR, 2, true>(x, tw, tws, hi, q);
    if constexpr (kR > 1) stage<kS, kR, 1, true>(x, tw, tws, hi, q);
    stage<kS, kR, 0, true>(x, tw, tws, hi, q);
  } else {
    stage<kS, kR, 0, false, kFresh>(x, tw, tws, hi, q);
    if constexpr (kR > 1) stage<kS, kR, 1, false>(x, tw, tws, hi, q);
    if constexpr (kR > 2) stage<kS, kR, 2, false>(x, tw, tws, hi, q);
    if constexpr (kR > 3) stage<kS, kR, 3, false>(x, tw, tws, hi, q);
  }
}

// Element of register r in pass (kS, kR) for thread t of its row: register
// c * 2^kR + k holds element k of group j = t + c * n / 16, which is
// hi * 2^kR * T + k * T + lo with T = n >> (kS + kR), (hi, lo) = j / T, j % T.
template <int kLogN, int kS, int kR>
__device__ __forceinline__ int element(int t, int r) {
  constexpr int kT = (1 << kLogN) >> (kS + kR);
  const int j = t + (r >> kR) * ((1 << kLogN) / kWords);
  return (j / kT) * (kT << kR) + (r % (1 << kR)) * kT + j % kT;
}

// The group of thread t in a pass of four stages at kS (its twiddles' hi).
template <int kLogN, int kS>
__device__ __forceinline__ int group(int t) {
  return t / ((1 << kLogN) >> (kS + kRadix));
}

// Word i of row g of the tile in shared memory (the core's header).
template <int kLogN>
__device__ __forceinline__ int tile_word(int g, int i) {
  return g * (1 << kLogN) + i;
}

template <int kLogN, int kP>
__device__ __forceinline__ void to_shared(const uint32_t (&x)[kWords], uint32_t* smem, int g,
                                          int t) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    smem[tile_word<kLogN>(g, element<kLogN, kS, kR>(t, r))] = x[r];
  }
}

template <int kLogN, int kP>
__device__ __forceinline__ void from_shared(uint32_t (&x)[kWords], const uint32_t* smem, int g,
                                            int t) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = smem[tile_word<kLogN>(g, element<kLogN, kS, kR>(t, r))];
  }
}

// Passes kP, kP + 1, ... of the forward, each after the exchange with the
// pass before it.
template <int kLogN, int kP>
__device__ __forceinline__ void forward_passes(uint32_t (&x)[kWords], uint32_t* smem,
                                               Table pt, int g, int t, uint32_t q) {
  if constexpr (kP < passes(kLogN)) {
    constexpr int kS = pass_stage(kLogN, kP), kOff = pass_offset(kLogN, kP);
    to_shared<kLogN, kP - 1>(x, smem, g, t);
    __syncthreads();
    from_shared<kLogN, kP>(x, smem, g, t);
    run_pass<kS, kRadix, false>(x, pt.w + kOff, pt.w_shoup + kOff, group<kLogN, kS>(t), q);
    forward_passes<kLogN, kP + 1>(x, smem, pt, g, t, q);
  }
}

// Passes kP, kP - 1, ... 0 of the inverse, each after the exchange with the
// pass after it.
template <int kLogN, int kP>
__device__ __forceinline__ void inverse_passes(uint32_t (&x)[kWords], uint32_t* smem,
                                               Table pt, int g, int t, uint32_t q) {
  if constexpr (kP >= 0) {
    constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
    constexpr int kOff = pass_offset(kLogN, kP);
    to_shared<kLogN, kP + 1>(x, smem, g, t);
    __syncthreads();
    from_shared<kLogN, kP>(x, smem, g, t);
    run_pass<kS, kR, true>(x, pt.w + kOff, pt.w_shoup + kOff, kP == 0 ? 0 : group<kLogN, kS>(t),
                           q);
    inverse_passes<kLogN, kP - 1>(x, smem, pt, g, t, q);
  }
}

// The forward of row `at` of `in`: the first pass's words from device
// memory ([0, q)), the passes; lanes in [0, 4q) out, spectrum words
// 16t ... 16t + 15.
template <int kLogN>
__device__ __forceinline__ void forward_row(uint32_t (&x)[kWords], const uint32_t* in, size_t at,
                                            uint32_t* smem, Table pt, int g, int t, bool live,
                                            uint32_t q) {
  constexpr int kR0 = first_stages(kLogN);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, q)
    x[r] = live ? in[at + element<kLogN, 0, kR0>(t, r)] : 0;
  }
  run_pass<0, kR0, false, true>(x, pt.w, pt.w_shoup, 0, q);
  forward_passes<kLogN, 1>(x, smem, pt, g, t, q);
}

// The inverse from spectrum words 16t ... 16t + 15 (lanes in [0, 2q)) and
// the store of row `at` in natural order, one compare: the last pass's
// words to the positions the forward's first pass loads from.
template <int kLogN>
__device__ __forceinline__ void inverse_row(uint32_t (&x)[kWords], uint32_t* out, size_t at,
                                            uint32_t* smem, Table pt, int g, int t, bool live,
                                            uint32_t q) {
  constexpr int kLast = passes(kLogN) - 1;
  constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
  run_pass<kS, kRadix, true>(x, pt.w + kOff, pt.w_shoup + kOff, group<kLogN, kS>(t), q);
  inverse_passes<kLogN, kLast - 1>(x, smem, pt, g, t, q);
  if (live) {
#pragma unroll
    for (int r = 0; r < kWords; ++r) {  // [0, 2q) -> [0, q)
      out[at + element<kLogN, 0, first_stages(kLogN)>(t, r)] = csub(x[r], q);
    }
  }
}

// Spectrum words 16t ... 16t + 15 of row `at`: four 16-byte vectors (0
// where the row is not live).
__device__ __forceinline__ void load_words(uint32_t (&x)[kWords], const uint32_t* in, size_t at,
                                           int t, bool live) {
  const uint4* v = reinterpret_cast<const uint4*>(in + at + kWords * t);
#pragma unroll
  for (int m = 0; m < kWords / 4; ++m) {
    const uint4 w = live ? v[m] : make_uint4(0, 0, 0, 0);
    x[4 * m] = w.x;
    x[4 * m + 1] = w.y;
    x[4 * m + 2] = w.z;
    x[4 * m + 3] = w.w;
  }
}

__device__ __forceinline__ void store_words(const uint32_t (&x)[kWords], uint32_t* out, size_t at,
                                            int t, bool live) {
  if (live) {
    uint4* v = reinterpret_cast<uint4*>(out + at + kWords * t);
#pragma unroll
    for (int m = 0; m < kWords / 4; ++m) {
      v[m] = make_uint4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
    }
  }
}

// out = NTT(in) * scale (scale 1 skipped) on `rows` rows: the forward, the
// lanes of [0, 4q) made canonical at the store of spectrum words 16t ...
// 16t + 15 (four 16-byte vectors).  Tables: the per-pass layout of
// mxu64.pass_table, four stages a pass.
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN), 1024 / block_threads(kLogN))
    radix_forward_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, Table pt,
                         int rows, uint32_t q, uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  uint32_t x[kWords];
  forward_row<kLogN>(x, in, at, smem, pt, g, t, live, q);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, 4q) -> [0, q)
    x[r] = scale == 1 ? csub(csub(x[r], 2 * q), q)
                      : csub(shoup_lazy(x[r], scale, scale_shoup, q), q);
  }
  store_words(x, out, at, t, live);  // the last pass holds elements 16t ... 16t + 15
}

// out = INTT(in) * scale on `rows` bit-reversed spectra (scale n^-1; the
// merged tables fold the negacyclic untwist in): spectrum words 16t ...
// 16t + 15 (four 16-byte vectors, canonical), one lazy Shoup product by
// `scale` ([0, 2q): the GS lanes' range), then inverse_row: the passes, one
// compare, the natural-order store.  Tiles and 1024 threads an SM as the
// forward's.
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN), 1024 / block_threads(kLogN))
    radix_inverse_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, Table pt,
                         int rows, uint32_t q, uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  uint32_t x[kWords];
  load_words(x, in, at, t, live);  // [0, q)
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, 2q)
    x[r] = shoup_lazy(x[r], scale, scale_shoup, q);
  }
  inverse_row<kLogN>(x, out, at, smem, pt, g, t, live, q);
}

// The products and the dot fused on the radix-16 core.  A slot product is a
// lazy REDC: a's lane x of [0, 4q), brought under 2q against a fresh
// spectrum's lane y (also under 2q, after its compare), or as it is against
// a cached spectrum's canonical word: x y < 4 q^2 < q 2^32 (q < 2^30)
// either way, so (x y + m q) / 2^32 < 2q, the inverse's range, with no
// compare.  A fresh b's spectrum waits while a's forward runs, and the
// dot's sum between its terms, each in a tile of shared memory private to
// each thread (word r of thread i at r * threads + i: a warp's 4-byte
// accesses hit 32 banks, no barrier), where the slot's lanes are; b's
// words reach the slot four at a time.  tools/nwc32_variants.py times the
// other places (PERF.md): b's spectrum in 16 registers ran as fast but
// spilled at six log n, at 512 threads an SM 6 % slower, in the output row
// 8 % slower (P24_4096, B = 2048); the dot's sum in registers spilled at
// every cached log n from 512 and ran from 6 % faster (n = 16384) to 10 %
// slower (DILITHIUM_256); 512 threads an SM ran 5 to 7 % slower than 1024.

// REDC(a * b) for a * b < q * 2^32: in [0, 2q), no compare.
__device__ __forceinline__ uint32_t mont_lazy(uint32_t a, uint32_t b, uint32_t q,
                                              uint32_t q_prime) {
  const uint32_t lo = a * b;
  const uint32_t m = lo * q_prime;
  return __umulhi(a, b) + __umulhi(m, q) + (lo != 0);  // (a b + m q) / 2^32 < 2q
}

template <bool kCached>
__device__ __forceinline__ uint32_t slot(uint32_t x, uint32_t y, uint32_t q, uint32_t q_prime) {
  return mont_lazy(kCached ? x : csub(x, 2 * q), y, q, q_prime);
}

// Word r of this thread in a private tile.
template <int kLogN>
__device__ __forceinline__ int own(int r) {
  return r * block_threads(kLogN) + threadIdx.x;
}

// Words 4m ... 4m + 3 of b's spectrum lanes of this thread: a cached
// spectrum's from row `at` ([0, q), times 2^32: one 16-byte vector of words
// 16t + 4m ...), a fresh one's from its private tile ([0, 2q)).
template <int kLogN, bool kCached>
__device__ __forceinline__ void spectrum_words(uint32_t (&y)[4], const uint32_t* b,
                                               const uint32_t* own_tile, size_t at, int t, int m,
                                               bool live) {
  if constexpr (kCached) {
    const uint4 v = live ? reinterpret_cast<const uint4*>(b + at + kWords * t)[m]
                         : make_uint4(0, 0, 0, 0);
    y[0] = v.x;
    y[1] = v.y;
    y[2] = v.z;
    y[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = own_tile[own<kLogN>(4 * m + i)];
    }
  }
}

// Blocks an SM of the fused kernels, for __launch_bounds__: 1024 threads.
__host__ __device__ constexpr int fused_blocks(int log_n) {
  return 1024 / block_threads(log_n);
}

// v, which the compiler must take as new (with kOn), so that each phase of a
// fused kernel (a forward; the slot and the inverse) computes its addresses
// again from it rather than keep an earlier phase's live.
template <bool kOn>
__device__ __forceinline__ int opaque(int v) {
  if constexpr (kOn) {
    asm volatile("" : "+r"(v));
  }
  return v;
}
template <bool kOn>
__device__ __forceinline__ size_t opaque_row(size_t v) {
  if constexpr (kOn) {
    asm volatile("" : "+l"(v));
  }
  return v;
}
// Whether a fused kernel's phases take their indices anew: where ptxas
// spilled without it at 64 registers a thread (the product at n = 8192, the
// cached one also at 512 and 16384, the cached dot at 8192).  Elsewhere it
// spilled nothing either way and cost 1 to 12 % (tools/nwc32_variants.py,
// PERF.md).
__host__ __device__ constexpr bool opaque_phases(int log_n, bool cached, bool dot) {
  return dot ? cached && log_n == 13 : log_n == 13 || (cached && (log_n == 9 || log_n == 14));
}

// out = INTT(NTT(a) o NTT(b)) * scale on `rows` rows (b a cached spectrum
// with kCached), `scale` at the slot (n^-1 2^32 after two fresh spectra,
// n^-1 against a cached one): b's forward, its lanes under 2q in a private
// tile, a's forward, the slot, the inverse.  Tables: the per-pass layout.
template <int kLogN, bool kCached>
__global__ void __launch_bounds__(block_threads(kLogN), fused_blocks(kLogN))
    product_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ out, Table tw, Table itw, int rows, uint32_t q,
                   uint32_t q_prime, uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN);
  uint32_t* const spectrum = smem + kTile * kN;
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  uint32_t x[kWords];
  if constexpr (!kCached) {
    forward_row<kLogN>(x, b, at, smem, tw, g, t, live, q);
#pragma unroll
    for (int r = 0; r < kWords; ++r) {  // [0, 4q) -> [0, 2q): the slot's lane
      spectrum[own<kLogN>(r)] = csub(x[r], 2 * q);
    }
    __syncthreads();  // a's first exchange overwrites the words b's last pass read
  }
  constexpr bool kOpaque = opaque_phases(kLogN, kCached, false);
  forward_row<kLogN>(x, a, opaque_row<kOpaque>(at), smem, tw, opaque<kOpaque>(g),
                     opaque<kOpaque>(t), live, q);
  const int gi = opaque<kOpaque>(g), ti = opaque<kOpaque>(t);  // the slot and the inverse
  const size_t ai = opaque_row<kOpaque>(at);
#pragma unroll
  for (int m = 0; m < kWords / 4; ++m) {
    uint32_t y[4];
    spectrum_words<kLogN, kCached>(y, b, spectrum, ai, ti, m, live);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // [0, 2q)
      const int r = 4 * m + i;
      x[r] = shoup_lazy(slot<kCached>(x[r], y[i], q, q_prime), scale, scale_shoup, q);
    }
  }
  inverse_row<kLogN>(x, out, ai, smem, itw, gi, ti, live, q);
}

// out = INTT(sum_k NTT(a_k) o NTT(b_k)) * scale for (terms, rows, n) stacks
// a and b (b cached spectra with kCached), one output row per row.  One loop
// of steps, each one forward: for a fresh term b's, whose lanes under 2q
// wait in a private tile, then a's, whose slot products add into the sum,
// in a second private tile; a cached term's b words are read after a's
// forward.  The sum stays in [0, 2q) by one compare after each add (two
// lanes below 2q sum below 4q < 2^32); after the last term its lanes times
// `scale`, then one inverse.
template <int kLogN, bool kCached>
__global__ void __launch_bounds__(block_threads(kLogN), fused_blocks(kLogN))
    dot_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, Table tw, Table itw, int terms, int rows, uint32_t q,
               uint32_t q_prime, uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN);
  uint32_t* const sum = smem + kTile * kN;
  uint32_t* const spectrum = smem + 2 * kTile * kN;
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  uint32_t x[kWords];
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    sum[own<kLogN>(r)] = 0;
  }
  constexpr bool kOpaque = opaque_phases(kLogN, kCached, true);
  const int steps = kCached ? terms : 2 * terms;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const int k = kCached ? step : step / 2;
    const bool of_b = !kCached && step % 2 == 0;  // b's forward of a fresh term
    const size_t ak = live ? (static_cast<size_t>(k) * rows + row) * kN : 0;
    const int gk = opaque<kOpaque>(g), tk = opaque<kOpaque>(t);  // this step's
    forward_row<kLogN>(x, of_b ? b : a, ak, smem, tw, gk, tk, live, q);
    if (of_b) {
#pragma unroll
      for (int r = 0; r < kWords; ++r) {  // [0, 4q) -> [0, 2q): the slot's lane
        spectrum[own<kLogN>(r)] = csub(x[r], 2 * q);
      }
    } else {
#pragma unroll
      for (int m = 0; m < kWords / 4; ++m) {
        uint32_t y[4];
        spectrum_words<kLogN, kCached>(y, b, spectrum, ak, tk, m, live);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // [0, 2q) + [0, 2q) < 4q -> [0, 2q)
          const int e = own<kLogN>(4 * m + i);
          sum[e] = csub(sum[e] + slot<kCached>(x[4 * m + i], y[i], q, q_prime), 2 * q);
        }
      }
    }
    if (step + 1 < steps) {
      __syncthreads();  // the next step's first exchange overwrites the words this one read
    }
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, 2q) -> [0, 2q)
    x[r] = shoup_lazy(sum[own<kLogN>(r)], scale, scale_shoup, q);
  }
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  inverse_row<kLogN>(x, out, at, smem, itw, opaque<kOpaque>(g), opaque<kOpaque>(t), live, q);
}

// REDC of a 64-bit sum: (t + m q) / 2^32 with m = lo(t) q' mod 2^32, for
// t < 2^63 (no wrap: m q < 2^62); congruent to t 2^-32 and below
// t / 2^32 + q.
__device__ __forceinline__ uint32_t redc64(uint64_t t, uint32_t q, uint32_t q_prime) {
  const uint32_t m = static_cast<uint32_t>(t) * q_prime;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);
}

// The matvec's accumulate-and-inverse (nwc32_matvec, K3c): out[i, r] =
// INTT(sum_j S[j, r] o A[i, j]) * scale for the (cols, batch, n) plain
// spectra S of s (the wrapper's nwc32_forward) and the (rows, cols, n)
// cached spectra A (times 2^32, so one REDC of the sum gives the plain
// products' sum), on the merged inverse's per-pass tables.  nwc64.cu's
// matvec schedule (nwc64_matvec) on this core: thread t of output row (i, r) sums
// words 16t ... 16t + 15 of S[j, r] o A[i, j] over j; both are canonical
// bit-reversed spectra, and those are the words the inverse's first pass
// starts from, so no exchange comes before it.  Then `scale` one lazy
// Shoup product and inverse_row: the passes, one compare, the
// natural-order store.  The k output rows of one batch row r are adjacent
// (output row o = r * rows + i, rows tiling a block as in the transforms),
// so the words of S a block reads come from device memory once and from L1
// or L2 k - 1 times; A (k l n words, 16 KiB at DILITHIUM_256 4 x 4) stays
// in L1 and L2.
// * The sum in plain products: s a < q^2 < 2^60, so the sum of l <= 8
//   terms stays below 8 q^2 < 2^63 in 64 bits, one multiply-add a word and
//   term (IMAD.WIDE) with no reduction, and one REDC of it after the loop
//   (below 8 q^2 / 2^32 + q < 3q for q < 2^30; the scale's lazy Shoup
//   product takes any word to [0, 2q)), where a REDC and a compare a term
//   were.
// * In two halves: eight 64-bit sums and a term's two 16-byte vectors of S
//   and of A fit 64 registers a thread beside the first half's results, so
//   the loop over j runs for words 16t ... 16t + 7, then for 16t + 8 ...
//   16t + 15 (each half a whole 32-byte sector of each row).  Sixteen
//   32-bit sums with one REDC and a compare a term, in registers beside a
//   term's 32 words, spilled 4 bytes at every log n at 64 registers a
//   thread (1024 threads an SM); tools/nwc32_variants.py times 512 threads
//   an SM and the batch row fastest beside this (PERF.md).
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN), fused_blocks(kLogN))
    radix_matvec_kernel(const uint32_t* __restrict__ spectra, const uint32_t* __restrict__ mat,
                        uint32_t* __restrict__ out, Table itw, int rows, int cols, int batch,
                        uint32_t q, uint32_t q_prime, uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN), kHalf = kWords / 2;
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int o = blockIdx.x * kTile + g;
  const bool live = o < rows * batch;
  const int r = live ? o / rows : 0, i = live ? o % rows : 0;  // batch row, row of A
  uint32_t x[kWords];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // words 16t + 8h ... 16t + 8h + 7
    uint64_t sum[kHalf];
#pragma unroll
    for (int w = 0; w < kHalf; ++w) {
      sum[w] = 0;
    }
#pragma unroll 1
    for (int j = 0; j < cols; ++j) {
      const uint4* s = reinterpret_cast<const uint4*>(
          spectra + (static_cast<size_t>(j) * batch + r) * kN + kWords * t + kHalf * h);
      const uint4* a = reinterpret_cast<const uint4*>(
          mat + (static_cast<size_t>(i) * cols + j) * kN + kWords * t + kHalf * h);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint4 sv = live ? s[m] : make_uint4(0, 0, 0, 0);  // [0, q)
        const uint4 av = live ? a[m] : make_uint4(0, 0, 0, 0);  // [0, q), times 2^32
        uint64_t* const z = sum + 4 * m;  // below 8 q^2 < 2^63 after eight terms
        z[0] += static_cast<uint64_t>(sv.x) * av.x;
        z[1] += static_cast<uint64_t>(sv.y) * av.y;
        z[2] += static_cast<uint64_t>(sv.z) * av.z;
        z[3] += static_cast<uint64_t>(sv.w) * av.w;
      }
    }
#pragma unroll
    for (int w = 0; w < kHalf; ++w) {  // below 3q -> [0, 2q)
      x[kHalf * h + w] = shoup_lazy(redc64(sum[w], q, q_prime), scale, scale_shoup, q);
    }
  }
  const size_t at = live ? (static_cast<size_t>(i) * batch + r) * kN : 0;
  inverse_row<kLogN>(x, out, at, smem, itw, g, t, live, q);
}

bool bad_shape(int batch, int log_n) {
  return batch < 1 || log_n < 8 || log_n > 14;
}

// Whether a row pointer is not 16-byte aligned (the spectrum words' vectors)
// or a table pointer not 8-byte aligned (its pairs).
bool misaligned(std::initializer_list<const void*> rows,
                std::initializer_list<const void*> tables) {
  uintptr_t r = 0, t = 0;
  for (const void* p : rows) {
    r |= reinterpret_cast<uintptr_t>(p);
  }
  for (const void* p : tables) {
    t |= reinterpret_cast<uintptr_t>(p);
  }
  return r % 16 || t % 8;
}

// Lifts the kernel's dynamic shared memory cap to `words` uint32 values.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int words) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              words * static_cast<int>(sizeof(uint32_t)));
}

Table table(const void* w, const void* w_shoup) {
  return Table{static_cast<const uint32_t*>(w),
               static_cast<const uint32_t*>(w_shoup)};
}

// A radix-16 kernel of log n = kLogN on `batch` rows, tile(kLogN) rows a
// block, with `tiles` tiles of shared memory.
template <int kLogN, typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int tiles, int batch, cudaStream_t stream, Args... args) {
  constexpr int kTile = tile(kLogN);
  const cudaError_t err = allow_smem(kernel, tiles * (kTile << kLogN));
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<(batch + kTile - 1) / kTile, block_threads(kLogN),
           tiles * (kTile << kLogN) * sizeof(uint32_t), stream>>>(args...);
  return cudaGetLastError();
}

// The fused product's entry (cached with kCached): log n from 8 to 14,
// the rows 16-byte aligned, the tables 8-byte aligned.
template <bool kCached>
int launch_product(const void* a, const void* b, void* out, const void* tw,
                   const void* tw_shoup, const void* itw, const void* itw_shoup,
                   int batch, int log_n, uint32_t q, uint32_t q_prime,
                   uint32_t scale, uint32_t scale_shoup, void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({a, b, out}, {tw, tw_shoup, itw, itw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  const Table ptw = table(tw, tw_shoup), pitw = table(itw, itw_shoup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC32_LOG_N(L)                                                                      \
  case L:                                                                                   \
    return launch_rows<L>(product_kernel<L, kCached>, kCached ? 1 : 2, batch, s, pa, pb, po, \
                          ptw, pitw, batch, q, q_prime, scale, scale_shoup);
    NWC32_LOG_N(8) NWC32_LOG_N(9) NWC32_LOG_N(10) NWC32_LOG_N(11) NWC32_LOG_N(12)
    NWC32_LOG_N(13) NWC32_LOG_N(14)
#undef NWC32_LOG_N
  }
  return cudaErrorInvalidValue;
}

// The fused dot's entry: one to eight terms, as launch_product.
template <bool kCached>
int launch_dot(const void* a, const void* b, void* out, const void* tw, const void* tw_shoup,
               const void* itw, const void* itw_shoup, int terms, int batch, int log_n,
               uint32_t q, uint32_t q_prime, uint32_t scale, uint32_t scale_shoup,
               void* stream) {
  if (bad_shape(batch, log_n) || terms < 1 || terms > 8) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({a, b, out}, {tw, tw_shoup, itw, itw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  const Table ptw = table(tw, tw_shoup), pitw = table(itw, itw_shoup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC32_LOG_N(L)                                                                   \
  case L:                                                                                \
    return launch_rows<L>(dot_kernel<L, kCached>, kCached ? 2 : 3, batch, s, pa, pb, po, \
                          ptw, pitw, terms, batch, q, q_prime, scale, scale_shoup);
    NWC32_LOG_N(8) NWC32_LOG_N(9) NWC32_LOG_N(10) NWC32_LOG_N(11) NWC32_LOG_N(12)
    NWC32_LOG_N(13) NWC32_LOG_N(14)
#undef NWC32_LOG_N
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Every entry point launches on `stream`, which must belong to the current
// device, and returns the CUDA error code (0 on success).  A launch the
// device refuses (too much shared memory, a bad shape, a misaligned
// pointer) never runs, so the caller must check the code.  Every entry
// point reads its tables (w, w') in the per-pass layout of mxu64.pass_table
// at four stages a pass.

// out = INTT(NTT(a) o NTT(b)) * scale on (batch, n) rows, fused on the
// radix-16 core; rows 16-byte aligned, tables 8-byte aligned.
extern "C" int nwc32_product(const void* a, const void* b, void* out,
                             const void* tw, const void* tw_shoup,
                             const void* itw, const void* itw_shoup, int batch,
                             int log_n, uint32_t q, uint32_t q_prime,
                             uint32_t scale, uint32_t scale_shoup, void* stream) {
  return launch_product<false>(a, b, out, tw, tw_shoup, itw, itw_shoup, batch,
                               log_n, q, q_prime, scale, scale_shoup, stream);
}

// The same against a cached spectrum (one forward).
extern "C" int nwc32_cached(const void* a, const void* spectrum, void* out,
                            const void* tw, const void* tw_shoup,
                            const void* itw, const void* itw_shoup, int batch,
                            int log_n, uint32_t q, uint32_t q_prime,
                            uint32_t scale, uint32_t scale_shoup, void* stream) {
  return launch_product<true>(a, spectrum, out, tw, tw_shoup, itw, itw_shoup,
                              batch, log_n, q, q_prime, scale, scale_shoup,
                              stream);
}

// The forward of (batch, n) rows on the radix-16 core, times `scale` unless
// it is 1; out 16-byte aligned, the tables 8-byte aligned.
extern "C" int nwc32_forward(const void* in, void* out, const void* tw,
                             const void* tw_shoup, int batch, int log_n,
                             uint32_t q, uint32_t scale, uint32_t scale_shoup,
                             void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({out}, {tw, tw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table pt = table(tw, tw_shoup);
  const uint32_t* pi = static_cast<const uint32_t*>(in);
  uint32_t* po = static_cast<uint32_t*>(out);
  switch (log_n) {
#define NWC32_LOG_N(L) \
  case L:              \
    return launch_rows<L>(radix_forward_kernel<L>, 1, batch, s, pi, po, pt, batch, q, scale, \
                          scale_shoup);
    NWC32_LOG_N(8) NWC32_LOG_N(9) NWC32_LOG_N(10) NWC32_LOG_N(11) NWC32_LOG_N(12)
    NWC32_LOG_N(13) NWC32_LOG_N(14)
#undef NWC32_LOG_N
  }
  return cudaErrorInvalidValue;
}

// The inverse of (batch, n) bit-reversed spectra on the radix-16 core,
// times `scale`; in 16-byte aligned, the tables 8-byte aligned.
extern "C" int nwc32_inverse(const void* in, void* out, const void* itw,
                             const void* itw_shoup, int batch, int log_n,
                             uint32_t q, uint32_t scale, uint32_t scale_shoup,
                             void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({in}, {itw, itw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table pt = table(itw, itw_shoup);
  const uint32_t* pi = static_cast<const uint32_t*>(in);
  uint32_t* po = static_cast<uint32_t*>(out);
  switch (log_n) {
#define NWC32_LOG_N(L) \
  case L:              \
    return launch_rows<L>(radix_inverse_kernel<L>, 1, batch, s, pi, po, pt, batch, q, scale, \
                          scale_shoup);
    NWC32_LOG_N(8) NWC32_LOG_N(9) NWC32_LOG_N(10) NWC32_LOG_N(11) NWC32_LOG_N(12)
    NWC32_LOG_N(13) NWC32_LOG_N(14)
#undef NWC32_LOG_N
  }
  return cudaErrorInvalidValue;
}

// out = INTT(sum_k NTT(a_k) o NTT(b_k)) * scale for (terms, batch, n) stacks
// (b cached spectra where `cached` is nonzero), 1 <= terms <= 8, fused on
// the radix-16 core; rows 16-byte aligned, tables 8-byte aligned.
extern "C" int nwc32_dot(const void* a, const void* b, void* out,
                         const void* tw, const void* tw_shoup, const void* itw,
                         const void* itw_shoup, int terms, int batch, int log_n,
                         uint32_t q, uint32_t q_prime, uint32_t scale,
                         uint32_t scale_shoup, int cached, void* stream) {
  return (cached ? launch_dot<true> : launch_dot<false>)(a, b, out, tw, tw_shoup, itw, itw_shoup,
                                                         terms, batch, log_n, q, q_prime, scale,
                                                         scale_shoup, stream);
}

// The matvec's accumulate-and-inverse: the (cols, batch, n) plain spectra
// of s against the (rows, cols, n) cached spectra of A, 1 <= rows, cols <=
// 8; (rows, batch, n) out, on the radix-16 core with the merged inverse's
// per-pass tables; rows 16-byte aligned, tables 8-byte aligned.
extern "C" int nwc32_matvec(const void* spectra, const void* mat, void* out,
                            const void* itw, const void* itw_shoup, int rows,
                            int cols, int batch, int log_n, uint32_t q,
                            uint32_t q_prime, uint32_t scale,
                            uint32_t scale_shoup, void* stream) {
  if (bad_shape(batch, log_n) || rows < 1 || rows > 8 || cols < 1 || cols > 8 ||
      batch > 0x7fffffff / rows) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({spectra, mat, out}, {itw, itw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  const uint32_t* ps = static_cast<const uint32_t*>(spectra);
  const uint32_t* pm = static_cast<const uint32_t*>(mat);
  uint32_t* po = static_cast<uint32_t*>(out);
  const Table pitw = table(itw, itw_shoup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC32_LOG_N(L)                                                                      \
  case L:                                                                                   \
    return launch_rows<L>(radix_matvec_kernel<L>, 1, rows * batch, s, ps, pm, po, pitw, rows, \
                          cols, batch, q, q_prime, scale, scale_shoup);
    NWC32_LOG_N(8) NWC32_LOG_N(9) NWC32_LOG_N(10) NWC32_LOG_N(11) NWC32_LOG_N(12)
    NWC32_LOG_N(13) NWC32_LOG_N(14)
#undef NWC32_LOG_N
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* nwc32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kyber.cu: the ML-KEM (FIPS 203) kernels, hand-written for Hopper (sm_90a).
//
// Replaces kernel K4 of tpu_ntt/kernels/kyber.py (KyberPlan, the fixed ring
// Z_3329[x]/(x^256 + 1)), all four of its pallas_calls:
//   kyber_forward  _transform_kernel (:388) with the plain forward matrix
//                  through KyberPlan._call (:466): ntt (:547); with the scale
//                  2^32 mod q, _spectrum_kernel_v2 (:291) through _call_v2
//                  (:517): spectrum (:566) and matvec_spectra (:694)
//   kyber_inverse  _transform_kernel (:388) with the plain inverse matrix:
//                  intt (:556)
//   kyber_product  _poly_mult_kernel_v2 (:277) through _call_v2 (:517)
//   kyber_cached   _cached_kernel_v2 (:301), the same launcher
//   kyber_dot      _make_dot_kernel_v2 (:311) through _dot_call (:636),
//                  fresh and cached
//   kyber_matvec   _make_matvec_kernel_v2 (:336) through matvec (:776)
// The pair-layout bodies behind parity_matrices = False (_poly_mult_kernel
// :261, _poly_mult_kernel_st :359, _cached_kernel :382, _make_dot_kernel
// :392 through :673, _make_matvec_kernel :405 through :814) compute the same
// integers; only their cached-spectrum layout differs, and that layout is the
// TPU's.  Residues are uint32 in [0, q), (B, 256) rows, coefficients in
// natural order, spectra in FIPS-203 serialization order (slot i's two values
// at 2i and 2i + 1).  Each function computes what
// tpu_ntt_torch.kernels.kyber.KyberPlan's plain version of it computes, bit
// for bit: the TPU kernel's function, not its algorithm.  The 128 x 128 DFT
// matrices, 6-bit int8 limbs and parity-in-matrix layout exist only because
// of Mosaic (kyber.py:11-45); none of them is carried over.
//
// Two designs.  kyber_dot runs a radix-16 core of its own ("The radix-16
// core" below): nwc32.cu's schedule at n = 256 without its last stage, 16
// words a thread, two passes, the base case in plain products summed in
// registers.  The other five kernels keep the first design, correct
// first and simple (the shape of nwc32.cu's first kernels at n = 256):
// * One block of 128 threads per row (per output row for the matvec); its
//   rows live in static shared memory, 1 KiB each, so device memory sees
//   each operand and each result once.
// * Algorithm 9 is the first seven stages of a merged Cooley-Tukey network
//   on 256 values: the stage with m = 2^s groups pairs u and u + (128 >> s)
//   and takes zeta^br7(m + g) for group g, entry m + g of a 128-entry table,
//   beside its Shoup companion floor(w * 2^32 / q).  Thread j runs butterfly
//   j of every stage, __syncthreads between stages.  Algorithm 10 is the
//   Gentleman-Sande mirror with zeta^-br7(m + g), which equals FIPS's
//   -zeta^br7(2m - 1 - g), so (u - v) * w is its zeta * (v - u).
// * Thread i then owns slot i of the base case: c0 = a0 b0 + a1 b1 gamma_i,
//   c1 = a0 b1 + a1 b0, five Montgomery-32 products against gamma_i * 2^32
//   mod q, which leave c * 2^-32.  One Shoup multiply by the scale the
//   wrapper passes cancels it and applies Algorithm 10's 128^-1 (128^-1 *
//   2^32 for two fresh spectra; 128^-1 against a cached spectrum, which
//   holds its 2^32 already: JAX's cached domain, so convert only permutes).
// * Every value stays canonical in [0, q), also through the matvec's sums,
//   which each thread keeps for its slot in registers.
// * The matvec is one launch, unlike nwc32.cu's: the l rows of s and the
//   output row fit a block (9 KiB at l = 8), so each block transforms its
//   batch row's s, reads A's (k, l, 256) spectra from device memory (L2:
//   9 KiB at 3 x 3) and runs k accumulate-and-inverse passes.  The spectra
//   of s never reach device memory (nwc32's split writes and reads them).
//
// What bounds it on this card.  q = 3329 has four signed binary digits, so
// a product by q is a multiply: 3 IMADs a Shoup product, 4 a Montgomery one.
// A transform is 7 x 128 butterflies, a base case 128 x 5 Montgomery
// products.  At B = 16384 the product's 1.9e8 IMADs take 0.011 ms at 132 SMs
// x 64 IMADs a clock x 1.98 GHz, its 50 MB of operands and result 0.015 ms
// at 3.35 TB/s: device memory bounds the transforms, products and dot;
// multiplies bound the 3 x 3 matvec (tpu_ntt_torch/bounds.py).  What holds
// the first design back is neither: about 30 instructions a butterfly
// between 7 barriers a transform, one butterfly per thread between
// barriers; the radix-16 core's header says what it does about each.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kN = 256;       // coefficients a row
constexpr int kSlots = 128;   // quadratic slots a row, and threads a block
constexpr int kStages = 7;    // Algorithm 9's layers: lengths 128 down to 2
constexpr int kMaxTerms = 8;  // K of the dot, k and l of the matvec

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;  // a, b < q < 2^31: no wrap
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// a * w mod q for a constant w with w_shoup = floor(w * 2^32 / q).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t w_shoup, uint32_t q) {
  const uint32_t r = a * w - __umulhi(a, w_shoup) * q;  // in [0, 2q)
  return r >= q ? r - q : r;
}

// REDC(a * b) = a * b * 2^-32 mod q, with q_prime = -q^-1 mod 2^32.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t q,
                                             uint32_t q_prime) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * q_prime;
  // t + m*q < 2^62 + 2^63 and is 0 mod 2^32; the quotient is below 2q.
  const uint32_t r =
      static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);
  return r >= q ? r - q : r;
}

struct Table {
  const uint32_t* w;
  const uint32_t* w_shoup;
};

// The two values of slot i of the base case (FIPS-203 Algorithm 12), times
// 2^-32: gamma is gamma_i * 2^32 mod q.
__device__ __forceinline__ void base_case(uint32_t a0, uint32_t a1, uint32_t b0,
                                          uint32_t b1, uint32_t gamma, uint32_t q,
                                          uint32_t q_prime, uint32_t& c0,
                                          uint32_t& c1) {
  c0 = add_mod(mont_mul(a0, b0, q, q_prime),
               mont_mul(mont_mul(a1, b1, q, q_prime), gamma, q, q_prime), q);
  c1 = add_mod(mont_mul(a0, b1, q, q_prime), mont_mul(a1, b0, q, q_prime), q);
}

// Algorithm 9, in place, on `rows` rows of 256 values spaced 256 apart: stage
// s has m = 2^s groups of 2t values, t = 128 >> s; butterfly j pairs
// u = 2t * (j / t) + j % t with u + t.
__device__ void forward(uint32_t* x, int rows, Table tw, uint32_t q) {
  const int j = threadIdx.x;
  for (int s = 0; s < kStages; ++s) {
    const int lt = kStages - s;
    const int g = j >> lt;
    const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
    const int v = u + (1 << lt);
    const uint32_t w = __ldg(tw.w + (1 << s) + g);
    const uint32_t ws = __ldg(tw.w_shoup + (1 << s) + g);
    for (int r = 0; r < rows; ++r) {
      uint32_t* y = x + r * kN;
      const uint32_t yu = y[u], yv = shoup_mul(y[v], w, ws, q);
      y[u] = add_mod(yu, yv, q);
      y[v] = sub_mod(yu, yv, q);
    }
    __syncthreads();
  }
}

// Algorithm 10 without its 128^-1, in place on one row: the forward's stages
// in reverse order.  The caller's scale carries 128^-1.
__device__ void inverse(uint32_t* x, Table itw, uint32_t q) {
  const int j = threadIdx.x;
  for (int s = kStages - 1; s >= 0; --s) {
    const int lt = kStages - s;
    const int g = j >> lt;
    const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
    const int v = u + (1 << lt);
    const uint32_t w = __ldg(itw.w + (1 << s) + g);
    const uint32_t ws = __ldg(itw.w_shoup + (1 << s) + g);
    const uint32_t xu = x[u], xv = x[v];
    x[u] = add_mod(xu, xv, q);
    x[v] = shoup_mul(sub_mod(xu, xv, q), w, ws, q);
    __syncthreads();
  }
}

// Row `row` of `in` into x; each thread moves two coalesced words.
__device__ __forceinline__ void load_row(uint32_t* x, const uint32_t* in,
                                         size_t row) {
  const int t = threadIdx.x;
  x[t] = in[row * kN + t];
  x[t + kSlots] = in[row * kN + t + kSlots];
}

__device__ __forceinline__ void store_row(uint32_t* out, size_t row,
                                          const uint32_t* x) {
  const int t = threadIdx.x;
  out[row * kN + t] = x[t];
  out[row * kN + t + kSlots] = x[t + kSlots];
}

// Slot t's sum, times `scale`, into x at 2t and 2t + 1.
__device__ __forceinline__ void put_slot(uint32_t* x, uint32_t c0, uint32_t c1,
                                         uint32_t scale, uint32_t scale_shoup,
                                         uint32_t q) {
  const int t = threadIdx.x;
  x[2 * t] = shoup_mul(c0, scale, scale_shoup, q);
  x[2 * t + 1] = shoup_mul(c1, scale, scale_shoup, q);
}

// The product of a row of a with a row of b: b is coefficients, or with
// kCached a spectrum that is used as it is.
template <bool kCached>
__global__ void __launch_bounds__(kSlots)
    product_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ out, Table tw, Table itw,
                   const uint32_t* __restrict__ gamma, uint32_t q,
                   uint32_t q_prime, uint32_t scale, uint32_t scale_shoup) {
  __shared__ uint32_t x[2 * kN];
  const int t = threadIdx.x;
  uint32_t* y = x + kN;
  load_row(x, a, blockIdx.x);
  load_row(y, b, blockIdx.x);
  __syncthreads();
  forward(x, kCached ? 1 : 2, tw, q);
  uint32_t c0, c1;
  base_case(x[2 * t], x[2 * t + 1], y[2 * t], y[2 * t + 1], __ldg(gamma + t), q,
            q_prime, c0, c1);
  put_slot(x, c0, c1, scale, scale_shoup, q);  // slot t's own two words
  __syncthreads();
  inverse(x, itw, q);
  store_row(out, blockIdx.x, x);
}

// The forward of one row, times `scale` unless it is 1.
__global__ void __launch_bounds__(kSlots)
    forward_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   Table tw, uint32_t q, uint32_t scale, uint32_t scale_shoup) {
  __shared__ uint32_t x[kN];
  const int t = threadIdx.x;
  load_row(x, in, blockIdx.x);
  __syncthreads();
  forward(x, 1, tw, q);
  if (scale != 1) {
    x[t] = shoup_mul(x[t], scale, scale_shoup, q);
    x[t + kSlots] = shoup_mul(x[t + kSlots], scale, scale_shoup, q);
  }
  store_row(out, blockIdx.x, x);
}

// The inverse of one row, then times `scale` (128^-1).
__global__ void __launch_bounds__(kSlots)
    inverse_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   Table itw, uint32_t q, uint32_t scale, uint32_t scale_shoup) {
  __shared__ uint32_t x[kN];
  const int t = threadIdx.x;
  load_row(x, in, blockIdx.x);
  __syncthreads();
  inverse(x, itw, q);
  x[t] = shoup_mul(x[t], scale, scale_shoup, q);
  x[t + kSlots] = shoup_mul(x[t + kSlots], scale, scale_shoup, q);
  store_row(out, blockIdx.x, x);
}

// ---------------------------------------------------------------------------
// The radix-16 core: kyber_dot.  nwc32.cu's radix-16 schedule at log n = 8
// (its helpers copied here: kyber.cu is built alone) without the final
// stage, the same integers as the plain dot (a canonical result is unique):
// * Passes in registers.  A thread holds kWords = 16 words of its row, 16
//   threads a row (half a warp), kTile = 8 rows a block (128 threads).  Pass
//   1 runs stages 0-3 (spans 128, 64, 32, 16) on register k = element
//   16k + t, loaded straight from device memory (a row's 16 threads read 64
//   contiguous bytes a register); one exchange through the row's 1 KiB of
//   shared memory; pass 2 runs stages 4-6 (spans 8, 4, 2) on register
//   k = element 16t + k.  Stage s + d pairs registers k and k + 2^(3 - d)
//   in both passes and takes the group's twiddle k >> (4 - d).  Algorithm
//   9 has no span-1 stage, so pass 2 is a radix-16 pass of three stages:
//   thread t ends holding slots 8t ... 8t + 7, slot 8t + j's two values in
//   registers 2j and 2j + 1 (FIPS order, slot i at 2i and 2i + 1), and the
//   base case needs no exchange; a cached spectrum's words arrive there as
//   four 16-byte loads.  The inverse runs pass 2 reversed from those
//   registers, one exchange, pass 1 reversed, and stores to the positions
//   pass 1 loads from.  nwc32.cu's short pass is its first; here it is the
//   last, and the twiddle layout follows: mxu64.pass_table's per-pass
//   layout for the passes ((0, 4), (4, 3)) of a 128-entry table
//   (kernels/kyber.py PASSES): pass 1's 16 words, then pass 2's 16 groups
//   of four 8-byte columns (stage 4 and a pad, stage 5's two, stage 6's
//   four); Algorithm 10 reads the inverse table in the same layout.
// * Warp barriers.  A row's exchange involves its own 16 threads, half a
//   warp, so each barrier is the warp's (__syncwarp, which orders the
//   warp's shared-memory accesses), never the block's: the block's four
//   warps run apart.  One barrier a pass: the exchange's, and one after
//   each step of the dot's loop (the next forward's exchange writes words
//   another thread read); the inverse's exchange needs none before it (a
//   thread writes the words it alone read).
// * Lazy lanes, with room: q = 3329 < 2^12, so 32-bit lanes hold far more
//   than Harvey's 4q.  The forward's CT butterflies compare nothing: the
//   Shoup product of any word is below 2q, so a stage adds at most 2q to
//   its lanes' bound, q in, below (3 + 2s) q after stage s, 15q after
//   seven.  The GS butterflies keep their lanes in [0, 2q) (one compare),
//   one compare at the store.
// * The base case in plain products.  A fresh b's lanes are made
//   canonical (a Barrett step, floor(2^32 / q), and one compare) when its
//   forward ends; a cached spectrum's words are canonical.  With a's lanes
//   below 15q and b's below q, t = REDC(b1 gamma * 2^32) = b1 gamma (its
//   product below 2^32: no high product, no compare, mont_small, in
//   [0, q]), and c0 += a0 b0 + a1 t, c1 += a0 b1 + a1 b0 add below 30 q^2
//   a term: the sum of K <= 8 terms stays below 240 q^2 < 2^32 (62 % of
//   it) with no reduction at all.  After the loop one lazy Shoup product by
//   `scale` (any 32-bit word in, [0, 2q) out, the inverse's range) applies
//   128^-1 (and 2^-32 against a cached spectrum, which holds its 2^32):
//   four multiply-adds and one REDC a slot and term, where five REDCs and
//   their compares were.
// * The dot's loop is nwc32.cu's dot_kernel's: one forward a step (b's, then
//   a's of a fresh term), #pragma unroll 1.  A fresh b's canonical words
//   wait in a tile of shared memory private to each thread (word w of
//   thread i at w * 128 + i: a warp's accesses hit 32 banks, no barrier)
//   while a's forward runs; a cached term's b words are read after a's
//   forward.  The sum waits in sixteen registers; each thread reads its
//   eight gamma * 2^32 values as two 16-byte loads a term (L1).
//   tools/kyber_variants.py times the sum in a private tile, the block's
//   barrier and 512 threads an SM beside it (PERF.md).
// ---------------------------------------------------------------------------

constexpr int kWords = 16;                   // words a thread holds in both passes
constexpr int kRowThreads = kN / kWords;     // 16 threads a row: half a warp
constexpr int kTile = 8;                     // rows a block
constexpr int kThreads = kTile * kRowThreads;  // 128 threads a block
constexpr int kLastTable = 16;  // pass 2's table after pass 1's 16 words (8 pairs)

// a * w mod q up to one q: in [0, 2q) for ANY a < 2^32, given w < q and
// ws = floor(w * 2^32 / q) (a * ws / 2^32 falls short of a * w / q by less
// than a / 2^32 + 1 < 2); 2q < 2^32, so nothing wraps.
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w, uint32_t ws, uint32_t q) {
  return a * w - __umulhi(a, ws) * q;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) { return x >= m ? x - m : x; }

// x mod q for any x < 2^32, given q_floor = floor(2^32 / q): Barrett's
// quotient hi(x q_floor) falls short of x / q by less than 2, so x minus
// its multiple of q is below 2q; one compare makes it canonical.
__device__ __forceinline__ uint32_t canonical(uint32_t x, uint32_t q, uint32_t q_floor) {
  return csub(x - __umulhi(x, q_floor) * q, q);
}

// REDC(a * b) = a * b * 2^-32 mod q for a * b < 2^32: with m = a b q'
// mod 2^32, a b + m q is 0 mod 2^32 and below (q + 1) 2^32, so its quotient
// is hi(m q) plus the carry of the low words, in [0, q].
__device__ __forceinline__ uint32_t mont_small(uint32_t a, uint32_t b, uint32_t q,
                                               uint32_t q_prime) {
  const uint32_t lo = a * b;
  return __umulhi(lo * q_prime, q) + (lo != 0);
}

// Cooley-Tukey with no compare: x, y below X in, below X + 2q out (X at
// most 15q: nothing wraps).
__device__ __forceinline__ void ct(uint32_t& x, uint32_t& y, uint32_t w, uint32_t ws,
                                   uint32_t q) {
  const uint32_t u = x;
  const uint32_t v = shoup_lazy(y, w, ws, q);  // [0, 2q)
  x = u + v;
  y = u + 2 * q - v;
}

// Gentleman-Sande: x, y in [0, 2q) in, and out.
__device__ __forceinline__ void gs(uint32_t& x, uint32_t& y, uint32_t w, uint32_t ws, uint32_t q) {
  const uint32_t q2 = 2 * q;
  const uint32_t u = x, v = y;
  x = csub(u + v, q2);                   // [0, 2q)
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

// Stage kS + kD of a pass at stage kS: register k meets k + 2^(3 - kD)
// with the group's twiddle k >> (4 - kD).
template <int kS, int kD, bool kInverse>
__device__ __forceinline__ void stage(uint32_t (&x)[kWords], const uint32_t* tw,
                                      const uint32_t* tws, int hi, uint32_t q) {
  constexpr int kSpan = 8 >> kD;
  uint32_t w[8], ws[8];
  stage_twiddles<kS, kD>(tw, tws, hi, w, ws);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (!(k & kSpan)) {
      const int e = k >> (4 - kD);
      if constexpr (kInverse) {
        gs(x[k], x[k + kSpan], w[e], ws[e], q);
      } else {
        ct(x[k], x[k + kSpan], w[e], ws[e], q);
      }
    }
  }
}

// The barrier of a row's exchange: its 16 threads are half a warp.
__device__ __forceinline__ void row_sync() { __syncwarp(); }

// Element of register k of thread t: 16k + t in pass 1, 16t + k in pass 2.
__device__ __forceinline__ int first_word(int t, int k) { return kWords * k + t; }

// Pass 2's sixteen words of thread t in the row's tile, as four 16-byte
// vectors (the row's tile is 16-byte aligned).
__device__ __forceinline__ void load_own(uint32_t (&x)[kWords], const uint32_t* row, int t) {
  const uint4* v = reinterpret_cast<const uint4*>(row + kWords * t);
#pragma unroll
  for (int m = 0; m < kWords / 4; ++m) {
    const uint4 w = v[m];
    x[4 * m] = w.x;
    x[4 * m + 1] = w.y;
    x[4 * m + 2] = w.z;
    x[4 * m + 3] = w.w;
  }
}

__device__ __forceinline__ void store_own(const uint32_t (&x)[kWords], uint32_t* row, int t) {
  uint4* v = reinterpret_cast<uint4*>(row + kWords * t);
#pragma unroll
  for (int m = 0; m < kWords / 4; ++m) {
    v[m] = make_uint4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
  }
}

// Algorithm 9 on row `at` of `in` (words below q): pass 1 from device
// memory, the exchange through the row's tile, pass 2; lanes below 15q
// out, words 16t ... 16t + 15.  Tables: the per-pass layout.
__device__ __forceinline__ void forward_row(uint32_t (&x)[kWords], const uint32_t* in, size_t at,
                                            uint32_t* row, Table pt, int t, bool live,
                                            uint32_t q) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {  // [0, q)
    x[k] = live ? in[at + first_word(t, k)] : 0;
  }
  stage<0, 0, false>(x, pt.w, pt.w_shoup, 0, q);
  stage<0, 1, false>(x, pt.w, pt.w_shoup, 0, q);
  stage<0, 2, false>(x, pt.w, pt.w_shoup, 0, q);
  stage<0, 3, false>(x, pt.w, pt.w_shoup, 0, q);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    row[first_word(t, k)] = x[k];
  }
  row_sync();
  load_own(x, row, t);
  const uint32_t* w = pt.w + kLastTable;
  const uint32_t* ws = pt.w_shoup + kLastTable;
  stage<4, 0, false>(x, w, ws, t, q);
  stage<4, 1, false>(x, w, ws, t, q);
  stage<4, 2, false>(x, w, ws, t, q);
}

// Algorithm 10 without its 128^-1 from words 16t ... 16t + 15 (lanes in
// [0, 2q)): pass 2 reversed, the exchange (a thread writes the words it
// alone read last, so no barrier before it), pass 1 reversed, and the
// store of row `at` in natural order, one compare, at pass 1's positions.
__device__ __forceinline__ void inverse_row(uint32_t (&x)[kWords], uint32_t* out, size_t at,
                                            uint32_t* row, Table pt, int t, bool live,
                                            uint32_t q) {
  const uint32_t* w = pt.w + kLastTable;
  const uint32_t* ws = pt.w_shoup + kLastTable;
  stage<4, 2, true>(x, w, ws, t, q);
  stage<4, 1, true>(x, w, ws, t, q);
  stage<4, 0, true>(x, w, ws, t, q);
  store_own(x, row, t);
  row_sync();
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    x[k] = row[first_word(t, k)];
  }
  stage<0, 3, true>(x, pt.w, pt.w_shoup, 0, q);
  stage<0, 2, true>(x, pt.w, pt.w_shoup, 0, q);
  stage<0, 1, true>(x, pt.w, pt.w_shoup, 0, q);
  stage<0, 0, true>(x, pt.w, pt.w_shoup, 0, q);
  if (live) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {  // [0, 2q) -> [0, q)
      out[at + first_word(t, k)] = csub(x[k], q);
    }
  }
}

// Word w of this thread in a private tile.
__device__ __forceinline__ int own(int w) { return w * kThreads + threadIdx.x; }

// out[r] = INTT(sum_k NTT(a[k, r]) o NTT(b[k, r])) * scale for (terms,
// batch, 256) stacks a and b (b spectra times 2^32 with kCached), one
// output row per row: a loop of steps, each one forward (b's of a fresh
// term, whose canonical words wait in a private tile, then a's), a's lanes
// (below 15q) and b's canonical words meeting in the base case of slots
// 8t ... 8t + 7, each slot's plain products added into the sum (below
// 240 q^2 after eight terms); then the sum times `scale` (128^-1, and
// 2^-32 with kCached) and one inverse.
template <bool kCached>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    dot_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, Table tw, Table itw,
               const uint32_t* __restrict__ gamma, int terms, int batch, uint32_t q,
               uint32_t q_prime, uint32_t scale, uint32_t scale_shoup) {
  __shared__ __align__(16) uint32_t tile[kTile * kN];  // the exchange: row g at g * 256
  __shared__ uint32_t spectrum[kCached ? 1 : kWords * kThreads];  // a fresh b's words
  const int g = threadIdx.x / kRowThreads, t = threadIdx.x % kRowThreads;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < batch;
  const uint32_t q_floor = 0xFFFFFFFFu / q;  // floor(2^32 / q): q is odd
  uint32_t* const xrow = tile + g * kN;
  const uint4* const gam = reinterpret_cast<const uint4*>(gamma) + (kWords / 8) * t;
  uint32_t x[kWords], sum[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    sum[w] = 0;
  }
  const int steps = kCached ? terms : 2 * terms;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const int k = kCached ? step : step / 2;
    const bool of_b = !kCached && step % 2 == 0;  // b's forward of a fresh term
    const size_t at = live ? (static_cast<size_t>(k) * batch + row) * kN : 0;
    forward_row(x, of_b ? b : a, at, xrow, tw, t, live, q);  // below 15q
    if (of_b) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {  // [0, q)
        spectrum[own(w)] = canonical(x[w], q, q_floor);
      }
    } else {
#pragma unroll
      for (int m = 0; m < kWords / 4; ++m) {  // slots 8t + 2m and 8t + 2m + 1
        uint32_t y[4];  // b's words 16t + 4m ...: [0, q)
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
            y[i] = spectrum[own(4 * m + i)];
          }
        }
        const uint4 g4 = __ldg(gam + m / 2);  // gamma_i * 2^32 of slots 8t + 4(m / 2) ...
        const uint32_t gm[2] = {m % 2 ? g4.z : g4.x, m % 2 ? g4.w : g4.y};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int w = 4 * m + 2 * j;  // the slot's words w, w + 1
          const uint32_t b1g = mont_small(y[2 * j + 1], gm[j], q, q_prime);  // b1 gamma, [0, q]
          sum[w] += x[w] * y[2 * j] + x[w + 1] * b1g;  // c0: below 30 q^2 a term
          sum[w + 1] += x[w] * y[2 * j + 1] + x[w + 1] * y[2 * j];  // c1
        }
      }
    }
    if (step + 1 < steps) {
      row_sync();  // the next step's exchange overwrites words another thread read
    }
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {  // below 240 q^2 < 2^32 -> [0, 2q)
    x[w] = shoup_lazy(sum[w], scale, scale_shoup, q);
  }
  inverse_row(x, out, live ? static_cast<size_t>(row) * kN : 0, xrow, itw, t, live, q);
}

// out[i, r] = INTT(sum_j NTT(s[j, r]) o A[i, j]) for every i < rows, in the
// block of batch row r: s is (cols, batch, 256) coefficients, A the (rows,
// cols, 256) cached spectra (times 2^32), so each base case gives the plain
// product.
__global__ void __launch_bounds__(kSlots)
    matvec_kernel(const uint32_t* __restrict__ s, const uint32_t* __restrict__ mat,
                  uint32_t* __restrict__ out, Table tw, Table itw,
                  const uint32_t* __restrict__ gamma, int rows, int cols,
                  int batch, uint32_t q, uint32_t q_prime, uint32_t scale,
                  uint32_t scale_shoup) {
  __shared__ uint32_t x[(kMaxTerms + 1) * kN];
  const int t = threadIdx.x;
  uint32_t* acc = x + cols * kN;
  for (int j = 0; j < cols; ++j) {
    load_row(x + j * kN, s, static_cast<size_t>(j) * batch + blockIdx.x);
  }
  __syncthreads();
  forward(x, cols, tw, q);
  const uint32_t g = __ldg(gamma + t);
  for (int i = 0; i < rows; ++i) {
    uint32_t s0 = 0, s1 = 0;
    for (int j = 0; j < cols; ++j) {
      const uint32_t* sj = x + j * kN;
      const uint32_t* aij = mat + (static_cast<size_t>(i) * cols + j) * kN;
      uint32_t c0, c1;
      base_case(sj[2 * t], sj[2 * t + 1], __ldg(aij + 2 * t),
                __ldg(aij + 2 * t + 1), g, q, q_prime, c0, c1);
      s0 = add_mod(s0, c0, q);
      s1 = add_mod(s1, c1, q);
    }
    put_slot(acc, s0, s1, scale, scale_shoup, q);
    __syncthreads();
    inverse(acc, itw, q);
    store_row(out, static_cast<size_t>(i) * batch + blockIdx.x, acc);
    __syncthreads();  // before the next row overwrites acc
  }
}

Table table(const void* w, const void* w_shoup) {
  return Table{static_cast<const uint32_t*>(w),
               static_cast<const uint32_t*>(w_shoup)};
}

const uint32_t* words(const void* p) { return static_cast<const uint32_t*>(p); }

// Whether a row pointer or the gamma table is not 16-byte aligned (the
// dot's vectors) or a table pointer not 8-byte aligned (its pairs).
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

template <bool kCached>
int launch_product(const void* a, const void* b, void* out, const void* tw,
                   const void* tw_shoup, const void* itw, const void* itw_shoup,
                   const void* gamma, int batch, uint32_t q, uint32_t q_prime,
                   uint32_t scale, uint32_t scale_shoup, void* stream) {
  if (batch < 1) {
    return cudaErrorInvalidValue;
  }
  product_kernel<kCached><<<batch, kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      words(a), words(b), static_cast<uint32_t*>(out), table(tw, tw_shoup),
      table(itw, itw_shoup), words(gamma), q, q_prime, scale, scale_shoup);
  return cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, which must belong to the current
// device, and returns the CUDA error code (0 on success).  A launch the
// device refuses (a bad shape, a misaligned pointer) never runs, so the
// caller must check the code.  kyber_dot reads its tables (w, w') in the
// per-pass layout of its radix-16 core; the others the flat tables.

extern "C" int kyber_product(const void* a, const void* b, void* out,
                             const void* tw, const void* tw_shoup,
                             const void* itw, const void* itw_shoup,
                             const void* gamma, int batch, uint32_t q,
                             uint32_t q_prime, uint32_t scale,
                             uint32_t scale_shoup, void* stream) {
  return launch_product<false>(a, b, out, tw, tw_shoup, itw, itw_shoup, gamma,
                               batch, q, q_prime, scale, scale_shoup, stream);
}

extern "C" int kyber_cached(const void* a, const void* spectrum, void* out,
                            const void* tw, const void* tw_shoup,
                            const void* itw, const void* itw_shoup,
                            const void* gamma, int batch, uint32_t q,
                            uint32_t q_prime, uint32_t scale,
                            uint32_t scale_shoup, void* stream) {
  return launch_product<true>(a, spectrum, out, tw, tw_shoup, itw, itw_shoup,
                              gamma, batch, q, q_prime, scale, scale_shoup,
                              stream);
}

extern "C" int kyber_forward(const void* in, void* out, const void* tw,
                             const void* tw_shoup, int batch, uint32_t q,
                             uint32_t scale, uint32_t scale_shoup, void* stream) {
  if (batch < 1) {
    return cudaErrorInvalidValue;
  }
  forward_kernel<<<batch, kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      words(in), static_cast<uint32_t*>(out), table(tw, tw_shoup), q, scale,
      scale_shoup);
  return cudaGetLastError();
}

extern "C" int kyber_inverse(const void* in, void* out, const void* itw,
                             const void* itw_shoup, int batch, uint32_t q,
                             uint32_t scale, uint32_t scale_shoup, void* stream) {
  if (batch < 1) {
    return cudaErrorInvalidValue;
  }
  inverse_kernel<<<batch, kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      words(in), static_cast<uint32_t*>(out), table(itw, itw_shoup), q, scale,
      scale_shoup);
  return cudaGetLastError();
}

// out = INTT(sum_k NTT(a_k) o NTT(b_k)) * scale for (terms, batch, 256)
// stacks (b spectra times 2^32 where `cached` is nonzero), 1 <= terms <= 8,
// on the radix-16 core with the per-pass tables; rows and gamma 16-byte
// aligned, tables 8-byte aligned.
extern "C" int kyber_dot(const void* a, const void* b, void* out, const void* tw,
                         const void* tw_shoup, const void* itw,
                         const void* itw_shoup, const void* gamma, int terms,
                         int batch, uint32_t q, uint32_t q_prime, uint32_t scale,
                         uint32_t scale_shoup, int cached, void* stream) {
  if (batch < 1 || terms < 1 || terms > kMaxTerms) {
    return cudaErrorInvalidValue;
  }
  if (misaligned({a, b, out, gamma}, {tw, tw_shoup, itw, itw_shoup})) {
    return cudaErrorMisalignedAddress;
  }
  auto kernel = cached ? dot_kernel<true> : dot_kernel<false>;
  kernel<<<(batch + kTile - 1) / kTile, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words(a), words(b), static_cast<uint32_t*>(out), table(tw, tw_shoup),
      table(itw, itw_shoup), words(gamma), terms, batch, q, q_prime, scale, scale_shoup);
  return cudaGetLastError();
}

extern "C" int kyber_matvec(const void* s, const void* mat, void* out,
                            const void* tw, const void* tw_shoup,
                            const void* itw, const void* itw_shoup,
                            const void* gamma, int rows, int cols, int batch,
                            uint32_t q, uint32_t q_prime, uint32_t scale,
                            uint32_t scale_shoup, void* stream) {
  if (batch < 1 || rows < 1 || rows > kMaxTerms || cols < 1 || cols > kMaxTerms) {
    return cudaErrorInvalidValue;
  }
  matvec_kernel<<<batch, kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      words(s), words(mat), static_cast<uint32_t*>(out), table(tw, tw_shoup),
      table(itw, itw_shoup), words(gamma), rows, cols, batch, q, q_prime, scale,
      scale_shoup);
  return cudaGetLastError();
}

extern "C" const char* kyber_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

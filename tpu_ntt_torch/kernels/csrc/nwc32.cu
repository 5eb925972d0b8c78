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
// Two cores.  nwc32_forward runs the radix-16 core ("The radix-16 core"
// below): nwc64.cu's radix-8 schedule on 32-bit lanes, four stages a pass.
// The other five run the first core, correct first and simple (the shape of
// nwc64.cu's), until they move onto the radix-16 one; they read the
// spectra in the bit-reversed order both forwards write:
// * One thread block per row (per output row for the dot and the matvec).
//   The rows a block works on live in dynamic shared memory: 4n bytes each,
//   64 KiB at n = 16384, so device memory sees each operand and each result
//   once.  n / 4 threads (at most 1024) run two butterflies each up to
//   n = 4096.
// * A merged-psi Cooley-Tukey forward (natural in, bit-reversed out) and a
//   Gentleman-Sande inverse (bit-reversed in, natural out), __syncthreads
//   between stages.  The stage with m groups reads entry m + g of a flat
//   length-n table for group g, beside its Shoup companion
//   w' = floor(w * 2^32 / q); a constant multiply is Shoup with __umulhi.
//   The cyclic ops take the tables with omega powers (ntt.py, "bitrev").
// * The slot product is Montgomery-32 (one REDC): a*b*2^-32.  Its 2^-32 and
//   the inverse's n^-1 are cancelled by one Shoup multiply with the scale the
//   wrapper passes (n^-1 * 2^32 mod q for two fresh spectra; n^-1 against a
//   cached spectrum, which holds its 2^32 already).
// * Every value stays canonical in [0, q), also through the dot's and the
//   matvec's accumulation (one conditional subtract after each add).
// * The matvec keeps the l + k transforms of mxu.py:544-551 without holding
//   l + 1 rows in shared memory (576 KiB at n = 16384, l = 8): the wrapper
//   transforms the l * B rows of s with nwc32_forward (the radix-16 core)
//   into a scratch tensor, and nwc32_matvec accumulates sum_j REDC(S_j *
//   A_ij) from device memory and runs one inverse per output row.
//
// What bounds it on this card.  Per transform of one row, n/2 log2 n
// butterflies, each one Shoup multiply: a*w and hi(a*w'), two 32-bit
// multiplies, since the product by q = 8380417 = 2^23 - 2^13 + 1 is shifts
// and adds.  At P24_4096, B = 2048, the product's 3 transforms and slot pass
// need 3.4e8 IMADs, 0.021 ms at 132 SMs x 64 IMADs a clock x 1.98 GHz,
// against 101 MB of operands and result, 0.030 ms at 3.35 TB/s: device
// memory bounds it.  The design keeps every intermediate in shared memory,
// so device memory moves nothing twice.  What holds the first core back is
// neither: a butterfly is about 30 instructions (index arithmetic, shared
// loads and stores, twiddle loads, conditional subtracts) between 12
// barriers a transform, and on an H100 SXM at 700 W the product takes about
// 8x its bound (PERF.md).  The radix-16 core's header says what it does
// about each; a forward alone moves 67 MB at P24_4096, B = 2048 (0.020 ms)
// and needs 1.0e8 IMADs (0.006 ms): device memory bounds it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

// Cooley-Tukey forward, in place, on `rows` rows of n values spaced n apart:
// stage s has m = 2^s groups of 2t values, t = n >> (s + 1); butterfly j
// pairs u = 2t * (j / t) + j % t with u + t.
__device__ void forward(uint32_t* x, int rows, int log_n, Table tw, uint32_t q) {
  const int n = 1 << log_n;
  for (int s = 0; s < log_n; ++s) {
    const int lt = log_n - 1 - s;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
      const int g = j >> lt;
      const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
      const int v = u + (1 << lt);
      const uint32_t w = __ldg(tw.w + (1 << s) + g);
      const uint32_t ws = __ldg(tw.w_shoup + (1 << s) + g);
      for (int r = 0; r < rows; ++r) {
        uint32_t* y = x + r * n;
        const uint32_t yu = y[u], yv = shoup_mul(y[v], w, ws, q);
        y[u] = add_mod(yu, yv, q);
        y[v] = sub_mod(yu, yv, q);
      }
    }
    __syncthreads();
  }
}

// Gentleman-Sande inverse of one row, in place: the forward's stages in
// reverse order.  No n^-1: the caller's scale carries it.
__device__ void inverse(uint32_t* x, int log_n, Table itw, uint32_t q) {
  const int n = 1 << log_n;
  for (int s = log_n - 1; s >= 0; --s) {
    const int lt = log_n - 1 - s;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
      const int g = j >> lt;
      const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
      const int v = u + (1 << lt);
      const uint32_t w = __ldg(itw.w + (1 << s) + g);
      const uint32_t ws = __ldg(itw.w_shoup + (1 << s) + g);
      const uint32_t xu = x[u], xv = x[v];
      x[u] = add_mod(xu, xv, q);
      x[v] = shoup_mul(sub_mod(xu, xv, q), w, ws, q);
    }
    __syncthreads();
  }
}

// The product of a row of a with a row of b: b is coefficients, or with
// kCached a spectrum that is used as it is.  dot_kernel at one term computes
// the same; this body skips its accumulator row, zeroing pass and separate
// scale pass, and is 3.5 % faster for the product, 4.7 % for the cached one
// (P24_4096, B = 2048, H100 SXM at 700 W; PERF.md).
template <bool kCached>
__global__ void product_kernel(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ out, Table tw, Table itw,
                               int log_n, uint32_t q, uint32_t q_prime,
                               uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << log_n;
  uint32_t* x = smem;
  uint32_t* y = smem + n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = a[row + i];
    y[i] = b[row + i];
  }
  __syncthreads();
  forward(x, kCached ? 1 : 2, log_n, tw, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = shoup_mul(mont_mul(x[i], y[i], q, q_prime), scale, scale_shoup, q);
  }
  __syncthreads();
  inverse(x, log_n, itw, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = x[i];
  }
}

// The inverse of one row, then times `scale` (n^-1).
__global__ void inverse_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, Table itw, int log_n,
                               uint32_t q, uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t x[];
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = in[row + i];
  }
  __syncthreads();
  inverse(x, log_n, itw, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = shoup_mul(x[i], scale, scale_shoup, q);
  }
}

// out[r] = INTT(sum_k NTT(a[k, r]) . NTT(b[k, r])) for (terms, batch, n)
// stacks a and b; with `cached`, b holds spectra.  The sum stays in shared
// memory, one inverse per output row.
__global__ void dot_kernel(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           uint32_t* __restrict__ out, Table tw, Table itw,
                           int terms, int batch, int log_n, uint32_t q,
                           uint32_t q_prime, uint32_t scale,
                           uint32_t scale_shoup, int cached) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << log_n;
  uint32_t* acc = smem;
  uint32_t* x = smem + n;
  uint32_t* y = smem + 2 * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    acc[i] = 0;
  }
  for (int k = 0; k < terms; ++k) {
    const size_t row = (static_cast<size_t>(k) * batch + blockIdx.x) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      x[i] = a[row + i];
      y[i] = b[row + i];
    }
    __syncthreads();
    forward(x, cached ? 1 : 2, log_n, tw, q);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      acc[i] = add_mod(acc[i], mont_mul(x[i], y[i], q, q_prime), q);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    acc[i] = shoup_mul(acc[i], scale, scale_shoup, q);
  }
  __syncthreads();
  inverse(acc, log_n, itw, q);
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = acc[i];
  }
}

// out[i, r] = INTT(sum_j S[j, r] . A[i, j]) for block (r, i): S is the
// (cols, batch, n) stack of plain spectra of s, A the (rows, cols, n) cached
// spectra (times 2^32), so each REDC gives the plain product.
__global__ void matvec_kernel(const uint32_t* __restrict__ spectra,
                              const uint32_t* __restrict__ mat,
                              uint32_t* __restrict__ out, Table itw, int cols,
                              int batch, int log_n, uint32_t q, uint32_t q_prime,
                              uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t x[];
  const int n = 1 << log_n;
  const size_t r = blockIdx.x, i = blockIdx.y;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    uint32_t acc = 0;
    for (int j = 0; j < cols; ++j) {
      const uint32_t s = spectra[(j * batch + r) * n + e];
      const uint32_t m = __ldg(mat + (i * cols + j) * n + e);
      acc = add_mod(acc, mont_mul(s, m, q, q_prime), q);
    }
    x[e] = shoup_mul(acc, scale, scale_shoup, q);
  }
  __syncthreads();
  inverse(x, log_n, itw, q);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    out[(i * batch + r) * n + e] = x[e];
  }
}

// ---------------------------------------------------------------------------
// The radix-16 core: nwc32_forward.  The schedule of nwc64.cu's radix-8
// core on 32-bit lanes, the same integers as the first core's forward (a
// canonical result is unique) in the same bit-reversed order, by another
// schedule:
// * Passes in registers.  A thread holds kWords = 16 words, 16 registers as
//   nwc64.cu's eight 64-bit ones, and a pass runs four stages on them with
//   no barrier between them: stage s + d of a radix-16 group pairs its
//   registers k and k + 2^(3 - d).  log n = 12 takes three passes and two
//   barriers instead of twelve of each.  The first pass takes log n mod 4
//   stages, 4 if that is 0 (then each thread holds 16 / 2^stages groups);
//   it is the pass at stage 0, where every group has the same twiddles.
//   Shapes, pass stages and table offsets are template constants (kLogN):
//   one kernel a log n from 8 to 14, every loop unrolled.  Sixteen words a
//   thread keep n = 16384 at 1024 threads a row, where eight would need
//   2048: every n of the window runs the same core.
// * Device memory once.  The first pass loads straight from device memory
//   (register k of group j is element k * n / 2^stages + j: a warp's 4-byte
//   loads cover 128 contiguous bytes of a row), the last stores straight to
//   it, the correction and the scale folded into its registers (a thread's
//   sixteen words are adjacent there: four 16-byte stores).  Shared memory
//   is only the exchange between passes: each pass reads and then writes the
//   same sixteen words of each thread, so one barrier a pass suffices.
// * No swizzle.  Word i of row g of the tile lives at g * n + i.  The
//   first passes' 4-byte accesses of a warp conflict at most two ways, and
//   in the last pass a thread's sixteen words are adjacent (16t ...
//   16t + 15), which the compiler moves as 16-byte vectors
//   (tests/test_torch_nwc32_radix.py counts the conflicts at every n from
//   256 to 16384).  nwc64.cu's kind of swizzle, a ^ ((a >> 4) & 31) here,
//   conflict-free on 4-byte words but sixteen scalar accesses a pass, ran
//   0.1 to 8 % slower at every shape timed (tools/nwc32_variants.py,
//   PERF.md): the kernel waits on device memory, not on shared memory.
// * Lazy butterflies (Harvey).  q < 2^30 keeps 4q < 2^32, so a lane is a
//   uint32_t in [0, 4q): the CT butterfly brings x under 2q with one
//   compare, leaves the Shoup product (a * w - hi(a * w') q, __umulhi) in
//   [0, 2q), and returns x + v and x + 2q - v; the first stage takes the
//   words of device memory, below q, as they are.  One correction to
//   [0, q) at the store: two compares at scale 1, else one lazy Shoup
//   product of the lane as it is and one compare.
// * Twiddles a pass at a time, host-built (mxu64.pass_table with four
//   stages a pass): pass (s, R) holds 2^(R - 1) columns of 8-byte pairs of
//   twiddles for each of its 2^s groups, w and w' in two tables of the same
//   layout: column 0 (stage s, then a pad word), column 1 (stage s + 1's
//   two), columns 2 and 3 (stage s + 2's four), columns 4 to 7 (stage
//   s + 3's eight).  A stage loads what it uses, one 8-byte vector per two
//   twiddles; a warp's loads are 256 contiguous bytes (consecutive groups,
//   in the last pass) or one broadcast word.
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
// kFresh: the first stage of the first pass (ct).
template <int kS, int kR, int kD, bool kFresh>
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
      ct<kFresh>(x[r], x[r + kSpan], w[e], ws[e], q);
    }
  }
}

// Pass (kS, kR): its stages in order.
template <int kS, int kR, bool kFresh = false>
__device__ __forceinline__ void run_pass(uint32_t (&x)[kWords], const uint32_t* tw,
                                         const uint32_t* tws, int hi, uint32_t q) {
  stage<kS, kR, 0, kFresh>(x, tw, tws, hi, q);
  if constexpr (kR > 1) stage<kS, kR, 1, false>(x, tw, tws, hi, q);
  if constexpr (kR > 2) stage<kS, kR, 2, false>(x, tw, tws, hi, q);
  if constexpr (kR > 3) stage<kS, kR, 3, false>(x, tw, tws, hi, q);
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
    run_pass<kS, kRadix>(x, pt.w + kOff, pt.w_shoup + kOff, group<kLogN, kS>(t), q);
    forward_passes<kLogN, kP + 1>(x, smem, pt, g, t, q);
  }
}

// out = NTT(in) * scale (scale 1 skipped) on `rows` rows: the first pass's
// words from device memory ([0, q)), the passes, the lanes of [0, 4q) made
// canonical at the store of spectrum words 16t ... 16t + 15 (four 16-byte
// vectors).  Tables: the per-pass layout of mxu64.pass_table, four stages
// a pass.
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN), 1024 / block_threads(kLogN))
    radix_forward_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, Table pt,
                         int rows, uint32_t q, uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN);
  constexpr int kR0 = first_stages(kLogN);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  uint32_t x[kWords];
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, q)
    x[r] = live ? in[at + element<kLogN, 0, kR0>(t, r)] : 0;
  }
  run_pass<0, kR0, true>(x, pt.w, pt.w_shoup, 0, q);
  forward_passes<kLogN, 1>(x, smem, pt, g, t, q);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // [0, 4q) -> [0, q)
    x[r] = scale == 1 ? csub(csub(x[r], 2 * q), q)
                      : csub(shoup_lazy(x[r], scale, scale_shoup, q), q);
  }
  if (live) {  // the last pass holds elements 16t ... 16t + 15
    uint4* v = reinterpret_cast<uint4*>(out + at + kWords * t);
#pragma unroll
    for (int m = 0; m < kWords / 4; ++m) {
      v[m] = make_uint4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
    }
  }
}

int threads_for(int log_n) {
  const int quarter = 1 << (log_n - 2);
  return quarter < 1024 ? quarter : 1024;
}

bool bad_shape(int batch, int log_n) {
  return batch < 1 || log_n < 8 || log_n > 14;
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

template <bool kCached>
int launch_product(const void* a, const void* b, void* out, const void* tw,
                   const void* tw_shoup, const void* itw, const void* itw_shoup,
                   int batch, int log_n, uint32_t q, uint32_t q_prime,
                   uint32_t scale, uint32_t scale_shoup, void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(product_kernel<kCached>, 2 * n);
  if (err != cudaSuccess) {
    return err;
  }
  product_kernel<kCached><<<batch, threads_for(log_n), 2 * n * sizeof(uint32_t),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), table(tw, tw_shoup), table(itw, itw_shoup),
      log_n, q, q_prime, scale, scale_shoup);
  return cudaGetLastError();
}

template <int kLogN>
int launch_forward(const void* in, void* out, const void* tw, const void* tw_shoup, int batch,
                   uint32_t q, uint32_t scale, uint32_t scale_shoup, cudaStream_t stream) {
  constexpr int kTile = tile(kLogN);
  auto kernel = radix_forward_kernel<kLogN>;
  const cudaError_t err = allow_smem(kernel, kTile << kLogN);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<(batch + kTile - 1) / kTile, block_threads(kLogN),
           (kTile << kLogN) * sizeof(uint32_t), stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), table(tw, tw_shoup),
      batch, q, scale, scale_shoup);
  return cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, which must belong to the current
// device, and returns the CUDA error code (0 on success).  A launch the
// device refuses (too much shared memory, a bad shape) never runs, so the
// caller must check the code.

extern "C" int nwc32_product(const void* a, const void* b, void* out,
                             const void* tw, const void* tw_shoup,
                             const void* itw, const void* itw_shoup, int batch,
                             int log_n, uint32_t q, uint32_t q_prime,
                             uint32_t scale, uint32_t scale_shoup, void* stream) {
  return launch_product<false>(a, b, out, tw, tw_shoup, itw, itw_shoup, batch,
                               log_n, q, q_prime, scale, scale_shoup, stream);
}

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
// it is 1; the tables (w, w') those of mxu64.pass_table at four stages a
// pass; out 16-byte aligned, the tables 8-byte aligned.
extern "C" int nwc32_forward(const void* in, void* out, const void* tw,
                             const void* tw_shoup, int batch, int log_n,
                             uint32_t q, uint32_t scale, uint32_t scale_shoup,
                             void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(tw) % 8 ||
      reinterpret_cast<uintptr_t>(tw_shoup) % 8) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define NWC32_LOG_N(L) \
  case L:              \
    return launch_forward<L>(in, out, tw, tw_shoup, batch, q, scale, scale_shoup, s);
    NWC32_LOG_N(8) NWC32_LOG_N(9) NWC32_LOG_N(10) NWC32_LOG_N(11) NWC32_LOG_N(12)
    NWC32_LOG_N(13) NWC32_LOG_N(14)
#undef NWC32_LOG_N
  }
  return cudaErrorInvalidValue;
}

extern "C" int nwc32_inverse(const void* in, void* out, const void* itw,
                             const void* itw_shoup, int batch, int log_n,
                             uint32_t q, uint32_t scale, uint32_t scale_shoup,
                             void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(inverse_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  inverse_kernel<<<batch, threads_for(log_n), n * sizeof(uint32_t),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      table(itw, itw_shoup), log_n, q, scale, scale_shoup);
  return cudaGetLastError();
}

extern "C" int nwc32_dot(const void* a, const void* b, void* out,
                         const void* tw, const void* tw_shoup, const void* itw,
                         const void* itw_shoup, int terms, int batch, int log_n,
                         uint32_t q, uint32_t q_prime, uint32_t scale,
                         uint32_t scale_shoup, int cached, void* stream) {
  if (bad_shape(batch, log_n) || terms < 1 || terms > 8) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(dot_kernel, 3 * n);
  if (err != cudaSuccess) {
    return err;
  }
  dot_kernel<<<batch, threads_for(log_n), 3 * n * sizeof(uint32_t),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), table(tw, tw_shoup), table(itw, itw_shoup),
      terms, batch, log_n, q, q_prime, scale, scale_shoup, cached);
  return cudaGetLastError();
}

extern "C" int nwc32_matvec(const void* spectra, const void* mat, void* out,
                            const void* itw, const void* itw_shoup, int rows,
                            int cols, int batch, int log_n, uint32_t q,
                            uint32_t q_prime, uint32_t scale,
                            uint32_t scale_shoup, void* stream) {
  if (bad_shape(batch, log_n) || rows < 1 || rows > 8 || cols < 1 || cols > 8) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(matvec_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  matvec_kernel<<<dim3(batch, rows), threads_for(log_n), n * sizeof(uint32_t),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(spectra), static_cast<const uint32_t*>(mat),
      static_cast<uint32_t*>(out), table(itw, itw_shoup), cols, batch, log_n, q,
      q_prime, scale, scale_shoup);
  return cudaGetLastError();
}

extern "C" const char* nwc32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// Design, correct first and simple (the shape of nwc32.cu at n = 256):
// * One block of 128 threads per row (per output row for the dot and the
//   matvec); its rows live in static shared memory, 1 KiB each, so device
//   memory sees each operand and each result once.
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
// * Every value stays canonical in [0, q), also through the dot's and the
//   matvec's sums, which each thread keeps for its slot in registers.
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
// it back is neither: about 30 instructions a butterfly between 7 barriers a
// transform, one butterfly per thread between barriers.  Several rows per
// block and several stages per barrier in registers are the later work
// (PERF.md).

#include <cstdint>

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

// out[r] = INTT(sum_k NTT(a[k, r]) o NTT(b[k, r])) for (terms, batch, 256)
// stacks a and b; with `cached`, b holds spectra.  Each thread sums its slot
// in registers; one inverse per output row.
__global__ void __launch_bounds__(kSlots)
    dot_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, Table tw, Table itw,
               const uint32_t* __restrict__ gamma, int terms, int batch,
               uint32_t q, uint32_t q_prime, uint32_t scale,
               uint32_t scale_shoup, int cached) {
  __shared__ uint32_t x[2 * kN];
  const int t = threadIdx.x;
  uint32_t* y = x + kN;
  const uint32_t g = __ldg(gamma + t);
  uint32_t s0 = 0, s1 = 0;
  for (int k = 0; k < terms; ++k) {
    const size_t row = static_cast<size_t>(k) * batch + blockIdx.x;
    load_row(x, a, row);
    load_row(y, b, row);
    __syncthreads();
    forward(x, cached ? 1 : 2, tw, q);
    uint32_t c0, c1;
    base_case(x[2 * t], x[2 * t + 1], y[2 * t], y[2 * t + 1], g, q, q_prime, c0,
              c1);
    s0 = add_mod(s0, c0, q);
    s1 = add_mod(s1, c1, q);
    __syncthreads();  // before the next term overwrites x and y
  }
  put_slot(x, s0, s1, scale, scale_shoup, q);
  __syncthreads();
  inverse(x, itw, q);
  store_row(out, blockIdx.x, x);
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
// device refuses (a bad shape) never runs, so the caller must check the code.

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

extern "C" int kyber_dot(const void* a, const void* b, void* out, const void* tw,
                         const void* tw_shoup, const void* itw,
                         const void* itw_shoup, const void* gamma, int terms,
                         int batch, uint32_t q, uint32_t q_prime, uint32_t scale,
                         uint32_t scale_shoup, int cached, void* stream) {
  if (batch < 1 || terms < 1 || terms > kMaxTerms) {
    return cudaErrorInvalidValue;
  }
  dot_kernel<<<batch, kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      words(a), words(b), static_cast<uint32_t*>(out), table(tw, tw_shoup),
      table(itw, itw_shoup), words(gamma), terms, batch, q, q_prime, scale,
      scale_shoup, cached);
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

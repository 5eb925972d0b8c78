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
// Design, correct first and simple (the shape of nwc64.cu):
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
//   transforms the l * B rows of s with nwc32_forward into a scratch tensor,
//   and nwc32_matvec accumulates sum_j REDC(S_j * A_ij) from device memory
//   and runs one inverse per output row.
//
// What bounds it on this card.  Per transform of one row, n/2 log2 n
// butterflies, each one Shoup multiply: a*w and hi(a*w'), two 32-bit
// multiplies, since the product by q = 8380417 = 2^23 - 2^13 + 1 is shifts
// and adds.  At P24_4096, B = 2048, the product's 3 transforms and slot pass
// need 3.4e8 IMADs, 0.021 ms at 132 SMs x 64 IMADs a clock x 1.98 GHz,
// against 101 MB of operands and result, 0.030 ms at 3.35 TB/s: device
// memory bounds it.  The design keeps every intermediate in shared memory,
// so device memory moves nothing twice.  What holds it back is neither: a
// butterfly is about 30 instructions (index arithmetic, shared loads and
// stores, twiddle loads, conditional subtracts) between 12 barriers a
// transform, and on an H100 SXM at 700 W the product takes about 8x its
// bound (PERF.md).  Several stages per barrier in registers, lazy reduction
// and several rows per block are the later work.

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

// The forward of one row, times `scale` unless it is 1.
__global__ void forward_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, Table tw, int log_n,
                               uint32_t q, uint32_t scale, uint32_t scale_shoup) {
  extern __shared__ uint32_t x[];
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = in[row + i];
  }
  __syncthreads();
  forward(x, 1, log_n, tw, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = scale == 1 ? x[i] : shoup_mul(x[i], scale, scale_shoup, q);
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

extern "C" int nwc32_forward(const void* in, void* out, const void* tw,
                             const void* tw_shoup, int batch, int log_n,
                             uint32_t q, uint32_t scale, uint32_t scale_shoup,
                             void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(forward_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  forward_kernel<<<batch, threads_for(log_n), n * sizeof(uint32_t),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      table(tw, tw_shoup), log_n, q, scale, scale_shoup);
  return cudaGetLastError();
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

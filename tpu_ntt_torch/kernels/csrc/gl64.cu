// gl64.cu: the NTT kernels of the Goldilocks field, q = 2^64 - 2^32 + 1,
// hand-written for Hopper (sm_90a).
//
// Replaces kernel K2, tpu_ntt/kernels/gl64.py:59 (GoldilocksPlan64), which
// runs every body of kernel K1 at the Goldilocks prime through K1's three
// pallas_calls (tpu_ntt/kernels/mxu64.py:2027, :2272, :2348):
//   gl64_product  _nwc_kernel (mxu64.py:1442) through MxuPlan64._call
//                 (:1981): the negacyclic product and, with cyclic tables,
//                 _cyclic_kernel (:1474, cyclic_poly_mult)
//   gl64_cached   _nwc_cached_kernel (:1691), the same launcher
//   gl64_forward  _nwc_fwd_kernel (:1715: nwc_ntt_fwd), _fwd_kernel (:1544:
//                 ntt_fwd, with cyclic tables) and _nwc_spec_kernel (:1675:
//                 nwc_spectrum, which in the plain domain is the forward)
//   gl64_inverse  _nwc_inv_kernel (:1733: nwc_ntt_inv) and _inv_kernel
//                 (:1559: ntt_inv)
//   gl64_dot      _make_dot_kernel (:1599) through _dot_call (:2238)
//   gl64_matvec   _make_matvec_kernel (:1639) through nwc_matvec_cached
//                 (:2305), after gl64_forward has transformed s
// and, as the row pass of the four-step that serves 8192 < n <= 2^20
// (tpu_ntt_torch/sharded.py, where gl64_forward and gl64_inverse run the
// column pass; JAX runs GoldilocksPlan64's split bodies at 16384 and 32768
// and its kernel four-step with XLA mids above), K1a's large-n bodies at
// the Goldilocks q, the counterparts of nwc64.cu's nwc64_*_scaled:
//   gl64_cyclic_scaled   _cyclic_scaled_kernel (:1501): post . INTT(NTT(pre
//                 . a) o NTT(pre . b)), row r scaled by table row r % period;
//                 with the column pass, the split-radix products
//                 _nwc_kernel_split{,2,3,4,5} (:1409, :1378, :1217, :1348,
//                 :1318)
//   gl64_forward_scaled, gl64_inverse_scaled  its halves: with the column
//                 pass, _make_nwc_{fwd,inv,spec}_split_kernel (:1877,
//                 :1897, :1949)
//   gl64_cached_scaled   against the rows of a cached spectrum:
//                 _make_nwc_cached_split_kernel (:1918)
//   gl64_dot_scaled, gl64_matvec_scaled  the row passes of the dot (K1b,
//                 :1599) and the matvec (K1c, :1639)
// Residues are uint64 in [0, q), (B, n) rows, natural order (the port's
// torch.int64 tensors hold the same bytes: a residue >= 2^63 is a negative
// int64 there and an ordinary uint64_t here); a spectrum is in bit-reversed
// order.  Each function computes what tpu_ntt_torch.kernels
// GoldilocksPlan64's plain version of it computes, bit for bit.  The TPU's
// nine balanced int8 digits, carry-save lanes and lazy window exist only
// because Mosaic has no 64-bit integers (gl64.py:1-40); none is carried
// over.  32 <= n <= 8192 (the public window is 256 <= n <= 8192; below
// it, the four-step's sub-sizes).
//
// Design: nwc64.cu's, in a file of its own.  The network code is a copy of
// nwc64.cu's rather than a header shared by both, so nwc64.cu is not
// changed and its functions and times stay as they were; only the
// arithmetic differs:
// * One thread block per row (per output row for the dot and the matvec),
//   the rows in dynamic shared memory, 8n bytes each: two for the product,
//   three for the dot (192 KiB at n = 8192, under the 227 KB a block may
//   have).  n / 8 threads (at most 1024), four butterflies each, from
//   n = 256 on; below, a warp, or n / 2 (the four-step's sub-sizes).
// * A merged-psi Cooley-Tukey forward (natural in, bit-reversed out) and a
//   Gentleman-Sande inverse (bit-reversed in, natural out), __syncthreads
//   between stages; the stage with m groups reads entry m + g of a flat
//   length-n table of plain twiddles.
// * Every product is gl_mul: the 128-bit product from a * b and
//   __umul64hi, reduced by the phi-fold (2^96 = -1, 2^64 = 2^32 - 1 mod q:
//   shifts, adds and one conditional subtract, no multiply).  Shoup's form
//   needs q < 2^63, so twiddles and scales are plain values and the cached
//   spectra are in the plain domain (gl64.py:75-77): a slot product needs
//   no domain scale, and the n^-1 of the inverse is one gl_mul by the scale
//   the wrapper passes.
// * A sum of two residues can pass 2^64 here (nwc64.cu's add_mod assumes it
//   cannot): gl_add takes the carry as 2^64 = q + (2^32 - 1).
// * Every value stays canonical in [0, q), also through the dot's and the
//   matvec's accumulation.
// * The four-step's row pass (the *_scaled functions) is product_kernel,
//   forward_kernel, inverse_kernel, dot_kernel and matvec_kernel with one
//   gl_mul more, by a table row, at entry and/or exit (never on a cached
//   spectrum, which the row forward has already scaled).  Row r of a
//   launch reads row r % period of a (period, n) table of plain values (no
//   Shoup companion, as for the twiddles): a batch of B polynomials of n1
//   rows each passes period = n1.  The spectra stay plain, so `cacheable`
//   changes nothing here, where nwc64.cu multiplies by 2^64 mod q.
//
// What bounds it on this card: the multiplies, as in nwc64.cu.  Hopper
// builds a 64 x 64 -> 128 product from about eight 32-bit IMADs (the
// phi-fold adds none), against about twelve for a Shoup-64 or Montgomery-64
// product, so a Goldilocks butterfly has two thirds of a 60-bit one's
// multiplies; at goldilocks_4096, B = 2048, the product needs 1.3e9 IMADs,
// 0.08 ms at 132 SMs x 64 a clock x 1.98 GHz, against 201 MB of operands
// and result, 0.06 ms at 3.35 TB/s.  What holds it back is what holds
// nwc64.cu back (PERF.md): instruction issue and latency between the
// __syncthreads of every stage.  Several stages per barrier in registers
// and several rows per block at small n are the later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kQ = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod q = 2^32 - 1

// (a + b) mod q: a carry out of 64 bits is 2^64 = q + eps, so the wrapped
// sum plus eps is a + b - q, already below q.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  if (s < a) {
    return s + kEps;
  }
  return s >= kQ ? s - kQ : s;
}

// (a - b) mod q: a borrow wraps by 2^64 = q + eps, so take eps off.
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a >= b ? d : d - kEps;
}

// (hi * 2^64 + lo) mod q by the phi-fold: hi = a * 2^32 + b gives
// lo - a + b * (2^32 - 1).
__device__ __forceinline__ uint64_t gl_reduce(uint64_t lo, uint64_t hi) {
  const uint64_t a = hi >> 32;
  const uint64_t b = hi & kEps;
  uint64_t t0 = lo - a;
  if (lo < a) {
    t0 -= kEps;  // the borrow's 2^64 is q + eps; t0 > eps here
  }
  const uint64_t t1 = (b << 32) - b;
  uint64_t t = t0 + t1;
  if (t < t0) {
    t += kEps;  // the carry's 2^64; it cannot carry again
  }
  return t >= kQ ? t - kQ : t;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce(a * b, __umul64hi(a, b));
}

// Cooley-Tukey forward, in place, on `rows` rows of n values spaced n apart:
// stage s has m = 2^s groups of 2t values, t = n >> (s + 1); butterfly j
// pairs u = 2t * (j / t) + j % t with u + t.
__device__ void forward(uint64_t* x, int rows, int log_n, const uint64_t* tw) {
  const int n = 1 << log_n;
  for (int s = 0; s < log_n; ++s) {
    const int lt = log_n - 1 - s;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
      const int g = j >> lt;
      const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
      const int v = u + (1 << lt);
      const uint64_t w = __ldg(tw + (1 << s) + g);
      for (int r = 0; r < rows; ++r) {
        uint64_t* y = x + r * n;
        const uint64_t yu = y[u], yv = gl_mul(y[v], w);
        y[u] = gl_add(yu, yv);
        y[v] = gl_sub(yu, yv);
      }
    }
    __syncthreads();
  }
}

// Gentleman-Sande inverse of one row, in place: the forward's stages in
// reverse order.  No n^-1: the caller's scale carries it.
__device__ void inverse(uint64_t* x, int log_n, const uint64_t* itw) {
  const int n = 1 << log_n;
  for (int s = log_n - 1; s >= 0; --s) {
    const int lt = log_n - 1 - s;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
      const int g = j >> lt;
      const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
      const int v = u + (1 << lt);
      const uint64_t w = __ldg(itw + (1 << s) + g);
      const uint64_t xu = x[u], xv = x[v];
      x[u] = gl_add(xu, xv);
      x[v] = gl_mul(gl_sub(xu, xv), w);
    }
    __syncthreads();
  }
}

// The product of a row of a with a row of b: b is coefficients, or with
// kCached a spectrum that is used as it is.
template <bool kCached>
__global__ void product_kernel(const uint64_t* __restrict__ a,
                               const uint64_t* __restrict__ b,
                               uint64_t* __restrict__ out,
                               const uint64_t* __restrict__ tw,
                               const uint64_t* __restrict__ itw, int log_n,
                               uint64_t scale) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  uint64_t* x = smem;
  uint64_t* y = smem + n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = a[row + i];
    y[i] = b[row + i];
  }
  __syncthreads();
  forward(x, kCached ? 1 : 2, log_n, tw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = gl_mul(gl_mul(x[i], y[i]), scale);
  }
  __syncthreads();
  inverse(x, log_n, itw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = x[i];
  }
}

// The forward of one row, times `scale` unless it is 1.
__global__ void forward_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out,
                               const uint64_t* __restrict__ tw, int log_n,
                               uint64_t scale) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = in[row + i];
  }
  __syncthreads();
  forward(x, 1, log_n, tw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = scale == 1 ? x[i] : gl_mul(x[i], scale);
  }
}

// The inverse of one row, then times `scale` (n^-1).
__global__ void inverse_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out,
                               const uint64_t* __restrict__ itw, int log_n,
                               uint64_t scale) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = in[row + i];
  }
  __syncthreads();
  inverse(x, log_n, itw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = gl_mul(x[i], scale);
  }
}

// out[r] = INTT(sum_k NTT(a[k, r]) . NTT(b[k, r])) for (terms, batch, n)
// stacks a and b; with `cached`, b holds spectra.  The sum stays in shared
// memory, one inverse per output row.
__global__ void dot_kernel(const uint64_t* __restrict__ a,
                           const uint64_t* __restrict__ b,
                           uint64_t* __restrict__ out,
                           const uint64_t* __restrict__ tw,
                           const uint64_t* __restrict__ itw, int terms,
                           int batch, int log_n, uint64_t scale, int cached) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  uint64_t* acc = smem;
  uint64_t* x = smem + n;
  uint64_t* y = smem + 2 * n;
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
    forward(x, cached ? 1 : 2, log_n, tw);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      acc[i] = gl_add(acc[i], gl_mul(x[i], y[i]));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    acc[i] = gl_mul(acc[i], scale);
  }
  __syncthreads();
  inverse(acc, log_n, itw);
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = acc[i];
  }
}

// out[i, r] = INTT(sum_j S[j, r] . A[i, j]) for block (r, i): S is the
// (cols, batch, n) stack of spectra of s, A the (rows, cols, n) cached
// spectra, both plain.
__global__ void matvec_kernel(const uint64_t* __restrict__ spectra,
                              const uint64_t* __restrict__ mat,
                              uint64_t* __restrict__ out,
                              const uint64_t* __restrict__ itw, int cols,
                              int batch, int log_n, uint64_t scale) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t r = blockIdx.x, i = blockIdx.y;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    uint64_t acc = 0;
    for (int j = 0; j < cols; ++j) {
      const uint64_t s = spectra[(j * batch + r) * n + e];
      const uint64_t m = __ldg(mat + (i * cols + j) * n + e);
      acc = gl_add(acc, gl_mul(s, m));
    }
    x[e] = gl_mul(acc, scale);
  }
  __syncthreads();
  inverse(x, log_n, itw);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    out[(i * batch + r) * n + e] = x[e];
  }
}

// The four-step's row pass: product_kernel with cyclic tables between an
// entry scale pre[r % period] and an exit scale post[r % period].  With
// kCached, b holds the rows of a cached spectrum, used as they are.
template <bool kCached>
__global__ void cyclic_scaled_kernel(const uint64_t* __restrict__ a,
                                     const uint64_t* __restrict__ b,
                                     uint64_t* __restrict__ out,
                                     const uint64_t* __restrict__ tw,
                                     const uint64_t* __restrict__ itw,
                                     const uint64_t* __restrict__ pre,
                                     const uint64_t* __restrict__ post,
                                     int period, int log_n, uint64_t scale) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  uint64_t* x = smem;
  uint64_t* y = smem + n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const size_t srow = static_cast<size_t>(blockIdx.x % period) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t w = __ldg(pre + srow + i);
    x[i] = gl_mul(a[row + i], w);
    y[i] = kCached ? b[row + i] : gl_mul(b[row + i], w);
  }
  __syncthreads();
  forward(x, kCached ? 1 : 2, log_n, tw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = gl_mul(gl_mul(x[i], y[i]), scale);
  }
  __syncthreads();
  inverse(x, log_n, itw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = gl_mul(x[i], __ldg(post + srow + i));
  }
}

// Its first half: times pre[r % period], the forward, times `scale` unless
// it is 1.
__global__ void forward_scaled_kernel(const uint64_t* __restrict__ in,
                                      uint64_t* __restrict__ out,
                                      const uint64_t* __restrict__ tw,
                                      const uint64_t* __restrict__ pre,
                                      int period, int log_n, uint64_t scale) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const size_t srow = static_cast<size_t>(blockIdx.x % period) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = gl_mul(in[row + i], __ldg(pre + srow + i));
  }
  __syncthreads();
  forward(x, 1, log_n, tw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = scale == 1 ? x[i] : gl_mul(x[i], scale);
  }
}

// Its second half: the inverse, times `scale` (n^-1), times post[r % period].
__global__ void inverse_scaled_kernel(const uint64_t* __restrict__ in,
                                      uint64_t* __restrict__ out,
                                      const uint64_t* __restrict__ itw,
                                      const uint64_t* __restrict__ post,
                                      int period, int log_n, uint64_t scale) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const size_t srow = static_cast<size_t>(blockIdx.x % period) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = in[row + i];
  }
  __syncthreads();
  inverse(x, log_n, itw);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = gl_mul(gl_mul(x[i], scale), __ldg(post + srow + i));
  }
}

// The four-step's row pass of the dot: dot_kernel with the entry scale
// pre[r % period] on every fresh operand and the exit scale post[r % period]
// after the one inverse.  a and b are (terms, batch, n) stacks of the column
// pass's rows; with `cached`, b holds cached spectrum rows, used as they are.
__global__ void dot_scaled_kernel(const uint64_t* __restrict__ a,
                                  const uint64_t* __restrict__ b,
                                  uint64_t* __restrict__ out,
                                  const uint64_t* __restrict__ tw,
                                  const uint64_t* __restrict__ itw,
                                  const uint64_t* __restrict__ pre,
                                  const uint64_t* __restrict__ post,
                                  int period, int terms, int batch, int log_n,
                                  uint64_t scale, int cached) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  uint64_t* acc = smem;
  uint64_t* x = smem + n;
  uint64_t* y = smem + 2 * n;
  const size_t srow = static_cast<size_t>(blockIdx.x % period) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    acc[i] = 0;
  }
  for (int k = 0; k < terms; ++k) {
    const size_t row = (static_cast<size_t>(k) * batch + blockIdx.x) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint64_t w = __ldg(pre + srow + i);
      x[i] = gl_mul(a[row + i], w);
      y[i] = cached ? b[row + i] : gl_mul(b[row + i], w);
    }
    __syncthreads();
    forward(x, cached ? 1 : 2, log_n, tw);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      acc[i] = gl_add(acc[i], gl_mul(x[i], y[i]));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    acc[i] = gl_mul(acc[i], scale);
  }
  __syncthreads();
  inverse(acc, log_n, itw);
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = gl_mul(acc[i], __ldg(post + srow + i));
  }
}

// The four-step's row pass of the matvec: matvec_kernel on the rows of the
// spectra of s (their row forward done by forward_scaled_kernel) against A's
// cached spectra, (rows, cols, period, n), row r reading A's row r % period;
// the exit scale post[r % period] after the inverse.
__global__ void matvec_scaled_kernel(const uint64_t* __restrict__ spectra,
                                     const uint64_t* __restrict__ mat,
                                     uint64_t* __restrict__ out,
                                     const uint64_t* __restrict__ itw,
                                     const uint64_t* __restrict__ post,
                                     int period, int cols, int batch,
                                     int log_n, uint64_t scale) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t r = blockIdx.x, i = blockIdx.y, p = blockIdx.x % period;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    uint64_t acc = 0;
    for (int j = 0; j < cols; ++j) {
      const uint64_t s = spectra[(static_cast<size_t>(j) * batch + r) * n + e];
      const uint64_t m = __ldg(mat + ((i * cols + j) * period + p) * n + e);
      acc = gl_add(acc, gl_mul(s, m));
    }
    x[e] = gl_mul(acc, scale);
  }
  __syncthreads();
  inverse(x, log_n, itw);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    out[(i * batch + r) * n + e] = gl_mul(x[e], __ldg(post + p * n + e));
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

const uint64_t* words(const void* p) { return static_cast<const uint64_t*>(p); }

template <bool kCached>
int launch_product(const void* a, const void* b, void* out, const void* tw,
                   const void* itw, int batch, int log_n, uint64_t scale,
                   void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(product_kernel<kCached>, 2 * n);
  if (err != cudaSuccess) {
    return err;
  }
  product_kernel<kCached><<<batch, threads_for(log_n), 2 * n * sizeof(uint64_t),
                            static_cast<cudaStream_t>(stream)>>>(
      words(a), words(b), static_cast<uint64_t*>(out), words(tw), words(itw),
      log_n, scale);
  return cudaGetLastError();
}

template <bool kCached>
int launch_cyclic_scaled(const void* a, const void* b, void* out,
                         const void* tw, const void* itw, const void* pre,
                         const void* post, int period, int batch, int log_n,
                         uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(cyclic_scaled_kernel<kCached>, 2 * n);
  if (err != cudaSuccess) {
    return err;
  }
  cyclic_scaled_kernel<kCached><<<batch, threads_for(log_n),
                                  2 * n * sizeof(uint64_t),
                                  static_cast<cudaStream_t>(stream)>>>(
      words(a), words(b), static_cast<uint64_t*>(out), words(tw), words(itw),
      words(pre), words(post), period, log_n, scale);
  return cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, which must belong to the current
// device, and returns the CUDA error code (0 on success).  A launch the
// device refuses (too much shared memory, a bad shape) never runs, so the
// caller must check the code.

extern "C" int gl64_product(const void* a, const void* b, void* out,
                            const void* tw, const void* itw, int batch,
                            int log_n, uint64_t scale, void* stream) {
  return launch_product<false>(a, b, out, tw, itw, batch, log_n, scale, stream);
}

extern "C" int gl64_cached(const void* a, const void* spectrum, void* out,
                           const void* tw, const void* itw, int batch,
                           int log_n, uint64_t scale, void* stream) {
  return launch_product<true>(a, spectrum, out, tw, itw, batch, log_n, scale,
                              stream);
}

extern "C" int gl64_forward(const void* in, void* out, const void* tw,
                            int batch, int log_n, uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(forward_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  forward_kernel<<<batch, threads_for(log_n), n * sizeof(uint64_t),
                   static_cast<cudaStream_t>(stream)>>>(
      words(in), static_cast<uint64_t*>(out), words(tw), log_n, scale);
  return cudaGetLastError();
}

extern "C" int gl64_inverse(const void* in, void* out, const void* itw,
                            int batch, int log_n, uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n)) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(inverse_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  inverse_kernel<<<batch, threads_for(log_n), n * sizeof(uint64_t),
                   static_cast<cudaStream_t>(stream)>>>(
      words(in), static_cast<uint64_t*>(out), words(itw), log_n, scale);
  return cudaGetLastError();
}

extern "C" int gl64_dot(const void* a, const void* b, void* out,
                        const void* tw, const void* itw, int terms, int batch,
                        int log_n, uint64_t scale, int cached, void* stream) {
  if (bad_shape(batch, log_n) || terms < 1 || terms > 8) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(dot_kernel, 3 * n);
  if (err != cudaSuccess) {
    return err;
  }
  dot_kernel<<<batch, threads_for(log_n), 3 * n * sizeof(uint64_t),
               static_cast<cudaStream_t>(stream)>>>(
      words(a), words(b), static_cast<uint64_t*>(out), words(tw), words(itw),
      terms, batch, log_n, scale, cached);
  return cudaGetLastError();
}

extern "C" int gl64_matvec(const void* spectra, const void* mat, void* out,
                           const void* itw, int rows, int cols, int batch,
                           int log_n, uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n) || rows < 1 || rows > 8 || cols < 1 || cols > 8) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(matvec_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  matvec_kernel<<<dim3(batch, rows), threads_for(log_n), n * sizeof(uint64_t),
                  static_cast<cudaStream_t>(stream)>>>(
      words(spectra), words(mat), static_cast<uint64_t*>(out), words(itw), cols,
      batch, log_n, scale);
  return cudaGetLastError();
}

// The row pass of the four-step: `period` rows of plain scales pre and
// post, n values each; batch must be a multiple of it.
extern "C" int gl64_cyclic_scaled(const void* a, const void* b, void* out,
                                  const void* tw, const void* itw,
                                  const void* pre, const void* post, int period,
                                  int batch, int log_n, uint64_t scale,
                                  void* stream) {
  return launch_cyclic_scaled<false>(a, b, out, tw, itw, pre, post, period,
                                     batch, log_n, scale, stream);
}

// The same against the rows of a cached spectrum.
extern "C" int gl64_cached_scaled(const void* a, const void* spectrum,
                                  void* out, const void* tw, const void* itw,
                                  const void* pre, const void* post, int period,
                                  int batch, int log_n, uint64_t scale,
                                  void* stream) {
  return launch_cyclic_scaled<true>(a, spectrum, out, tw, itw, pre, post,
                                    period, batch, log_n, scale, stream);
}

extern "C" int gl64_forward_scaled(const void* in, void* out, const void* tw,
                                   const void* pre, int period, int batch,
                                   int log_n, uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(forward_scaled_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  forward_scaled_kernel<<<batch, threads_for(log_n), n * sizeof(uint64_t),
                          static_cast<cudaStream_t>(stream)>>>(
      words(in), static_cast<uint64_t*>(out), words(tw), words(pre), period,
      log_n, scale);
  return cudaGetLastError();
}

extern "C" int gl64_inverse_scaled(const void* in, void* out, const void* itw,
                                   const void* post, int period, int batch,
                                   int log_n, uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(inverse_scaled_kernel, n);
  if (err != cudaSuccess) {
    return err;
  }
  inverse_scaled_kernel<<<batch, threads_for(log_n), n * sizeof(uint64_t),
                          static_cast<cudaStream_t>(stream)>>>(
      words(in), static_cast<uint64_t*>(out), words(itw), words(post), period,
      log_n, scale);
  return cudaGetLastError();
}

// The dot's row pass: (terms, batch, n) stacks a and b (b cached spectra
// with `cached`), one output row per row of the batch.
extern "C" int gl64_dot_scaled(const void* a, const void* b, void* out,
                               const void* tw, const void* itw, const void* pre,
                               const void* post, int period, int terms,
                               int batch, int log_n, uint64_t scale, int cached,
                               void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period || terms < 1) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  cudaError_t err = allow_smem(dot_scaled_kernel, 3 * n);
  if (err != cudaSuccess) {
    return err;
  }
  dot_scaled_kernel<<<batch, threads_for(log_n), 3 * n * sizeof(uint64_t),
                      static_cast<cudaStream_t>(stream)>>>(
      words(a), words(b), static_cast<uint64_t*>(out), words(tw), words(itw),
      words(pre), words(post), period, terms, batch, log_n, scale, cached);
  return cudaGetLastError();
}

// The matvec's row pass: the (cols, batch, n) row spectra of s against the
// (rows, cols, period, n) cached spectra of A; (rows, batch, n) out.
extern "C" int gl64_matvec_scaled(const void* spectra, const void* mat,
                                  void* out, const void* itw, const void* post,
                                  int period, int rows, int cols, int batch,
                                  int log_n, uint64_t scale, void* stream) {
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
      words(spectra), words(mat), static_cast<uint64_t*>(out), words(itw),
      words(post), period, cols, batch, log_n, scale);
  return cudaGetLastError();
}

extern "C" const char* gl64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

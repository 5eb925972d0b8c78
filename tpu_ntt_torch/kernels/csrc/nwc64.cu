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
//   nwc64_dot      _make_dot_kernel (:1599) through MxuPlan64._dot_call
//                  (:2238), fresh or cached
//   nwc64_matvec   _make_matvec_kernel (:1639) through nwc_matvec_cached
//                  (:2305), after nwc64_forward has transformed s
// and, as the row pass of the four-step that serves 8192 < n <= 2^20
// (tpu_ntt_torch/sharded.py, where nwc64_forward and nwc64_inverse run the
// column pass), K1a's large-n bodies:
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
// Design, correct first and simple (the design of nwc32.cu on 64-bit words):
// * One thread block per row (per output row for the dot and the matvec).
//   The rows a block works on live in dynamic shared memory, 8n bytes each:
//   the product holds two (128 KiB at n = 8192), the dot three (192 KiB at
//   n = 8192, under the 227 KB a block may have), so device memory sees each
//   operand and each result once.  n / 8 threads (at most 1024) run four
//   butterflies each up to n = 8192 (below n = 256, a warp, or n / 2).
// * A merged-psi Cooley-Tukey forward (natural in, bit-reversed out) and a
//   Gentleman-Sande inverse (bit-reversed in, natural out), __syncthreads
//   between stages.  The stage with m groups reads entry m + g of a flat
//   length-n table for group g, beside its Shoup companion
//   w' = floor(w * 2^64 / q); a constant multiply is Shoup with __umul64hi.
//   The cyclic ops take the tables with omega powers (ntt.py, "bitrev").
// * The slot product is Montgomery-64 (one REDC): a*b*2^-64.  Its 2^-64 and
//   the inverse's n^-1 are cancelled by one Shoup multiply with the scale the
//   wrapper passes (n^-1 * 2^64 mod q for two fresh spectra; n^-1 against a
//   cached spectrum, which holds its 2^64 already).  Montgomery serves every
//   odd q < 2^62 in three wide multiplies; the TPU's Solinas fold exists only
//   because Mosaic has no 64-bit multiply.
// * Every value stays canonical in [0, q), also through the dot's and the
//   matvec's accumulation (one conditional subtract after each add: two
//   residues below q < 2^62 sum below 2^63).
// * The matvec keeps the l + k transforms of mxu64.py:1639 without holding A
//   in shared memory (k * l * n * 8 bytes, 512 KiB at 4 x 4, n = 4096): the
//   wrapper transforms the l * B rows of s with nwc64_forward into a scratch
//   tensor, and nwc64_matvec accumulates sum_j REDC(S_j * A_ij) from device
//   memory (A stays in L2) and runs one inverse per output row.
// * The four-step's row pass (the *_scaled functions) is product_kernel,
//   forward_kernel, inverse_kernel, dot_kernel and matvec_kernel with one
//   Shoup multiply more, by a table row, at entry and/or exit (never on a
//   cached spectrum, which the row forward has already scaled).  Row r of
//   a launch reads row r % period of the (period, n) tables (w, w'): a
//   batch of B polynomials of n1 rows each passes period = n1, every row
//   of a polynomial in one launch.  The entry product leaves [0, q) before the transform, the exit
//   product canonical words, as strict Shoup does for q < 2^62.
//
// What bounds it on this card.  Not the 64-bit multiplies it was first
// thought to be: Hopper builds a 64 x 64 product from 32-bit IMADs, about
// twelve for a Shoup-64 or Montgomery-64 product, and at P60_4096, B = 2048
// the product's 3 transforms and slot pass need 2.0e9 of them, 0.12 ms at
// 132 SMs x 64 IMADs a clock x 1.98 GHz, against 201 MB of operands and
// result, 0.06 ms at 3.35 TB/s.  The product takes about four times that
// bound, and the 24-bit kernel, with a sixth of the multiplies a butterfly,
// takes more than half its time (PERF.md): what holds both back is
// instruction issue and latency between barriers (index arithmetic, shared
// loads and stores, twiddle loads and conditional subtracts around each
// product) and the __syncthreads of every stage.  Several stages per barrier
// in registers, lazy reduction and several rows per block at small n are the
// later work.

#include <cstdint>

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

// Cooley-Tukey forward, in place, on `rows` rows of n values spaced n apart:
// stage s has m = 2^s groups of 2t values, t = n >> (s + 1); butterfly j
// pairs u = 2t * (j / t) + j % t with u + t.
__device__ void forward(uint64_t* x, int rows, int log_n, Table tw, uint64_t q) {
  const int n = 1 << log_n;
  for (int s = 0; s < log_n; ++s) {
    const int lt = log_n - 1 - s;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
      const int g = j >> lt;
      const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
      const int v = u + (1 << lt);
      const uint64_t w = __ldg(tw.w + (1 << s) + g);
      const uint64_t ws = __ldg(tw.w_shoup + (1 << s) + g);
      for (int r = 0; r < rows; ++r) {
        uint64_t* y = x + r * n;
        const uint64_t yu = y[u], yv = shoup_mul(y[v], w, ws, q);
        y[u] = add_mod(yu, yv, q);
        y[v] = sub_mod(yu, yv, q);
      }
    }
    __syncthreads();
  }
}

// Gentleman-Sande inverse of one row, in place: the forward's stages in
// reverse order.  No n^-1: the caller's scale carries it.
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

// The product of a row of a with a row of b: b is coefficients, or with
// kCached a spectrum that is used as it is.  Its own body rather than
// dot_kernel at one term, which would add an accumulator row, a zeroing pass
// and a separate scale pass (3.5 % slower on the 24-bit side; PERF.md).
template <bool kCached>
__global__ void product_kernel(const uint64_t* __restrict__ a,
                               const uint64_t* __restrict__ b,
                               uint64_t* __restrict__ out, Table tw, Table itw,
                               int log_n, uint64_t q, uint64_t q_prime,
                               uint64_t scale, uint64_t scale_shoup) {
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
__global__ void forward_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, Table tw, int log_n,
                               uint64_t q, uint64_t scale, uint64_t scale_shoup) {
  extern __shared__ uint64_t x[];
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
__global__ void inverse_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, Table itw, int log_n,
                               uint64_t q, uint64_t scale, uint64_t scale_shoup) {
  extern __shared__ uint64_t x[];
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
__global__ void dot_kernel(const uint64_t* __restrict__ a,
                           const uint64_t* __restrict__ b,
                           uint64_t* __restrict__ out, Table tw, Table itw,
                           int terms, int batch, int log_n, uint64_t q,
                           uint64_t q_prime, uint64_t scale,
                           uint64_t scale_shoup, int cached) {
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
// spectra (times 2^64), so each REDC gives the plain product.
__global__ void matvec_kernel(const uint64_t* __restrict__ spectra,
                              const uint64_t* __restrict__ mat,
                              uint64_t* __restrict__ out, Table itw, int cols,
                              int batch, int log_n, uint64_t q, uint64_t q_prime,
                              uint64_t scale, uint64_t scale_shoup) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t r = blockIdx.x, i = blockIdx.y;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    uint64_t acc = 0;
    for (int j = 0; j < cols; ++j) {
      const uint64_t s = spectra[(j * batch + r) * n + e];
      const uint64_t m = __ldg(mat + (i * cols + j) * n + e);
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

// The four-step's row pass: product_kernel with cyclic tables between an
// entry scale pre[r % period] and an exit scale post[r % period].  With
// kCached, b holds the rows of a cached spectrum (times 2^64), used as they
// are: the row pass of the product against a cached spectrum.
template <bool kCached>
__global__ void cyclic_scaled_kernel(const uint64_t* __restrict__ a,
                                     const uint64_t* __restrict__ b,
                                     uint64_t* __restrict__ out, Table tw,
                                     Table itw, Table pre, Table post,
                                     int period, int log_n, uint64_t q,
                                     uint64_t q_prime, uint64_t scale,
                                     uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  uint64_t* x = smem;
  uint64_t* y = smem + n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const size_t srow = static_cast<size_t>(blockIdx.x % period) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t w = __ldg(pre.w + srow + i);
    const uint64_t ws = __ldg(pre.w_shoup + srow + i);
    x[i] = shoup_mul(a[row + i], w, ws, q);
    y[i] = kCached ? b[row + i] : shoup_mul(b[row + i], w, ws, q);
  }
  __syncthreads();
  forward(x, kCached ? 1 : 2, log_n, tw, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = shoup_mul(mont_mul(x[i], y[i], q, q_prime), scale, scale_shoup, q);
  }
  __syncthreads();
  inverse(x, log_n, itw, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = shoup_mul(x[i], __ldg(post.w + srow + i),
                             __ldg(post.w_shoup + srow + i), q);
  }
}

// Its first half: times pre[r % period], the forward, times `scale` unless
// it is 1.
__global__ void forward_scaled_kernel(const uint64_t* __restrict__ in,
                                      uint64_t* __restrict__ out, Table tw,
                                      Table pre, int period, int log_n,
                                      uint64_t q, uint64_t scale,
                                      uint64_t scale_shoup) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const size_t srow = static_cast<size_t>(blockIdx.x % period) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = shoup_mul(in[row + i], __ldg(pre.w + srow + i),
                     __ldg(pre.w_shoup + srow + i), q);
  }
  __syncthreads();
  forward(x, 1, log_n, tw, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = scale == 1 ? x[i] : shoup_mul(x[i], scale, scale_shoup, q);
  }
}

// Its second half: the inverse, times `scale` (n^-1), times post[r % period].
__global__ void inverse_scaled_kernel(const uint64_t* __restrict__ in,
                                      uint64_t* __restrict__ out, Table itw,
                                      Table post, int period, int log_n,
                                      uint64_t q, uint64_t scale,
                                      uint64_t scale_shoup) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const size_t srow = static_cast<size_t>(blockIdx.x % period) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = in[row + i];
  }
  __syncthreads();
  inverse(x, log_n, itw, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = shoup_mul(shoup_mul(x[i], scale, scale_shoup, q),
                             __ldg(post.w + srow + i),
                             __ldg(post.w_shoup + srow + i), q);
  }
}

// The four-step's row pass of the dot: dot_kernel with the entry scale
// pre[r % period] on every fresh operand and the exit scale post[r % period]
// after the one inverse.  a and b are (terms, batch, n) stacks of the column
// pass's rows; with `cached`, b holds cached spectrum rows, used as they are.
__global__ void dot_scaled_kernel(const uint64_t* __restrict__ a,
                                  const uint64_t* __restrict__ b,
                                  uint64_t* __restrict__ out, Table tw,
                                  Table itw, Table pre, Table post, int period,
                                  int terms, int batch, int log_n, uint64_t q,
                                  uint64_t q_prime, uint64_t scale,
                                  uint64_t scale_shoup, int cached) {
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
      const uint64_t w = __ldg(pre.w + srow + i);
      const uint64_t ws = __ldg(pre.w_shoup + srow + i);
      x[i] = shoup_mul(a[row + i], w, ws, q);
      y[i] = cached ? b[row + i] : shoup_mul(b[row + i], w, ws, q);
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
    out[row + i] = shoup_mul(acc[i], __ldg(post.w + srow + i),
                             __ldg(post.w_shoup + srow + i), q);
  }
}

// The four-step's row pass of the matvec: matvec_kernel on the rows of the
// spectra of s (their row forward done by forward_scaled_kernel) against A's
// cached spectra, (rows, cols, period, n), row r reading A's row r % period;
// the exit scale post[r % period] after the inverse.
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

template <bool kCached>
int launch_product(const void* a, const void* b, void* out, const void* tw,
                   const void* tw_shoup, const void* itw, const void* itw_shoup,
                   int batch, int log_n, uint64_t q, uint64_t q_prime,
                   uint64_t scale, uint64_t scale_shoup, void* stream) {
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
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<uint64_t*>(out), table(tw, tw_shoup), table(itw, itw_shoup),
      log_n, q, q_prime, scale, scale_shoup);
  return cudaGetLastError();
}

template <bool kCached>
int launch_cyclic_scaled(const void* a, const void* b, void* out,
                         const void* tw, const void* tw_shoup, const void* itw,
                         const void* itw_shoup, const void* pre,
                         const void* pre_shoup, const void* post,
                         const void* post_shoup, int period, int batch,
                         int log_n, uint64_t q, uint64_t q_prime,
                         uint64_t scale, uint64_t scale_shoup, void* stream) {
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
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<uint64_t*>(out), table(tw, tw_shoup), table(itw, itw_shoup),
      table(pre, pre_shoup), table(post, post_shoup), period, log_n, q, q_prime,
      scale, scale_shoup);
  return cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, which must belong to the current
// device, and returns the CUDA error code (0 on success).  A launch the
// device refuses (too much shared memory, a bad shape) never runs, so the
// caller must check the code.

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

extern "C" int nwc64_forward(const void* in, void* out, const void* tw,
                             const void* tw_shoup, int batch, int log_n,
                             uint64_t q, uint64_t scale, uint64_t scale_shoup,
                             void* stream) {
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
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
      table(tw, tw_shoup), log_n, q, scale, scale_shoup);
  return cudaGetLastError();
}

extern "C" int nwc64_inverse(const void* in, void* out, const void* itw,
                             const void* itw_shoup, int batch, int log_n,
                             uint64_t q, uint64_t scale, uint64_t scale_shoup,
                             void* stream) {
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
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
      table(itw, itw_shoup), log_n, q, scale, scale_shoup);
  return cudaGetLastError();
}

extern "C" int nwc64_dot(const void* a, const void* b, void* out,
                         const void* tw, const void* tw_shoup, const void* itw,
                         const void* itw_shoup, int terms, int batch, int log_n,
                         uint64_t q, uint64_t q_prime, uint64_t scale,
                         uint64_t scale_shoup, int cached, void* stream) {
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
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<uint64_t*>(out), table(tw, tw_shoup), table(itw, itw_shoup),
      terms, batch, log_n, q, q_prime, scale, scale_shoup, cached);
  return cudaGetLastError();
}

extern "C" int nwc64_matvec(const void* spectra, const void* mat, void* out,
                            const void* itw, const void* itw_shoup, int rows,
                            int cols, int batch, int log_n, uint64_t q,
                            uint64_t q_prime, uint64_t scale,
                            uint64_t scale_shoup, void* stream) {
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
      static_cast<const uint64_t*>(spectra), static_cast<const uint64_t*>(mat),
      static_cast<uint64_t*>(out), table(itw, itw_shoup), cols, batch, log_n, q,
      q_prime, scale, scale_shoup);
  return cudaGetLastError();
}

// The row pass of the four-step: `period` rows of scales pre and post, each
// n values beside their Shoup companions; batch must be a multiple of it.
extern "C" int nwc64_cyclic_scaled(const void* a, const void* b, void* out,
                                   const void* tw, const void* tw_shoup,
                                   const void* itw, const void* itw_shoup,
                                   const void* pre, const void* pre_shoup,
                                   const void* post, const void* post_shoup,
                                   int period, int batch, int log_n, uint64_t q,
                                   uint64_t q_prime, uint64_t scale,
                                   uint64_t scale_shoup, void* stream) {
  return launch_cyclic_scaled<false>(a, b, out, tw, tw_shoup, itw, itw_shoup,
                                     pre, pre_shoup, post, post_shoup, period,
                                     batch, log_n, q, q_prime, scale,
                                     scale_shoup, stream);
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
  return launch_cyclic_scaled<true>(a, spectrum, out, tw, tw_shoup, itw,
                                    itw_shoup, pre, pre_shoup, post, post_shoup,
                                    period, batch, log_n, q, q_prime, scale,
                                    scale_shoup, stream);
}

extern "C" int nwc64_forward_scaled(const void* in, void* out, const void* tw,
                                    const void* tw_shoup, const void* pre,
                                    const void* pre_shoup, int period,
                                    int batch, int log_n, uint64_t q,
                                    uint64_t scale, uint64_t scale_shoup,
                                    void* stream) {
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
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
      table(tw, tw_shoup), table(pre, pre_shoup), period, log_n, q, scale,
      scale_shoup);
  return cudaGetLastError();
}

extern "C" int nwc64_inverse_scaled(const void* in, void* out, const void* itw,
                                    const void* itw_shoup, const void* post,
                                    const void* post_shoup, int period,
                                    int batch, int log_n, uint64_t q,
                                    uint64_t scale, uint64_t scale_shoup,
                                    void* stream) {
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
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
      table(itw, itw_shoup), table(post, post_shoup), period, log_n, q, scale,
      scale_shoup);
  return cudaGetLastError();
}

// The dot's row pass: (terms, batch, n) stacks a and b (b cached spectra
// with `cached`), one output row per row of the batch.
extern "C" int nwc64_dot_scaled(const void* a, const void* b, void* out,
                                const void* tw, const void* tw_shoup,
                                const void* itw, const void* itw_shoup,
                                const void* pre, const void* pre_shoup,
                                const void* post, const void* post_shoup,
                                int period, int terms, int batch, int log_n,
                                uint64_t q, uint64_t q_prime, uint64_t scale,
                                uint64_t scale_shoup, int cached, void* stream) {
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
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<uint64_t*>(out), table(tw, tw_shoup), table(itw, itw_shoup),
      table(pre, pre_shoup), table(post, post_shoup), period, terms, batch,
      log_n, q, q_prime, scale, scale_shoup, cached);
  return cudaGetLastError();
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

// nwc64.cu: fused negacyclic product for 60-bit NTT primes, hand-written for
// Hopper (sm_90a).
//
// Replaces tpu_ntt/kernels/mxu64.py MxuPlan64._nwc_kernel (:1442), as
// specialised by SolinasPlan64 (tpu_ntt/kernels/sol64.py) and launched by
// MxuPlan64._call (mxu64.py:1981).  For (B, n) rows of uint64 residues in
// [0, q), natural order, it writes c = a * b mod (x^n + 1, q) in [0, q),
// natural order: the function of tpu_ntt_torch.ntt.nwc_poly_mult_merged, bit
// for bit.  256 <= n <= 8192, q odd and below 2^62.
//
// Design, correct first and simple:
// * One thread block per row.  Both operand rows live in dynamic shared
//   memory (2 * n * 8 bytes: 64 KiB at n = 4096, 128 KiB at n = 8192), so
//   device memory sees each operand and the result once.
// * The merged-psi Cooley-Tukey forward runs in place on both rows (natural
//   in, bit-reversed out), then the slotwise product, then the merged
//   Gentleman-Sande inverse (bit-reversed in, natural out), with a
//   __syncthreads between stages.
// * Twiddles come from flat length-n tables in device memory: the stage with
//   m butterfly groups reads entry m + g for group g, each beside its Shoup
//   companion w' = floor(w * 2^64 / q).  Constant multiplies are Shoup with
//   __umul64hi.
// * The variable x variable product is Montgomery-64 (one REDC).  Its 2^-64
//   is cancelled in the same pass by a Shoup multiply with n^-1 * 2^64 mod q,
//   which also applies the inverse's n^-1 scale.  Montgomery is chosen over
//   the Solinas shift-add fold of sol64.py: it serves every odd q < 2^62 in
//   three wide multiplies, and the fold exists on the TPU only because Mosaic
//   has no 64-bit multiply.
// * Every value stays canonical in [0, q); q < 2^62 leaves room for a + b.
//
// What bounds it on this card: 64-bit integer multiplies.  Hopper has no
// 64-bit multiplier; a 64 x 64 low product takes about three 32-bit IMADs and
// __umul64hi several more.  At B = 2048, n = 4096 the product does 3
// transforms x 12 stages x 2048 butterflies per row, each with one Shoup
// multiply of three wide multiplies: 1.5e8 Shoup multiplies, 4.5e8 wide
// multiplies, against 192 MiB of operand and result traffic that takes about
// 0.06 ms at 3.35 TB/s.  The
// design keeps every intermediate in shared memory so that the multiplies
// are the only cost left; making them cheaper (lazy butterflies, several rows
// per block, int8 tensor-core transforms) is later work.

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

__global__ void nwc64_kernel(const uint64_t* __restrict__ a,
                             const uint64_t* __restrict__ b,
                             uint64_t* __restrict__ out,
                             const uint64_t* __restrict__ tw,
                             const uint64_t* __restrict__ tw_shoup,
                             const uint64_t* __restrict__ itw,
                             const uint64_t* __restrict__ itw_shoup,
                             int log_n, uint64_t q, uint64_t q_prime,
                             uint64_t scale, uint64_t scale_shoup) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  uint64_t* x = smem;
  uint64_t* y = smem + n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = a[row + i];
    y[i] = b[row + i];
  }
  __syncthreads();

  // Forward, Cooley-Tukey: stage s has m = 2^s groups of 2t values,
  // t = n >> (s + 1); butterfly j pairs u = 2t * (j / t) + j % t with u + t.
  for (int s = 0; s < log_n; ++s) {
    const int lt = log_n - 1 - s;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int g = j >> lt;
      const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
      const int v = u + (1 << lt);
      const uint64_t w = __ldg(tw + (1 << s) + g);
      const uint64_t ws = __ldg(tw_shoup + (1 << s) + g);
      const uint64_t xu = x[u], xv = shoup_mul(x[v], w, ws, q);
      x[u] = add_mod(xu, xv, q);
      x[v] = sub_mod(xu, xv, q);
      const uint64_t yu = y[u], yv = shoup_mul(y[v], w, ws, q);
      y[u] = add_mod(yu, yv, q);
      y[v] = sub_mod(yu, yv, q);
    }
    __syncthreads();
  }

  // Slotwise product: REDC gives x*y*2^-64; scale = n^-1 * 2^64 mod q.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = shoup_mul(mont_mul(x[i], y[i], q, q_prime), scale, scale_shoup, q);
  }
  __syncthreads();

  // Inverse, Gentleman-Sande: the forward's stages in reverse order.
  for (int s = log_n - 1; s >= 0; --s) {
    const int lt = log_n - 1 - s;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int g = j >> lt;
      const int u = (g << (lt + 1)) | (j & ((1 << lt) - 1));
      const int v = u + (1 << lt);
      const uint64_t w = __ldg(itw + (1 << s) + g);
      const uint64_t ws = __ldg(itw_shoup + (1 << s) + g);
      const uint64_t xu = x[u], xv = x[v];
      x[u] = add_mod(xu, xv, q);
      x[v] = shoup_mul(sub_mod(xu, xv, q), w, ws, q);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = x[i];
  }
}

}  // namespace

// Launches the kernel on `stream`, which must belong to the current device,
// and returns the CUDA error code (0 on success).  A launch the device
// refuses (too much shared memory, a bad shape) never runs, so the caller
// must check the code.
extern "C" int nwc64_launch(const void* a, const void* b, void* out,
                            const void* tw, const void* tw_shoup,
                            const void* itw, const void* itw_shoup,
                            int batch, int log_n, uint64_t q, uint64_t q_prime,
                            uint64_t scale, uint64_t scale_shoup,
                            void* stream) {
  if (batch < 1 || log_n < 8 || log_n > 13) {
    return cudaErrorInvalidValue;
  }
  const int n = 1 << log_n;
  const int smem = 2 * n * static_cast<int>(sizeof(uint64_t));
  cudaError_t err = cudaFuncSetAttribute(
      nwc64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const int threads = n / 8 < 1024 ? n / 8 : 1024;  // 4 butterflies a thread
  nwc64_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<uint64_t*>(out), static_cast<const uint64_t*>(tw),
      static_cast<const uint64_t*>(tw_shoup), static_cast<const uint64_t*>(itw),
      static_cast<const uint64_t*>(itw_shoup), log_n, q, q_prime, scale,
      scale_shoup);
  return cudaGetLastError();
}

extern "C" const char* nwc64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

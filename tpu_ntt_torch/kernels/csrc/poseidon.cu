// poseidon.cu: the Poseidon2 permutation and sponge over the Goldilocks
// field, q = 2^64 - 2^32 + 1, hand-written for Hopper (sm_90a).
//
// Replaces the two pallas_calls of tpu_ntt/kernels/poseidon.py:
//   poseidon_permute  kernel K5a: _compiled (:193, pallas_call :202) through
//                     permute_kernel (:324), body _kernel_body (:114) and
//                     _permute_rounds (:54): one permutation of each column
//                     of a (W, B) state, W = 8 or 12
//   poseidon_sponge   kernel K5b: _compiled_sponge (:218, pallas_call :227)
//                     through hash_rows_kernel (:243), body _sponge_body
//                     (:127): the rate-4 sponge of each row of (B, L) rows,
//                     a (4, B) digest
// Residues are uint64 in [0, q) (the port's wrapped torch.int64 tensors
// hold the same bytes).  Each function computes what
// tpu_ntt_torch.poseidon.Poseidon2GL's plain version computes, bit for bit:
// 4 full rounds, rp partial rounds, 4 full rounds (rf = 8, rp = 22 by
// default), the external layer first; a full round adds a constant to each
// lane, applies x^7 to each and the external layer (M4 on each block of four
// lanes by the addition schedule of tpu_ntt/poseidon.py:282-296, then each
// block plus the sum of the blocks); a partial round adds a constant to lane
// 0, applies x^7 to it, then the internal layer (the lane sum plus each lane
// times its diagonal entry minus one).  The sponge puts the row length in
// lane 4, adds each chunk of four elements to lanes 0-3 (a short last chunk
// as if zero-padded, poseidon.py:257-260 there) and permutes; L = 0 still
// permutes once.  The TPU kernel's sublane fold, (hi, lo) uint32 pairs and
// VMEM tables exist only for the TPU's vector unit; none is carried over.
//
// Design, correct first and simple: one thread runs one permutation (or one
// row's sponge) with its W lanes in registers, W a template parameter, so
// the state never leaves the thread between rounds; nothing is shared
// between threads but the constants.  The round constants (rf * W full,
// rp partial) and the diagonal minus one come from a device table the
// wrapper builds from the hasher's own constants, copied into shared memory
// by each block (at most 6144 words).  The permutation reads its state as
// (W, B), so neighbouring threads load neighbouring words; the sponge reads
// row-major (B, L) rows, so each thread's loads are L words apart: strided,
// left so for now (PERF.md).
//
// What bounds it on this card: the multiplies.  A permutation at W = 8 has
// 8 * 4 * 8 + 22 * (4 + 8) = 520 Goldilocks products of about eight 32-bit
// IMADs each and moves 128 bytes; at B = 131072 that is 5.5e8 IMADs, 0.033
// ms at 132 SMs x 64 a clock x 1.98 GHz, against 17 MB, 0.005 ms at
// 3.35 TB/s.  The adds around each product (the external layer is 36 of
// them at W = 8, each a compare and a select) are not counted there and
// cost issue slots of their own.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kQ = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod q = 2^32 - 1
constexpr int kRate = 4;
constexpr int kThreads = 128;
constexpr int kMaxConsts = 6144;  // 48 KiB of shared memory

// (a + b) mod q: a carry out of 64 bits is 2^64 = q + eps.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  if (s < a) {
    return s + kEps;
  }
  return s >= kQ ? s - kQ : s;
}

// (hi * 2^64 + lo) mod q by the phi-fold: 2^96 = -1 and 2^64 = 2^32 - 1.
__device__ __forceinline__ uint64_t gl_reduce(uint64_t lo, uint64_t hi) {
  const uint64_t a = hi >> 32;
  const uint64_t b = hi & kEps;
  uint64_t t0 = lo - a;
  if (lo < a) {
    t0 -= kEps;
  }
  const uint64_t t1 = (b << 32) - b;
  uint64_t t = t0 + t1;
  if (t < t0) {
    t += kEps;
  }
  return t >= kQ ? t - kQ : t;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t sbox(uint64_t v) {
  const uint64_t v2 = gl_mul(v, v);
  const uint64_t v4 = gl_mul(v2, v2);
  return gl_mul(gl_mul(v4, v2), v);
}

// M4 @ x for four lanes, in place, by tpu_ntt's addition schedule.
__device__ __forceinline__ void m4(uint64_t* x) {
  const uint64_t t0 = gl_add(x[0], x[1]);
  const uint64_t t1 = gl_add(x[2], x[3]);
  const uint64_t t2 = gl_add(gl_add(x[1], x[1]), t1);
  const uint64_t t3 = gl_add(gl_add(x[3], x[3]), t0);
  const uint64_t t4 = gl_add(gl_add(gl_add(t1, t1), gl_add(t1, t1)), t3);
  const uint64_t t5 = gl_add(gl_add(gl_add(t0, t0), gl_add(t0, t0)), t2);
  x[0] = gl_add(t3, t5);
  x[1] = t5;
  x[2] = gl_add(t2, t4);
  x[3] = t4;
}

template <int W>
__device__ __forceinline__ void external(uint64_t (&x)[W]) {
#pragma unroll
  for (int o = 0; o < W; o += 4) {
    m4(x + o);
  }
  uint64_t s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = x[i];
#pragma unroll
    for (int o = 4; o < W; o += 4) {
      s[i] = gl_add(s[i], x[o + i]);
    }
  }
#pragma unroll
  for (int o = 0; o < W; o += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[o + i] = gl_add(x[o + i], s[i]);
    }
  }
}

template <int W>
__device__ __forceinline__ void full_round(uint64_t (&x)[W], const uint64_t* rc) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = sbox(gl_add(x[i], rc[i]));
  }
  external<W>(x);
}

template <int W>
__device__ __forceinline__ void partial_round(uint64_t (&x)[W], uint64_t rc,
                                              const uint64_t* diag_m1) {
  x[0] = sbox(gl_add(x[0], rc));
  uint64_t s = x[0];
#pragma unroll
  for (int i = 1; i < W; ++i) {
    s = gl_add(s, x[i]);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = gl_add(gl_mul(x[i], diag_m1[i]), s);
  }
}

// The permutation, with the constants table c = [rf * W full-round
// constants | rp partial-round constants | W diagonal entries minus one].
template <int W>
__device__ void permute_state(uint64_t (&x)[W], const uint64_t* c, int rf,
                              int rp) {
  const uint64_t* rc_part = c + rf * W;
  const uint64_t* diag_m1 = rc_part + rp;
  const int half = rf / 2;
  external<W>(x);
  for (int r = 0; r < half; ++r) {
    full_round<W>(x, c + r * W);
  }
  for (int r = 0; r < rp; ++r) {
    partial_round<W>(x, rc_part[r], diag_m1);
  }
  for (int r = half; r < rf; ++r) {
    full_round<W>(x, c + r * W);
  }
}

__device__ void load_constants(uint64_t* dst, const uint64_t* src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    dst[i] = src[i];
  }
  __syncthreads();
}

template <int W>
__global__ void permute_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out,
                               const uint64_t* __restrict__ consts, int rf,
                               int rp, int batch) {
  extern __shared__ uint64_t c[];
  load_constants(c, consts, rf * W + rp + W);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) {
    return;
  }
  uint64_t x[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = in[static_cast<size_t>(i) * batch + b];
  }
  permute_state<W>(x, c, rf, rp);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    out[static_cast<size_t>(i) * batch + b] = x[i];
  }
}

template <int W>
__global__ void sponge_kernel(const uint64_t* __restrict__ rows,
                              uint64_t* __restrict__ digest,
                              const uint64_t* __restrict__ consts, int rf,
                              int rp, int batch, int len) {
  extern __shared__ uint64_t c[];
  load_constants(c, consts, rf * W + rp + W);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) {
    return;
  }
  uint64_t x[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = 0;
  }
  x[kRate] = static_cast<uint64_t>(len);  // below q: the length domain tag
  const uint64_t* row = rows + static_cast<size_t>(b) * len;
  int off = 0;
  do {
#pragma unroll
    for (int i = 0; i < kRate; ++i) {
      if (off + i < len) {
        x[i] = gl_add(x[i], row[off + i]);
      }
    }
    permute_state<W>(x, c, rf, rp);
    off += kRate;
  } while (off < len);
#pragma unroll
  for (int i = 0; i < kRate; ++i) {
    digest[static_cast<size_t>(i) * batch + b] = x[i];
  }
}

int consts_words(int width, int rf, int rp) { return rf * width + rp + width; }

bool bad_args(int width, int rf, int rp, int batch) {
  return (width != 8 && width != 12) || rf < 2 || rf % 2 || rp < 0 ||
         batch < 1 || consts_words(width, rf, rp) > kMaxConsts;
}

int blocks_for(int batch) { return (batch + kThreads - 1) / kThreads; }

}  // namespace

// Every entry point launches on `stream`, which must belong to the current
// device, and returns the CUDA error code (0 on success); a launch refused
// for its arguments returns cudaErrorInvalidValue and never runs.

extern "C" int poseidon_permute(const void* state, void* out, const void* consts,
                                int width, int rf, int rp, int batch,
                                void* stream) {
  if (bad_args(width, rf, rp, batch)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = consts_words(width, rf, rp) * sizeof(uint64_t);
  const auto* in = static_cast<const uint64_t*>(state);
  auto* o = static_cast<uint64_t*>(out);
  const auto* c = static_cast<const uint64_t*>(consts);
  const auto s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    permute_kernel<8><<<blocks_for(batch), kThreads, smem, s>>>(in, o, c, rf, rp,
                                                                batch);
  } else {
    permute_kernel<12><<<blocks_for(batch), kThreads, smem, s>>>(in, o, c, rf, rp,
                                                                 batch);
  }
  return cudaGetLastError();
}

extern "C" int poseidon_sponge(const void* rows, void* digest, const void* consts,
                               int width, int rf, int rp, int batch, int len,
                               void* stream) {
  if (bad_args(width, rf, rp, batch) || len < 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = consts_words(width, rf, rp) * sizeof(uint64_t);
  const auto* in = static_cast<const uint64_t*>(rows);
  auto* o = static_cast<uint64_t*>(digest);
  const auto* c = static_cast<const uint64_t*>(consts);
  const auto s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    sponge_kernel<8><<<blocks_for(batch), kThreads, smem, s>>>(in, o, c, rf, rp,
                                                               batch, len);
  } else {
    sponge_kernel<12><<<blocks_for(batch), kThreads, smem, s>>>(in, o, c, rf, rp,
                                                                batch, len);
  }
  return cudaGetLastError();
}

extern "C" const char* poseidon_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

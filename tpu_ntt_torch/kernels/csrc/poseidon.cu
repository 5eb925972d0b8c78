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
// and adds poseidon_field_probe, no TPU kernel's counterpart: it applies the
// arithmetic core below to operands it is given, so that a test can hold
// the core to Python integers on operands a permutation of uniform states
// almost never produces.
//
// Residues are uint64 in [0, q) (the port's wrapped torch.int64 tensors
// hold the same bytes).  Each function computes what
// tpu_ntt_torch.poseidon.Poseidon2GL's plain version computes, bit for bit:
// 4 full rounds, rp partial rounds, 4 full rounds (rf = 8, rp = 22 by
// default), the external layer first; a full round adds a constant to each
// lane, applies x^7 to each and the external layer (M4 on each block of four
// lanes, then each block plus the sum of the blocks); a partial round adds a
// constant to lane 0, applies x^7 to it, then the internal layer (the lane
// sum plus each lane times its diagonal entry minus one).  The sponge puts
// the row length in lane 4, adds each chunk of four elements to lanes 0-3 (a
// short last chunk as if zero-padded, tpu_ntt/kernels/poseidon.py:257-260)
// and permutes; L = 0 still permutes once.  The TPU kernel's sublane fold,
// (hi, lo) uint32 pairs and VMEM tables exist only for the TPU's vector
// unit; none is carried over.
//
// What bounds it on this card: issue slots.  A permutation at W = 8 has
// 8 * 4 * 8 + 22 * (4 + 8) = 520 Goldilocks products of eight 32-bit
// multiplies each and about 780 additions, and moves 128 bytes; at
// B = 131072 the multiplies alone take 0.033 ms at 132 SMs x 64 a clock x
// 1.98 GHz, the bytes 0.005 ms at 3.35 TB/s.  Every instruction around the
// multiplies (carries, reductions, additions) takes an issue slot of its
// own, so the design spends as few as it can:
// * One arithmetic core (the section below), written as PTX carry chains on
//   32-bit words: the 64 x 64 -> 128 product as four 32 x 32 partial
//   products (eight multiplies), the phi-fold
//   (2^64 = 2^32 - 1, 2^96 = -1 mod q) with its borrows and carries taken
//   from the carry flag, never from 64-bit compares.
// * Lazy reduction: inside a permutation a lane holds any 64-bit pattern
//   congruent to its value mod q; each output word is brought into [0, q)
//   once, at the end.  The external layer collects each output lane as a
//   96-bit sum (64 bits and a carry word: M4's small coefficients, the block
//   sum and the next round's constant) and folds it once; the internal
//   layer adds the 96-bit lane sum inside each diagonal product's carry
//   chain, before its one fold.  x^7 is v2 = v^2, v3 = v2 v, v4 = v2^2,
//   v7 = v4 v3: three products deep, not four.
// * The rounds are loops over the constants in shared memory, each round's
//   lanes unrolled, so every thread reads the same address (a broadcast)
//   and one instantiation a width serves every schedule Poseidon2GL
//   accepts.  Unrolled, the default schedule (rf, rp) = (8, 22) is 12k
//   instructions at W = 8, more than the instruction cache holds: it ran
//   slower on the H100 than the loops, the sponge most (PERF.md).
// One thread runs one permutation (or one row's sponge) with its W lanes in
// registers, so the state never leaves the thread between rounds.  The
// sponge's rows, 8L bytes apart, are staged through shared memory: each
// block copies the next kChunk words of each of its rows with 8-byte
// cp.async, neighbouring threads on neighbouring words, into one of two
// buffers while its threads permute the chunk before (TMA cannot take the
// rows: its global stride must be a multiple of 16 bytes, and a row of
// 135 words is 1080).  The block shrinks from 128 threads to 32 while the
// batch would leave SMs without a block (an 8192-row sponge, the upper
// levels of a Merkle tree).

#include <cstdint>

#include <cuda_runtime.h>

// ---------------------------------------------------------------------------
// The arithmetic core.  Each GL_PTX_* string is one carry chain, kept whole
// in one asm statement (the carry flag does not survive between two);
// tests/test_torch_poseidon_lazy.py reads these strings and runs them on a
// model of the 32-bit instructions, so the operand numbers in each comment
// are part of the contract with that test.
// ---------------------------------------------------------------------------

// a * b + c + e * 2^64 as four words r0..r3 from the four 32 x 32 partial
// products, eight multiplies: the cross sum m = a0 b1 + a1 b0 (65 bits)
// first, then a0 b0 + c and a1 b1 + e in one chain, then m at 2^32 (the
// order that keeps ptxas's 64-bit multiply-adds on whole register pairs).
// %0-%3 r0..r3; %4-%6 m0..m2; %7, %8 a0, a1; %9, %10 b0, b1; %11, %12 c0,
// c1; %13 e.  Exact when the sum is below 2^128.
#define GL_PTX_WIDE                      \
  "mul.lo.u32 %4, %7, %10;\n\t"          \
  "mul.hi.u32 %5, %7, %10;\n\t"          \
  "mad.lo.cc.u32 %4, %8, %9, %4;\n\t"    \
  "madc.hi.cc.u32 %5, %8, %9, %5;\n\t"   \
  "addc.u32 %6, 0, 0;\n\t"               \
  "mad.lo.cc.u32 %0, %7, %9, %11;\n\t"   \
  "madc.hi.cc.u32 %1, %7, %9, %12;\n\t"  \
  "madc.lo.cc.u32 %2, %8, %10, %13;\n\t" \
  "madc.hi.u32 %3, %8, %10, 0;\n\t"      \
  "add.cc.u32 %1, %1, %4;\n\t"           \
  "addc.cc.u32 %2, %2, %5;\n\t"          \
  "addc.u32 %3, %3, %6;"

// The phi-fold of r = r0 + r1 2^32 + r2 2^64 + r3 2^96, congruent to
// X = (r1:r0) + r2 eps - r3: t = X - k 2^64 with k = floor(X / 2^64) in
// {-1, 0, 1}, from the carry of the add and the borrow of the subtract.
// %0, %1 t0, t1; %2 k; %3-%6 r0..r3; %7 eps = 2^32 - 1.
#define GL_PTX_FOLD128                 \
  "mad.lo.cc.u32 %0, %5, %7, %3;\n\t"  \
  "madc.hi.cc.u32 %1, %5, %7, %4;\n\t" \
  "addc.u32 %2, 0, 0;\n\t"             \
  "sub.cc.u32 %0, %0, %6;\n\t"         \
  "subc.cc.u32 %1, %1, 0;\n\t"         \
  "subc.u32 %2, %2, 0;"

// t += (d0:d1) mod 2^64.  %0, %1 t0, t1 (read and written); %2, %3 d0, d1.
#define GL_PTX_ADD64                   \
  "add.cc.u32 %0, %0, %2;\n\t"         \
  "addc.u32 %1, %1, %3;"

// The fold of a 96-bit sum v = (w1:w0) + w2 2^64, congruent to
// (w1:w0) + w2 eps: t = that with carry c, then t + c eps, which stays
// below 2^64.  %0, %1 t0, t1; %2 c; %3-%5 w0..w2; %6 eps.
#define GL_PTX_FOLD96                  \
  "mad.lo.cc.u32 %0, %5, %6, %3;\n\t"  \
  "madc.hi.cc.u32 %1, %5, %6, %4;\n\t" \
  "addc.u32 %2, 0, 0;\n\t"             \
  "mad.lo.cc.u32 %0, %2, %6, %0;\n\t"  \
  "addc.u32 %1, %1, 0;"

// 96-bit a + b.  %0-%2 the sum's words; %3-%5 a's; %6-%8 b's.
#define GL_PTX_ADD96                   \
  "add.cc.u32 %0, %3, %6;\n\t"         \
  "addc.cc.u32 %1, %4, %7;\n\t"        \
  "addc.u32 %2, %5, %8;"

// a + b for b below q: a carry out of 64 bits adds eps, and then a + b -
// 2^64 < q keeps the sum below 2^64.  %0, %1 t0, t1; %2 c; %3, %4 a0, a1;
// %5, %6 b0, b1; %7 eps.
#define GL_PTX_ADD_REDUCED             \
  "add.cc.u32 %0, %3, %5;\n\t"         \
  "addc.cc.u32 %1, %4, %6;\n\t"        \
  "addc.u32 %2, 0, 0;\n\t"             \
  "mad.lo.cc.u32 %0, %2, %7, %0;\n\t"  \
  "addc.u32 %1, %1, 0;"

namespace {

constexpr uint64_t kQ = 0xFFFFFFFF00000001ull;
constexpr uint32_t kEps = 0xFFFFFFFFu;  // 2^64 mod q = 2^32 - 1
constexpr int kRate = 4;
constexpr int kMaxThreads = 128;
constexpr int kMaxConsts = 6144;  // 48 KiB of shared memory
constexpr int kChunk = 8;  // words of each row staged at a time: two absorptions
constexpr int kStride = kChunk + 1;  // odd, so a warp's 8-byte reads miss no bank twice

__device__ __forceinline__ uint32_t lo32(uint64_t x) { return static_cast<uint32_t>(x); }
__device__ __forceinline__ uint32_t hi32(uint64_t x) {
  return static_cast<uint32_t>(x >> 32);
}
__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// A sum of a few 64-bit words: w0 + w1 2^32 + w2 2^64.
struct Acc {
  uint32_t w0, w1, w2;
};

__device__ __forceinline__ Acc acc(uint64_t x) { return {lo32(x), hi32(x), 0}; }

__device__ __forceinline__ Acc add(Acc a, Acc b) {
  Acc s;
  asm(GL_PTX_ADD96
      : "=&r"(s.w0), "=&r"(s.w1), "=&r"(s.w2)
      : "r"(a.w0), "r"(a.w1), "r"(a.w2), "r"(b.w0), "r"(b.w1), "r"(b.w2));
  return s;
}
__device__ __forceinline__ Acc add(Acc a, uint64_t b) { return add(a, acc(b)); }
__device__ __forceinline__ Acc add(uint64_t a, uint64_t b) { return add(acc(a), acc(b)); }

__device__ __forceinline__ Acc times4(Acc a) {
  return {a.w0 << 2, (a.w1 << 2) | (a.w0 >> 30), (a.w2 << 2) | (a.w1 >> 30)};
}

__device__ __forceinline__ uint64_t fold(Acc v) {
  uint32_t t0, t1, c;
  asm(GL_PTX_FOLD96
      : "=&r"(t0), "=&r"(t1), "=&r"(c)
      : "r"(v.w0), "r"(v.w1), "r"(v.w2), "r"(kEps));
  return join(t0, t1);
}

// a * b + c + e 2^64, folded to a 64-bit word congruent to it.
__device__ __forceinline__ uint64_t mul_add(uint64_t a, uint64_t b, uint64_t c,
                                            uint32_t e) {
  uint32_t r0, r1, r2, r3, m0, m1, m2;
  asm(GL_PTX_WIDE
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3), "=&r"(m0), "=&r"(m1), "=&r"(m2)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)), "r"(lo32(c)),
        "r"(hi32(c)), "r"(e));
  uint32_t t0, t1, k;
  asm(GL_PTX_FOLD128
      : "=&r"(t0), "=&r"(t1), "=&r"(k)
      : "r"(r0), "r"(r1), "r"(r2), "r"(r3), "r"(kEps));
  // t + k eps lies in [0, 2^64) (k = 1 leaves t below eps^2, k = -1 leaves
  // it above 2^64 - 2^32), so it is added mod 2^64: the words of k eps mod
  // 2^64 are (-k, k >> 31) for k in {-1, 0, 1}
  asm(GL_PTX_ADD64 : "+r"(t0), "+r"(t1) : "r"(0u - k), "r"(static_cast<uint32_t>(
      static_cast<int32_t>(k) >> 31)));
  return join(t0, t1);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return mul_add(a, b, 0, 0); }

// a * b + s for b below q and s a sum of at most 12 words: below 2^128.
__device__ __forceinline__ uint64_t mul_add(uint64_t a, uint64_t b, Acc s) {
  return mul_add(a, b, join(s.w0, s.w1), s.w2);
}

__device__ __forceinline__ uint64_t add_reduced(uint64_t a, uint64_t b) {
  uint32_t t0, t1, c;
  asm(GL_PTX_ADD_REDUCED
      : "=&r"(t0), "=&r"(t1), "=&r"(c)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)), "r"(kEps));
  return join(t0, t1);
}

__device__ __forceinline__ uint64_t add_any(uint64_t a, uint64_t b) { return fold(add(a, b)); }

__device__ __forceinline__ uint64_t canonical(uint64_t x) { return x >= kQ ? x - kQ : x; }

__device__ __forceinline__ uint64_t sbox(uint64_t v) {
  const uint64_t v2 = mul(v, v);
  const uint64_t v3 = mul(v2, v);
  const uint64_t v4 = mul(v2, v2);
  return mul(v4, v3);
}

// ---------------------------------------------------------------------------
// The layers and the permutation
// ---------------------------------------------------------------------------

// M4 @ x for four lanes as 96-bit sums (each below 16 * 2^64), by
// tpu_ntt's addition schedule: 2 x1 + x2 + x3, 2 x3 + x0 + x1, then four
// times each pair sum.
__device__ __forceinline__ void m4(const uint64_t* x, Acc* y) {
  const Acc t0 = add(x[0], x[1]);
  const Acc t1 = add(x[2], x[3]);
  const Acc t2 = add(add(x[1], x[1]), t1);
  const Acc t3 = add(add(x[3], x[3]), t0);
  const Acc t4 = add(times4(t1), t3);
  const Acc t5 = add(times4(t0), t2);
  y[0] = add(t3, t5);
  y[1] = t5;
  y[2] = add(t2, t4);
  y[3] = t4;
}

// The external layer, then rc[i] added to lane i (the next full round's
// constants, or a row of zeros): each lane one fold of a sum below
// 65 * 2^64.
template <int W>
__device__ __forceinline__ void external(uint64_t (&x)[W], const uint64_t* rc) {
  Acc m[W];
#pragma unroll
  for (int o = 0; o < W; o += 4) {
    m4(x + o, m + o);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    Acc s = m[i];
#pragma unroll
    for (int o = 4; o < W; o += 4) {
      s = add(s, m[o + i]);
    }
#pragma unroll
    for (int o = 0; o < W; o += 4) {
      x[o + i] = fold(add(add(m[o + i], s), rc[o + i]));
    }
  }
}

// The internal layer: the lane sum plus each lane times its diagonal entry
// minus one (below q), the sum added inside each product's carry chain.
template <int W>
__device__ __forceinline__ void internal(uint64_t (&x)[W], const uint64_t* diag_m1) {
  Acc s = add(x[0], x[1]);
#pragma unroll
  for (int i = 2; i < W; ++i) {
    s = add(s, x[i]);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = mul_add(x[i], diag_m1[i], s);
  }
}

template <int W>
__device__ __forceinline__ void full_round(uint64_t (&x)[W], const uint64_t* rc_next) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = sbox(x[i]);
  }
  external<W>(x, rc_next);
}

// The permutation, with the constants table c = [rf * W full-round
// constants | rp partial-round constants | W diagonal entries minus one |
// W zeros]: rounds in loops, their lanes unrolled.
template <int W>
__device__ __forceinline__ void permute_state(uint64_t (&x)[W], const uint64_t* c, int rf,
                                              int rp) {
  const int half = rf / 2;
  const uint64_t* rc_part = c + rf * W;
  const uint64_t* diag_m1 = rc_part + rp;
  const uint64_t* zeros = diag_m1 + W;
  external<W>(x, c);  // and full round 0's constants
#pragma unroll 1
  for (int r = 0; r < half; ++r) {
    full_round<W>(x, r + 1 < half ? c + (r + 1) * W : zeros);
  }
#pragma unroll 1
  for (int r = 0; r < rp; ++r) {
    x[0] = sbox(add_reduced(x[0], rc_part[r]));
    internal<W>(x, diag_m1);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = add_reduced(x[i], c[half * W + i]);
  }
#pragma unroll 1
  for (int r = half; r < rf; ++r) {
    full_round<W>(x, r + 1 < rf ? c + (r + 1) * W : zeros);
  }
}

// The constants, then W zeros, into shared memory.
__device__ void load_constants(uint64_t* dst, const uint64_t* src, int count, int width) {
  for (int i = threadIdx.x; i < count + width; i += blockDim.x) {
    dst[i] = i < count ? src[i] : 0;
  }
  __syncthreads();
}

__host__ __device__ int consts_words(int width, int rf, int rp) {
  return rf * width + rp + width;
}

template <int W>
__global__ void __launch_bounds__(kMaxThreads)
    permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                   const uint64_t* __restrict__ consts, int rf, int rp, int batch) {
  extern __shared__ uint64_t c[];
  load_constants(c, consts, consts_words(W, rf, rp), W);
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
    out[static_cast<size_t>(i) * batch + b] = canonical(x[i]);
  }
}

__device__ __forceinline__ void cp_async8(uint64_t* dst, const uint64_t* src) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src) : "memory");
}

// Words [ch * kChunk, ch * kChunk + kChunk) of the block's rows (those that
// exist) into buf, row r at r * kStride, as one cp.async group.
__device__ __forceinline__ void stage_chunk(uint64_t* buf, const uint64_t* rows, int row0,
                                            int batch, int len, int ch) {
  for (int i = threadIdx.x; i < blockDim.x * kChunk; i += blockDim.x) {
    const int r = i / kChunk, col = i % kChunk;
    const int word = ch * kChunk + col;
    if (row0 + r < batch && word < len) {
      cp_async8(buf + r * kStride + col, rows + static_cast<size_t>(row0 + r) * len + word);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int W>
__global__ void __launch_bounds__(kMaxThreads)
    sponge_kernel(const uint64_t* __restrict__ rows, uint64_t* __restrict__ digest,
                  const uint64_t* __restrict__ consts, int rf, int rp, int batch, int len) {
  extern __shared__ uint64_t c[];
  const int ncon = consts_words(W, rf, rp);
  load_constants(c, consts, ncon, W);
  uint64_t* stage = c + ncon + W;  // two buffers of blockDim.x * kStride words
  const int row0 = blockIdx.x * blockDim.x;
  const int b = row0 + threadIdx.x;
  uint64_t x[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = 0;
  }
  x[kRate] = static_cast<uint64_t>(len);  // below q: the length domain tag
  const int perms = len > 0 ? (len + kRate - 1) / kRate : 1;
  const int chunks = (len + kChunk - 1) / kChunk;
  if (len > 0) {
    stage_chunk(stage, rows, row0, batch, len, 0);
  }
  for (int j = 0; j < perms; ++j) {
    const int ch = j / (kChunk / kRate), part = j % (kChunk / kRate);
    const uint64_t* buf = stage + (ch & 1) * blockDim.x * kStride;
    if (len > 0 && part == 0) {
      __syncthreads();  // every thread is done with the buffer refilled next
      if (ch + 1 < chunks) {
        stage_chunk(stage + ((ch + 1) & 1) * blockDim.x * kStride, rows, row0, batch, len,
                    ch + 1);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncthreads();  // chunk ch, copied by every thread, is in place
    }
    const uint64_t* mine = buf + threadIdx.x * kStride + part * kRate;
    const int off = j * kRate;
#pragma unroll
    for (int i = 0; i < kRate; ++i) {
      if (off + i < len) {
        x[i] = add_any(x[i], mine[i]);
      }
    }
    permute_state<W>(x, c, rf, rp);
  }
  if (b < batch) {
#pragma unroll
    for (int i = 0; i < kRate; ++i) {
      digest[static_cast<size_t>(i) * batch + b] = canonical(x[i]);
    }
  }
}

// Rows of poseidon_field_probe's output, each n words.
constexpr int kProbeRows = 10 + 2 * (8 + 12);

// Element i of the probe: the core on a = a[i], b = b[i], c = c[i], each any
// 64-bit word, and the two layers on lanes drawn from the three arrays.
// Rows: 0 add_any(a, b); 1 it canonical; 2 mul(a, b); 3 it canonical;
// 4 mul_add(a, canonical(b), a + c) (a 96-bit addend); 5 it canonical;
// 6 add_reduced(a, canonical(b)); 7 it canonical; 8 canonical(a); 9 the
// S-box of a, canonical; then, for W = 8 and then 12, with lane j the word
// j % 4 places on of a (lanes 0-3), b (4-7) or c (8-11) and d_j =
// canonical(c[i + j]): W rows of the external layer plus d, canonical, and
// W rows of the internal layer with diagonal-minus-one d, canonical.
template <int W>
__device__ __forceinline__ void probe_layers(const uint64_t* a, const uint64_t* b,
                                             const uint64_t* c, uint64_t* out, int n, int i,
                                             int row) {
  uint64_t x[W], y[W], d[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t* src = j < 4 ? a : j < 8 ? b : c;
    x[j] = y[j] = src[(i + j % 4) % n];
    d[j] = canonical(c[(i + j) % n]);
  }
  external<W>(x, d);
  internal<W>(y, d);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    out[static_cast<size_t>(row + j) * n + i] = canonical(x[j]);
    out[static_cast<size_t>(row + W + j) * n + i] = canonical(y[j]);
  }
}

__global__ void probe_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                             const uint64_t* __restrict__ c, uint64_t* __restrict__ out,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const uint64_t x = a[i], y = b[i], z = c[i];
  const uint64_t r[] = {add_any(x, y), mul(x, y), mul_add(x, canonical(y), add(x, z)),
                        add_reduced(x, canonical(y))};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[static_cast<size_t>(2 * k) * n + i] = r[k];
    out[static_cast<size_t>(2 * k + 1) * n + i] = canonical(r[k]);
  }
  out[static_cast<size_t>(8) * n + i] = canonical(x);
  out[static_cast<size_t>(9) * n + i] = canonical(sbox(x));
  probe_layers<8>(a, b, c, out, n, i, 10);
  probe_layers<12>(a, b, c, out, n, i, 26);
}

bool bad_args(int width, int rf, int rp, int batch) {
  return (width != 8 && width != 12) || rf < 2 || rf % 2 || rp < 0 ||
         batch < 1 || consts_words(width, rf, rp) > kMaxConsts;
}

int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev]) {
    return cached[dev];
  }
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1) {
    sms = 132;
  }
  if (dev >= 0 && dev < 64) {
    cached[dev] = sms;
  }
  return sms;
}

// 128 threads a block, halved down to 32 while the batch would leave an SM
// without a block.
int threads_for(int batch) {
  const int sms = sm_count();
  int threads = kMaxThreads;
  while (threads > 32 && (batch + threads - 1) / threads < sms) {
    threads /= 2;
  }
  return threads;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int batch, int threads, size_t smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      return err;
    }
  }
  kernel<<<(batch + threads - 1) / threads, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

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
  const size_t smem = (consts_words(width, rf, rp) + width) * sizeof(uint64_t);
  const auto* in = static_cast<const uint64_t*>(state);
  auto* o = static_cast<uint64_t*>(out);
  const auto* c = static_cast<const uint64_t*>(consts);
  const int threads = threads_for(batch);
  return launch(width == 8 ? &permute_kernel<8> : &permute_kernel<12>, batch, threads, smem,
                stream, in, o, c, rf, rp, batch);
}

extern "C" int poseidon_sponge(const void* rows, void* digest, const void* consts,
                               int width, int rf, int rp, int batch, int len,
                               void* stream) {
  if (bad_args(width, rf, rp, batch) || len < 0) {
    return cudaErrorInvalidValue;
  }
  const int threads = threads_for(batch);
  const size_t smem =
      (consts_words(width, rf, rp) + width + 2 * threads * kStride) * sizeof(uint64_t);
  const auto* in = static_cast<const uint64_t*>(rows);
  auto* o = static_cast<uint64_t*>(digest);
  const auto* c = static_cast<const uint64_t*>(consts);
  return launch(width == 8 ? &sponge_kernel<8> : &sponge_kernel<12>, batch, threads, smem,
                stream, in, o, c, rf, rp, batch, len);
}

// The arithmetic core on n operand triples (a, b, c), any 64-bit words:
// a (kProbeRows, n) array of results, the rows as probe_kernel lists them.
extern "C" int poseidon_field_probe(const void* a, const void* b, const void* c, void* out,
                                    int n, void* stream) {
  if (n < 1) {
    return cudaErrorInvalidValue;
  }
  probe_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<const uint64_t*>(c), static_cast<uint64_t*>(out), n);
  return cudaGetLastError();
}

extern "C" const char* poseidon_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

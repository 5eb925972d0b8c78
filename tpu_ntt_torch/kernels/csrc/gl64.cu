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
//   gl64_forward_cols, gl64_inverse_cols  the same two on every column of
//                 (R, n, width) natural rows: the four-step's column pass
//                 (tpu_ntt_torch/sharded.py), where JAX moves the axis in
//                 XLA around the same two kernels (tpu_ntt/sharded.py:419-442)
//   gl64_dot      _make_dot_kernel (:1599) through _dot_call (:2238)
//   gl64_matvec   _make_matvec_kernel (:1639) through nwc_matvec_cached
//                 (:2305), after gl64_forward has transformed s
// and, as the row pass of the four-step that serves 8192 < n <= 2^20
// (tpu_ntt_torch/sharded.py, where gl64_forward_cols and gl64_inverse_cols
// run the column pass; JAX runs GoldilocksPlan64's split bodies at 16384
// and 32768 and its kernel four-step with XLA mids above), K1a's large-n
// bodies at the Goldilocks q, the counterparts of nwc64.cu's nwc64_*_scaled:
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
// Two cores, as in nwc64.cu.  Thirteen entry points run the radix-8 core
// ("The radix-8 core" below): gl64_forward, gl64_inverse and their column
// entry points; the row forward gl64_forward_scaled, the entry scale and
// one forward on it, and the row inverse gl64_inverse_scaled, one inverse
// and the exit scale; and, fused onto it ("The products fused on the
// radix-8 core"), both forwards, the slot product and the inverse in one
// kernel a launch: K2's flat product gl64_product and gl64_cached, and the
// four-step's row pass gl64_cyclic_scaled and gl64_cached_scaled, with the
// entry and exit scales; the dots ("The dot fused on the radix-8 core"), a
// forward a loop step and one inverse: K2's flat gl64_dot and, with the
// scales, the four-step's row pass gl64_dot_scaled; and the four-step's row
// pass of the matvec gl64_matvec_scaled, a sum of slot products a loop step
// and one inverse.  The other one (gl64_matvec) runs the first core's
// inverse, correct first and simple, until it moves onto the radix-8 one.
// The network code of both is a copy of nwc64.cu's rather than a header
// shared by both, so nwc64.cu is not changed and its functions and times
// stay as they were; the arithmetic differs.  The first core:
// * One thread block per output row, the row in dynamic shared memory, 8n
//   bytes.  n / 8 threads (at most 1024), four butterflies each, from
//   n = 256 on; below, a warp, or n / 2 (the four-step's sub-sizes).
// * A Gentleman-Sande inverse (bit-reversed in, natural out),
//   __syncthreads between stages; the stage with m groups reads entry
//   m + g of a flat length-n table of plain twiddles.
// * Every product is gl_mul: the 128-bit product from a * b and
//   __umul64hi, reduced by the phi-fold (2^96 = -1, 2^64 = 2^32 - 1 mod q:
//   shifts, adds and one conditional subtract, no multiply).  Shoup's form
//   needs q < 2^63, so twiddles and scales are plain values and the cached
//   spectra are in the plain domain (gl64.py:75-77): a slot product needs
//   no domain scale, and the n^-1 of the inverse is one gl_mul by the scale
//   the wrapper passes.
// * A sum of two residues can pass 2^64 here (nwc64.cu's add_mod assumes it
//   cannot): gl_add takes the carry as 2^64 = q + (2^32 - 1).
// * Every value stays canonical in [0, q), also through the matvec's
//   accumulation.
//
// What bounds both cores on this card: the multiplies, as in nwc64.cu.
// Hopper builds a 64 x 64 -> 128 product from about eight 32-bit IMADs (the
// phi-fold adds none), against about twelve for a Shoup-64 or Montgomery-64
// product, so a Goldilocks butterfly has two thirds of a 60-bit one's
// multiplies; at goldilocks_4096, B = 2048, the product needs 1.3e9 IMADs,
// 0.08 ms at 132 SMs x 64 a clock x 1.98 GHz, against 201 MB of operands
// and result, 0.06 ms at 3.35 TB/s.  What holds the first core back is what
// held nwc64.cu's first core back (PERF.md): instruction issue and latency
// between the __syncthreads of every stage.

#include <cstdint>

#include <cuda_runtime.h>

// ---------------------------------------------------------------------------
// The radix-8 core's carry chains, each kept whole in one asm statement
// (the carry flag does not survive between two).  WIDE, FOLD128, ADD64 and
// ADD_REDUCED are poseidon.cu's, SUB_REDUCED, ADD_ANY and SUB_ANY
// this file's; tests/test_torch_gl64_radix.py reads these strings and runs
// them on a model of the 32-bit instructions, so the operand numbers in
// each comment are part of the contract with that test.
// ---------------------------------------------------------------------------

// a * b + c + e * 2^64 as four words r0..r3 from the four 32 x 32 partial
// products.  %0-%3 r0..r3; %4-%6 m0..m2; %7, %8 a0, a1; %9, %10 b0, b1;
// %11, %12 c0, c1; %13 e.  Exact when the sum is below 2^128.
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
// {-1, 0, 1}.  %0, %1 t0, t1; %2 k; %3-%6 r0..r3; %7 eps = 2^32 - 1.
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

// a + b for b below q: a carry out of 64 bits adds eps, and then a + b -
// 2^64 < q keeps the sum below 2^64.  %0, %1 t0, t1; %2 c; %3, %4 a0, a1;
// %5, %6 b0, b1; %7 eps.
#define GL_PTX_ADD_REDUCED             \
  "add.cc.u32 %0, %3, %5;\n\t"         \
  "addc.cc.u32 %1, %4, %6;\n\t"        \
  "addc.u32 %2, 0, 0;\n\t"             \
  "mad.lo.cc.u32 %0, %2, %7, %0;\n\t"  \
  "addc.u32 %1, %1, 0;"

// a - b for b below q: a borrow (2^64 added) takes eps off, and a - b +
// 2^64 > 2^64 - q = 2^32 - 1 keeps that from wrapping.  %0, %1 t0, t1; %2
// m (eps after a borrow, else 0); %3, %4 a0, a1; %5, %6 b0, b1.
#define GL_PTX_SUB_REDUCED             \
  "sub.cc.u32 %0, %3, %5;\n\t"         \
  "subc.cc.u32 %1, %4, %6;\n\t"        \
  "subc.u32 %2, 0, 0;\n\t"             \
  "sub.cc.u32 %0, %0, %2;\n\t"         \
  "subc.u32 %1, %1, 0;"

// a + b for any words: the carry adds eps, which can carry once more (only
// where a + b > 2^65 - 2^32, so both are at least q) and then leaves a sum
// below 2^33.  %0, %1 t0, t1; %2 c; %3, %4 a0, a1; %5, %6 b0, b1; %7 eps.
#define GL_PTX_ADD_ANY                 \
  "add.cc.u32 %0, %3, %5;\n\t"         \
  "addc.cc.u32 %1, %4, %6;\n\t"        \
  "addc.u32 %2, 0, 0;\n\t"             \
  "mad.lo.cc.u32 %0, %2, %7, %0;\n\t"  \
  "addc.cc.u32 %1, %1, 0;\n\t"         \
  "addc.u32 %2, 0, 0;\n\t"             \
  "mad.lo.cc.u32 %0, %2, %7, %0;\n\t"  \
  "addc.u32 %1, %1, 0;"

// a - b for any words: the borrow takes eps off, which can borrow once
// more (only where b - a >= q, so b is at least q) and then leaves a
// difference above 2^64 - 2^33.  %0, %1 t0, t1; %2 m; %3, %4 a0, a1; %5,
// %6 b0, b1.
#define GL_PTX_SUB_ANY                 \
  "sub.cc.u32 %0, %3, %5;\n\t"         \
  "subc.cc.u32 %1, %4, %6;\n\t"        \
  "subc.u32 %2, 0, 0;\n\t"             \
  "sub.cc.u32 %0, %0, %2;\n\t"         \
  "subc.cc.u32 %1, %1, 0;\n\t"         \
  "subc.u32 %2, 0, 0;\n\t"             \
  "sub.cc.u32 %0, %0, %2;\n\t"         \
  "subc.u32 %1, %1, 0;"

namespace {

constexpr uint64_t kQ = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod q = 2^32 - 1
constexpr uint32_t kEps32 = 0xFFFFFFFFu;

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

// ---------------------------------------------------------------------------
// The radix-8 core: gl64_forward, gl64_inverse, gl64_forward_cols and
// gl64_inverse_cols.  The schedule is nwc64.cu's radix-8 core, copied (so
// nwc64.cu and its measured times stay as they were): a thread holds
// kWords = 8 words and a pass runs three stages on them in registers, one
// barrier a pass (the first pass in forward order takes log n mod 3
// stages, 3 if that is 0); the first pass loads straight from device
// memory and the last stores straight to it; shared memory holds only the
// exchange between passes, word a of the tile at a ^ ((a >> 3) & 15); the
// twiddles come a pass at a time from host-built tables
// (mxu64.pass_table), here the 1-tuple (w,) of plain values; a block holds
// 1024 / n rows up to n = 1024, or a tile of max(8, 1024 / n) adjacent
// columns up to n = 1024, then 8192 / n; __launch_bounds__ keeps 1024
// threads of an SM resident.  nwc64.cu's header says why each piece is so.
//
// The arithmetic is what differs.  Harvey's lanes below 4q do not exist
// here (q > 2^63): the only slack is that every 64-bit word is one of at
// most two representatives of its residue (2^64 < 2q).  So a lane is ANY
// 64-bit word congruent to its value, and the store makes it canonical
// once.  Each step is a carry chain in PTX (the GL_PTX_* strings above:
// four of poseidon.cu's and three of this file's), whose ranges
// tests/test_torch_gl64_radix.py runs on a model of the 32-bit
// instructions:
// * the product, mul_lazy: any a, b -> a word congruent to a * b (the
//   phi-fold, no compare);
// * the forward's CT butterfly: v = canonical(mul_lazy(y, w)) is below q,
//   so x + v and x - v need one carry (borrow) fix each for any word x;
// * the inverse's GS butterfly: x + y and x - y of two arbitrary words
//   may carry (borrow) twice, so each takes two fixes, and the product of
//   the difference stays lazy.
// Against the first core's canonical gl_add, gl_sub and gl_mul that drops
// the sum's compare from every forward butterfly and the product's compare
// from every inverse one.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lo32(uint64_t x) { return static_cast<uint32_t>(x); }
__device__ __forceinline__ uint32_t hi32(uint64_t x) {
  return static_cast<uint32_t>(x >> 32);
}
__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// A word congruent to a * b for any words a, b: a * b < 2^128, folded.
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  uint32_t r0, r1, r2, r3, m0, m1, m2;
  asm(GL_PTX_WIDE
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3), "=&r"(m0), "=&r"(m1), "=&r"(m2)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)), "r"(0u), "r"(0u),
        "r"(0u));
  uint32_t t0, t1, k;
  asm(GL_PTX_FOLD128
      : "=&r"(t0), "=&r"(t1), "=&r"(k)
      : "r"(r0), "r"(r1), "r"(r2), "r"(r3), "r"(kEps32));
  // t + k eps lies in [0, 2^64): the words of k eps mod 2^64 are (-k, k >> 31)
  asm(GL_PTX_ADD64 : "+r"(t0), "+r"(t1) : "r"(0u - k), "r"(static_cast<uint32_t>(
      static_cast<int32_t>(k) >> 31)));
  return join(t0, t1);
}

// Any word -> [0, q): a word at or above q is below 2q.
__device__ __forceinline__ uint64_t canonical(uint64_t x) { return x >= kQ ? x - kQ : x; }

// a + b for any word a and b below q: one carry fix (a + b - 2^64 < q).
__device__ __forceinline__ uint64_t add_reduced(uint64_t a, uint64_t b) {
  uint32_t t0, t1, c;
  asm(GL_PTX_ADD_REDUCED
      : "=&r"(t0), "=&r"(t1), "=&r"(c)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)), "r"(kEps32));
  return join(t0, t1);
}

// a - b for any word a and b below q: one borrow fix (a - b + 2^64 >= 2^32).
__device__ __forceinline__ uint64_t sub_reduced(uint64_t a, uint64_t b) {
  uint32_t t0, t1, m;
  asm(GL_PTX_SUB_REDUCED
      : "=&r"(t0), "=&r"(t1), "=&r"(m)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(t0, t1);
}

// a + b for any words: two carry fixes.
__device__ __forceinline__ uint64_t add_any(uint64_t a, uint64_t b) {
  uint32_t t0, t1, c;
  asm(GL_PTX_ADD_ANY
      : "=&r"(t0), "=&r"(t1), "=&r"(c)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)), "r"(kEps32));
  return join(t0, t1);
}

// a - b for any words: two borrow fixes.
__device__ __forceinline__ uint64_t sub_any(uint64_t a, uint64_t b) {
  uint32_t t0, t1, m;
  asm(GL_PTX_SUB_ANY
      : "=&r"(t0), "=&r"(t1), "=&r"(m)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(t0, t1);
}

// Cooley-Tukey: x, y any words in, and out; w < q.
__device__ __forceinline__ void ct(uint64_t& x, uint64_t& y, uint64_t w) {
  const uint64_t u = x;
  const uint64_t v = canonical(mul_lazy(y, w));  // [0, q)
  x = add_reduced(u, v);  // any word
  y = sub_reduced(u, v);  // any word
}

// Gentleman-Sande: x, y any words in, and out.
__device__ __forceinline__ void gs(uint64_t& x, uint64_t& y, uint64_t w) {
  const uint64_t u = x, v = y;
  x = add_any(u, v);                // any word
  y = mul_lazy(sub_any(u, v), w);   // any word
}

constexpr int kWords = 8;  // words a thread holds in every pass

__host__ __device__ constexpr int first_stages(int log_n) {
  return log_n - 3 * ((log_n - 1) / 3);
}
__host__ __device__ constexpr int passes(int log_n) { return (log_n - 1) / 3 + 1; }
// the first stage of pass p (forward order) and its stages
__host__ __device__ constexpr int pass_stage(int log_n, int p) {
  return p == 0 ? 0 : first_stages(log_n) + 3 * (p - 1);
}
__host__ __device__ constexpr int pass_stages(int log_n, int p) {
  return p == 0 ? first_stages(log_n) : 3;
}
// pass p's table begins after 2^(stages + stage) words of each earlier pass
__host__ __device__ constexpr int pass_offset(int log_n, int p) {
  int off = 0;
  for (int k = 0; k < p; ++k) {
    off += 1 << (pass_stages(log_n, k) + pass_stage(log_n, k));
  }
  return off;
}
// transforms a block: rows, or columns of the tile
__host__ __device__ constexpr int tile(int log_n, bool cols) {
  const int n = 1 << log_n;
  if (!cols) {
    return n >= 1024 ? 1 : 1024 / n;
  }
  const int least = 1024 / n > 8 ? 1024 / n : 8;
  return least < 8192 / n ? least : 8192 / n;
}
__host__ __device__ constexpr int block_threads(int log_n, bool cols) {
  return tile(log_n, cols) * ((1 << log_n) / kWords);
}

// Stage s + d's 2^d twiddles of group hi in pass table tw at stage s:
// column 0 for d = 0, columns [2^(d - 1), 2^d) after.
template <int kS, int kD>
__device__ __forceinline__ void stage_twiddles(const uint64_t* tw, int hi, uint64_t (&w)[4]) {
  constexpr int kFirst = kD == 0 ? 0 : (1 << kD) / 2;
  constexpr int kCount = kD == 0 ? 1 : (1 << kD) / 2;
  const ulonglong2* pw = reinterpret_cast<const ulonglong2*>(tw);
#pragma unroll
  for (int m = 0; m < kCount; ++m) {
    const ulonglong2 a = __ldg(pw + ((kFirst + m) << kS) + hi);
    w[2 * m] = a.x;
    w[2 * m + 1] = a.y;
  }
}

// One stage of a pass: register k of each group of 2^kR meets k + span.
template <int kS, int kR, int kD, bool kInverse>
__device__ __forceinline__ void stage(uint64_t (&x)[kWords], const uint64_t* tw, int hi) {
  constexpr int kGroup = 1 << kR, kSpan = kGroup >> (kD + 1);
  uint64_t w[4];
  stage_twiddles<kS, kD>(tw, hi, w);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    const int k = r % kGroup;
    if (!(k & kSpan)) {
      const int e = k >> (kR - kD);  // the group's twiddle at this stage
      if constexpr (kInverse) {
        gs(x[r], x[r + kSpan], w[e]);
      } else {
        ct(x[r], x[r + kSpan], w[e]);
      }
    }
  }
}

// Pass (kS, kR): the forward's stages in order, the inverse's reversed.
template <int kS, int kR, bool kInverse>
__device__ __forceinline__ void run_pass(uint64_t (&x)[kWords], const uint64_t* tw, int hi) {
  if constexpr (kInverse) {
    if constexpr (kR > 2) stage<kS, kR, 2, true>(x, tw, hi);
    if constexpr (kR > 1) stage<kS, kR, 1, true>(x, tw, hi);
    stage<kS, kR, 0, true>(x, tw, hi);
  } else {
    stage<kS, kR, 0, false>(x, tw, hi);
    if constexpr (kR > 1) stage<kS, kR, 1, false>(x, tw, hi);
    if constexpr (kR > 2) stage<kS, kR, 2, false>(x, tw, hi);
  }
}

// Element of register r in pass (kS, kR) for thread t of its transform:
// register c * 2^kR + k holds element k of group j = t + c * n / 8, which
// is hi * 2^kR * T + k * T + lo with T = n >> (kS + kR), (hi, lo) = j / T,
// j % T.
template <int kLogN, int kS, int kR>
__device__ __forceinline__ int element(int t, int r) {
  constexpr int kT = (1 << kLogN) >> (kS + kR);
  const int j = t + (r >> kR) * ((1 << kLogN) / kWords);
  return (j / kT) * (kT << kR) + (r % (1 << kR)) * kT + j % kT;
}

// The group of thread t in a pass of three stages at kS (its twiddles' hi).
template <int kLogN, int kS>
__device__ __forceinline__ int group(int t) {
  return t / ((1 << kLogN) >> (kS + 3));
}

// Word a of the tile in shared memory, swizzled.
template <int kLogN, bool kCols>
__device__ __forceinline__ int tile_word(int g, int i) {
  const int a = kCols ? i * tile(kLogN, true) + g : g * (1 << kLogN) + i;
  return a ^ ((a >> 3) & 15);
}

template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void to_shared(const uint64_t (&x)[kWords], uint64_t* smem, int g,
                                          int t) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    smem[tile_word<kLogN, kCols>(g, element<kLogN, kS, kR>(t, r))] = x[r];
  }
}

template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void from_shared(uint64_t (&x)[kWords], const uint64_t* smem, int g,
                                            int t) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = smem[tile_word<kLogN, kCols>(g, element<kLogN, kS, kR>(t, r))];
  }
}

// Pass kP's words from device memory: row (or column) `at`, `stride`
// words between elements; on rows in the last pass, four 16-byte vectors.
template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void load(uint64_t (&x)[kWords], const uint64_t* in, size_t at,
                                     size_t stride, int t, bool live) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
  if constexpr (!kCols && kS + kR == kLogN && kR == 3) {  // element 8t + r
    const ulonglong2* v = reinterpret_cast<const ulonglong2*>(in + at + kWords * t);
#pragma unroll
    for (int m = 0; m < kWords / 2; ++m) {
      const ulonglong2 p = live ? v[m] : make_ulonglong2(0, 0);
      x[2 * m] = p.x;
      x[2 * m + 1] = p.y;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = live ? in[at + element<kLogN, kS, kR>(t, r) * stride] : 0;
  }
}

template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void store(const uint64_t (&x)[kWords], uint64_t* out, size_t at,
                                      size_t stride, int t, bool live) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
  if (!live) {
    return;
  }
  if constexpr (!kCols && kS + kR == kLogN && kR == 3) {
    ulonglong2* v = reinterpret_cast<ulonglong2*>(out + at + kWords * t);
#pragma unroll
    for (int m = 0; m < kWords / 2; ++m) {
      v[m] = make_ulonglong2(x[2 * m], x[2 * m + 1]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    out[at + element<kLogN, kS, kR>(t, r) * stride] = x[r];
  }
}

// Passes kP, kP + 1, ... of the forward, each after the exchange with the
// pass before it.
template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void forward_passes(uint64_t (&x)[kWords], uint64_t* smem,
                                               const uint64_t* tw, int g, int t) {
  if constexpr (kP < passes(kLogN)) {
    constexpr int kS = pass_stage(kLogN, kP), kOff = pass_offset(kLogN, kP);
    to_shared<kLogN, kCols, kP - 1>(x, smem, g, t);
    __syncthreads();
    from_shared<kLogN, kCols, kP>(x, smem, g, t);
    run_pass<kS, 3, false>(x, tw + kOff, group<kLogN, kS>(t));
    forward_passes<kLogN, kCols, kP + 1>(x, smem, tw, g, t);
  }
}

// Passes kP, kP - 1, ... 0 of the inverse.
template <int kLogN, bool kCols, int kP>
__device__ __forceinline__ void inverse_passes(uint64_t (&x)[kWords], uint64_t* smem,
                                               const uint64_t* tw, int g, int t) {
  if constexpr (kP >= 0) {
    constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
    constexpr int kOff = pass_offset(kLogN, kP);
    to_shared<kLogN, kCols, kP + 1>(x, smem, g, t);
    __syncthreads();
    from_shared<kLogN, kCols, kP>(x, smem, g, t);
    run_pass<kS, kR, true>(x, tw + kOff, kP == 0 ? 0 : group<kLogN, kS>(t));
    inverse_passes<kLogN, kCols, kP - 1>(x, smem, tw, g, t);
  }
}

// The forward's store: any word -> [0, q), times `scale` (one lazy product)
// unless it is 1, then the one compare.
__device__ __forceinline__ void forward_out(uint64_t (&x)[kWords], uint64_t scale) {
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = canonical(scale == 1 ? x[r] : mul_lazy(x[r], scale));
  }
}

// The transforms of `transforms` rows (kCols false: row r at r * n) or
// columns (column c of matrix m at m * n * width + c, `width` words between
// its elements) from `in` to `out`, each then times `scale` (the forward
// skips scale 1).  Table: the per-pass layout of mxu64.pass_table.
template <int kLogN, bool kInverse, bool kCols>
__global__ void __launch_bounds__(block_threads(kLogN, kCols),
                                  1024 / block_threads(kLogN, kCols))
    transform_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                     const uint64_t* __restrict__ pt, long long transforms, int width,
                     uint64_t scale) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, kCols);
  constexpr int kLast = passes(kLogN) - 1;
  const int tid = threadIdx.x;
  const int g = kCols ? tid % kTile : tid / kPer;
  const int t = kCols ? tid / kTile : tid % kPer;
  const long long tg = static_cast<long long>(blockIdx.x) * kTile + g;
  const bool live = tg < transforms;
  const size_t at = !live ? 0
                    : kCols ? static_cast<size_t>(tg / width) * kN * width + tg % width
                            : static_cast<size_t>(tg) * kN;
  const size_t stride = kCols ? width : 1;
  uint64_t x[kWords];
  if constexpr (!kInverse) {
    load<kLogN, kCols, 0>(x, in, at, stride, t, live);  // [0, q): any words
    run_pass<0, first_stages(kLogN), false>(x, pt, 0);
    forward_passes<kLogN, kCols, 1>(x, smem, pt, g, t);
    forward_out(x, scale);
    store<kLogN, kCols, kLast>(x, out, at, stride, t, live);
  } else {
    load<kLogN, kCols, kLast>(x, in, at, stride, t, live);  // [0, q): any words
    constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
    run_pass<kS, 3, true>(x, pt + kOff, group<kLogN, kS>(t));
    inverse_passes<kLogN, kCols, kLast - 1>(x, smem, pt, g, t);
#pragma unroll
    for (int r = 0; r < kWords; ++r) {  // any word -> [0, q)
      x[r] = canonical(mul_lazy(x[r], scale));
    }
    store<kLogN, kCols, 0>(x, out, at, stride, t, live);
  }
}

// x times the words of table row `srow` at pass kP's positions: any words.
template <int kLogN, int kP>
__device__ __forceinline__ void times_row(uint64_t (&x)[kWords], const uint64_t* table,
                                          size_t srow, int t) {
  constexpr int kS = pass_stage(kLogN, kP), kR = pass_stages(kLogN, kP);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = mul_lazy(x[r], __ldg(table + srow + element<kLogN, kS, kR>(t, r)));
  }
}

// The four-step's row forward on the radix-8 core (gl64_forward_scaled):
// out = NTT(pre . in) * scale on `rows` rows, row r scaled by row r % period
// of the (period, n) table pre of plain values.  pre's product is one
// mul_lazy a word on the words the first pass loads, its table words read
// at the same positions (from L2): any words, which the CT butterfly takes;
// then the forward's passes and the transforms' store (forward_out) of
// spectrum words 8t ... 8t + 7.  Rows tile a block as in the transforms, at
// their 1024 threads an SM: a pre word has no Shoup companion, so the scale
// costs a thread 16 registers where nwc64.cu's pairs cost 32 (and spilled
// there at 1024 threads); here nothing spills, and 1024 ran 0.3 % faster
// than 512 (tools/gl64_variants.py, PERF.md).
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN, false),
                                  1024 / block_threads(kLogN, false))
    forward_scaled_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                          const uint64_t* __restrict__ tw, const uint64_t* __restrict__ pre,
                          int period, int rows, uint64_t scale) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  const size_t srow = live ? static_cast<size_t>(row % period) * kN : 0;
  uint64_t x[kWords];
  load<kLogN, false, 0>(x, in, at, 1, t, live);  // [0, q)
  times_row<kLogN, 0>(x, pre, srow, t);          // any words
  run_pass<0, first_stages(kLogN), false>(x, tw, 0);
  forward_passes<kLogN, false, 1>(x, smem, tw, g, t);
  forward_out(x, scale);
  store<kLogN, false, passes(kLogN) - 1>(x, out, at, 1, t, live);
}

// The four-step's row inverse on the radix-8 core (gl64_inverse_scaled):
// out = post . INTT(in) * scale on `rows` bit-reversed spectra, row r scaled
// by row r % period of the (period, n) table post of plain values;
// nwc64.cu's row inverse on this file's arithmetic.  The spectrum's words
// 8t ... 8t + 7 (the inverse's first pass; 16-byte vectors), one mul_lazy
// by `scale` (n^-1: any words), the inverse's passes, post's mul_lazy at
// the store's positions (its table words from L2) and the one compare, as
// the fused row pass's tail.  Rows tile a block as in the transforms, at
// 512 threads an SM: ptxas gives a thread 64 registers either way, and 512
// ran 1.3 % faster than the transforms' 1024 at both row shapes
// (tools/gl64_variants.py, PERF.md).
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN, false),
                                  block_threads(kLogN, false) > 256
                                      ? 1
                                      : 512 / block_threads(kLogN, false))
    inverse_scaled_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                          const uint64_t* __restrict__ itw, const uint64_t* __restrict__ post,
                          int period, int rows, uint64_t scale) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  constexpr int kLast = passes(kLogN) - 1;
  constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  const size_t srow = live ? static_cast<size_t>(row % period) * kN : 0;
  uint64_t x[kWords];
  load<kLogN, false, kLast>(x, in, at, 1, t, live);  // words 8t ... 8t + 7, [0, q)
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // any words
    x[r] = mul_lazy(x[r], scale);
  }
  run_pass<kS, 3, true>(x, itw + kOff, group<kLogN, kS>(t));
  inverse_passes<kLogN, false, kLast - 1>(x, smem, itw, g, t);
  times_row<kLogN, 0>(x, post, srow, t);  // the store's positions
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // any word -> [0, q)
    x[r] = canonical(x[r]);
  }
  store<kLogN, false, 0>(x, out, at, 1, t, live);
}

// The products fused on the radix-8 core, one kernel a launch; device
// memory sees each operand and the result once.  nwc64.cu's fused product
// on this file's arithmetic: the forward of b, the forward of a, the slot
// product in registers (after the forward's last pass thread t holds
// spectrum words 8t ... 8t + 7 of its row, where the inverse's first pass
// starts), the inverse, one compare at the store.  The slot is
// mul_lazy(mul_lazy(x, y), scale): any words in and out, `scale` the n^-1
// the wrapper passes.  A cached b is a spectrum, loaded as 16-byte vectors
// where a's forward leaves its words, and neither scaled nor transformed.
// * kScaled, the four-step's row pass (gl64_cyclic_scaled,
//   gl64_cached_scaled): post . INTT(NTT(pre . a) o NTT(pre . b)) * scale,
//   row r scaled by row r % period of the (period, n) tables pre and post.
//   The entry scale is one product a word on the words the first pass
//   loads, its table words taken at the same positions (from L2); the exit
//   scale one product a word before the store's compare.
// * Without, K2's flat product (gl64_product, gl64_cached): INTT(NTT(a) o
//   NTT(b)) * scale on merged or cyclic tables; pre, post and period unused.
// b's spectrum waits in eight more registers a thread, or in the output row
// at the thread's own words (16-byte vectors written after b's forward and
// read back, mostly from L2, before the slot product; the result
// overwrites them), as in nwc64.cu.  The row pass keeps it in registers
// below n = 8192 (kSpectrumInRegisters); the flat product in the output
// row at every n, so that its 64-register threads run 1024 an SM: two
// blocks of 512 at n = 4096, where registers leave one and ran 2.0 %
// slower.  A second tile of shared memory, tried too, ran 2.7 % faster
// than the output row but spilled 8 to 36 bytes at five log n
// (tools/gl64_variants.py, PERF.md).
constexpr bool kSpectrumInRegisters = true;

// Whether b's spectrum waits in registers at log n: at 1024 threads a block
// (n = 8192) 64 registers a thread are all an SM has.
__host__ __device__ constexpr bool spectrum_in_registers(int log_n, bool scaled) {
  return scaled && kSpectrumInRegisters && block_threads(log_n, false) < 1024;
}
// Blocks an SM for __launch_bounds__: 1024 threads at 64 registers, or 640
// (96 registers; 512 at n = 2048 and 4096, 128) when b's spectrum takes its
// eight registers more.
__host__ __device__ constexpr int product_blocks(int log_n, bool cached, bool scaled) {
  const int threads = block_threads(log_n, false);
  if (cached || !spectrum_in_registers(log_n, scaled)) {
    return 1024 / threads;
  }
  return threads > 384 ? 1 : 640 / threads;
}
// v, which the compiler must take as new: each phase of the fused kernel
// (b's forward, a's, the inverse: the same words) computes its swizzled
// shared-memory addresses again from it, and a's forward reads its
// twiddles through an opaque table pointer, where opaque_phases holds: where
// a thread has 64 registers (n = 8192; the fresh flat product, whose b
// spectrum waits in the output row, at every n), the compiler would keep
// the first phase's addresses and twiddles live through the others and
// spill (ptxas); below, the row pass's 96 or 128 registers hold them, and
// recomputing them costs 7 % (tools/gl64_variants.py).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ const uint64_t* opaque(const uint64_t* p) {
  uintptr_t v = reinterpret_cast<uintptr_t>(p);
  asm volatile("" : "+l"(v));
  return reinterpret_cast<const uint64_t*>(v);
}
__host__ __device__ constexpr bool opaque_phases(int log_n, bool cached, bool scaled) {
  return log_n == 13 || (!cached && !spectrum_in_registers(log_n, scaled));
}

// Tables: the per-pass layout of mxu64.pass_table; pre and post plain rows.
template <int kLogN, bool kCached, bool kScaled>
__global__ void __launch_bounds__(block_threads(kLogN, false),
                                  product_blocks(kLogN, kCached, kScaled))
    cyclic_scaled_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                         uint64_t* __restrict__ out, const uint64_t* __restrict__ tw,
                         const uint64_t* __restrict__ itw, const uint64_t* __restrict__ pre,
                         const uint64_t* __restrict__ post, int period, int rows,
                         uint64_t scale) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  constexpr int kLast = passes(kLogN) - 1;
  constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
  constexpr bool kInRegisters = spectrum_in_registers(kLogN, kScaled);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  const size_t srow = live ? static_cast<size_t>(row % period) * kN : 0;
  uint64_t y[kWords];
  if constexpr (!kCached) {
    load<kLogN, false, 0>(y, b, at, 1, t, live);  // [0, q): any words
    if constexpr (kScaled) {
      times_row<kLogN, 0>(y, pre, srow, t);
    }
    run_pass<0, first_stages(kLogN), false>(y, tw, 0);
    forward_passes<kLogN, false, 1>(y, smem, tw, g, t);
    if constexpr (!kInRegisters) {
      store<kLogN, false, kLast>(y, out, at, 1, t, live);  // words 8t ... 8t + 7
    }
    __syncthreads();  // a's first exchange overwrites the words b's last pass read
  }
  constexpr bool kOpaque = opaque_phases(kLogN, kCached, kScaled);
  const int ga = kOpaque ? opaque(g) : g, ta = kOpaque ? opaque(t) : t;  // a's forward
  const uint64_t* const twa = kOpaque ? opaque(tw) : tw;
  uint64_t x[kWords];
  load<kLogN, false, 0>(x, a, at, 1, ta, live);
  if constexpr (kScaled) {
    times_row<kLogN, 0>(x, pre, srow, ta);
  }
  run_pass<0, first_stages(kLogN), false>(x, twa, 0);
  forward_passes<kLogN, false, 1>(x, smem, twa, ga, ta);
  if constexpr (kCached) {
    load<kLogN, false, kLast>(y, b, at, 1, ta, live);  // [0, q)
  } else if constexpr (!kInRegisters) {
    load<kLogN, false, kLast>(y, out, at, 1, ta, live);  // this thread's own words
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // any words, times n^-1: any word
    x[r] = mul_lazy(mul_lazy(x[r], y[r]), scale);
  }
  const int gi = kOpaque ? opaque(g) : g, ti = kOpaque ? opaque(t) : t;  // the inverse
  run_pass<kS, 3, true>(x, itw + kOff, group<kLogN, kS>(ti));
  inverse_passes<kLogN, false, kLast - 1>(x, smem, itw, gi, ti);
  if constexpr (kScaled) {
    times_row<kLogN, 0>(x, post, srow, ti);  // the store's positions
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // any word -> [0, q)
    x[r] = canonical(x[r]);
  }
  store<kLogN, false, 0>(x, out, at, 1, ti, live);
}

// The dot fused on the radix-8 core (gl64_dot, K1b's body at the Goldilocks
// q): out = INTT(sum_k NTT(a_k) o NTT(b_k)) * scale for (terms, rows, n)
// stacks a and b (b plain-domain spectra with kCached), one output row a
// row, on merged (or cyclic) per-pass tables; nwc64.cu's flat dot on this
// file's arithmetic.  One loop of steps, each one forward on the core: a
// fresh term's b, then its a, whose slot product goes into the sum; a's
// alone against a cached spectrum, whose words are read (16-byte vectors)
// where a's forward leaves its own.  The slot is mul_lazy and the sum
// add_any: lanes are any 64-bit words, and a sum of two can carry twice.
// After the last term one inverse, `scale` (n^-1) one mul_lazy a word and
// one compare at the store, as in the transforms.
// * kScaled, the four-step's row pass (gl64_dot_scaled): out = post .
//   INTT(sum_k NTT(pre . a_k) o NTT(pre . b_k)) * scale, row r scaled by
//   row r % period of the (period, n) tables pre and post, on cyclic
//   tables.  pre is one mul_lazy a word on the words each fresh operand's
//   first pass loads (a cached b is never scaled), its table words read at
//   the same positions (from L2) through a pointer each step takes anew;
//   post one mul_lazy a word after n^-1's, at the store's positions, before
//   the one compare.  A table word has no Shoup companion, so a scale's
//   eight words take 16 registers where nwc64.cu's pairs take 32.
//
// Where the words wait.  After a forward thread t holds spectrum words
// 8t ... 8t + 7 of its row, the words the slot needs, so the sum and a
// fresh b's spectrum are private to the thread: each waits in a tile of
// shared memory of its own beside the exchange's, word r of thread i at
// r * threads + i (a warp's accesses 256 contiguous bytes: no bank conflict,
// no swizzle, one address a thread and constant offsets), 24 KiB a block up
// to n = 1024, 96 KiB at 4096 and 192 KiB at 8192 fresh (two tiles
// cached): two blocks of 512 threads an SM at n = 4096.  A thread keeps only
// the forward's eight lanes (16 registers) through the loop, and each step
// takes its thread indices and twiddle pointer anew (opaque), so that the
// compiler keeps no address or twiddle of one step live into the next:
// 1024 threads an SM, 64 registers a thread, at every n.  At K = 4, B = 512,
// n = 4096, b's spectrum in the output row ran 26 % slower, in registers at
// 512 threads an SM 7 % slower (and spilled at n = 8192), both tiles at
// nwc64.cu's swizzled words 0.8 % slower (tools/gl64_variants.py, PERF.md).
__host__ __device__ constexpr int dot_tiles(bool cached) { return cached ? 2 : 3; }

// Blocks an SM of a dot for __launch_bounds__: the flat dot's 1024 threads
// an SM (64 registers), the row pass's 512 (up to 128 registers), which
// both fit without a spill: at goldilocks_32768's rows 512 ran 0.6 %
// faster fresh and 1.5 % cached (tools/gl64_variants.py, PERF.md).
__host__ __device__ constexpr int dot_blocks(int log_n, bool scaled) {
  const int threads = block_threads(log_n, false);
  return !scaled ? 1024 / threads : threads > 256 ? 1 : 512 / threads;
}

template <int kLogN, bool kCached, bool kScaled>
__global__ void __launch_bounds__(block_threads(kLogN, false), dot_blocks(kLogN, kScaled))
    dot_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
               uint64_t* __restrict__ out, const uint64_t* __restrict__ tw,
               const uint64_t* __restrict__ itw, const uint64_t* __restrict__ pre,
               const uint64_t* __restrict__ post, int period, int terms, int rows,
               uint64_t scale) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  constexpr int kThreads = block_threads(kLogN, false);
  constexpr int kLast = passes(kLogN) - 1;
  constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
  uint64_t* const sum = smem + kTile * kN + threadIdx.x;  // word r at sum[r * kThreads]
  uint64_t* const spectrum = sum + kTile * kN;            // a fresh b's, the same
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int row = blockIdx.x * kTile + g;
  const bool live = row < rows;
  const size_t at = live ? static_cast<size_t>(row) * kN : 0;
  const size_t srow = live ? static_cast<size_t>(row % period) * kN : 0;
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    sum[r * kThreads] = 0;
  }
  const int steps = kCached ? terms : 2 * terms;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const int k = kCached ? step : step / 2;
    const bool of_b = !kCached && step % 2 == 0;  // b's forward of a fresh term
    const size_t ak = live ? (static_cast<size_t>(k) * rows + row) * kN : 0;
    const int gs = opaque(g), ts = opaque(t);
    const uint64_t* const tws = opaque(tw);
    uint64_t x[kWords];
    load<kLogN, false, 0>(x, of_b ? b : a, ak, 1, ts, live);  // [0, q): any words
    if constexpr (kScaled) {
      times_row<kLogN, 0>(x, opaque(pre), srow, ts);          // any words
    }
    run_pass<0, first_stages(kLogN), false>(x, tws, 0);
    forward_passes<kLogN, false, 1>(x, smem, tws, gs, ts);    // words 8t ... 8t + 7
    if (of_b) {
#pragma unroll
      for (int r = 0; r < kWords; ++r) {
        spectrum[r * kThreads] = x[r];
      }
    } else {
      uint64_t y[kWords];
      if constexpr (kCached) {
        load<kLogN, false, kLast>(y, b, ak, 1, ts, live);  // [0, q)
      }
#pragma unroll
      for (int r = 0; r < kWords; ++r) {  // any words
        sum[r * kThreads] =
            add_any(sum[r * kThreads], mul_lazy(x[r], kCached ? y[r] : spectrum[r * kThreads]));
      }
    }
    if (step + 1 < steps) {
      __syncthreads();  // the next step's first exchange overwrites the words this one's read
    }
  }
  const int gi = opaque(g), ti = opaque(t);  // the inverse
  uint64_t x[kWords];
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    x[r] = sum[r * kThreads];
  }
  run_pass<kS, 3, true>(x, itw + kOff, group<kLogN, kS>(ti));
  inverse_passes<kLogN, false, kLast - 1>(x, smem, itw, gi, ti);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // any words
    x[r] = mul_lazy(x[r], scale);
  }
  if constexpr (kScaled) {
    times_row<kLogN, 0>(x, post, srow, ti);  // the store's positions
  }
#pragma unroll
  for (int r = 0; r < kWords; ++r) {  // any word -> [0, q)
    x[r] = canonical(x[r]);
  }
  store<kLogN, false, 0>(x, out, at, 1, ti, live);
}

// The four-step's row pass of the matvec on the radix-8 core
// (gl64_matvec_scaled, K1c's body at the Goldilocks q): out[i, r] = post .
// INTT(sum_j S[j, r] o A[i, j, r % P]) * scale for the (cols, batch, n) row
// spectra S of s (their row forward done by gl64_forward_scaled) and the
// (rows, cols, P, n) rows A of the cached spectra of the matrix, both plain
// (a Goldilocks cached spectrum has domain factor 1, so `cacheable` changes
// nothing and the slot needs no REDC), row r scaled by row r % P of the
// (P, n) table post of plain values, on cyclic per-pass tables: nwc64.cu's
// matvec_kernel on this file's arithmetic, with the row inverse's tail.
// Thread t of output row (i, r) loads, for each j, words 8t ... 8t + 7 of
// S[j, r] and of A[i, j, r % P] as 16-byte vectors: the words where the
// inverse's first pass starts, so no exchange comes before it.  The slot is
// mul_lazy and the sum add_any (any words in and out, the dot's).  Then
// `scale` (n^-1) one mul_lazy a word, the inverse's passes, post's
// mul_lazy at the store's positions and the one compare.  The k output rows
// of one batch row are adjacent (output row o = r * rows + i, rows tiling a
// block as in the transforms), so the words of S a block reads come from
// device memory once and from L2 k - 1 times; A (k l P n words, 4 MiB at
// goldilocks_32768's 4 x 4) stays in L2: with the batch row fastest the
// kernel ran 7.4 % slower there and 37 % slower at 2^20's rows of 1024.
// The sum waits in eight registers a thread, 1024 threads an SM: the
// Goldilocks slot needs no q registers, so ptxas spills nothing at 64 a
// thread, where nwc64.cu's sum spilled and waits in a shared tile; such a
// tile ran 2.6 % slower at goldilocks_32768's rows of 128 and 6.8 % at
// 2^20's rows of 1024, and 512 threads an SM 0.8 % faster and 4.2 %
// slower (tools/gl64_variants.py, PERF.md).
template <int kLogN>
__global__ void __launch_bounds__(block_threads(kLogN, false),
                                  1024 / block_threads(kLogN, false))
    radix_matvec_kernel(const uint64_t* __restrict__ spectra, const uint64_t* __restrict__ mat,
                        uint64_t* __restrict__ out, const uint64_t* __restrict__ itw,
                        const uint64_t* __restrict__ post, int period, int rows, int cols,
                        int batch, uint64_t scale) {
  extern __shared__ uint64_t smem[];
  constexpr int kN = 1 << kLogN, kPer = kN / kWords, kTile = tile(kLogN, false);
  constexpr int kLast = passes(kLogN) - 1;
  constexpr int kS = pass_stage(kLogN, kLast), kOff = pass_offset(kLogN, kLast);
  const int g = threadIdx.x / kPer, t = threadIdx.x % kPer;
  const int o = blockIdx.x * kTile + g;
  const bool live = o < rows * batch;
  const int r = live ? o / rows : 0, i = live ? o % rows : 0;  // batch row, row of A
  const size_t srow = static_cast<size_t>(r % period) * kN;
  uint64_t x[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    x[w] = 0;
  }
#pragma unroll 1
  for (int j = 0; j < cols; ++j) {
    uint64_t s[kWords], a[kWords];
    load<kLogN, false, kLast>(s, spectra, (static_cast<size_t>(j) * batch + r) * kN, 1, t,
                              live);  // [0, q)
    load<kLogN, false, kLast>(a, mat, (static_cast<size_t>(i) * cols + j) * period * kN + srow,
                              1, t, live);  // [0, q)
#pragma unroll
    for (int w = 0; w < kWords; ++w) {  // any words
      x[w] = add_any(x[w], mul_lazy(s[w], a[w]));
    }
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {  // any words
    x[w] = mul_lazy(x[w], scale);
  }
  run_pass<kS, 3, true>(x, itw + kOff, group<kLogN, kS>(t));
  inverse_passes<kLogN, false, kLast - 1>(x, smem, itw, g, t);
  times_row<kLogN, 0>(x, post, srow, t);  // the store's positions
#pragma unroll
  for (int w = 0; w < kWords; ++w) {  // any word -> [0, q)
    x[w] = canonical(x[w]);
  }
  store<kLogN, false, 0>(x, out, (static_cast<size_t>(i) * batch + r) * kN, 1, t, live);
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

template <int kLogN, bool kInverse, bool kCols>
int launch_transform(const void* in, void* out, const void* pt, long long transforms,
                     int width, uint64_t scale, void* stream) {
  constexpr int kTile = tile(kLogN, kCols);
  constexpr int kSmem = kTile * (1 << kLogN) * static_cast<int>(sizeof(uint64_t));
  const long long blocks = (transforms + kTile - 1) / kTile;
  if (blocks > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  auto kernel = transform_kernel<kLogN, kInverse, kCols>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<static_cast<unsigned>(blocks), block_threads(kLogN, kCols), kSmem,
           static_cast<cudaStream_t>(stream)>>>(words(in), static_cast<uint64_t*>(out),
                                                 words(pt), transforms, width, scale);
  return cudaGetLastError();
}

// Whether any pointer is not 16-byte aligned, as the radix-8 core's vector
// loads of tables and rows need.
template <typename... P>
bool misaligned(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 != 0) || ...);
}

// The radix-8 core's entry: log n from 5 to 13, every pointer 16-byte
// aligned (the table's vectors, and the rows' in the last pass).
template <bool kInverse, bool kCols>
int launch_core(const void* in, void* out, const void* tw, int batch, int log_n, int width,
                uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n) || width < 1) {
    return cudaErrorInvalidValue;
  }
  if (misaligned(in, out, tw)) {
    return cudaErrorMisalignedAddress;
  }
  const long long transforms = static_cast<long long>(batch) * width;
  switch (log_n) {
#define GL64_LOG_N(L)                                                                    \
  case L:                                                                                \
    return launch_transform<L, kInverse, kCols>(in, out, tw, transforms, width, scale,   \
                                                stream);
    GL64_LOG_N(5) GL64_LOG_N(6) GL64_LOG_N(7) GL64_LOG_N(8) GL64_LOG_N(9)
    GL64_LOG_N(10) GL64_LOG_N(11) GL64_LOG_N(12) GL64_LOG_N(13)
#undef GL64_LOG_N
  }
  return cudaErrorInvalidValue;
}

// A row transform (the row forward, or with kInverse the row inverse) of
// log n = kLogN on `batch` rows, tile(kLogN) rows a block.
template <int kLogN, bool kInverse>
int launch_row(const void* in, void* out, const void* tw, const void* table, int period,
               int batch, uint64_t scale, cudaStream_t stream) {
  constexpr int kTile = tile(kLogN, false);
  auto kernel = kInverse ? inverse_scaled_kernel<kLogN> : forward_scaled_kernel<kLogN>;
  const cudaError_t err = allow_smem(kernel, kTile << kLogN);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<(batch + kTile - 1) / kTile, block_threads(kLogN, false),
           (kTile << kLogN) * sizeof(uint64_t), stream>>>(
      words(in), static_cast<uint64_t*>(out), words(tw), words(table), period, batch, scale);
  return cudaGetLastError();
}

// The row transforms' entry: log n from 5 to 13, whole periods, every
// pointer 16-byte aligned.
template <bool kInverse>
int launch_rows(const void* in, void* out, const void* tw, const void* table, int period,
                int batch, int log_n, uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period) {
    return cudaErrorInvalidValue;
  }
  if (misaligned(in, out, tw, table)) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define GL64_LOG_N(L)                                                                    \
  case L:                                                                                \
    return launch_row<L, kInverse>(in, out, tw, table, period, batch, scale, s);
    GL64_LOG_N(5) GL64_LOG_N(6) GL64_LOG_N(7) GL64_LOG_N(8) GL64_LOG_N(9)
    GL64_LOG_N(10) GL64_LOG_N(11) GL64_LOG_N(12) GL64_LOG_N(13)
#undef GL64_LOG_N
  }
  return cudaErrorInvalidValue;
}

template <int kLogN, bool kCached, bool kScaled>
int launch_fused(const void* a, const void* b, void* out, const void* tw, const void* itw,
                 const void* pre, const void* post, int period, int batch, uint64_t scale,
                 cudaStream_t stream) {
  constexpr int kTile = tile(kLogN, false);
  constexpr int kSmem = kTile * (1 << kLogN) * static_cast<int>(sizeof(uint64_t));
  auto kernel = cyclic_scaled_kernel<kLogN, kCached, kScaled>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<(batch + kTile - 1) / kTile, block_threads(kLogN, false), kSmem, stream>>>(
      words(a), words(b), static_cast<uint64_t*>(out), words(tw), words(itw), words(pre),
      words(post), period, batch, scale);
  return cudaGetLastError();
}

template <int kLogN, bool kCached, bool kScaled>
int launch_dot(const void* a, const void* b, void* out, const void* tw, const void* itw,
               const void* pre, const void* post, int period, int terms, int batch,
               uint64_t scale, cudaStream_t stream) {
  constexpr int kTile = tile(kLogN, false);
  constexpr int kSmem =
      dot_tiles(kCached) * kTile * (1 << kLogN) * static_cast<int>(sizeof(uint64_t));
  auto kernel = dot_kernel<kLogN, kCached, kScaled>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<(batch + kTile - 1) / kTile, block_threads(kLogN, false), kSmem, stream>>>(
      words(a), words(b), static_cast<uint64_t*>(out), words(tw), words(itw), words(pre),
      words(post), period, terms, batch, scale);
  return cudaGetLastError();
}

// The matvec's row pass at log n = kLogN: rows * batch output rows,
// tile(kLogN) a block.
template <int kLogN>
int launch_matvec(const void* spectra, const void* mat, void* out, const void* itw,
                  const void* post, int period, int rows, int cols, int batch, uint64_t scale,
                  cudaStream_t stream) {
  constexpr int kTile = tile(kLogN, false);
  auto kernel = radix_matvec_kernel<kLogN>;
  const cudaError_t err = allow_smem(kernel, kTile << kLogN);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<(rows * batch + kTile - 1) / kTile, block_threads(kLogN, false),
           (kTile << kLogN) * sizeof(uint64_t), stream>>>(
      words(spectra), words(mat), static_cast<uint64_t*>(out), words(itw), words(post), period,
      rows, cols, batch, scale);
  return cudaGetLastError();
}

// The dots' entry: log n from 5 to 13, whole periods, every pointer 16-byte
// aligned; the flat dot (kScaled false) passes no pre or post, and period 1.
template <bool kScaled>
int launch_dots(const void* a, const void* b, void* out, const void* tw, const void* itw,
                const void* pre, const void* post, int period, int terms, int batch, int log_n,
                uint64_t scale, int cached, void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period || terms < 1) {
    return cudaErrorInvalidValue;
  }
  if (misaligned(a, b, out, tw, itw, pre, post)) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define GL64_LOG_N(L)                                                                       \
  case L:                                                                                   \
    return cached ? launch_dot<L, true, kScaled>(a, b, out, tw, itw, pre, post, period,     \
                                                 terms, batch, scale, s)                    \
                  : launch_dot<L, false, kScaled>(a, b, out, tw, itw, pre, post, period,    \
                                                  terms, batch, scale, s);
    GL64_LOG_N(5) GL64_LOG_N(6) GL64_LOG_N(7) GL64_LOG_N(8) GL64_LOG_N(9)
    GL64_LOG_N(10) GL64_LOG_N(11) GL64_LOG_N(12) GL64_LOG_N(13)
#undef GL64_LOG_N
  }
  return cudaErrorInvalidValue;
}

// The fused products' entry: log n from 5 to 13, every pointer 16-byte
// aligned (the tables' vectors, and a cached spectrum's); the flat product
// (kScaled false) passes no pre or post, and period 1.
template <bool kCached, bool kScaled>
int launch_product(const void* a, const void* b, void* out, const void* tw, const void* itw,
                   const void* pre, const void* post, int period, int batch, int log_n,
                   uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period) {
    return cudaErrorInvalidValue;
  }
  if (misaligned(a, b, out, tw, itw, pre, post)) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define GL64_LOG_N(L)                                                                    \
  case L:                                                                                \
    return launch_fused<L, kCached, kScaled>(a, b, out, tw, itw, pre, post, period,      \
                                             batch, scale, s);
    GL64_LOG_N(5) GL64_LOG_N(6) GL64_LOG_N(7) GL64_LOG_N(8) GL64_LOG_N(9)
    GL64_LOG_N(10) GL64_LOG_N(11) GL64_LOG_N(12) GL64_LOG_N(13)
#undef GL64_LOG_N
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Every entry point launches on `stream`, which must belong to the current
// device, and returns the CUDA error code (0 on success).  A launch the
// device refuses (too much shared memory, a bad shape) never runs, so the
// caller must check the code.

// The product of (batch, n) rows on the radix-8 core, fused: merged tables
// give the negacyclic product, cyclic ones the cyclic; the tables are those
// of mxu64.pass_table, the scale n^-1.
extern "C" int gl64_product(const void* a, const void* b, void* out,
                            const void* tw, const void* itw, int batch,
                            int log_n, uint64_t scale, void* stream) {
  return launch_product<false, false>(a, b, out, tw, itw, nullptr, nullptr, 1, batch, log_n,
                                      scale, stream);
}

// The same against a plain-domain, bit-reversed cached spectrum.
extern "C" int gl64_cached(const void* a, const void* spectrum, void* out,
                           const void* tw, const void* itw, int batch,
                           int log_n, uint64_t scale, void* stream) {
  return launch_product<true, false>(a, spectrum, out, tw, itw, nullptr, nullptr, 1, batch,
                                     log_n, scale, stream);
}

// The forward and the inverse of (batch, n) rows on the radix-8 core.  The
// table is that of mxu64.pass_table: the flat table of the first core in
// the per-pass layout; the forward skips scale 1.
extern "C" int gl64_forward(const void* in, void* out, const void* tw,
                            int batch, int log_n, uint64_t scale, void* stream) {
  return launch_core<false, false>(in, out, tw, batch, log_n, 1, scale, stream);
}

extern "C" int gl64_inverse(const void* in, void* out, const void* itw,
                            int batch, int log_n, uint64_t scale, void* stream) {
  return launch_core<true, false>(in, out, itw, batch, log_n, 1, scale, stream);
}

// The same on every column of `batch` natural (n, width) matrices, in
// place of the transposes around a row transform: column c of matrix m is
// the n words m * n * width + c + i * width; the forward's spectrum comes
// out down the same column, in bit-reversed order.
extern "C" int gl64_forward_cols(const void* in, void* out, const void* tw, int batch,
                                 int log_n, int width, uint64_t scale, void* stream) {
  return launch_core<false, true>(in, out, tw, batch, log_n, width, scale, stream);
}

extern "C" int gl64_inverse_cols(const void* in, void* out, const void* itw, int batch,
                                 int log_n, int width, uint64_t scale, void* stream) {
  return launch_core<true, true>(in, out, itw, batch, log_n, width, scale, stream);
}

// The dot of (terms, batch, n) stacks a and b, 1 <= terms <= 8 (b holds
// plain-domain spectra with `cached`), one output row a row of the batch,
// on the radix-8 core, fused; the tables are those of mxu64.pass_table,
// the scale n^-1; every pointer 16-byte aligned.
extern "C" int gl64_dot(const void* a, const void* b, void* out,
                        const void* tw, const void* itw, int terms, int batch,
                        int log_n, uint64_t scale, int cached, void* stream) {
  if (terms > 8) {
    return cudaErrorInvalidValue;
  }
  return launch_dots<false>(a, b, out, tw, itw, nullptr, nullptr, 1, terms, batch, log_n, scale,
                            cached, stream);
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

// The row pass of the four-step, fused on the radix-8 core: `period` rows
// of plain scales pre and post, n values each (batch must be a multiple of
// it), the tables those of mxu64.pass_table.
extern "C" int gl64_cyclic_scaled(const void* a, const void* b, void* out,
                                  const void* tw, const void* itw,
                                  const void* pre, const void* post, int period,
                                  int batch, int log_n, uint64_t scale,
                                  void* stream) {
  return launch_product<false, true>(a, b, out, tw, itw, pre, post, period, batch, log_n,
                                     scale, stream);
}

// The same against the rows of a cached spectrum.
extern "C" int gl64_cached_scaled(const void* a, const void* spectrum,
                                  void* out, const void* tw, const void* itw,
                                  const void* pre, const void* post, int period,
                                  int batch, int log_n, uint64_t scale,
                                  void* stream) {
  return launch_product<true, true>(a, spectrum, out, tw, itw, pre, post, period, batch,
                                    log_n, scale, stream);
}

// The row forward on the radix-8 core: NTT(pre . in) * scale (scale 1
// skipped), pre as for gl64_cyclic_scaled, the table that of
// mxu64.pass_table.
extern "C" int gl64_forward_scaled(const void* in, void* out, const void* tw,
                                   const void* pre, int period, int batch,
                                   int log_n, uint64_t scale, void* stream) {
  return launch_rows<false>(in, out, tw, pre, period, batch, log_n, scale, stream);
}

// The row inverse on the radix-8 core: post . INTT(in) * scale (n^-1) for
// bit-reversed spectra, post as for gl64_cyclic_scaled, the table that of
// mxu64.pass_table.
extern "C" int gl64_inverse_scaled(const void* in, void* out, const void* itw,
                                   const void* post, int period, int batch,
                                   int log_n, uint64_t scale, void* stream) {
  return launch_rows<true>(in, out, itw, post, period, batch, log_n, scale, stream);
}

// The dot's row pass: (terms, batch, n) stacks a and b (b cached spectra
// with `cached`), one output row per row of the batch, pre and post as for
// gl64_cyclic_scaled: the flat dot's loop on the radix-8 core with the
// scales, on the tables of mxu64.pass_table.
extern "C" int gl64_dot_scaled(const void* a, const void* b, void* out,
                               const void* tw, const void* itw, const void* pre,
                               const void* post, int period, int terms,
                               int batch, int log_n, uint64_t scale, int cached,
                               void* stream) {
  return launch_dots<true>(a, b, out, tw, itw, pre, post, period, terms, batch, log_n, scale,
                           cached, stream);
}

// The matvec's row pass on the radix-8 core: the (cols, batch, n) row
// spectra of s against the (rows, cols, period, n) cached spectra of A, row
// r of s meeting A's row r % period, post as for gl64_cyclic_scaled;
// (rows, batch, n) out, on the inverse table of mxu64.pass_table.
extern "C" int gl64_matvec_scaled(const void* spectra, const void* mat,
                                  void* out, const void* itw, const void* post,
                                  int period, int rows, int cols, int batch,
                                  int log_n, uint64_t scale, void* stream) {
  if (bad_shape(batch, log_n) || period < 1 || batch % period || rows < 1 ||
      rows > 65535 || cols < 1 || batch > 0x7fffffff / rows) {
    return cudaErrorInvalidValue;
  }
  if (misaligned(spectra, mat, out, itw, post)) {
    return cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n) {
#define GL64_LOG_N(L)                                                                    \
  case L:                                                                                \
    return launch_matvec<L>(spectra, mat, out, itw, post, period, rows, cols, batch,     \
                            scale, s);
    GL64_LOG_N(5) GL64_LOG_N(6) GL64_LOG_N(7) GL64_LOG_N(8) GL64_LOG_N(9)
    GL64_LOG_N(10) GL64_LOG_N(11) GL64_LOG_N(12) GL64_LOG_N(13)
#undef GL64_LOG_N
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gl64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

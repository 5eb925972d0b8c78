// a2a.cu: the four-step's stage exchange, a tiled all-to-all between the
// shards of one mesh axis, hand-written for Hopper (sm_90a).
//
// Replaces kernel K6, tpu_ntt/sharded.py:580 _a2a_pallas_leaf (its
// pallas_call at :669), which ShardedNtt(fused_exchange=True) runs once a
// transform (:761-775):
//   a2a_exchange  one source shard `me` of a (batch, rows, cols) leaf
//                 copied to the D destination buffers of its peers.
//                 split_from_end = 2, the forward exchange: source rows
//                 [t * rows / D, (t + 1) * rows / D) go to peer t's columns
//                 [me * cols, (me + 1) * cols) of its (batch, rows / D,
//                 cols * D) output.  split_from_end = 1, the inverse: source
//                 columns [t * cols / D, (t + 1) * cols / D) go to peer t's
//                 rows [me * rows, (me + 1) * rows) of its (batch, rows * D,
//                 cols / D) output.
//   a2a_peer_access  lets the current device's kernels write to `peer`'s
//                 memory (shards on several cards).
// A caller runs a2a_exchange once for each of the D sources, on the source
// shard's stream, into outputs allocated before the first launch: the
// function of jax.lax.all_to_all(..., tiled=True) over the axis
// (tpu_ntt_torch/kernels/a2a.py).  The TPU kernel opens with a barrier
// (:625-634) so that no remote DMA lands before every peer's kernel exists;
// here stream order does that (the wrapper's events across cards).  With
// every shard on one card each destination pointer is local; across cards
// it is a peer's memory, written over NVLink.
//
// The kernel copies bits and does no arithmetic, so it serves 4-byte words
// (torch.int32, Ring32 residues) and 8-byte ones (torch.int64: 60-bit
// residues and Goldilocks patterns >= 2^63 alike), the element size a
// template parameter.  It is a gather-scatter of row segments: the grid
// runs over (peer, batch x row tiles), each thread copies four vectors of
// the segments, 16 bytes where the segment's width, every stride and offset
// and every pointer allow it, else 8 or 4.  Mosaic's (8, 128) tiling limit
// (:597-607) has no counterpart: any shape where D divides the split axis
// runs.  Up to 16 peers; their pointers travel by value in the kernel's
// parameters.
//
// What bounds it on this card: bytes.  Every word is read once and written
// once, 2 x 32 MiB for the exchange of p60_1048576 at B = 4 (0.020 ms at
// 3.35 TB/s).  Index arithmetic is a few 32-bit divisions a vector, far
// below the issue rate at 16 bytes a thread.

#include <cstdint>

#include <cuda_runtime.h>

constexpr int kMaxPeers = 16;

// The destination pointers of a launch, by value in the kernel's parameters
// (the C entry's argument type, so outside the unnamed namespace).
struct Peers {
  void* dst[kMaxPeers];
};

namespace {

// A launch's geometry in vectors: a segment is one row of a block (cols
// words forward, cols / D inverse), seg_rows of them a batch entry and peer.
struct Geometry {
  uint32_t batch;
  uint32_t seg_rows;
  uint32_t seg_vecs;
  uint64_t src_batch, src_row, src_block;    // source strides; src_block a peer
  uint64_t dst_batch, dst_row, dst_offset;   // destination strides; me's block
};

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread has in flight

// Block (x, t) copies vectors of the segments bound for peer t: each thread
// kUnroll vectors kThreads apart, all loads issued before the stores.  The
// peers' pointers stay in the parameter space (__grid_constant__): indexed
// by t, a by-value array would be copied to every thread's stack.
template <int kElemBytes, typename Vec>
__global__ void __launch_bounds__(kThreads)
    exchange_kernel(const Vec* __restrict__ src, const __grid_constant__ Peers peers,
                    const __grid_constant__ Geometry g) {
  static_assert(sizeof(Vec) % kElemBytes == 0, "a vector holds whole words");
  const uint32_t t = blockIdx.y;
  Vec* __restrict__ dst = static_cast<Vec*>(peers.dst[t]);
  const uint32_t total = g.batch * g.seg_rows * g.seg_vecs;  // < 2^31: the host checks
  for (uint32_t base = blockIdx.x * kThreads * kUnroll + threadIdx.x; base < total;
       base += gridDim.x * kThreads * kUnroll) {
    Vec val[kUnroll];
    uint64_t to[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = base + u * kThreads;
      if (i < total) {
        const uint32_t v = i % g.seg_vecs;
        const uint32_t seg = i / g.seg_vecs;
        const uint64_t r = seg % g.seg_rows;
        const uint64_t b = seg / g.seg_rows;
        to[u] = b * g.dst_batch + r * g.dst_row + g.dst_offset + v;
        val[u] = src[b * g.src_batch + r * g.src_row + t * g.src_block + v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads < total) {
        dst[to[u]] = val[u];
      }
    }
  }
}

template <int kElemBytes, typename Vec>
cudaError_t launch(const void* src, const Peers& peers, int npeers, Geometry g,
                   cudaStream_t stream) {
  const uint32_t total = g.batch * g.seg_rows * g.seg_vecs;
  const uint32_t blocks = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const dim3 grid(blocks < 4096 ? blocks : 4096, npeers);
  exchange_kernel<kElemBytes, Vec><<<grid, kThreads, 0, stream>>>(
      static_cast<const Vec*>(src), peers, g);
  return cudaGetLastError();
}

// The widest vector (16, 8 or 4 bytes, at least one word) that divides every
// width, stride and offset of the geometry and aligns every pointer.
int vector_bytes(const void* src, const Peers& peers, int npeers,
                 const uint64_t* words, int count, int elem_bytes) {
  for (int vb = 16; vb > elem_bytes; vb /= 2) {
    bool ok = reinterpret_cast<uintptr_t>(src) % vb == 0;
    for (int t = 0; t < npeers; ++t) {
      ok = ok && reinterpret_cast<uintptr_t>(peers.dst[t]) % vb == 0;
    }
    for (int k = 0; k < count; ++k) {
      ok = ok && words[k] * elem_bytes % vb == 0;
    }
    if (ok) {
      return vb;
    }
  }
  return elem_bytes;
}

template <int kElemBytes>
cudaError_t exchange(const void* src, const Peers& peers, int npeers,
                     Geometry g, uint32_t seg_words, cudaStream_t stream) {
  const uint64_t words[] = {seg_words,   g.src_batch, g.src_row, g.src_block,
                            g.dst_batch, g.dst_row,   g.dst_offset};
  const int vb = vector_bytes(src, peers, npeers, words, 7, kElemBytes);
  const uint32_t per_vec = vb / kElemBytes;
  g.seg_vecs = seg_words / per_vec;
  g.src_batch /= per_vec;
  g.src_row /= per_vec;
  g.src_block /= per_vec;
  g.dst_batch /= per_vec;
  g.dst_row /= per_vec;
  g.dst_offset /= per_vec;
  if (vb == 16) {
    return launch<kElemBytes, uint4>(src, peers, npeers, g, stream);
  }
  if constexpr (kElemBytes == 4) {  // 4-byte words: an 8-byte vector or one word
    if (vb == 4) {
      return launch<4, unsigned int>(src, peers, npeers, g, stream);
    }
  }
  return launch<kElemBytes, unsigned long long>(src, peers, npeers, g, stream);
}

}  // namespace

// The entry points return the CUDA error code (0 on success); a launch the
// device refuses never runs, so the caller must check the code.
// a2a_exchange launches on `stream`, which must belong to the current
// device, as src must; the destinations may lie on peers of that device
// whose memory it may write (a2a_peer_access).

extern "C" int a2a_exchange(const void* src, Peers dsts, int peers, int me,
                            int batch, int rows, int cols, int elem_bytes,
                            int split_from_end, void* stream) {
  if (peers < 1 || peers > kMaxPeers || me < 0 || me >= peers || batch < 0 ||
      rows < 1 || cols < 1 || (elem_bytes != 4 && elem_bytes != 8) ||
      (split_from_end != 1 && split_from_end != 2) ||
      (split_from_end == 2 ? rows % peers : cols % peers) || src == nullptr) {
    return cudaErrorInvalidValue;
  }
  for (int t = 0; t < peers; ++t) {
    if (dsts.dst[t] == nullptr) {
      return cudaErrorInvalidValue;
    }
  }
  const uint64_t per_peer = static_cast<uint64_t>(batch) * rows * cols / peers;
  if (per_peer >= (1ull << 31)) {
    return cudaErrorInvalidValue;  // the kernel indexes a peer's words in 32 bits
  }
  if (batch == 0) {
    return cudaSuccess;
  }
  const uint64_t d = peers, m = me;
  Geometry g{};
  g.batch = batch;
  g.src_batch = static_cast<uint64_t>(rows) * cols;
  g.src_row = cols;
  uint32_t seg_words;
  if (split_from_end == 2) {  // a block is rows / D full rows
    g.seg_rows = rows / peers;
    seg_words = cols;
    g.src_block = g.seg_rows * g.src_row;
    g.dst_batch = g.seg_rows * cols * d;
    g.dst_row = cols * d;
    g.dst_offset = m * cols;
  } else {  // a block is every row's cols / D columns
    g.seg_rows = rows;
    seg_words = cols / peers;
    g.src_block = seg_words;
    g.dst_batch = g.src_batch;
    g.dst_row = seg_words;
    g.dst_offset = m * rows * seg_words;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 8) {
    return exchange<8>(src, dsts, peers, g, seg_words, s);
  }
  return exchange<4>(src, dsts, peers, g, seg_words, s);
}

extern "C" int a2a_peer_access(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: access is what was asked for
    return cudaSuccess;
  }
  return err;
}

extern "C" const char* a2a_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

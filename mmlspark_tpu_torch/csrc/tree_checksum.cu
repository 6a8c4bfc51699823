// tree_checksum.cu — the trainer's integrity fold over every parameter and
// optimizer-state tensor as one multi-tensor pass, for Hopper.
//
// No TPU kernel stands behind it: in the reference, XLA fuses the fold
// (mmlspark_tpu/core/integrity.py: tree_checksum) into the jitted training
// step under lax.cond (mmlspark_tpu/train/trainer.py: step_audit). The port
// needs a kernel of its own to keep the audited step one CUDA graph: a flag
// in device memory decides, on the device, whether this step folds, so the
// same captured program serves audit and non-audit steps. With the flag at
// 0 every block returns at once and the carry is left as it was.
//
// The function, exact mod 2^32 (the JAX package's host twin,
// tree_checksum_host, computes the same): for leaf i and word j of its
// bitcast word stream, sum w[j] * (j * 0x9E3779B8 + 2i + 1). A leaf of
// 1-byte elements (bool included: 0 or 1) gives one zero-extended word an
// element, 2-byte elements likewise, 4-byte elements one word, 8-byte
// elements two little-endian words (the wrapper passes those as 4-byte
// words, twice as many).
//
// What bounds it on the H100: bytes. Each word is read once and takes one
// multiply and one add in 32-bit integers; the full-width LM's parameters
// and adam moments are ~406 MB, 0.121 ms at 3.35 TB/s. The design: the
// leaves' pointers, word counts and salts in a device table built once by
// the wrapper (the tensors keep their addresses, so a captured graph reads
// the same table on every replay); a grid-stride walk over fixed chunks of
// every leaf (a block finds a chunk's leaf by a binary search of the chunk
// offsets), 16-byte loads where a leaf is 16-byte aligned, consecutive
// threads on consecutive addresses; a per-block uint32 sum added into a
// two-word workspace with integer atomics; the last block to finish moves
// the sum into the carry and zeroes the workspace for the next launch.
// Integer sums mod 2^32 commute, so the result is exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkWords = 8192;  // words a chunk; a multiple of 16
constexpr unsigned int kMix = 0x9E3779B8u;

// One leaf of the table; the wrapper packs the same 32-byte layout.
struct FoldLeaf {
  const void* ptr;
  long long n_words;
  long long chunk_start;  // chunks of the leaves before this one
  unsigned int salt;      // 2 * leaf index + 1
  int word_bytes;         // 1, 2 or 4
};
static_assert(sizeof(FoldLeaf) == 32, "the wrapper packs 32-byte entries");

template <typename W>
__device__ __forceinline__ unsigned int scalar_terms(const W* p,
                                                     long long begin,
                                                     long long end,
                                                     unsigned int salt) {
  unsigned int sum = 0;
  for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
    const unsigned int w = (unsigned int)__ldg(p + j);
    sum += w * ((unsigned int)j * kMix + salt);
  }
  return sum;
}

// words [begin, end) of one leaf; begin is a multiple of kChunkWords
template <typename W>
__device__ __forceinline__ unsigned int chunk_terms(const W* p,
                                                    long long begin,
                                                    long long end,
                                                    unsigned int salt) {
  constexpr int kVec = 16 / sizeof(W);  // words a 16-byte load
  if ((reinterpret_cast<uintptr_t>(p) & 15) != 0) {
    return scalar_terms(p, begin, end, salt);
  }
  const long long vec_end = begin + (end - begin) / kVec * kVec;
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
  unsigned int sum = 0;
  for (long long v = begin / kVec + threadIdx.x; v < vec_end / kVec;
       v += kThreads) {
    const uint4 q = __ldg(p4 + v);
    const unsigned int parts[4] = {q.x, q.y, q.z, q.w};
    unsigned int m = (unsigned int)(v * kVec) * kMix + salt;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (sizeof(W) == 4) {
        sum += parts[k] * m;
        m += kMix;
      } else if (sizeof(W) == 2) {
        sum += (parts[k] & 0xffffu) * m;
        m += kMix;
        sum += (parts[k] >> 16) * m;
        m += kMix;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          sum += ((parts[k] >> (8 * b)) & 0xffu) * m;
          m += kMix;
        }
      }
    }
  }
  return sum + scalar_terms(p, vec_end, end, salt);
}

__global__ void __launch_bounds__(kThreads)
    tree_checksum_kernel(const FoldLeaf* __restrict__ table, int n_leaves,
                         long long total_chunks,
                         const unsigned char* __restrict__ flag,
                         unsigned int* workspace, unsigned int* out) {
  if (flag != nullptr && *flag == 0) return;  // not an audit step
  unsigned int sum = 0;
  for (long long c = blockIdx.x; c < total_chunks; c += gridDim.x) {
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid].chunk_start <= c) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const FoldLeaf leaf = table[lo];
    const long long begin = (c - leaf.chunk_start) * kChunkWords;
    const long long end = begin + kChunkWords < leaf.n_words
                              ? begin + kChunkWords
                              : leaf.n_words;
    if (leaf.word_bytes == 4) {
      sum += chunk_terms(static_cast<const uint32_t*>(leaf.ptr), begin, end,
                         leaf.salt);
    } else if (leaf.word_bytes == 2) {
      sum += chunk_terms(static_cast<const uint16_t*>(leaf.ptr), begin, end,
                         leaf.salt);
    } else {
      sum += chunk_terms(static_cast<const uint8_t*>(leaf.ptr), begin, end,
                         leaf.salt);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  __shared__ unsigned int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned int block_sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) block_sum += warp_sums[w];
  atomicAdd(&workspace[0], block_sum);
  __threadfence();
  const unsigned int done = atomicAdd(&workspace[1], 1u);
  if (done == gridDim.x - 1) {
    // every other block's sum is in: take the total, leave zeros behind
    __threadfence();
    *out = atomicExch(&workspace[0], 0u);
    workspace[1] = 0u;
  }
}

}  // namespace

// table: device array of n_leaves 32-byte FoldLeaf entries (the wrapper's
// plan; only non-empty leaves); total_chunks: the chunks of all of them;
// flag: a device byte, fold only where it is non-zero (null: always);
// workspace: two device uint32, zero at rest (the kernel leaves them zero);
// out: the device uint32 carry. blocks: the grid (at least 1).
extern "C" int mml_tree_checksum(const void* table, int n_leaves,
                                 long long total_chunks, const void* flag,
                                 void* workspace, void* out, int blocks,
                                 void* stream) {
  if (n_leaves < 0 || total_chunks < 0 || blocks < 1 ||
      (total_chunks > 0 && (table == nullptr || n_leaves == 0)) ||
      workspace == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  tree_checksum_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const FoldLeaf*>(table), n_leaves, total_chunks,
      static_cast<const unsigned char*>(flag),
      static_cast<unsigned int*>(workspace), static_cast<unsigned int*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

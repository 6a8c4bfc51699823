// flash_attention.cuh — what the cache-free attention kernels share
// (flash_attention_fwd.cu: the forward; flash_attention_bwd.cu: dK/dV and
// dQ): the masking geometry, tile staging and the two small products.
//
// Layout. q, k, v and dO are (B, S, heads, D) tensors read through their
// (batch, position, head) strides with the last dimension contiguous: q, k
// and v are strided slices of the model's fused qkv projection, read in
// place. Outputs (out, dq, dk, dv) are contiguous (B, S, heads, D); the row
// log-sum-exp and D = rowsum(dO * out) are compact (B * H, S) f32. Query head
// h reads kv head h / (H / Hkv) (grouped-query attention).
//
// Numerics, as the Pallas kernels of mmlspark_tpu/ops/flash_attention.py:
// scores q.k in f32 times the softmax scale; an online softmax in f32 whose
// running max starts at the finite -1e30 (KERNEL_NEG_INF of
// ops/attention.py); P rounded to V's dtype before P.V, P to dO's dtype
// before dV, dS to q's (k's) dtype before dK (dQ); f32 accumulators, cast
// once. Masked and padded entries are exactly 0 in P; a row with no live key
// has l == 0 and gives zeros and LSE -1e30.
//
// Threads. A block has 256 threads in a 16 x 16 grid (tx = tid % 16, ty =
// tid / 16). Square tiles of BT positions (64 for D <= 128, 32 for
// D <= 256) sit in shared memory as f32, MAXD + 1 floats a row (the +1
// keeps the 16 rows a half-warp reads in distinct banks); columns past D
// and rows past S are zeros. In a BT x BT score tile thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j (i, j < BT / 16); a row's 16 owners
// are one half-warp, so row max and sum are half-warp shuffles. In a
// BT x MAXD output tile it owns rows ty + 16 i and columns tx + 16 c.
//
// What bounds these kernels on the H100: at the training shape (S = 512,
// D = 64, bf16) the bytes (each input once, each output once) take about
// 5-8 us at 3.35 TB/s and the causal products about 2-5 us at the tensor
// cores' 989 TFLOP/s. This first version is neither: its products are
// scalar f32 FMAs fed from shared memory, with no overlap of loads and
// compute. Left for later PRs: mma.sync/wgmma products in bf16, cp.async or
// TMA double buffering, a persistent grid that balances the causal
// triangle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mfa {

constexpr int kThreads = 256;
// KERNEL_NEG_INF of ops/attention.py
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// x rounded to T and back: the cast the Pallas kernels make before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// reductions over the 16 lanes of a half-warp (offsets < 16 stay inside it)
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// -- the masking geometry (the Pallas kernels' _block_live, _dead_mask and
// _live_k_range). window == 0 means no window; query and key tiles are the
// same size blk.

// does key tile ki meet query tile qi's span at all?
__device__ __forceinline__ bool block_live(int qi, int ki, bool causal,
                                           int window, int blk) {
  bool live = true;
  if (causal) live = ki * blk <= qi * blk + blk - 1;
  if (window > 0) live = live && (ki * blk + blk - 1 >= qi * blk - window + 1);
  return live;
}

// must the (query, key) pair NOT attend? Padded keys never attend; with
// with_q_pad padded query rows do not either (the backward's rule)
__device__ __forceinline__ bool dead_entry(int qpos, int kpos, int seq_len,
                                           bool causal, int window,
                                           bool with_q_pad) {
  bool dead = kpos >= seq_len;
  if (with_q_pad) dead = dead || qpos >= seq_len;
  if (causal) dead = dead || kpos > qpos;
  if (window > 0) dead = dead || kpos <= qpos - window;
  return dead;
}

// [lo, hi] of the key tiles query tile qi may meet: left of the diagonal
// when causal, inside the window when there is one
__device__ __forceinline__ void live_k_range(int qi, bool causal, int window,
                                             int blk, int n_blk, int* lo,
                                             int* hi) {
  *hi = causal ? qi : n_blk - 1;
  const int oldest = qi * blk - window + 1;  // the tile's oldest row's reach
  *lo = (window > 0 && oldest > 0) ? oldest / blk : 0;
}

// [lo, hi] of the query tiles that may meet key tile ki (the transpose)
__device__ __forceinline__ void live_q_range(int ki, bool causal, int window,
                                             int blk, int n_blk, int* lo,
                                             int* hi) {
  *lo = causal ? ki : 0;
  *hi = n_blk - 1;
  if (window > 0) {
    // the newest query that still sees the tile's last key
    const int newest = (ki * blk + blk + window - 2) / blk;
    *hi = newest < *hi ? newest : *hi;
  }
}

// -- staging and products

// rows [row0, row0 + BT) of one head of a (B, S, heads, D) tensor (src at
// the (b, head) base, s_stride elements between positions) into dst as f32,
// MAXD + 1 floats a row; rows past seq_len and columns past D are zeros
template <typename T, int BT, int MAXD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long s_stride, int row0,
                                          int seq_len, int D) {
  constexpr int LD = MAXD + 1;
  for (int idx = threadIdx.x; idx < BT * MAXD; idx += kThreads) {
    const int r = idx / MAXD;
    const int d = idx - r * MAXD;
    const int pos = row0 + r;
    float x = 0.f;
    if (pos < seq_len && d < D) x = to_f32<T>(src[(long long)pos * s_stride + d]);
    dst[r * LD + d] = x;
  }
}

// acc[i][j] += sum_d A[row ty + 16 i][d] * B[row tx + 16 j][d]
template <int RT, int LD>
__device__ __forceinline__ void dot_rows(float (&acc)[RT][RT], const float* A,
                                         const float* B, int D, int ty,
                                         int tx) {
  for (int d = 0; d < D; ++d) {
    float a[RT], b[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < RT; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_r P(ty + 16 i, r) * X[row r][tx + 16 c] over the BT rows
// of X, where P(row, r) is P[row][r], or P[r][row] when TRANS (a BT x BT
// tile, BT + 1 floats a row)
template <int RT, int DT, int BT, int LD, bool TRANS>
__device__ __forceinline__ void mul_tile(float (&acc)[RT][DT], const float* P,
                                         const float* X, int ty, int tx) {
  constexpr int PLD = BT + 1;
  for (int r = 0; r < BT; ++r) {
    float p[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      p[i] = TRANS ? P[r * PLD + ty + 16 * i] : P[(ty + 16 * i) * PLD + r];
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const float x = X[r * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
    }
  }
}

// the dynamic shared memory a kernel of tile BT and width MAXD takes for
// `tiles` (BT, MAXD + 1) tiles, `scores` (BT, BT + 1) tiles and `rows`
// BT-float vectors
constexpr size_t smem_bytes(int BT, int MAXD, int tiles, int scores,
                            int rows) {
  return sizeof(float) * ((size_t)tiles * BT * (MAXD + 1) +
                          (size_t)scores * BT * (BT + 1) + (size_t)rows * BT);
}

}  // namespace mfa

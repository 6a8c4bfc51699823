// decode_attention.cuh — the one-token attention read shared by the
// port's decode kernels (flash_decode.cu: dense slot caches, float or
// int8; paged_flash_decode.cu: page stores through a page table, float or
// int8).
//
// For each (row b, query head h) the kernel computes
//
//   s_j = (q . k_j) * scale * ks_j          for j < length[b]
//   out = sum_j softmax(s)_j * v_j * vs_j   (zeros when length[b] == 0)
//
// where ks_j / vs_j are the int8 dequantization scales of the page that
// holds position j (1 for float K/V). f32 products and sums, an f32
// online softmax, and p kept in f32 against upcast v (not rounded to bf16:
// the JAX kernels do the same so that their output matches the dense
// oracle). Query head h reads kv head h / (H / Hkv) (grouped-query
// attention).
//
// Addressing. Position j of row b lives in "page" pg = j / page_size at
// offset j % page_size. A dense slot cache is one page per row: pg is the
// row b itself and page_size is the cache length L. A paged cache maps
// the logical page through the row's page table: phys = pt[b, pg]. Either
// way the K row sits at
//
//   k + page * k_sp + hk * k_sh + (j % page_size) * k_sl
//
// (dense: the (B, L, Hkv, D) strides; paged: the contiguous
// (num_pages, Hkv, page_size, D) store), and the int8 scales at
// ks[page * Hkv + hk] ((B, Hkv) dense, (num_pages, Hkv) paged). Masking
// uses LOGICAL positions; only the fetch goes through the table. A page id
// outside [0, num_pages) traps, so the launch fails instead of reading
// another tenant's memory.
//
// int8: k's scale folds into the softmax scale of each score (as the JAX
// kernel's `* (scale * ks)`), and v's scale multiplies each page's P.V
// partial sum before it enters the accumulator (`acc = acc * corr +
// (sum p.v_i8) * vs`) — exact at per-page granularity, since every
// position of a page shares its scale.
//
// What bounds it on the card: memory. A decode step reads each live K and
// V row once and does 4 * D flops per row and query head, far below the
// H100's ~295 flops per byte. Least bytes for one call:
//   sum_b 2 * length_b * Hkv * D * sizeof(KV)  +  q and out (B * H * D
//   each)  +  lengths, the live page-table entries and the live pages'
//   scales
// and its bound is those bytes over the card's memory bandwidth. int8
// K/V halve the dominant term against bf16.
//
// Design (the simple first version):
// - one thread block of 128 threads per (b, h), grid (H, B);
// - the block walks only the live prefix [0, length[b]) in tiles of TILE
//   rows (TILE * sizeof(KV) = 128 bytes a D element, so every type stages
//   the same 32 KB), first resolving each row's address (and scales) into
//   shared memory, then staging K/V through shared memory with VEC-byte
//   loads (neighbouring threads on neighbouring addresses); int8 tiles are
//   converted to f32 where they are used; a row with length 0 reads
//   nothing;
// - scores: one warp per row, lanes split D, a warp shuffle reduction;
//   tile max and sum: every warp reduces the tile's scores the same way,
//   so every thread holds the same running (max, sum);
// - P.V: thread d accumulates output element d in f32.
// Left for later PRs: splitting one row's KV walk across blocks
// (flash-decoding), cp.async/TMA double buffering, and filling the 132
// SMs when B * H = 64 blocks leave most of them idle; per (b, kv head)
// blocks that read K/V once for a whole GQA group.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mml {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
// KERNEL_NEG_INF of ops/attention.py: a finite start for the running max,
// so exp(m_prev - m_new) never computes inf - inf
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// butterfly reductions: every lane ends with the same value
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// one staging load of VEC bytes
template <int VEC> struct Chunk;
template <> struct Chunk<16> { using type = uint4; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<4> { using type = unsigned int; };
template <> struct Chunk<2> { using type = unsigned short; };

struct DecodeArgs {
  const void* q;             // (B, 1, H, D) f32/bf16, strides q_sb, q_sh
  const void* k;             // K store (see the addressing note above)
  const void* v;             // V store
  const int* lengths;        // (B,) live positions per row
  const int* page_table;     // (B, max_pages) int32; nullptr: dense
  const float* k_scale;      // int8 only: (pages, Hkv) f32, contiguous
  const float* v_scale;
  void* out;                 // (B, 1, H, D) contiguous, q's dtype
  int H, group, Hkv, L, D;   // L: the (virtual) cache length
  int page_size, max_pages, num_pages;
  long long q_sb, q_sh;
  long long k_sp, k_sl, k_sh;  // page (dense: row), position, kv head
  long long v_sp, v_sl, v_sh;
  float scale;
};

template <typename TQ, typename TKV, int VEC, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const DecodeArgs a) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int TILE = 128 / sizeof(TKV);
  constexpr int EPC = VEC / sizeof(TKV);  // elements per staging load
  using C = typename Chunk<VEC>::type;
  __shared__ __align__(16) TKV k_tile[TILE * kMaxD];
  __shared__ __align__(16) TKV v_tile[TILE * kMaxD];
  __shared__ long long k_row[TILE];  // element offset of each tile row
  __shared__ long long v_row[TILE];
  __shared__ float ks_row[TILE];     // scale * k dequant scale
  __shared__ float vs_row[TILE];     // v dequant scale
  __shared__ float q_s[kMaxD];
  __shared__ float s_tile[TILE];
  __shared__ float p_tile[TILE];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = a.D;
  const int ps = a.page_size;

  int length = a.lengths[b];
  length = length < 0 ? 0 : (length > a.L ? a.L : length);
  TQ* o = static_cast<TQ*>(a.out) + ((long long)b * a.H + h) * D;
  if (length == 0) {
    // nothing live: zeros, the dense path's answer for a masked row
    if (tid < D) o[tid] = from_f32<TQ>(0.f);
    return;
  }

  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.q_sb + h * a.q_sh;
  if (tid < D) q_s[tid] = to_f32<TQ>(qp[tid]);
  const int hk = h / a.group;
  const TKV* kp = static_cast<const TKV*>(a.k) + hk * a.k_sh;
  const TKV* vp = static_cast<const TKV*>(a.v) + hk * a.v_sh;
  const int* pt = PAGED ? a.page_table + (long long)b * a.max_pages : nullptr;
  const int chunks = D / EPC;  // staging loads per K/V row

  float m_run = kNegInf;
  float l_run = 0.f;
  float acc = 0.f;  // output element d = tid (tid < D)

  for (int start = 0; start < length; start += TILE) {
    const int rows = min(TILE, length - start);
    __syncthreads();  // the previous tile's readers are done
    for (int r = tid; r < rows; r += kThreads) {
      const int j = start + r;
      long long page = b;
      if (PAGED) {
        page = pt[j / ps];
        if (page < 0 || page >= a.num_pages) __trap();
      }
      const long long off = j % ps;
      k_row[r] = page * a.k_sp + off * a.k_sl;
      v_row[r] = page * a.v_sp + off * a.v_sl;
      if (kQuant) {
        ks_row[r] = a.scale * a.k_scale[page * a.Hkv + hk];
        vs_row[r] = a.v_scale[page * a.Hkv + hk];
      }
    }
    __syncthreads();
    for (int c = tid; c < rows * chunks; c += kThreads) {
      const int r = c / chunks;
      const int e = (c - r * chunks) * EPC;
      *reinterpret_cast<C*>(&k_tile[r * D + e]) =
          *reinterpret_cast<const C*>(kp + k_row[r] + e);
      *reinterpret_cast<C*>(&v_tile[r * D + e]) =
          *reinterpret_cast<const C*>(vp + v_row[r] + e);
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32)
        part += q_s[d] * to_f32<TKV>(k_tile[r * D + d]);
      part = warp_sum(part);
      if (lane == 0) s_tile[r] = part * (kQuant ? ks_row[r] : a.scale);
    }
    __syncthreads();

    float tmax = kNegInf;
    for (int r = lane; r < rows; r += 32) tmax = fmaxf(tmax, s_tile[r]);
    tmax = warp_max(tmax);
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    float psum = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float p = expf(s_tile[r] - m_new);
      psum += p;
      if (warp == 0) p_tile[r] = p;
    }
    psum = warp_sum(psum);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncthreads();

    if (tid < D) {
      float pv = 0.f;
      if (kQuant) {
        // one partial sum per page, scaled by that page's v scale
        float part = 0.f;
        for (int r = 0; r < rows; ++r) {
          if (r > 0 && (start + r) % ps == 0) {
            pv += part * vs_row[r - 1];
            part = 0.f;
          }
          part += p_tile[r] * to_f32<TKV>(v_tile[r * D + tid]);
        }
        pv += part * vs_row[rows - 1];
      } else {
        for (int r = 0; r < rows; ++r)
          pv += p_tile[r] * to_f32<TKV>(v_tile[r * D + tid]);
      }
      acc = acc * corr + pv;
    }
  }
  if (tid < D) o[tid] = from_f32<TQ>(acc / (l_run == 0.f ? 1.f : l_run));
}

// Launch for one (query type, K/V type, paging) and the load width the
// caller picked — 16 bytes for float K/V (whose head_dim the wrapper
// keeps a multiple of 8), the widest of 16/8/4/2 that divides the row
// for int8 (every even head_dim). Returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a shape or width the kernel
// does not take.
template <typename TQ, typename TKV, bool PAGED>
int launch_decode(const DecodeArgs& a, int B, int vec_bytes,
                  cudaStream_t stream) {
  if (B < 1 || B > 65535 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv ||
      a.H / a.Hkv != a.group || a.L < 1 || a.D < 2 || a.D > kMaxD ||
      a.page_size < 1 || (a.D * (int)sizeof(TKV)) % vec_bytes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.H, B);
  if constexpr (std::is_same<TKV, int8_t>::value) {
    switch (vec_bytes) {
      case 16:
        decode_attention_kernel<TQ, TKV, 16, PAGED>
            <<<grid, kThreads, 0, stream>>>(a);
        break;
      case 8:
        decode_attention_kernel<TQ, TKV, 8, PAGED>
            <<<grid, kThreads, 0, stream>>>(a);
        break;
      case 4:
        decode_attention_kernel<TQ, TKV, 4, PAGED>
            <<<grid, kThreads, 0, stream>>>(a);
        break;
      case 2:
        decode_attention_kernel<TQ, TKV, 2, PAGED>
            <<<grid, kThreads, 0, stream>>>(a);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    if (vec_bytes != 16) return (int)cudaErrorInvalidValue;
    decode_attention_kernel<TQ, TKV, 16, PAGED>
        <<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace mml

// decode_attention.cuh — the one-token attention read shared by the
// port's decode kernels (flash_decode.cu: dense slot caches, float or
// int8; paged_flash_decode.cu: page stores through a page table, float or
// int8), written as split-KV ("flash-decoding") for the H100.
//
// For each (row b, query head h) the kernels compute
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
// kernel's `* (scale * ks)`), and v's scale multiplies each row's p before
// its p * v enters the accumulator, so no partial sum mixes two pages.
//
// What bounds it on the H100: memory. A decode step reads each live K and
// V row once and does 4 * D flops per row and query head, far below the
// card's ~295 flops per byte. Least bytes for one call:
//   sum_b 2 * length_b * Hkv * D * sizeof(KV)  +  q and out (B * H * D
//   each)  +  lengths, the live page-table entries and the live pages'
//   scales
// — at B = 8, 256 live positions of 512, Hkv = 8, D = 64, bf16: 4.2 MB,
// 1.26 us at 3.35 TB/s; int8 K/V halve it. The split-KV workspace is not
// counted: it is the design's, not the algorithm's.
//
// Design (split-KV):
// - Grid (splits, Hkv * head groups, B): one block per (chunk of `chunk`
//   positions, kv head, row). A block takes the whole GQA group of query
//   heads that read its kv head (up to 8; a wider group is cut into slices
//   of 8), so K/V are read once a group. `splits` = ceil(L / chunk) comes
//   from the static cache length: the host never reads `lengths`, and a
//   block whose chunk starts at or past its row's length exits at once.
// - Inside a block: lanes split D, each lane one 16-byte load of a row
//   (8 bytes for int8, so that a lane holds at most 8 elements); the lanes
//   of one row ("a lane group") reduce its scores by xor-shuffles. Each
//   lane group takes 4 rows at a time, issuing all 8 loads before it uses
//   one, and keeps its own online softmax; each lane resolves its row's
//   page address itself (no shared-memory address pass), its first page
//   ids loading beside the row's length, and the query is staged while
//   the first rows are in flight. Lane groups merge by shuffles, the 4
//   warps once through shared memory, in a fixed order.
// - Output: each block writes its f32 partial (m, l, acc[D]) per query
//   head to a workspace the wrapper allocates. A second small kernel
//   combines a row's live splits in split order and writes the output in
//   q's dtype (exact zeros for a length-0 row). It is a programmatic
//   dependent launch: scheduled while the partials run, it waits for them
//   with griddepcontrol.wait, so its launch latency is hidden. One wrapper
//   call is still one count on its launch counter.
// - Batch invariance: chunk boundaries depend on the position alone (not
//   on B or L), the order of every sum is fixed, so a row's result is the
//   same whatever batch or cache length it sits in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mml {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
// query heads one block takes: a GQA group, or a slice of a wider one
constexpr int kMaxGroup = 8;
// rows a lane group loads before it uses them
constexpr int kRows = 4;
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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// one lane's VEC-byte slice of a K or V row, as 32-bit words
template <int VEC>
struct Slice {
  uint32_t w[VEC >= 4 ? VEC / 4 : 1];
};

template <int VEC>
__device__ __forceinline__ void load_slice(Slice<VEC>& s, const void* p) {
  if constexpr (VEC == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    s.w[0] = x.x;
    s.w[1] = x.y;
    s.w[2] = x.z;
    s.w[3] = x.w;
  } else if constexpr (VEC == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    s.w[0] = x.x;
    s.w[1] = x.y;
  } else if constexpr (VEC == 4) {
    s.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    s.w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

// element i of a slice of T values, as f32 (exact for every T)
template <typename T, int VEC>
__device__ __forceinline__ float elem(const Slice<VEC>& s, int i) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(s.w[i]);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t w = s.w[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return static_cast<float>(
        static_cast<int8_t>((s.w[i >> 2] >> (8 * (i & 3))) & 0xffu));
  }
}

struct DecodeArgs {
  const void* q;             // (B, 1, H, D) f32/bf16, strides q_sb, q_sh
  const void* k;             // K store (see the addressing note above)
  const void* v;             // V store
  const int* lengths;        // (B,) live positions per row
  const int* page_table;     // (B, max_pages) int32; nullptr: dense
  const float* k_scale;      // int8 only: (pages, Hkv) f32, contiguous
  const float* v_scale;
  void* out;                 // (B, 1, H, D) contiguous, q's dtype
  float* ws;                 // (B * H * splits) x (D + 2) f32 partials
  int B, H, group, Hkv, L, D;  // L: the (virtual) cache length
  int page_size, max_pages, num_pages;
  int chunk, splits;         // positions a split, splits a row
  long long q_sb, q_sh;
  long long k_sp, k_sl, k_sh;  // page (dense: row), position, kv head
  long long v_sp, v_sl, v_sh;
  float scale;
};

__device__ __forceinline__ int live_length(const DecodeArgs& a, int b) {
  const int n = a.lengths[b];
  return n < 0 ? 0 : (n > a.L ? a.L : n);
}

// the workspace: acc as (B, H, splits, D), then (m, l) as (B, H, splits, 2)
__device__ __forceinline__ float* ws_acc(const DecodeArgs& a, int b, int h,
                                         int split) {
  return a.ws + (((long long)b * a.H + h) * a.splits + split) * a.D;
}

__device__ __forceinline__ float* ws_ml(const DecodeArgs& a, int b, int h,
                                        int split) {
  return a.ws + (long long)a.B * a.H * a.splits * a.D +
         (((long long)b * a.H + h) * a.splits + split) * 2;
}

// One chunk of one row for the G (<= kMaxGroup) query heads of a kv head
// (or of a slice of its group).
template <typename TQ, typename TKV, int VEC, bool PAGED, int G>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const DecodeArgs a) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int EPL = VEC / (int)sizeof(TKV);  // elements a lane reads
  __shared__ __align__(16) float q_s[G * kMaxD];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][kMaxD];

  // the combine kernel may launch now: it waits for this grid's results
  // (griddepcontrol.wait) before it reads them
  asm volatile("griddepcontrol.launch_dependents;");
  const int split = blockIdx.x;
  const int hk = blockIdx.y % a.Hkv;
  const int h0 = hk * a.group + (blockIdx.y / a.Hkv) * G;
  const int gn = min(G, hk * a.group + a.group - h0);  // heads here
  const int b = blockIdx.z;
  const int start = split * a.chunk;
  const int D = a.D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // lanes a row: the row's VEC-byte slices, rounded up to a power of two
  const int slices = D * (int)sizeof(TKV) / VEC;
  int lpr = 1;
  while (lpr < slices) lpr <<= 1;
  const int sub = lane & (lpr - 1);
  const bool active = sub < slices;
  const int col = sub * EPL;
  const int group_id = tid / lpr;  // this lane group in the block
  const int n_groups = kThreads / lpr;

  const TKV* kp = static_cast<const TKV*>(a.k) + hk * a.k_sh + col;
  const TKV* vp = static_cast<const TKV*>(a.v) + hk * a.v_sh + col;
  const int* pt = PAGED ? a.page_table + (long long)b * a.max_pages : nullptr;
  const int ps = a.page_size;
  // the first rows' page ids do not depend on the length: they load
  // beside it (an entry past the length is read, never used)
  int first_page[kRows];
  if (PAGED) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      first_page[r] =
          pt[min(start + r * n_groups + group_id, a.L - 1) / ps];
  }
  const int length = live_length(a, b);
  if (start >= length) return;  // the combine reads only live splits
  const int stop = min(start + a.chunk, length);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int gl = 0; gl < G; ++gl) {
    m[gl] = kNegInf;
    l[gl] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gl][e] = 0.f;
  }

  for (int base = start; base < stop; base += n_groups * kRows) {
    Slice<VEC> ks[kRows], vs[kRows];
    float ksc[kRows], vsc[kRows];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = base + r * n_groups + group_id;
      live[r] = j < stop;
      ksc[r] = a.scale;
      vsc[r] = 1.f;
      if (live[r]) {
        long long page = b;
        if (PAGED) {
          page = base == start ? first_page[r] : pt[j / ps];
          if (page < 0 || page >= a.num_pages) __trap();
        }
        const long long off = j % ps;
        if (active) {
          load_slice<VEC>(ks[r], kp + page * a.k_sp + off * a.k_sl);
          load_slice<VEC>(vs[r], vp + page * a.v_sp + off * a.v_sl);
        }
        if (kQuant) {
          ksc[r] = a.scale * a.k_scale[page * a.Hkv + hk];
          vsc[r] = a.v_scale[page * a.Hkv + hk];
        }
      }
    }
    if (base == start) {
      // q of the block's heads, f32, while the first rows are in flight
      const TQ* qp = static_cast<const TQ*>(a.q) + b * a.q_sb;
      for (int i = tid; i < G * D; i += kThreads) {
        const int gl = i / D;
        q_s[i] = gl < gn
                     ? to_f32<TQ>(qp[(h0 + gl) * a.q_sh + (i - gl * D)])
                     : 0.f;
      }
      __syncthreads();
    }
    // scores: each lane's partial dot, summed over the row's lanes
    float s[kRows][G];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int gl = 0; gl < G; ++gl) {
        float part = 0.f;
        if (active && live[r]) {
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            part += q_s[gl * D + col + e] * elem<TKV, VEC>(ks[r], e);
        }
        for (int o = lpr >> 1; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[r][gl] = part * ksc[r];
      }
    // the lane group's online softmax over these rows
#pragma unroll
    for (int gl = 0; gl < G; ++gl) {
      float mx = m[gl];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (live[r]) mx = fmaxf(mx, s[r][gl]);
      const float corr = expf(m[gl] - mx);
      float p[kRows], psum = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // a dead row is dropped, not exponentiated
        p[r] = live[r] ? expf(s[r][gl] - mx) : 0.f;
        psum += p[r];
        p[r] *= vsc[r];
      }
      l[gl] = l[gl] * corr + psum;
      m[gl] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float pv = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (active && live[r]) pv += p[r] * elem<TKV, VEC>(vs[r], e);
        acc[gl][e] = acc[gl][e] * corr + pv;
      }
    }
  }

  // merge the warp's lane groups (lanes lpr apart hold the same columns)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int gl = 0; gl < G; ++gl) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gl], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gl], o);
      const float mn = fmaxf(m[gl], mo);
      const float ca = expf(m[gl] - mn);
      const float cb = expf(mo - mn);
      l[gl] = l[gl] * ca + lo * cb;
      m[gl] = mn;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gl][e], o);
        acc[gl][e] = acc[gl][e] * ca + ao * cb;
      }
    }
  }
  if (lane < lpr && active) {
#pragma unroll
    for (int gl = 0; gl < G; ++gl) {
      m_s[warp][gl] = m[gl];
      l_s[warp][gl] = l[gl];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc_s[warp][gl][col + e] = acc[gl][e];
    }
  }
  __syncthreads();
  // then the warps, in order, into this split's partial
  for (int i = tid; i < gn * D; i += kThreads) {
    const int gl = i / D;
    const int d = i - gl * D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][gl]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][gl] - mm);
      ll += l_s[w][gl] * c;
      aa += acc_s[w][gl][d] * c;
    }
    ws_acc(a, b, h0 + gl, split)[d] = aa;
    if (d == 0) {
      float* ml = ws_ml(a, b, h0 + gl, split);
      ml[0] = mm;
      ml[1] = ll;
    }
  }
}

// Combine each (row, query head)'s live splits, in split order, into the
// output in q's dtype; a length-0 row gets exact zeros.
template <typename TQ>
__global__ void __launch_bounds__(kMaxD)
    decode_combine_kernel(const DecodeArgs a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  if (d >= a.D) return;
  TQ* o = static_cast<TQ*>(a.out) + ((long long)b * a.H + h) * a.D;
  const int n = (live_length(a, b) + a.chunk - 1) / a.chunk;
  if (n == 0) {
    o[d] = from_f32<TQ>(0.f);  // nothing live: the dense path's zeros
    return;
  }
  // launched early (programmatic dependent launch): wait here until the
  // partial kernel has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float* ml = ws_ml(a, b, h, 0);
  const float* acc = ws_acc(a, b, h, 0) + d;
  float mm = kNegInf;
  for (int s = 0; s < n; ++s) mm = fmaxf(mm, ml[2 * s]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < n; ++s) {
    const float c = expf(ml[2 * s] - mm);
    ll += ml[2 * s + 1] * c;
    aa += acc[(long long)s * a.D] * c;
  }
  o[d] = from_f32<TQ>(aa / (ll == 0.f ? 1.f : ll));
}

template <typename TQ, typename TKV, int VEC, bool PAGED>
void launch_partial(const DecodeArgs& a, dim3 grid, int g,
                    cudaStream_t stream) {
  switch (g) {
    case 1:
      decode_partial_kernel<TQ, TKV, VEC, PAGED, 1>
          <<<grid, kThreads, 0, stream>>>(a);
      break;
    case 2:
      decode_partial_kernel<TQ, TKV, VEC, PAGED, 2>
          <<<grid, kThreads, 0, stream>>>(a);
      break;
    case 4:
      decode_partial_kernel<TQ, TKV, VEC, PAGED, 4>
          <<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      decode_partial_kernel<TQ, TKV, VEC, PAGED, kMaxGroup>
          <<<grid, kThreads, 0, stream>>>(a);
  }
}

// Launch both kernels for one (query type, K/V type, paging) and the load
// width the caller picked — 16 bytes for float K/V (whose head_dim the
// wrapper keeps a multiple of 8), the widest of 8/4/2 that divides the
// row for int8 (every even head_dim). Returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a shape, width or split plan
// the kernels do not take.
template <typename TQ, typename TKV, bool PAGED>
int launch_decode(const DecodeArgs& a, int vec_bytes, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  if (a.B < 1 || a.B > 65535 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv ||
      a.H / a.Hkv != a.group || a.L < 1 || a.D < 2 || a.D > kMaxD ||
      a.page_size < 1 || a.chunk < 1 || a.ws == nullptr ||
      a.splits != (a.L + a.chunk - 1) / a.chunk ||
      (a.D * (int)sizeof(TKV)) % vec_bytes)
    return (int)cudaErrorInvalidValue;
  // the query heads a block takes: the group, up to kMaxGroup, as the
  // smallest instantiated width that holds it
  const int g = a.group >= kMaxGroup ? kMaxGroup
                : a.group > 2        ? 4
                                     : a.group;
  const int slices_of_group = (a.group + g - 1) / g;
  if ((long long)a.Hkv * slices_of_group > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.splits, a.Hkv * slices_of_group, a.B);
  if constexpr (kQuant) {
    switch (vec_bytes) {
      case 8:
        launch_partial<TQ, TKV, 8, PAGED>(a, grid, g, stream);
        break;
      case 4:
        launch_partial<TQ, TKV, 4, PAGED>(a, grid, g, stream);
        break;
      case 2:
        launch_partial<TQ, TKV, 2, PAGED>(a, grid, g, stream);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    if (vec_bytes != 16) return (int)cudaErrorInvalidValue;
    launch_partial<TQ, TKV, 16, PAGED>(a, grid, g, stream);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the combine as a programmatic dependent launch: it is scheduled while
  // the partials run, which hides its launch, and waits for them inside
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.B);
  cfg.blockDim = dim3((a.D + 31) / 32 * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_combine_kernel<TQ>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace mml

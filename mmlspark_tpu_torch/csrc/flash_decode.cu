// flash_decode.cu — one-token attention over slot KV caches, for Hopper.
//
// Replaces mmlspark_tpu/ops/flash_attention.py:_decode_kernel (the Pallas
// kernel behind flash_decode). For each (row b, query head h) it computes
//
//   s_j = (q . k_j) * scale            for j < length[b]
//   out = sum_j softmax(s)_j * v_j     (zeros when length[b] == 0)
//
// with bf16 (or f32) operands, f32 products and sums, an f32 online
// softmax, and p kept in f32 against upcast v (not rounded to bf16: the
// JAX kernel does the same so that its output matches the dense oracle).
// Query head h reads kv head h / (H / Hkv) (grouped-query attention).
//
// What bounds it on the card: memory. A decode step reads each live K and
// V row once and does 4 * D flops per row and query head, far below the
// H100's ~295 flops per byte. Least bytes for one call:
//   sum_b 2 * length_b * Hkv * D * sizeof(T)  +  q and out (B * H * D each)
// and its bound is those bytes over the card's memory bandwidth.
//
// Design (the simple first version):
// - one thread block of 128 threads per (b, h), grid (H, B);
// - K/V are read in place through their (B, L, Hkv, D) strides — no
//   transpose copy into (B*Hkv, L, D) as the Pallas wrapper's _to_bh does;
// - the block walks only the live prefix [0, length[b]) in tiles of TILE
//   rows, staged through shared memory with 16-byte loads (neighbouring
//   threads on neighbouring addresses); a row with length 0 reads nothing;
// - scores: one warp per row, lanes split D, a warp shuffle reduction;
//   tile max and sum: every warp reduces the tile's scores the same way,
//   so every thread holds the same running (max, sum);
// - P.V: thread d accumulates output element d in f32.
// Left for later PRs: splitting one row's KV walk across blocks
// (flash-decoding), cp.async/TMA double buffering, and filling the 132
// SMs when B * H = 64 blocks leave most of them idle; per (b, kv head)
// blocks that read K/V once for a whole GQA group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ out, int H, int group, int L, int D, long long q_sb,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ __align__(16) T k_tile[TILE * kMaxD];
  __shared__ __align__(16) T v_tile[TILE * kMaxD];
  __shared__ float q_s[kMaxD];
  __shared__ float s_tile[TILE];
  __shared__ float p_tile[TILE];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int length = lengths[b];
  length = length < 0 ? 0 : (length > L ? L : length);
  T* o = out + ((long long)b * H + h) * D;
  if (length == 0) {
    // nothing live: zeros, the dense path's answer for a masked row
    if (tid < D) o[tid] = from_f32<T>(0.f);
    return;
  }

  const T* qp = q + b * q_sb + h * q_sh;
  if (tid < D) q_s[tid] = to_f32<T>(qp[tid]);
  const int hk = h / group;
  const T* kp = k + b * k_sb + hk * k_sh;
  const T* vp = v + b * v_sb + hk * v_sh;
  const int chunks = D / VEC;  // 16-byte chunks per K/V row

  float m_run = kNegInf;
  float l_run = 0.f;
  float acc = 0.f;  // output element d = tid (tid < D)

  for (int start = 0; start < length; start += TILE) {
    const int rows = min(TILE, length - start);
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < rows * chunks; c += kThreads) {
      const int r = c / chunks;
      const int e = (c - r * chunks) * VEC;
      const long long j = start + r;
      *reinterpret_cast<uint4*>(&k_tile[r * D + e]) =
          *reinterpret_cast<const uint4*>(kp + j * k_sl + e);
      *reinterpret_cast<uint4*>(&v_tile[r * D + e]) =
          *reinterpret_cast<const uint4*>(vp + j * v_sl + e);
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32)
        part += q_s[d] * to_f32<T>(k_tile[r * D + d]);
      part = warp_sum(part);
      if (lane == 0) s_tile[r] = part * scale;
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
      for (int r = 0; r < rows; ++r)
        pv += p_tile[r] * to_f32<T>(v_tile[r * D + tid]);
      acc = acc * corr + pv;
    }
  }
  if (tid < D) o[tid] = from_f32<T>(acc / (l_run == 0.f ? 1.f : l_run));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of q, k and v is contiguous. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int mml_flash_decode(int dtype, const void* q, const void* k,
                                const void* v, const void* lengths,
                                void* out, int B, int H, int Hkv, int L,
                                int D, long long q_sb, long long q_sh,
                                long long k_sb, long long k_sl,
                                long long k_sh, long long v_sb,
                                long long v_sl, long long v_sh, float scale,
                                void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || L < 1 || D < 8 ||
      D > kMaxD || D % 8 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int group = H / Hkv;
  if (dtype == 0) {
    flash_decode_kernel<float, 32><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(lengths),
        static_cast<float*>(out), H, group, L, D, q_sb, q_sh, k_sb, k_sl,
        k_sh, v_sb, v_sl, v_sh, scale);
  } else if (dtype == 1) {
    flash_decode_kernel<__nv_bfloat16, 64><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), H, group, L, D, q_sb, q_sh, k_sb,
        k_sl, k_sh, v_sb, v_sl, v_sh, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The CUDA runtime's text for an error code the launcher returned.
extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

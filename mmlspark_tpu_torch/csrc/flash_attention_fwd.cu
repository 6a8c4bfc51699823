// flash_attention_fwd.cu — the cache-free attention forward, for Hopper.
//
// Replaces mmlspark_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas
// kernel behind _flash_forward and flash_attention): blockwise causal or
// windowed grouped-query attention with an online softmax, and, on the
// gradient path, the row log-sum-exp the backward kernels recompute P from.
// Layout, numerics and masking are in flash_attention.cuh.
//
// What bounds it: at the training shape (B = 8, S = 512, H = 8, D = 64,
// bf16, causal) it must move q, k, v and out once (4 x 4 MiB) plus the
// 128 KiB LSE, about 5 us at 3.35 TB/s, and do 4 * B * H * D * S (S + 1) / 2
// = 2.2 GFLOP, about 2 us on the tensor cores: bytes bound it.
//
// Since the tensor-core forward (flash_attention_fwd_mma.cu) took the bf16
// inputs at head dims 64 and 128, this kernel serves float32 (whose f32
// products the card-vs-CPU f32 training check needs) and the other head
// dims; ops/flash_attention._fwd_route picks before the launch.
//
// Design (the simple first version): one block per (query tile, b * h).
// The query tile stays in shared memory; the block walks only the key
// tiles it can meet (the causal diagonal and the window's far edge,
// _live_k_range), staging each K and V tile once. Scores, the (m, l, acc)
// carry and P.V are f32 FMAs; the Pallas kernel's lanes-replicated
// (B * H, S, 128) LSE becomes a compact (B * H, S) one.

#include "flash_attention.cuh"

namespace {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;   // (B, S, H, D) contiguous, q's dtype
  float* lse;  // (B * H, S) f32, or nullptr when not asked for
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal, window;  // window 0: none
};

template <typename T, int MAXD, int BT>
__global__ void __launch_bounds__(mfa::kThreads)
    flash_fwd_kernel(const FwdArgs a) {
  constexpr int LD = MAXD + 1, PLD = BT + 1, RT = BT / 16, DT = MAXD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BT * LD;
  float* v_s = k_s + BT * LD;
  float* p_s = v_s + BT * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qi * BT;
  const int n_blk = (a.S + BT - 1) / BT;
  const bool causal = a.causal != 0;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  mfa::load_tile<T, BT, MAXD>(q_s, qp, a.q_ss, q0, a.S, a.D);

  float m[RT], l[RT], acc[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = mfa::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  mfa::live_k_range(qi, causal, a.window, BT, n_blk, &lo, &hi);
  for (int ki = lo; ki <= hi; ++ki) {
    if (!mfa::block_live(qi, ki, causal, a.window, BT)) continue;
    const int k0 = ki * BT;
    __syncthreads();  // the previous tile's readers are done
    mfa::load_tile<T, BT, MAXD>(k_s, kp, a.k_ss, k0, a.S, a.D);
    mfa::load_tile<T, BT, MAXD>(v_s, vp, a.v_ss, k0, a.S, a.D);
    __syncthreads();

    float s[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) s[i][j] = 0.f;
    mfa::dot_rows<RT, LD>(s, q_s, k_s, a.D, ty, tx);

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool live[RT];
      float tile_max = mfa::kNegInf;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        live[j] = !mfa::dead_entry(qpos, k0 + tx + 16 * j, a.S, causal,
                                   a.window, false);
        s[i][j] *= a.scale;
        if (live[j]) tile_max = fmaxf(tile_max, s[i][j]);
      }
      tile_max = mfa::half_warp_max(tile_max);
      const float m_new = fmaxf(m[i], tile_max);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        // dead entries are dropped, not exponentiated: a row with nothing
        // live so far keeps l == 0 exactly
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        p_s[(ty + 16 * i) * PLD + tx + 16 * j] = mfa::round_to<T>(p);
      }
      l[i] = l[i] * corr + mfa::half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    mfa::mul_tile<RT, DT, BT, LD, false>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.S) continue;  // padded query rows are never written
    T* o = static_cast<T*>(a.out) +
           (((long long)b * a.S + qpos) * a.H + h) * a.D;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D) o[d] = mfa::from_f32<T>(acc[i][c] / denom);
    }
    if (a.lse != nullptr && tx == 0)
      a.lse[(long long)bh * a.S + qpos] =
          l[i] == 0.f ? mfa::kNegInf : m[i] + logf(l[i]);
  }
}

template <typename T, int MAXD, int BT>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = mfa::smem_bytes(BT, MAXD, 3, 1, 0);
  // set once a process (per instantiation): the size is a constant of
  // the template, and a captured CUDA graph records only the launch
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, MAXD, BT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((a.S + BT - 1) / BT, a.B * a.H);
  flash_fwd_kernel<T, MAXD, BT><<<grid, mfa::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_width(const FwdArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64, 64>(a, stream);
  if (a.D <= 128) return launch<T, 128, 64>(a, stream);
  if (a.D <= 256) return launch<T, 256, 32>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Strides are in
// elements, for the (batch, position, head) dimensions; the last dimension
// is contiguous. lse may be nullptr (the inference-only forward). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int mml_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int S, int H, int Hkv, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, int window, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 || D > 256 ||
      (long long)B * H > 65535 || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_for_width<float>(a, s);
  if (dtype == 1) return launch_for_width<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The CUDA runtime's text for an error code the launcher returned.
extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

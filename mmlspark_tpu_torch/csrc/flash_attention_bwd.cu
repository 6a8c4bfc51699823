// flash_attention_bwd.cu — the gradient of the cache-free attention, for
// Hopper: two kernels.
//
// mml_flash_attention_bwd_kv replaces
// mmlspark_tpu/ops/flash_attention.py:_bwd_kv_kernel (dV += P^T.dO,
// dK += dS^T.Q * scale) and the group sum the Pallas wrapper
// _flash_backward runs after it in XLA; mml_flash_attention_bwd_q replaces
// _bwd_q_kernel (dQ += dS.K * scale). Both recompute P from q, k and the
// forward's row log-sum-exp, P = exp(q.k * scale - lse) with masked and
// padded entries exactly 0, and form dS = P * (dO.v - D) with
// D = rowsum(dO * out), which the caller computes (as the Pallas wrapper
// leaves it to XLA). Layout and numerics: flash_attention.cuh.
//
// What bounds them: at the training shape (B = 8, S = 512, H = 8, D = 64,
// bf16, causal) the dK/dV kernel must read q, k, v, dO, LSE and D and
// write dk and dv, about 25 MB, 7.6 us at 3.35 TB/s; the dQ kernel reads
// the same and writes dq, about 21 MB, 6.3 us. Their products (8 * B * H *
// D * S (S + 1) / 2 flops each, 4.3 GFLOP, about 4 us on the tensor cores)
// weigh less: bytes bound both.
//
// Design (the simple first version):
// - dK/dV: one block per (key tile, b * kv head). K and V stay in shared
//   memory; the block loops over the group's query heads and, for each,
//   over the query tiles that can meet the key tile (the causal diagonal
//   and the window, the transpose of _live_k_range). dK and dV stay in f32
//   registers across the whole group and are cast once: the Pallas path
//   writes a dK per query head in the input dtype and sums the group in
//   f32 after, so in bf16 under GQA this kernel rounds less than it. No
//   atomics: a kv head's tile belongs to one block.
// - dQ: one block per (query tile, b * h), looping over the live key tiles
//   as the forward does, dQ in f32 registers.

#include "flash_attention.cuh"

namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B * H, S) f32
  const float* delta;  // (B * H, S) f32, rowsum(dO * out)
  void* dq;            // (B, S, H, D) contiguous, q's dtype
  void* dk;            // (B, S, Hkv, D) contiguous, k's dtype
  void* dv;            // (B, S, Hkv, D) contiguous, v's dtype
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  float scale;
  int causal, window;  // window 0: none
};

// the score and dP tiles of one (query tile, key tile) pair, then P and dS:
// p[i][j] and ds[i][j] for query row ty + 16 i, key column tx + 16 j
template <int RT, int LD>
__device__ __forceinline__ void p_and_ds(
    const BwdArgs& a, const float* q_s, const float* k_s, const float* do_s,
    const float* v_s, const float* lse_s, const float* dd_s, int q0, int k0,
    int ty, int tx, float (&p)[RT][RT], float (&ds)[RT][RT]) {
  float dp[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) p[i][j] = dp[i][j] = 0.f;
  mfa::dot_rows<RT, LD>(p, q_s, k_s, a.D, ty, tx);
  mfa::dot_rows<RT, LD>(dp, do_s, v_s, a.D, ty, tx);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qr = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const bool dead = mfa::dead_entry(q0 + qr, k0 + tx + 16 * j, a.S,
                                        a.causal != 0, a.window, true);
      p[i][j] = dead ? 0.f : expf(p[i][j] * a.scale - lse_s[qr]);
      ds[i][j] = p[i][j] * (dp[i][j] - dd_s[qr]);
    }
  }
}

// stage one query tile of head h: q, dO, and its LSE and D rows
template <typename T, int BT, int MAXD>
__device__ __forceinline__ void load_query_side(const BwdArgs& a, int b, int h,
                                                int q0, float* q_s,
                                                float* do_s, float* lse_s,
                                                float* dd_s) {
  mfa::load_tile<T, BT, MAXD>(
      q_s, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
      a.S, a.D);
  mfa::load_tile<T, BT, MAXD>(
      do_s, static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh, a.o_ss,
      q0, a.S, a.D);
  if (threadIdx.x < BT) {
    const int pos = q0 + threadIdx.x;
    const long long row = ((long long)b * a.H + h) * a.S + pos;
    lse_s[threadIdx.x] = pos < a.S ? a.lse[row] : 0.f;
    dd_s[threadIdx.x] = pos < a.S ? a.delta[row] : 0.f;
  }
}

template <typename T, int BT, int MAXD>
__device__ __forceinline__ void load_key_side(const BwdArgs& a, int b, int hk,
                                              int k0, float* k_s,
                                              float* v_s) {
  mfa::load_tile<T, BT, MAXD>(
      k_s, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh, a.k_ss, k0,
      a.S, a.D);
  mfa::load_tile<T, BT, MAXD>(
      v_s, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh, a.v_ss, k0,
      a.S, a.D);
}

template <typename T, int MAXD, int BT>
__global__ void __launch_bounds__(mfa::kThreads)
    flash_bwd_kv_kernel(const BwdArgs a) {
  constexpr int LD = MAXD + 1, PLD = BT + 1, RT = BT / 16, DT = MAXD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BT * LD;
  float* q_s = v_s + BT * LD;
  float* do_s = q_s + BT * LD;
  float* p_s = do_s + BT * LD;
  float* ds_s = p_s + BT * PLD;
  float* lse_s = ds_s + BT * PLD;
  float* dd_s = lse_s + BT;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int ki = blockIdx.x;
  const int b = blockIdx.y / a.Hkv;
  const int hk = blockIdx.y - b * a.Hkv;
  const int group = a.H / a.Hkv;
  const int k0 = ki * BT;
  const int n_blk = (a.S + BT - 1) / BT;
  const bool causal = a.causal != 0;

  load_key_side<T, BT, MAXD>(a, b, hk, k0, k_s, v_s);
  float dk[RT][DT], dv[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < DT; ++c) dk[i][c] = dv[i][c] = 0.f;

  int lo, hi;
  mfa::live_q_range(ki, causal, a.window, BT, n_blk, &lo, &hi);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qi = lo; qi <= hi; ++qi) {
      if (!mfa::block_live(qi, ki, causal, a.window, BT)) continue;
      const int q0 = qi * BT;
      __syncthreads();  // the previous tile's readers are done
      load_query_side<T, BT, MAXD>(a, b, h, q0, q_s, do_s, lse_s, dd_s);
      __syncthreads();
      float p[RT][RT], ds[RT][RT];
      p_and_ds<RT, LD>(a, q_s, k_s, do_s, v_s, lse_s, dd_s, q0, k0, ty, tx,
                       p, ds);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int at = (ty + 16 * i) * PLD + tx + 16 * j;
          p_s[at] = mfa::round_to<T>(p[i][j]);    // to dO's dtype
          ds_s[at] = mfa::round_to<T>(ds[i][j]);  // to q's dtype
        }
      __syncthreads();
      // this thread's dK/dV rows are key rows ty + 16 i: P^T and dS^T
      mfa::mul_tile<RT, DT, BT, LD, true>(dv, p_s, do_s, ty, tx);
      mfa::mul_tile<RT, DT, BT, LD, true>(dk, ds_s, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.S) continue;
    const long long row = (((long long)b * a.S + kpos) * a.Hkv + hk) * a.D;
    T* dkp = static_cast<T*>(a.dk) + row;
    T* dvp = static_cast<T*>(a.dv) + row;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D) {
        dkp[d] = mfa::from_f32<T>(dk[i][c] * a.scale);
        dvp[d] = mfa::from_f32<T>(dv[i][c]);
      }
    }
  }
}

template <typename T, int MAXD, int BT>
__global__ void __launch_bounds__(mfa::kThreads)
    flash_bwd_q_kernel(const BwdArgs a) {
  constexpr int LD = MAXD + 1, PLD = BT + 1, RT = BT / 16, DT = MAXD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BT * LD;
  float* k_s = do_s + BT * LD;
  float* v_s = k_s + BT * LD;
  float* ds_s = v_s + BT * LD;
  float* lse_s = ds_s + BT * PLD;
  float* dd_s = lse_s + BT;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qi = blockIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qi * BT;
  const int n_blk = (a.S + BT - 1) / BT;
  const bool causal = a.causal != 0;

  load_query_side<T, BT, MAXD>(a, b, h, q0, q_s, do_s, lse_s, dd_s);
  float dq[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < DT; ++c) dq[i][c] = 0.f;

  int lo, hi;
  mfa::live_k_range(qi, causal, a.window, BT, n_blk, &lo, &hi);
  for (int ki = lo; ki <= hi; ++ki) {
    if (!mfa::block_live(qi, ki, causal, a.window, BT)) continue;
    const int k0 = ki * BT;
    __syncthreads();  // the previous tile's readers are done
    load_key_side<T, BT, MAXD>(a, b, hk, k0, k_s, v_s);
    __syncthreads();
    float p[RT][RT], ds[RT][RT];
    p_and_ds<RT, LD>(a, q_s, k_s, do_s, v_s, lse_s, dd_s, q0, k0, ty, tx, p,
                     ds);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j)
        ds_s[(ty + 16 * i) * PLD + tx + 16 * j] =
            mfa::round_to<T>(ds[i][j]);  // to k's dtype
    __syncthreads();
    mfa::mul_tile<RT, DT, BT, LD, false>(dq, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.S) continue;
    T* dqp = static_cast<T*>(a.dq) +
             (((long long)b * a.S + qpos) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D) dqp[d] = mfa::from_f32<T>(dq[i][c] * a.scale);
    }
  }
}

template <typename T, int MAXD, int BT>
int launch_kv(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = mfa::smem_bytes(BT, MAXD, 4, 2, 2);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<T, MAXD, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + BT - 1) / BT, a.B * a.Hkv);
  flash_bwd_kv_kernel<T, MAXD, BT><<<grid, mfa::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MAXD, int BT>
int launch_q(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = mfa::smem_bytes(BT, MAXD, 4, 1, 2);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_q_kernel<T, MAXD, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + BT - 1) / BT, a.B * a.H);
  flash_bwd_q_kernel<T, MAXD, BT><<<grid, mfa::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// which: 0 = dK/dV, 1 = dQ
template <typename T>
int launch_for_width(const BwdArgs& a, int which, cudaStream_t stream) {
  if (a.D <= 64)
    return which ? launch_q<T, 64, 64>(a, stream)
                 : launch_kv<T, 64, 64>(a, stream);
  if (a.D <= 128)
    return which ? launch_q<T, 128, 64>(a, stream)
                 : launch_kv<T, 128, 64>(a, stream);
  if (a.D <= 256)
    return which ? launch_q<T, 256, 32>(a, stream)
                 : launch_kv<T, 256, 32>(a, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_bwd(int which, int dtype, const void* q, const void* k,
               const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int B, int S,
               int H, int Hkv, int D, long long q_sb, long long q_ss,
               long long q_sh, long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               long long o_sb, long long o_ss, long long o_sh, float scale,
               int causal, int window, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 || D > 256 ||
      (long long)B * H > 65535 || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
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
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_for_width<float>(a, which, s);
  if (dtype == 1) return launch_for_width<__nv_bfloat16>(a, which, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the gradients alike).
// Strides are in elements, for the (batch, position, head) dimensions of q,
// k, v and dO; the last dimension is contiguous. lse and delta are compact
// (B * H, S) f32. Each returns cudaGetLastError() after its launch (0 =
// launched), or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int mml_flash_attention_bwd_kv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, int window, void* stream) {
  return launch_bwd(0, dtype, q, k, v, dout, lse, delta, nullptr, dk, dv, B,
                    S, H, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                    v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal, window,
                    stream);
}

extern "C" int mml_flash_attention_bwd_q(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H,
    int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, int window, void* stream) {
  return launch_bwd(1, dtype, q, k, v, dout, lse, delta, dq, nullptr,
                    nullptr, B, S, H, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss,
                    k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal,
                    window, stream);
}

// The CUDA runtime's text for an error code the launcher returned.
extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

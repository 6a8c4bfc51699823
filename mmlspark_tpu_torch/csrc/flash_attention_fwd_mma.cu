// flash_attention_fwd_mma.cu — the cache-free attention forward on the
// H100's tensor cores, for bf16 at head dims 64 and 128.
//
// Replaces mmlspark_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas
// kernel behind _flash_forward and flash_attention) on the bf16 route;
// float32 and other head dims keep flash_attention_fwd.cu, whose f32
// products the card-vs-CPU f32 training check needs. The route is chosen
// before the launch, from dtype, head dim and alignment
// (ops/flash_attention._fwd_route). Numerics and the masking geometry are
// flash_attention.cuh's: f32 scores times the scale, an online softmax in
// f32 from -1e30, P rounded to bf16 before P.V, dead entries exactly 0, a
// row with nothing live gives zeros and LSE -1e30.
//
// What bounds it on the H100: at the training shape (B = 8, S = 512,
// H = Hkv = 8, D = 64, causal) it must move q, k, v and out once (4 x 4
// MiB) and the 128 KiB LSE: 16.9 MB, 5.05 us at 3.35 TB/s; the causal
// products are 2.15 GFLOP, 2.2 us at 989 bf16 TFLOP/s. Bytes bound it.
//
// Design. One block of 4 warps per (b * h, query tile of 64 rows), each
// warp owning 16 query rows:
// - K and V tiles of 64 keys stay bf16 in shared memory, rows XOR-swizzled
//   in 16-byte chunks (mma_fragments.cuh) so ldmatrix reads no bank twice;
//   they are staged with 16-byte cp.async and double-buffered: tile k+1 is
//   in flight while tile k is used. Padded rows (past S) are zero-filled.
// - S = Q.K^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate). At D = 64
//   a warp's Q fragments stay in registers for the whole walk; at D = 128
//   they are reloaded from shared memory each tile, which keeps the kernel
//   near 128 registers a thread.
// - The online softmax runs in registers on the accumulator fragments, a
//   quad shuffle per row; P is rounded to bf16 in registers and fed back
//   as the A operand of P.V, V through ldmatrix.trans; O is f32 in
//   registers.
// - Masks are computed only on tiles that cross the causal diagonal, the
//   window's far edge or the end of the sequence; the block walks only the
//   key tiles live_k_range admits.
// - Heaviest query tiles first: under causal masking blockIdx.y runs the
//   query tiles from the last (which meets every key tile) to the first.
// - Epilogue: divide by l, stage the warp's 16 rows in shared memory, and
//   store them with 16-byte stores; the LSE goes to the compact (B * H, S)
//   f32 tensor.

#include "flash_attention.cuh"
#include "mma_fragments.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // query rows a block
constexpr int kBN = 64;  // keys a tile (the geometry's one tile size)
constexpr int kThreadsMma = 128;

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;   // (B, S, H, D) contiguous
  float* lse;  // (B * H, S) f32, or nullptr when not asked for
  int B, S, H, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal, window;  // window 0: none
};

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
    flash_fwd_mma_kernel(const FwdArgs a) {
  constexpr int NKS = D / 16;  // k-steps of Q.K^T
  constexpr int NDB = D / 8;   // n-blocks of P.V
  constexpr bool kQRegs = D <= 64;
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* k_s = q_s + kBM * D;      // two buffers
  bf16* v_s = k_s + 2 * kBN * D;  // two buffers

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const bool causal = a.causal != 0;
  const int n_blk = (a.S + kBM - 1) / kBM;
  const int qi = causal ? n_blk - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qi * kBM;
  const int row_a = q0 + warp * 16 + g;  // this lane's two query rows
  const int row_b = row_a + 8;

  const bf16* qp = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kp = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = a.v + b * a.v_sb + hk * a.v_sh;

  int lo, hi;
  mfa::live_k_range(qi, causal, a.window, kBN, n_blk, &lo, &hi);
  mma::stage_rows<D, kBN, kThreadsMma>(q_s, qp, a.q_ss, q0, a.S);
  mma::stage_rows<D, kBN, kThreadsMma>(k_s, kp, a.k_ss, lo * kBN, a.S);
  mma::stage_rows<D, kBN, kThreadsMma>(v_s, vp, a.v_ss, lo * kBN, a.S);
  mma::cp_async_commit();

  uint32_t qf[kQRegs ? NKS : 1][4];
  float o[NDB][4];
#pragma unroll
  for (int n = 0; n < NDB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {mfa::kNegInf, mfa::kNegInf};
  float l[2] = {0.f, 0.f};
  // this lane's ldmatrix row within a 16-row A block and its column half
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;

  for (int ki = lo; ki <= hi; ++ki) {
    const int buf = (ki - lo) & 1;
    if (ki < hi) {
      mma::stage_rows<D, kBN, kThreadsMma>(k_s + (buf ^ 1) * kBN * D, kp,
                                           a.k_ss, (ki + 1) * kBN, a.S);
      mma::stage_rows<D, kBN, kThreadsMma>(v_s + (buf ^ 1) * kBN * D, vp,
                                           a.v_ss, (ki + 1) * kBN, a.S);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (kQRegs && ki == lo) {
#pragma unroll
      for (int ks = 0; ks < (kQRegs ? NKS : 1); ++ks)
        mma::ldmatrix_x4(qf[ks], q_s + mma::swz<D>(a_row, ks * 16 + a_col));
    }
    const bf16* kt = k_s + buf * kBN * D;
    const bf16* vt = v_s + buf * kBN * D;

    // S = Q.K^T: 16 rows x 64 keys a warp, 8 n-blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
      } else {
        mma::ldmatrix_x4(qa, q_s + mma::swz<D>(a_row, ks * 16 + a_col));
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        // keys n2*16 + 0..15, columns ks*16 + 0..15: {b0, b1} of n-block
        // 2*n2, then of 2*n2 + 1
        uint32_t kb[4];
        mma::ldmatrix_x4(
            kb, kt + mma::swz<D>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                 ks * 16 + ((lane >> 3) & 1) * 8));
        mma::mma_bf16(s[2 * n2], qa, kb[0], kb[1]);
        mma::mma_bf16(s[2 * n2 + 1], qa, kb[2], kb[3]);
      }
    }

    // scale, mask (edge tiles only), and the online softmax of each row
    const int k0 = ki * kBN;
    const bool edge = k0 + kBN > a.S || (causal && k0 + kBN - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + kBM - 1 - a.window);
    float mx[2] = {mfa::kNegInf, mfa::kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = s[n][e] * a.scale;
        const bool dead =
            edge && mfa::dead_entry(r ? row_b : row_a, k0 + n * 8 + 2 * t +
                                                           (e & 1),
                                    a.S, causal, a.window, false);
        // a dead entry is dropped, not exponentiated: exp(-inf) is 0
        // exactly, and a row with nothing live keeps l == 0
        s[n][e] = dead ? __int_as_float(0xff800000) : x;
        if (!dead) mx[r] = fmaxf(mx[r], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    uint32_t pa[4][4];  // P as the A operand of P.V, 4 k-steps of 16 keys
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[n][e] - m[e >> 1]);
        psum[e >> 1] += p[e];
      }
      pa[n >> 1][(n & 1) * 2] = mma::pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = mma::pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < NDB; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P.V: keys kk*16 + 0..15, head columns d2*16 + 0..15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // a0..a3 of P: (g, keys 2t..) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..)
      const uint32_t pf[4] = {pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]};
#pragma unroll
      for (int d2 = 0; d2 < NDB / 2; ++d2) {
        uint32_t vb[4];
        mma::ldmatrix_x4_trans(
            vb, vt + mma::swz<D>(kk * 16 + (lane & 7) +
                                     (((lane >> 3) & 1) << 3),
                                 d2 * 16 + (lane >> 4) * 8));
        mma::mma_bf16(o[2 * d2], pf, vb[0], vb[1]);
        mma::mma_bf16(o[2 * d2 + 1], pf, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  // epilogue: the warp's 16 rows through its own rows of q_s (no other
  // warp reads them), then 16-byte stores
  const float den[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  bf16* os = q_s;
#pragma unroll
  for (int n = 0; n < NDB; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(os + mma::swz<D>(warp * 16 + g, col)) =
        mma::pack_bf16(o[n][0] / den[0], o[n][1] / den[0]);
    *reinterpret_cast<uint32_t*>(os + mma::swz<D>(warp * 16 + g + 8, col)) =
        mma::pack_bf16(o[n][2] / den[1], o[n][3] / den[1]);
  }
  __syncwarp();
  constexpr int CPR = D / 8;
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR;
    const int col = (c - r * CPR) * 8;
    const int pos = q0 + warp * 16 + r;
    if (pos < a.S)  // padded query rows are never written
      *reinterpret_cast<uint4*>(a.out + (((long long)b * a.S + pos) * a.H +
                                         h) * D + col) =
          *reinterpret_cast<const uint4*>(os + mma::swz<D>(warp * 16 + r,
                                                           col));
  }
  if (a.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = r ? row_b : row_a;
      if (pos < a.S)
        a.lse[(long long)bh * a.S + pos] =
            l[r] == 0.f ? mfa::kNegInf : m[r] + logf(l[r]);
    }
  }
}

template <int D>
int launch(const FwdArgs& a, cudaStream_t stream) {
  constexpr int smem = (kBM + 4 * kBN) * D * (int)sizeof(bf16);
  static bool sized = false;  // the attribute is set once a process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(a.B * a.H, (a.S + kBM - 1) / kBM);
  flash_fwd_mma_kernel<D><<<grid, kThreadsMma, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, long long sb, long long ss, long long sh) {
  // every row start 16 bytes aligned: the base and every stride (bf16)
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

}  // namespace

// bf16 q, k, v and out; D = 64 or 128. Strides are in elements, for the
// (batch, position, head) dimensions; the last dimension is contiguous and
// every row starts on a 16-byte boundary. lse may be nullptr (the
// inference-only forward). Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for a shape or layout the
// kernel does not take.
extern "C" int mml_flash_attention_fwd_mma(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int window, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv ||
      (long long)B * H > 0x7fffffffLL || (S + kBM - 1) / kBM > 65535 ||
      window < 0 || (window > 0 && !causal) || (D != 64 && D != 128) ||
      !aligned16(q, q_sb, q_ss, q_sh) || !aligned16(k, k_sb, k_ss, k_sh) ||
      !aligned16(v, v_sb, v_ss, v_sh) ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  FwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
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
  return D == 64 ? launch<64>(a, s) : launch<128>(a, s);
}

// The CUDA runtime's text for an error code the launcher returned.
extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

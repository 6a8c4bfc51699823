// flash_attention_bwd_mma.cu — the gradient of the cache-free attention on
// the H100's tensor cores, for bf16 at head dims 64 and 128: two kernels.
//
// mml_flash_attention_bwd_kv_mma replaces
// mmlspark_tpu/ops/flash_attention.py:_bwd_kv_kernel (dV += P^T.dO,
// dK += dS^T.Q * scale) and the group sum _flash_backward runs after it in
// XLA; mml_flash_attention_bwd_q_mma replaces _bwd_q_kernel
// (dQ += dS.K * scale). The route is chosen before the launch, from dtype,
// head dim and alignment (ops/flash_attention._bwd_route); float32 and
// other head dims keep flash_attention_bwd.cu. Numerics and the masking
// geometry are flash_attention.cuh's: f32 scores times the scale, P
// recomputed from the forward's row log-sum-exp, dS = P * (dO.v - D) with
// D = rowsum(dO * out) from the caller, P rounded to bf16 before dV and dS
// before dK and dQ, f32 sums cast once, dead and padded entries exactly 0.
// exp(x) is taken as exp2(x * log2 e), the scale and the LSE multiplied by
// log2 e first: one MUFU operation where expf takes about eight, at a cost
// of a few f32 ulps before P is rounded to bf16.
//
// What bounds them on the H100: at the training shape (B = 8, S = 512,
// H = Hkv = 8, D = 64, causal) dK/dV must read q, k, v, dO, LSE and D and
// write dk and dv, 25.4 MB, 7.6 us at 3.35 TB/s; dQ reads the same and
// writes dq, 21.2 MB, 6.3 us. Their causal products are 4.30 and 3.23
// GFLOP, 4.3 and 3.3 us at 989 bf16 TFLOP/s. Bytes bound both, the
// products close behind. The design reads each tile from device memory
// once a block and reuses it from shared memory in all four warps, keeps P
// and dS in registers, and runs every product on the tensor cores; what
// stands between it and the bound is latency (4 warps a block, a barrier
// a tile, the exps between dependent products), which the occupancy
// choices below trade against registers.
//
// Design.
// - dK/dV: one block of 4 warps per (b * kv head, key tile of 64), each
//   warp owning 16 key rows; the key tiles run from the first, which meets
//   the most query tiles under causal masking. The block walks the GQA
//   group's query heads and, for each, the query tiles live_q_range
//   admits, as one flat walk, so the staging pipeline runs across head
//   boundaries. Q and dO tiles of 64 rows are staged bf16 by 16-byte
//   cp.async into swizzled tiles and double-buffered (tile i + 1 in flight
//   while tile i is used), with the tile's 64 LSE and D values beside them
//   (4-byte cp.async). S^T = K.Q^T and dP^T = V.dO^T take Q and dO
//   through non-transposing ldmatrix; P^T = exp(S^T * scale - LSE[col])
//   and dS^T = P^T * (dP^T - D[col]) run on the accumulator fragments,
//   are rounded to bf16 in registers and fed back as the A operand of
//   dV += P^T.dO and dK += dS^T.Q, with dO and Q through ldmatrix.trans:
//   P and dS never touch shared memory. dK and dV are f32 fragments for
//   the whole walk, cast once; no atomics (a kv head's key tile belongs to
//   one block). At D = 64 a warp's K and V fragments stay in registers (168
//   registers a thread, 3 blocks an SM); at D = 128 they are reloaded from
//   shared memory each k-step and the query tile is walked 16 queries at a
//   time (32 at D = 64), which keeps the 256 accumulators of dK and dV
//   beside the scores.
// - dQ: the forward's structure. One block of 4 warps per (b * h, query
//   tile of 64), each warp owning 16 query rows, heaviest query tiles
//   first under causal masking; K and V tiles double-buffered by cp.async.
//   S = Q.K^T and dP = dO.V^T, P = exp(S * scale - LSE[row]) and dS = P *
//   (dP - D[row]) with the row's LSE and D in two registers a lane; dS in
//   registers is the A operand of dQ += dS.K, K through ldmatrix.trans.
//   A warp's Q and dO fragments are read from shared memory at each k-step
//   rather than held in 32 registers: at D = 64 that holds the kernel to
//   168 registers, 3 blocks an SM, which gains more than the extra
//   ldmatrix costs. dQ is multiplied by the scale once.
// - Two kernels, not one with atomics: dQ's f32 sum runs over the key
//   tiles in a fixed order, so a backward call is bit-reproducible.
// - Masks are computed only on tile pairs that cross the causal diagonal,
//   the window's far edge or the end of the sequence, for keys and (the
//   backward's rule) for queries alike.
// - Epilogues: each warp stages its 16 output rows in its own rows of a
//   tile it no longer reads and stores them with 16-byte stores.

#include "flash_attention.cuh"
#include "mma_fragments.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // query rows a tile
constexpr int kBN = 64;  // keys a tile (the geometry's one tile size)
constexpr int kThreadsMma = 128;
// P = exp(x) is computed as exp2(x * log2 e), one MUFU operation
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (B * H, S) f32
  const float* delta;  // (B * H, S) f32, rowsum(dO * out)
  bf16* dq;            // (B, S, H, D) contiguous
  bf16* dk;            // (B, S, Hkv, D) contiguous
  bf16* dv;            // (B, S, Hkv, D) contiguous
  int B, S, H, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  float scale;
  int causal, window;  // window 0: none
};

// may any (query, key) pair of the tiles at q0 and k0 be dead? Past S on
// either side, across the causal diagonal, or past the window's far edge
__device__ __forceinline__ bool edge_pair(const BwdArgs& a, int q0, int k0) {
  return q0 + kBM > a.S || k0 + kBN > a.S ||
         (a.causal && k0 + kBN - 1 > q0) ||
         (a.window > 0 && k0 <= q0 + kBM - 1 - a.window);
}

// acc[n] += A . X^T over one k-step of 16 head columns: A a warp's 16 x 16
// fragment, X rows x0 .. x0 + 8 NB - 1 of a swizzled tile through
// non-transposing ldmatrix (n-block n holds rows x0 + 8n ..)
template <int D, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4],
                                        const uint32_t (&af)[4],
                                        const bf16* x, int x0, int ks,
                                        int lane) {
#pragma unroll
  for (int n2 = 0; n2 < NB / 2; ++n2) {
    // rows n2*16 + 0..15, columns ks*16 + 0..15: {b0, b1} of n-block
    // 2*n2, then of 2*n2 + 1
    uint32_t xb[4];
    mma::ldmatrix_x4(
        xb, x + mma::swz<D>(x0 + n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                            ks * 16 + ((lane >> 3) & 1) * 8));
    mma::mma_bf16(acc[2 * n2], af, xb[0], xb[1]);
    mma::mma_bf16(acc[2 * n2 + 1], af, xb[2], xb[3]);
  }
}

// acc[n] += P . X for one k-step of 16 rows: P a warp's 16 x 16 A fragment
// in registers, X rows x0 .. x0 + 15 of a swizzled tile through
// ldmatrix.trans, all D columns (n-block n holds columns 8n ..)
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&pf)[4],
                                       const bf16* x, int x0, int lane) {
#pragma unroll
  for (int d2 = 0; d2 < D / 16; ++d2) {
    uint32_t xb[4];
    mma::ldmatrix_x4_trans(
        xb, x + mma::swz<D>(x0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                            d2 * 16 + (lane >> 4) * 8));
    mma::mma_bf16(acc[2 * d2], pf, xb[0], xb[1]);
    mma::mma_bf16(acc[2 * d2 + 1], pf, xb[2], xb[3]);
  }
}

// a warp's 16 x D accumulator rows, times mul and rounded to bf16, into
// rows r0 .. r0 + 15 of a swizzled tile (rows only this warp reads), then
// to rows p0 + r (< S) of a (rows of `stride` elements) output, 16 bytes a
// store
template <int D>
__device__ __forceinline__ void store_rows(bf16* tile, int r0,
                                           const float (&acc)[D / 8][4],
                                           float mul, bf16* out,
                                           long long stride, int p0, int S,
                                           int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + mma::swz<D>(r0 + g, col)) =
        mma::pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(tile + mma::swz<D>(r0 + g + 8, col)) =
        mma::pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int CPR = D / 8;
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR;
    const int col = (c - r * CPR) * 8;
    if (p0 + r < S)  // padded rows are never written
      *reinterpret_cast<uint4*>(out + (p0 + r) * stride + col) =
          *reinterpret_cast<const uint4*>(tile + mma::swz<D>(r0 + r, col));
  }
}

// the query side of one dK/dV step: rows [q0, q0 + 64) of query head h —
// q and dO tiles, and their 64 LSE and D values
template <int D>
__device__ __forceinline__ void stage_query_side(const BwdArgs& a, int b,
                                                 int h, int q0, bf16* q_s,
                                                 bf16* do_s, float* lse_s,
                                                 float* dd_s) {
  mma::stage_rows<D, kBM, kThreadsMma>(q_s, a.q + b * a.q_sb + h * a.q_sh,
                                       a.q_ss, q0, a.S);
  mma::stage_rows<D, kBM, kThreadsMma>(
      do_s, a.dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0, a.S);
  const int i = threadIdx.x & (kBM - 1);
  const int pos = q0 + i;
  const long long row = ((long long)b * a.H + h) * a.S;
  const float* src = threadIdx.x < kBM ? a.lse + row : a.delta + row;
  float* dst = threadIdx.x < kBM ? lse_s : dd_s;
  mma::cp_async4(dst + i, pos < a.S ? src + pos : src, pos < a.S ? 4 : 0);
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
    flash_bwd_kv_mma_kernel(const BwdArgs a) {
  constexpr int NKS = D / 16;  // k-steps of S^T and dP^T
  constexpr int NDB = D / 8;   // n-blocks of dK and dV
  constexpr bool kRegs = D <= 64;
  constexpr int QC = kRegs ? 32 : 16;  // queries a chunk
  constexpr int NQ = QC / 8;           // n-blocks of a chunk's S^T
  extern __shared__ uint4 smem_u4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* v_s = k_s + kBN * D;
  bf16* q_s = v_s + kBN * D;       // two buffers
  bf16* do_s = q_s + 2 * kBM * D;  // two buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBM * D);  // two
  float* dd_s = lse_s + 2 * kBM;                                 // two

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / a.Hkv;
  const int hk = blockIdx.x - b * a.Hkv;
  const int group = a.H / a.Hkv;
  const bool causal = a.causal != 0;
  const int n_blk = (a.S + kBN - 1) / kBN;
  const int ki = blockIdx.y;
  const int k0 = ki * kBN;
  const int key_a = k0 + warp * 16 + g;  // this lane's two key rows
  const int key_b = key_a + 8;
  const float scale2 = a.scale * kLog2e;

  int lo, hi;
  mfa::live_q_range(ki, causal, a.window, kBN, n_blk, &lo, &hi);
  const int nq = hi - lo + 1;   // query tiles a head
  const int n_it = group * nq;  // the walk: (head, query tile) pairs

  mma::stage_rows<D, kBN, kThreadsMma>(k_s, a.k + b * a.k_sb + hk * a.k_sh,
                                       a.k_ss, k0, a.S);
  mma::stage_rows<D, kBN, kThreadsMma>(v_s, a.v + b * a.v_sb + hk * a.v_sh,
                                       a.v_ss, k0, a.S);
  stage_query_side<D>(a, b, hk * group, lo * kBM, q_s, do_s, lse_s, dd_s);
  mma::cp_async_commit();

  uint32_t kf[kRegs ? NKS : 1][4], vf[kRegs ? NKS : 1][4];
  float dk[NDB][4], dv[NDB][4];
#pragma unroll
  for (int n = 0; n < NDB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // this lane's ldmatrix row within the warp's 16 key rows, its column half
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      const int nx = it + 1;
      const int nb = buf ^ 1;
      stage_query_side<D>(a, b, hk * group + nx / nq, (lo + nx % nq) * kBM,
                          q_s + nb * kBM * D, do_s + nb * kBM * D,
                          lse_s + nb * kBM, dd_s + nb * kBM);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kRegs) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < (kRegs ? NKS : 1); ++ks) {
          mma::ldmatrix_x4(kf[ks], k_s + mma::swz<D>(a_row, ks * 16 + a_col));
          mma::ldmatrix_x4(vf[ks], v_s + mma::swz<D>(a_row, ks * 16 + a_col));
        }
      }
    }
    const int q0 = (lo + it % nq) * kBM;
    const bf16* qt = q_s + buf * kBM * D;
    const bf16* dt = do_s + buf * kBM * D;
    const float* lt = lse_s + buf * kBM;
    const float* ddt = dd_s + buf * kBM;
    const bool edge = edge_pair(a, q0, k0);

#pragma unroll
    for (int qc = 0; qc < kBM; qc += QC) {
      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x QC queries a warp
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        uint32_t ka[4], va[4];
        if constexpr (kRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[ks][e];
            va[e] = vf[ks][e];
          }
        } else {
          mma::ldmatrix_x4(ka, k_s + mma::swz<D>(a_row, ks * 16 + a_col));
          mma::ldmatrix_x4(va, v_s + mma::swz<D>(a_row, ks * 16 + a_col));
        }
        mma_abt<D, NQ>(s, ka, qt, qc, ks, lane);
        mma_abt<D, NQ>(dp, va, dt, qc, ks, lane);
      }

      // P^T and dS^T on the fragments: c0, c1 are key g, queries 2t and
      // 2t + 1 of the n-block; c2, c3 key g + 8. Rounded to bf16 as the
      // A operands (keys x queries) of the two products below
      uint32_t pa[NQ / 2][4], da[NQ / 2][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = qc + n * 8 + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(lt + col);
        const float2 dd2 = *reinterpret_cast<const float2*>(ddt + col);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = ((e & 1) ? lse2.y : lse2.x) * kLog2e;
          const float dd_c = (e & 1) ? dd2.y : dd2.x;
          const bool dead =
              edge && mfa::dead_entry(q0 + col + (e & 1),
                                      (e >> 1) ? key_b : key_a, a.S, causal,
                                      a.window, true);
          p[e] = dead ? 0.f : exp2f(s[n][e] * scale2 - lse_c);
          ds[e] = dead ? 0.f : p[e] * (dp[n][e] - dd_c);
        }
        pa[n >> 1][(n & 1) * 2] = mma::pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = mma::pack_bf16(p[2], p[3]);
        da[n >> 1][(n & 1) * 2] = mma::pack_bf16(ds[0], ds[1]);
        da[n >> 1][(n & 1) * 2 + 1] = mma::pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T.dO and dK += dS^T.Q, 16 queries a k-step
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        mma_ab<D>(dv, pa[kk], dt, qc + kk * 16, lane);
        mma_ab<D>(dk, da[kk], qt, qc + kk * 16, lane);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  // through the warp's own rows of k_s and v_s, which no other warp reads
  const long long stride = (long long)a.Hkv * D;
  const long long base = ((long long)b * a.S * a.Hkv + hk) * D;
  store_rows<D>(k_s, warp * 16, dk, a.scale, a.dk + base, stride,
                k0 + warp * 16, a.S, lane);
  store_rows<D>(v_s, warp * 16, dv, 1.f, a.dv + base, stride,
                k0 + warp * 16, a.S, lane);
}

// at D = 64, 3 blocks an SM: 168 registers a thread, Q and dO fragments
// read from shared memory at each k-step rather than held
template <int D>
__global__ void __launch_bounds__(kThreadsMma, D <= 64 ? 3 : 1)
    flash_bwd_q_mma_kernel(const BwdArgs a) {
  constexpr int NKS = D / 16;  // k-steps of S and dP
  constexpr int NDB = D / 8;   // n-blocks of dQ
  constexpr int KC = 32;       // keys a chunk
  constexpr int NK = KC / 8;   // n-blocks of a chunk's S
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* do_s = q_s + kBM * D;
  bf16* k_s = do_s + kBM * D;     // two buffers
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

  const bf16* kp = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = a.v + b * a.v_sb + hk * a.v_sh;
  int lo, hi;
  mfa::live_k_range(qi, causal, a.window, kBN, n_blk, &lo, &hi);
  mma::stage_rows<D, kBM, kThreadsMma>(q_s, a.q + b * a.q_sb + h * a.q_sh,
                                       a.q_ss, q0, a.S);
  mma::stage_rows<D, kBM, kThreadsMma>(
      do_s, a.dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0, a.S);
  mma::stage_rows<D, kBN, kThreadsMma>(k_s, kp, a.k_ss, lo * kBN, a.S);
  mma::stage_rows<D, kBN, kThreadsMma>(v_s, vp, a.v_ss, lo * kBN, a.S);
  mma::cp_async_commit();

  // the rows' LSE (times log2 e) and D, two registers each (padded
  // rows: masked)
  const float scale2 = a.scale * kLog2e;
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = r ? row_b : row_a;
    const long long at = (long long)bh * a.S + pos;
    lse_r[r] = pos < a.S ? a.lse[at] * kLog2e : 0.f;
    dd_r[r] = pos < a.S ? a.delta[at] : 0.f;
  }

  float dq[NDB][4];
#pragma unroll
  for (int n = 0; n < NDB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
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
    const bf16* kt = k_s + buf * kBN * D;
    const bf16* vt = v_s + buf * kBN * D;
    const int k0 = ki * kBN;
    const bool edge = edge_pair(a, q0, k0);

#pragma unroll
    for (int kc = 0; kc < kBN; kc += KC) {
      // S = Q.K^T and dP = dO.V^T: 16 queries x KC keys a warp
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        uint32_t qa[4], oa[4];
        mma::ldmatrix_x4(qa, q_s + mma::swz<D>(a_row, ks * 16 + a_col));
        mma::ldmatrix_x4(oa, do_s + mma::swz<D>(a_row, ks * 16 + a_col));
        mma_abt<D, NK>(s, qa, kt, kc, ks, lane);
        mma_abt<D, NK>(dp, oa, vt, kc, ks, lane);
      }

      // dS on the fragments (c0, c1: row g, keys 2t, 2t + 1; c2, c3: row
      // g + 8), rounded to bf16 as the A operand of dQ += dS.K
      uint32_t da[NK / 2][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool dead =
              edge && mfa::dead_entry(r ? row_b : row_a,
                                      k0 + kc + n * 8 + 2 * t + (e & 1),
                                      a.S, causal, a.window, true);
          const float p = dead ? 0.f : exp2f(s[n][e] * scale2 - lse_r[r]);
          ds[e] = dead ? 0.f : p * (dp[n][e] - dd_r[r]);
        }
        da[n >> 1][(n & 1) * 2] = mma::pack_bf16(ds[0], ds[1]);
        da[n >> 1][(n & 1) * 2 + 1] = mma::pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk)
        mma_ab<D>(dq, da[kk], kt, kc + kk * 16, lane);
    }
    __syncthreads();  // every warp is done with this buffer
  }

  // through the warp's own rows of q_s, which no other warp reads
  store_rows<D>(q_s, warp * 16, dq, a.scale,
                a.dq + ((long long)b * a.S * a.H + h) * D,
                (long long)a.H * D, q0 + warp * 16, a.S, lane);
}

template <int D>
int launch_kv(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = (2 * kBN + 4 * kBM) * D * (int)sizeof(bf16) +
                       4 * kBM * (int)sizeof(float);
  static bool sized = false;  // the attribute is set once a process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kv_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(a.B * a.Hkv, (a.S + kBN - 1) / kBN);
  flash_bwd_kv_mma_kernel<D><<<grid, kThreadsMma, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_q(const BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = (2 * kBM + 4 * kBN) * D * (int)sizeof(bf16);
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_q_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(a.B * a.H, (a.S + kBM - 1) / kBM);
  flash_bwd_q_mma_kernel<D><<<grid, kThreadsMma, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, long long sb, long long ss, long long sh) {
  // every row start 16 bytes aligned: the base and every stride (bf16)
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

// which: 0 = dK/dV, 1 = dQ
int launch_bwd(int which, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dq, void* dk, void* dv, int B, int S, int H, int Hkv,
               int D, long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               long long o_sb, long long o_ss, long long o_sh, float scale,
               int causal, int window, void* stream) {
  const bool outs_ok =
      which ? reinterpret_cast<uintptr_t>(dq) % 16 == 0
            : reinterpret_cast<uintptr_t>(dk) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dv) % 16 == 0;
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv ||
      (long long)B * H > 0x7fffffffLL || (S + kBM - 1) / kBM > 65535 ||
      window < 0 || (window > 0 && !causal) || (D != 64 && D != 128) ||
      !aligned16(q, q_sb, q_ss, q_sh) || !aligned16(k, k_sb, k_ss, k_sh) ||
      !aligned16(v, v_sb, v_ss, v_sh) ||
      !aligned16(dout, o_sb, o_ss, o_sh) || !outs_ok ||
      reinterpret_cast<uintptr_t>(lse) % 4 ||
      reinterpret_cast<uintptr_t>(delta) % 4)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
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
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (which) return D == 64 ? launch_q<64>(a, s) : launch_q<128>(a, s);
  return D == 64 ? launch_kv<64>(a, s) : launch_kv<128>(a, s);
}

}  // namespace

// bf16 q, k, v, dO and gradients; D = 64 or 128. Strides are in elements,
// for the (batch, position, head) dimensions of q, k, v and dO; the last
// dimension is contiguous and every row starts on a 16-byte boundary. lse
// and delta are compact (B * H, S) f32; the outputs are contiguous. Each
// returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a shape or layout the kernels do not take.
extern "C" int mml_flash_attention_bwd_kv_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, int window, void* stream) {
  return launch_bwd(0, q, k, v, dout, lse, delta, nullptr, dk, dv, B, S, H,
                    Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                    v_sh, o_sb, o_ss, o_sh, scale, causal, window, stream);
}

extern "C" int mml_flash_attention_bwd_q_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H,
    int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, int window, void* stream) {
  return launch_bwd(1, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B,
                    S, H, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                    v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal, window,
                    stream);
}

// The CUDA runtime's text for an error code the launcher returned.
extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

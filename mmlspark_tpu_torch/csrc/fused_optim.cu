// fused_optim.cu — the trainer's optimizer update and anomaly quarantine as
// one multi-tensor pass, for Hopper.
//
// No TPU kernel stands behind it: in the reference, XLA fuses optax's
// update into the jitted training step (mmlspark_tpu/train/trainer.py).
// The port's eager version (mmlspark_tpu_torch/ops/fused_optim.py:
// optimizer_update_reference) is a dozen elementwise passes a tensor, each
// reading and writing the whole parameter set; this kernel reads p, g and
// the moments once and writes p and the moments once, for every parameter
// tensor in one launch.
//
// What bounds it on the H100: bytes. Adam moves 7 floats an element (read
// p, g, m, v; write p, m, v) and does ~15 flops, far below the card's
// 20 flops a byte; 33.9 M parameters move 0.95 GB, 0.28 ms at 3.35 TB/s.
// The design: a grid over fixed chunks of every tensor (a block finds its
// tensor by a binary search of the chunk offsets), consecutive threads on
// consecutive elements, each element read and written once, and nothing
// written at all when the step is quarantined.
//
// The table of pointers and sizes travels in the launch's parameter block
// (kernel parameters up to 32 KB, CUDA 12.1+), so a captured CUDA graph
// records it with the launch and no host-to-device copy is needed.
//
// Numerics: bit-equal in f32 to the eager update on the card. Each element
// operation rounds as the eager PyTorch op does, one rounding an op,
// with the constants rounded to f32 as PyTorch rounds a Python scalar:
// __fmul_rn, __fadd_rn, __fdiv_rn and __fsqrt_rn, never a contracted FMA.
// The per-step scalars (-lr(count), the bias corrections 1 - b^count and
// the quarantine flag) are computed by torch ops on the device and read
// here through pointers, so the result does not depend on how CUDA's pow
// rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTensors = 128;
constexpr int kChunk = 4096;  // elements a block
constexpr int kThreads = 256;

enum Kind { kAdam = 0, kAdamW = 1, kSgd = 2, kMomentum = 3 };

struct OptimTable {
  int n;
  int chunk_start[kMaxTensors + 1];  // prefix sum of chunks a tensor
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];  // adam's mu, momentum's trace
  float* v[kMaxTensors];  // adam's nu
  long long numel[kMaxTensors];
};

struct OptimScalars {
  const float* step_size;  // -lr(count), f32
  const float* c1;         // 1 - b1^(count + 1), f32 (adam)
  const float* c2;         // 1 - b2^(count + 1), f32 (adam)
  const bool* bad;         // the quarantine: keep every old value
  float one_minus_b1, b1, one_minus_b2, b2, eps, weight_decay, momentum;
};

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    fused_optim_kernel(const OptimTable t, const OptimScalars s) {
  if (*s.bad) return;  // torch.where(bad, old, new) keeps every old value
  const int chunk = blockIdx.x;
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int i = lo;
  const long long begin = (long long)(chunk - t.chunk_start[i]) * kChunk;
  const long long end =
      begin + kChunk < t.numel[i] ? begin + kChunk : t.numel[i];
  float* __restrict__ p = t.p[i];
  const float* __restrict__ g = t.g[i];
  float* __restrict__ m = t.m[i];
  float* __restrict__ v = t.v[i];
  const float step = *s.step_size;
  float c1 = 0.f, c2 = 0.f;
  if (KIND == kAdam || KIND == kAdamW) {
    c1 = *s.c1;
    c2 = *s.c2;
  }
  for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
    const float gj = g[j];
    const float pj = p[j];
    float u;
    if (KIND == kAdam || KIND == kAdamW) {
      // mu = (1 - b1) * g + b1 * m
      const float mu = __fadd_rn(__fmul_rn(s.one_minus_b1, gj),
                                 __fmul_rn(s.b1, m[j]));
      // nu = (1 - b2) * g * g + b2 * n
      const float nu =
          __fadd_rn(__fmul_rn(__fmul_rn(s.one_minus_b2, gj), gj),
                    __fmul_rn(s.b2, v[j]));
      // u = (mu / c1) / (sqrt(nu / c2) + eps)
      u = __fdiv_rn(__fdiv_rn(mu, c1),
                    __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, c2)), s.eps));
      if (KIND == kAdamW) u = __fadd_rn(u, __fmul_rn(s.weight_decay, pj));
      m[j] = mu;
      v[j] = nu;
    } else if (KIND == kMomentum) {
      // trace = g + momentum * trace
      u = __fadd_rn(gj, __fmul_rn(s.momentum, m[j]));
      m[j] = u;
    } else {
      u = gj;
    }
    // p + step_size * u
    p[j] = __fadd_rn(pj, __fmul_rn(step, u));
  }
}

template <int KIND>
int launch(const OptimTable& t, const OptimScalars& s, int blocks,
           cudaStream_t stream) {
  fused_optim_kernel<KIND><<<blocks, kThreads, 0, stream>>>(t, s);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 adam, 1 adamw, 2 sgd, 3 momentum. p_table, g_table, m_table,
// v_table: host arrays of n device pointers each (m and v null where the
// kind keeps no such moment); numel_table: a host array of n long long
// element counts. The scalars are device pointers to f32 (and a bool for
// bad). Tensors beyond the table's capacity go in further launches.
extern "C" int mml_fused_optim(int kind, int n, const void* p_table,
                               const void* g_table, const void* m_table,
                               const void* v_table, const void* numel_table,
                               const void* step_size, const void* c1,
                               const void* c2, const void* bad,
                               float one_minus_b1, float b1,
                               float one_minus_b2, float b2, float eps,
                               float weight_decay, float momentum,
                               void* stream) {
  if (kind < 0 || kind > 3 || n < 0) return (int)cudaErrorInvalidValue;
  void* const* p = static_cast<void* const*>(p_table);
  void* const* g = static_cast<void* const*>(g_table);
  void* const* m = static_cast<void* const*>(m_table);
  void* const* v = static_cast<void* const*>(v_table);
  const long long* numel = static_cast<const long long*>(numel_table);
  OptimScalars s{};
  s.step_size = static_cast<const float*>(step_size);
  s.c1 = static_cast<const float*>(c1);
  s.c2 = static_cast<const float*>(c2);
  s.bad = static_cast<const bool*>(bad);
  s.one_minus_b1 = one_minus_b1;
  s.b1 = b1;
  s.one_minus_b2 = one_minus_b2;
  s.b2 = b2;
  s.eps = eps;
  s.weight_decay = weight_decay;
  s.momentum = momentum;
  for (int first = 0; first < n; first += kMaxTensors) {
    OptimTable t{};
    t.n = n - first < kMaxTensors ? n - first : kMaxTensors;
    long long blocks = 0;
    for (int i = 0; i < t.n; ++i) {
      const int k = first + i;
      t.chunk_start[i] = (int)blocks;
      t.p[i] = static_cast<float*>(p[k]);
      t.g[i] = static_cast<const float*>(g[k]);
      t.m[i] = m ? static_cast<float*>(m[k]) : nullptr;
      t.v[i] = v ? static_cast<float*>(v[k]) : nullptr;
      t.numel[i] = numel[k];
      blocks += (numel[k] + kChunk - 1) / kChunk;
    }
    t.chunk_start[t.n] = (int)blocks;
    if (blocks == 0) continue;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int rc;
    switch (kind) {
      case kAdam:
        rc = launch<kAdam>(t, s, (int)blocks, st);
        break;
      case kAdamW:
        rc = launch<kAdamW>(t, s, (int)blocks, st);
        break;
      case kSgd:
        rc = launch<kSgd>(t, s, (int)blocks, st);
        break;
      default:
        rc = launch<kMomentum>(t, s, (int)blocks, st);
        break;
    }
    if (rc) return rc;
  }
  return 0;
}

extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

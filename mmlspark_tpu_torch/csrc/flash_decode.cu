// flash_decode.cu — one-token attention over dense slot KV caches, for
// Hopper.
//
// Replaces mmlspark_tpu/ops/flash_attention.py:_decode_kernel (the Pallas
// kernel behind flash_decode, float K/V) and
// mmlspark_tpu/ops/flash_attention.py:_decode_kernel_q8 (its int8 twin,
// per-(row, kv head) f32 scales). The kernel itself, its numerics and
// what bounds it are in decode_attention.cuh, which paged_flash_decode.cu
// shares: a dense slot cache is the one-page-per-row case of its
// addressing (page = row b, page_size = L, the (B, L, Hkv, D) strides),
// read in place — no transpose copy into (B*Hkv, L, D) as the Pallas
// wrapper's _to_bh does.

#include "decode_attention.cuh"

namespace {

mml::DecodeArgs dense_args(const void* q, const void* k, const void* v,
                           const void* lengths, const void* k_scale,
                           const void* v_scale, void* out, int H, int Hkv,
                           int L, int D, long long q_sb, long long q_sh,
                           long long k_sb, long long k_sl, long long k_sh,
                           long long v_sb, long long v_sl, long long v_sh,
                           float scale) {
  mml::DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.page_table = nullptr;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.out = out;
  a.H = H;
  a.Hkv = Hkv;
  a.group = Hkv > 0 ? H / Hkv : 0;
  a.L = L;
  a.D = D;
  a.page_size = L;  // one page per row: the row's whole cache
  a.max_pages = 1;
  a.num_pages = 0;  // unused without a page table
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sp = k_sb;
  a.k_sl = k_sl;
  a.k_sh = k_sh;
  a.v_sp = v_sb;
  a.v_sl = v_sl;
  a.v_sh = v_sh;
  a.scale = scale;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Strides are
// in elements; the last dimension of q, k and v is contiguous and K/V
// rows start on 16-byte boundaries. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a shape the kernel
// does not take.
extern "C" int mml_flash_decode(int dtype, const void* q, const void* k,
                                const void* v, const void* lengths,
                                void* out, int B, int H, int Hkv, int L,
                                int D, long long q_sb, long long q_sh,
                                long long k_sb, long long k_sl,
                                long long k_sh, long long v_sb,
                                long long v_sl, long long v_sh, float scale,
                                void* stream) {
  if (D % 8) return (int)cudaErrorInvalidValue;
  const mml::DecodeArgs a =
      dense_args(q, k, v, lengths, nullptr, nullptr, out, H, Hkv, L, D,
                 q_sb, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return mml::launch_decode<float, float, false>(a, B, 16, s);
  if (dtype == 1)
    return mml::launch_decode<__nv_bfloat16, __nv_bfloat16, false>(a, B, 16,
                                                                   s);
  return (int)cudaErrorInvalidValue;
}

// int8 K/V with (B, Hkv) f32 scales, contiguous. q_dtype: 0 = float32,
// 1 = bfloat16 (q and out). vec_bytes: the staging load width, 16, 8, 4
// or 2, dividing D and every K/V row start in bytes (the caller picks
// it). Returns as mml_flash_decode.
extern "C" int mml_flash_decode_q8(int q_dtype, const void* q,
                                   const void* k, const void* v,
                                   const void* lengths, const void* k_scale,
                                   const void* v_scale, void* out, int B,
                                   int H, int Hkv, int L, int D,
                                   int vec_bytes, long long q_sb,
                                   long long q_sh, long long k_sb,
                                   long long k_sl, long long k_sh,
                                   long long v_sb, long long v_sl,
                                   long long v_sh, float scale,
                                   void* stream) {
  if (!k_scale || !v_scale) return (int)cudaErrorInvalidValue;
  const mml::DecodeArgs a =
      dense_args(q, k, v, lengths, k_scale, v_scale, out, H, Hkv, L, D,
                 q_sb, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return mml::launch_decode<float, int8_t, false>(a, B, vec_bytes, s);
  if (q_dtype == 1)
    return mml::launch_decode<__nv_bfloat16, int8_t, false>(a, B,
                                                            vec_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// The CUDA runtime's text for an error code the launcher returned.
extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

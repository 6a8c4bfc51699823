// paged_flash_decode.cu — one-token attention over PAGED KV caches, for
// Hopper.
//
// Replaces mmlspark_tpu/ops/flash_attention.py:_paged_decode_kernel
// (float pages) and
// mmlspark_tpu/ops/flash_attention.py:_paged_decode_kernel_q8 (int8
// pages with per-(page, kv head) f32 scales), the Pallas kernels behind
// paged_flash_decode. The kernel, its
// numerics and what bounds it are in decode_attention.cuh, which
// flash_decode.cu shares.
//
// The paged pool (serve/paging.py) keeps K and V as contiguous
// (num_pages, Hkv, page_size, D) page stores shared by all rows and maps
// row b's logical page j to physical page page_table[b, j]. One block per
// (b, h) walks the logical pages j < ceil(length_b / page_size); the face
// of kv head hk in page phys starts at ((phys * Hkv + hk) * page_size) * D
// and is contiguous. Masking uses logical positions. The Pallas kernel
// needs page_size == its KV block, a multiple of 8 sublanes; here tiles
// and pages are independent (a tile may hold several pages, or part of
// one), and the int8 v scale is applied per page inside the tile.

#include "decode_attention.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (q and out). kv_dtype: 0 = float32,
// 1 = bfloat16 (each equal to q_dtype), 2 = int8 (with k_scale/v_scale,
// (num_pages, Hkv) f32, contiguous). The page stores and the
// (B, max_pages) int32 page table are contiguous; q's last dimension is.
// vec_bytes: the staging load width (16 for float pages; 16, 8, 4 or 2
// dividing D for int8). Every page id a live position reaches must lie in
// [0, num_pages): one outside traps and the launch fails. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or type the kernel does not take.
extern "C" int mml_paged_flash_decode(
    int q_dtype, int kv_dtype, const void* q, const void* k_pages,
    const void* v_pages, const void* lengths, const void* page_table,
    const void* k_scale, const void* v_scale, void* out, int B, int H,
    int Hkv, int num_pages, int page_size, int max_pages, int D,
    int vec_bytes, long long q_sb, long long q_sh, float scale,
    void* stream) {
  if (num_pages < 1 || page_size < 1 || max_pages < 1 || !page_table)
    return (int)cudaErrorInvalidValue;
  mml::DecodeArgs a{};
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.lengths = static_cast<const int*>(lengths);
  a.page_table = static_cast<const int*>(page_table);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.out = out;
  a.H = H;
  a.Hkv = Hkv;
  a.group = Hkv > 0 ? H / Hkv : 0;
  a.L = max_pages * page_size;  // the virtual cache length
  a.D = D;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.num_pages = num_pages;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  // (num_pages, Hkv, page_size, D), contiguous
  a.k_sl = a.v_sl = D;
  a.k_sh = a.v_sh = (long long)page_size * D;
  a.k_sp = a.v_sp = (long long)Hkv * page_size * D;
  a.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (kv_dtype == 2) {
    if (!k_scale || !v_scale) return (int)cudaErrorInvalidValue;
    if (q_dtype == 0)
      return mml::launch_decode<float, int8_t, true>(a, B, vec_bytes, s);
    if (q_dtype == 1)
      return mml::launch_decode<__nv_bfloat16, int8_t, true>(a, B,
                                                             vec_bytes, s);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != q_dtype || D % 8) return (int)cudaErrorInvalidValue;
  if (kv_dtype == 0)
    return mml::launch_decode<float, float, true>(a, B, vec_bytes, s);
  if (kv_dtype == 1)
    return mml::launch_decode<__nv_bfloat16, __nv_bfloat16, true>(
        a, B, vec_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// The CUDA runtime's text for an error code the launcher returned.
extern "C" const char* mml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

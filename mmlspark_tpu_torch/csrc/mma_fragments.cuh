// mma_fragments.cuh — the Hopper building blocks of the tensor-core
// attention kernels (flash_attention_fwd_mma.cu, flash_attention_bwd_mma.cu):
// cp.async staging, ldmatrix loads of bf16 fragments from XOR-swizzled
// shared-memory tiles, and the warp-level mma.sync.m16n8k16 product (bf16
// in, f32 accumulate).
//
// Fragment layout of mma.m16n8k16 for a lane with g = lane / 4 and
// t = lane % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k16"):
//   A (16 x 16, row-major) a0: (g, 2t..2t+1)  a1: (g+8, 2t..)
//                          a2: (g, 2t+8..)    a3: (g+8, 2t+8..)
//   B (16 x 8, "col")      b0: (2t..2t+1, g)  b1: (2t+8.., g)
//   C (16 x 8, f32)        c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..)
// A row of C's fragment is held by the 4 lanes of one quad, so a row's
// max and sum are two xor-shuffles (offsets 1 and 2).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with src_bytes 0
// nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes, the same way (the 4-byte form goes through L1: .ca); for f32
// rows whose starts need not sit on 16-byte boundaries
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i's fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b: one m16n8k16 product, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even, as torch's cast) in one
// register, lo in the low half: the order of a fragment's pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// element offset of (row, col) in a tile of rows of W bf16 (W a multiple
// of 64): the 16-byte chunk c of row r sits at chunk c ^ (r % 8), so the
// 8 rows an ldmatrix matrix reads (or a cp.async writes) fall in 8
// distinct bank groups
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  return row * W + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// rows [row0, row0 + ROWS) of one head of a (B, S, heads, W) bf16 tensor
// (src at the (b, head) base, s_stride elements between positions) into a
// swizzled W-wide tile, by THREADS threads, one 16-byte cp.async each; rows
// past S are zero-filled and read nothing
template <int W, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long s_stride, int row0,
                                           int S) {
  constexpr int CPR = W / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR;
    const int col = (c - r * CPR) * 8;
    const int pos = row0 + r;
    const bool ok = pos < S;
    cp_async16(dst + swz<W>(r, col),
               ok ? src + (long long)pos * s_stride + col : src, ok ? 16 : 0);
  }
}

}  // namespace mma

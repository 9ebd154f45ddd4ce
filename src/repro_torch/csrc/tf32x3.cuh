// Float32-accurate products on Hopper's tensor cores (3xTF32), and the
// asynchronous copies that feed them: what the float32 route of flash
// attention (flash_attention.cu, flash_attention_bwd.cu) is built from.
//
// 3xTF32. A TF32 operand keeps 10 explicit mantissa bits, about 3 decimal
// digits, so one TF32 product per fp32 product misses float32 accuracy.
// Each fp32 operand x is split in registers as it is loaded from shared
// memory: hi = x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 does) and lo = x - hi, exact in fp32, of which the
// tensor core reads the top 19 bits (TF32: it ignores the low 13); then
//   a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi,
// accumulated into an fp32 accumulator small terms first (CUTLASS's "fast
// accurate fp32"). hi + lo as read keeps x within 2^-21 |x|; with the
// dropped a_lo b_lo term that leaves about 2^-21 relative error a product,
// against fp32's 2^-24, and the tensor cores' 495 TFLOP/s of TF32 give
// 165 TFLOP/s of such products, against 67 TFLOP/s of scalar fp32 FMAs.
// hi is two integer operations, where cvt.rna compiles to four (a NaN
// test and a select besides) and rounding lo as well would take as many
// again: on an H100 the kernels ran measurably slower that way. A NaN in
// x stays a NaN in lo, so it still reaches the product.
//
// Products are mma.sync.m16n8k8 (a warp's 16 x 8 x 8). Fragment layout
// (PTX ISA), lane = 4 g + t:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product sums over k in any order, so a k-slot may stand for any k as
// long as A and B agree. Two slot maps are used:
//   natural:  slot t -> k = t,   slot t + 4 -> k = t + 4
//   paired:   slot t -> k = 2t,  slot t + 4 -> k = 2t + 1
// The paired map lets an accumulator (C) serve as the next product's A
// with no shuffle: a = {c0, c2, c1, c3}. Shared tiles of fp32 rows are
// padded to a pitch of 4 mod 16 floats (HD + 4): then an operand read as
// tile[row g][k t] (natural) or tile[k 2t][col g] (paired) touches 32
// distinct banks. Tiles of P or dS are padded to 8 mod 16 floats and read
// as float2 {tile[g][2t], tile[g][2t + 1]} (paired), also without
// conflicts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32: half of the dropped 13 bits' ulp added to the
// magnitude, then the 13 bits cleared (a carry moves into the exponent as
// it should; Inf stays Inf)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as the operands hi + lo (lo's low 13 bits left for the tensor core
// to drop)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma(d, alo, bhi);
  mma(d, ahi, blo);
  mma(d, ahi, bhi);
}

// A fragment, natural slots, of the 16 x 8 block at (row 0, col 0) of a
// row-major tile with pitch `ld`; g, t: the lane's group and thread.
__device__ __forceinline__ void load_a(const float* tile, int ld, int g, int t,
                                       float (&a)[4]) {
  a[0] = tile[g * ld + t];
  a[1] = tile[(g + 8) * ld + t];
  a[2] = tile[g * ld + t + 4];
  a[3] = tile[(g + 8) * ld + t + 4];
}

// A fragment, paired slots, from a tile of P or dS (pitch 8 mod 16)
__device__ __forceinline__ void load_a_paired(const float* tile, int ld, int g, int t,
                                              float (&a)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(tile + g * ld + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(tile + (g + 8) * ld + 2 * t);
  a[0] = lo.x;
  a[1] = hi.x;
  a[2] = lo.y;
  a[3] = hi.y;
}

// B fragment, natural slots, of a tile stored [n][k] (the rows of K in
// Q K^T): b(k, n) = tile[n][k]
__device__ __forceinline__ void load_b_nk(const float* tile, int ld, int g, int t,
                                          float (&b)[2]) {
  b[0] = tile[g * ld + t];
  b[1] = tile[g * ld + t + 4];
}

// B fragment, paired slots, of a tile stored [k][n] (V in P V):
// b(k, n) = tile[k][n]
__device__ __forceinline__ void load_b_kn(const float* tile, int ld, int g, int t,
                                          float (&b)[2]) {
  b[0] = tile[2 * t * ld + g];
  b[1] = tile[(2 * t + 1) * ld + g];
}

// An accumulator as the A fragment of the next product (paired slots)
__device__ __forceinline__ void c_as_a(const float (&c)[4], float (&a)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// --- asynchronous copies --------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros where `valid` is false (src must still be readable)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `ROWS` rows of HD floats from sequence position s0 (row stride
// `stride` floats) into a tile of pitch HD + 4; rows at or past S are
// zeros. `vec`: 16-byte copies (every row 16-byte aligned), else 4-byte.
template <int HD, int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t stride,
                                           int s0, int S, bool vec) {
  constexpr int LD = HD + 4;
  if (vec) {
    constexpr int CPR = HD / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
      const int r = i / CPR, c = (i % CPR) * 4;
      const int s = s0 + r;
      cp_async16(dst + r * LD + c, src + static_cast<int64_t>(s < S ? s : 0) * stride + c,
                 s < S);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD; i += NTHREADS) {
      const int r = i / HD, c = i % HD;
      const int s = s0 + r;
      cp_async4(dst + r * LD + c, src + static_cast<int64_t>(s < S ? s : 0) * stride + c,
                s < S);
    }
  }
}

// `n` consecutive floats from src[s0..] (contiguous), zeros at or past S
template <int NTHREADS>
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int s0, int n,
                                          int S) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    const int s = s0 + i;
    cp_async4(dst + i, src + (s < S ? s : 0), s < S);
  }
}

}  // namespace tf32x3

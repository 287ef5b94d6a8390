// fp32-accurate matrix products on the Hopper tensor cores: three TF32
// passes of the warp-level mma.sync.m16n8k8 (the fp32 flash backward,
// flash_bwd.cu), and the cp.async loads of the fp32 tiles they read.
//
// The tensor cores take no fp32 operand.  TF32 keeps 10 of fp32's 23
// mantissa bits, so one TF32 product is good to about 3 decimal digits.
// Split each operand x into hi, its top 11 significant bits rounded, and
// lo, the next 11 (split below): x - hi - lo is below 2^-21 |x|.  Then
// a.b = ah.bh + ah.bl + al.bh + al.bl, and the last product (below
// 2^-22 |a||b|) is dropped: three TF32 mma into one fp32 accumulator, the
// two small products first, give each product within a few 2^-21 of its
// size, where an fp32 sum rounds at 2^-24 each add.  Rate: 495 / 3 = 165
// TFLOP/s of fp32 work at the TF32 peak.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4; PTX ISA, "Matrix
// fragments for mma.m16n8k8" with .tf32):
//   A, 16 x 8, row:  a0 = A[g][t]  a1 = A[g + 8][t]  a2 = A[g][t + 4]
//                    a3 = A[g + 8][t + 4]
//   B,  8 x 8, col:  b0 = B[t][g]  b1 = B[t + 4][g]
//   C, 16 x 8:       c0 = C[g][2t]  c1 = C[g][2t + 1]  c2 = C[g + 8][2t]
//                    c3 = C[g + 8][2t + 1]
// Each thread loads its elements itself, from any layout: no transpose, no
// descriptor.  Tiles sit in shared memory as fp32 rows of LD = D + 4
// floats, so the word (row r, column c) falls in bank 4r + c (mod 32) and
// the fragment loads below, eight rows by four columns or four row pairs by
// eight columns, hit 32 different banks.
//
// Compiled for sm_90a with the rest of the port (mma.sync and cp.async
// exist from sm_80 on).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x = hi + lo + O(2^-21 |x|).  hi: x rounded to TF32 (11 significant
// bits), to nearest with ties away from zero, by integer add and mask (the
// cvt.rna.tf32.f32 instruction compiles to several, with checks for
// non-finite values the inputs never hold).  lo = x - hi, exact in fp32
// and below 2^-11 |x|; the mma reads only a TF32 operand's top 19 bits, so
// lo goes in as it is and is truncated to 11 bits there, within
// 2^-10 |lo| <= 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// c += a.b, one TF32 pass
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b to about fp32 accuracy: al.bh + ah.bl + ah.bh
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

// -- fragments of fp32 tiles in shared memory (rows of LD floats) ----------

// A of X.(.) over columns k0 .. k0 + 7 of rows r0 .. r0 + 15
template <int LD>
__device__ __forceinline__ void load_a(float (&a)[4], const float* X, int r0,
                                       int k0, int lane) {
  const float* p = X + (r0 + lane / 4) * LD + k0 + lane % 4;
  a[0] = p[0];
  a[1] = p[8 * LD];
  a[2] = p[4];
  a[3] = p[8 * LD + 4];
}

// B of (.).Y^T: Y's rows n0 .. n0 + 7 are B's columns, its columns k0 ..
// k0 + 7 B's rows (S = Q.K^T, dP = dO.V^T)
template <int LD>
__device__ __forceinline__ void load_b_t(float (&b)[2], const float* Y, int n0,
                                         int k0, int lane) {
  const float* p = Y + (n0 + lane / 4) * LD + k0 + lane % 4;
  b[0] = p[0];
  b[1] = p[4];
}

// B of (.).Y over Y's rows k0 .. k0 + 7 and columns n0 .. n0 + 7, with the
// rows in the order of an accumulator's columns: B row t is Y row k0 + 2t,
// B row t + 4 is Y row k0 + 2t + 1 (see acc_as_a)
template <int LD>
__device__ __forceinline__ void load_b_pairs(float (&b)[2], const float* Y,
                                             int k0, int n0, int lane) {
  const float* p = Y + (k0 + 2 * (lane % 4)) * LD + n0 + lane / 4;
  b[0] = p[0];
  b[1] = p[LD];
}

// An accumulator fragment C (16 x 8) as the A fragment of C.Y over the
// same 8 columns: A column t stands for C column 2t, A column t + 4 for
// C column 2t + 1, matched by load_b_pairs.  The sum over the 8 columns is
// unchanged, only its order.
__device__ __forceinline__ void acc_as_a(float (&a)[4], const float (&c)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// -- cp.async loads of 64-row fp32 tiles ------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(valid ? 16 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows t0 .. t0 + 63 of one head of x ([B, T, H, D] fp32; head points at
// its element (b, 0, h, 0), rows row_stride floats apart) into a [64][LD]
// tile, zeros past T, 16 bytes a copy, every thread of the CTA taking its
// share.  x must be 16-byte aligned.
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* head,
                                                size_t row_stride, int t0,
                                                int T_len, int tid) {
  constexpr int CPR = D / 4;  // 16-byte copies per row
  static_assert(64 * CPR % THREADS == 0, "copies split evenly");
#pragma unroll
  for (int j = 0; j < 64 * CPR / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CPR, c = 4 * (i % CPR);
    const bool in = t0 + r < T_len;
    cp_async16(dst + r * LD + c,
               in ? head + (size_t)(t0 + r) * row_stride + c : head, in);
  }
}

}  // namespace tf32x3

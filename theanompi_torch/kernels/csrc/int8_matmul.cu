// int8 weight matmul: out = x @ dequantize(W), straight from the chunked
// int8 payload.
//
// Replaces: theanompi_tpu/ops/quant.py::_int8_mm_kernel (pallas_call in
// int8_matmul).  Same association as the Pallas body: the band's per-row
// fp32 scales multiply the activation first, (x * s) in fp32, rounded to
// bf16 when the output is bf16, then the product with the raw int8 weight
// (exact in bf16 or fp32) accumulates in fp32.
//
// Bound on the H100: bytes.  Decode feeds M = 1..8 rows, so each weight
// byte is used by at most 8 rows (16 flops per byte, far under the ~295
// flops per byte where bf16 tensor cores would become the limit).  The
// least time is reading the int8 weight once.
//
// Design against that bound: each thread owns 4 adjacent output columns
// and loads their int8 weights as one 32-bit word per row of K, so a warp
// reads 128 contiguous bytes per row; the activation tile (up to 8 rows)
// sits in shared memory and is broadcast to all threads.  The scale of a
// thread's band is read per K row (one band per 4-column group, so the
// band width must be a multiple of 4).  Small weights give too few column
// blocks to fill 132 SMs, so K is split across grid.z: each split writes
// fp32 partial sums to a workspace, and a second kernel adds the splits in
// a fixed order (deterministic) and casts to the output dtype.  No tensor
// cores yet: at M <= 8 the weight stream, not the math, is the limit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;         // activation rows per block
constexpr int KT = 64;        // K rows per shared-memory tile
constexpr int THREADS = 64;   // 4 columns each -> 256 columns per block

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// the operand rounding of the Pallas body: bf16 operands for bf16 output
template <typename T> __device__ __forceinline__ float operand(float v);
template <> __device__ __forceinline__ float operand<float>(float v) { return v; }
template <> __device__ __forceinline__ float operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__global__ void int8_mm_kernel(const T* __restrict__ x,
                               const int8_t* __restrict__ q,
                               const float* __restrict__ s,
                               T* __restrict__ out, float* __restrict__ ws,
                               int M, int Din, int Dout, int cc,
                               int k_per_split) {
  __shared__ float xs[TM][KT];
  const int n = (blockIdx.x * THREADS + threadIdx.x) * 4;
  const int m0 = blockIdx.y * TM;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(Din, k_begin + k_per_split);
  const bool active = n < Dout;
  const float* srow = s + (size_t)(active ? n / cc : 0) * Din;

  float acc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    for (int i = threadIdx.x; i < TM * KT; i += THREADS) {
      const int mm = i / KT, kk = i % KT;
      const int m = m0 + mm, k = k0 + kk;
      xs[mm][kk] = (m < M && k < k_end) ? to_f<T>(x[(size_t)m * Din + k]) : 0.f;
    }
    __syncthreads();
    if (active) {
      const int kmax = min(KT, k_end - k0);
#pragma unroll 4
      for (int kk = 0; kk < kmax; ++kk) {
        const int k = k0 + kk;
        const char4 w = *reinterpret_cast<const char4*>(q + (size_t)k * Dout + n);
        const float sk = __ldg(srow + k);
        const float wf[4] = {(float)w.x, (float)w.y, (float)w.z, (float)w.w};
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float a = operand<T>(xs[m][kk] * sk);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(a, wf[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    if (m0 + m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ws == nullptr)
        out[(size_t)(m0 + m) * Dout + n + j] = from_f<T>(acc[m][j]);
      else
        ws[((size_t)split * M + m0 + m) * Dout + n + j] = acc[m][j];
    }
  }
}

template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ ws,
                                    T* __restrict__ out, int splits,
                                    size_t n_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += ws[sp * n_out + i];
  out[i] = from_f<T>(acc);
}

template <typename T>
int launch(const void* x, const void* q, const void* s, void* out, void* ws,
           int M, int Din, int Dout, int cc, int splits, int k_per_split,
           cudaStream_t stream) {
  dim3 grid((Dout / 4 + THREADS - 1) / THREADS, (M + TM - 1) / TM, splits);
  float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
  int8_mm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(out), wsf, M, Din, Dout,
      cc, k_per_split);
  if (splits > 1) {
    const size_t n_out = (size_t)M * Dout;
    const int threads = 256;
    split_reduce_kernel<T><<<(unsigned)((n_out + threads - 1) / threads),
                             threads, 0, stream>>>(wsf, static_cast<T*>(out),
                                                    splits, n_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out share it).  q is [Din, Dout]
// int8 row-major, s is [bands, Din] fp32 with band = column / cc.  ws holds
// splits * M * Dout floats when splits > 1 (unused otherwise).
extern "C" int int8_matmul(int dtype, const void* x, const void* q,
                           const void* s, void* out, void* ws, int M, int Din,
                           int Dout, int cc, int splits, int k_per_split,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, q, s, out, ws, M, Din, Dout, cc, splits,
                         k_per_split, st);
  return launch<__nv_bfloat16>(x, q, s, out, ws, M, Din, Dout, cc, splits,
                               k_per_split, st);
}

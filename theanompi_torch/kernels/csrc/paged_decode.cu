// Paged decode attention: one query per batch slot against a paged KV pool.
//
// Replaces: theanompi_tpu/ops/pallas_paged_attention.py::_decode_kernel
// (pallas_call in paged_attend_decode).  Same recurrence as the Pallas body
// and the reference's blockwise fallback: q scaled by Dh^-0.5 in fp32,
// scores in fp32, an online softmax over the sequence's pool blocks
// (running max, normalizer, accumulator), the last block's tail masked
// with -1e30 (never -inf), one division at the end.
//
// Bound on the H100: bytes.  Every cached K and V element of the sequence
// is read once and used for 2 flops, so the least time is the K/V bytes of
// positions 0..pos of every slot over the memory rate.
//
// Design against that bound: one CTA of 128 threads per (slot, head).  The
// CTA walks the block table only up to positions[b] / block_size, so the
// null-block tail of the table costs neither loads nor math (the Pallas
// kernel elided those DMAs by clamping its index map).  Per pool block, the
// threads split into block_size token groups; each group dots its token's
// key with the shared fp32 query and reduces with warp shuffles.  Every
// thread then runs the same softmax update from the block's scores in
// shared memory, and accumulates p * v for one head dimension over a
// strided subset of the block's tokens; the subsets are summed once at the
// end.  Rows of K and V are Dh contiguous elements, read by neighbouring
// threads.  An inactive slot (position 0, table of null blocks) attends to
// one token of the null block: finite output, never NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr float NEG_INF = -1e30f;

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

template <typename T, int D, int BS>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const T* __restrict__ q, T* __restrict__ out, int H,
                    int nb, float scale) {
  constexpr int TPT = NT / BS;   // threads per token for the scores
  constexpr int DPT = D / TPT;   // dims per thread for the scores
  constexpr int G = NT / D;      // token groups for the context
  static_assert(NT % BS == 0 && D % TPT == 0 && NT % D == 0, "tiling");

  __shared__ float q_s[D];
  __shared__ float s_s[BS];
  __shared__ float red[NT];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const size_t row = (size_t)H * D;  // elements between tokens of a block
  for (int i = tid; i < D; i += NT)
    q_s[i] = to_f<T>(q[((size_t)b * H + h) * D + i]) * scale;

  const int pos = positions[b];
  const int n_used = min(pos / BS + 1, nb);
  const int tok = tid / TPT, lane = tid % TPT;
  const int d = tid % D, g = tid / D;

  float m = NEG_INF, l = 0.f, acc = 0.f;
  for (int j = 0; j < n_used; ++j) {
    const int blk = tables[(size_t)b * nb + j];
    const T* kb = kp + (size_t)blk * BS * row + (size_t)h * D;
    const T* vb = vp + (size_t)blk * BS * row + (size_t)h * D;
    __syncthreads();  // q_s ready / previous block's s_s consumed
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int dd = lane + i * TPT;
      part += q_s[dd] * to_f<T>(kb[tok * row + dd]);
    }
#pragma unroll
    for (int off = TPT / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off, TPT);
    if (lane == 0) s_s[tok] = (j * BS + tok <= pos) ? part : NEG_INF;
    __syncthreads();

    float mx = m;
#pragma unroll
    for (int t = 0; t < BS; ++t) mx = fmaxf(mx, s_s[t]);
    const float corr = expf(m - mx);
    float psum = 0.f, ctx = 0.f;
#pragma unroll
    for (int t = 0; t < BS; ++t) {
      const float p = expf(s_s[t] - mx);
      psum += p;
      if (t % G == g) ctx += p * to_f<T>(vb[t * row + d]);
    }
    l = l * corr + psum;
    acc = acc * corr + ctx;
    m = mx;
  }
  red[tid] = acc;
  __syncthreads();
  if (g == 0) {
    float total = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) total += red[gg * D + d];
    out[((size_t)b * H + h) * D + d] = from_f<T>(total / l);
  }
}

template <typename T, int D>
int launch_d(int bs, const void* kp, const void* vp, const int* tables,
             const int* positions, const void* q, void* out, int B, int H,
             int nb, float scale, cudaStream_t st) {
  dim3 grid(B, H);
  const T* k = static_cast<const T*>(kp);
  const T* v = static_cast<const T*>(vp);
  const T* qq = static_cast<const T*>(q);
  T* o = static_cast<T*>(out);
  switch (bs) {
    case 8:
      paged_decode_kernel<T, D, 8><<<grid, NT, 0, st>>>(k, v, tables, positions, qq, o, H, nb, scale);
      break;
    case 16:
      paged_decode_kernel<T, D, 16><<<grid, NT, 0, st>>>(k, v, tables, positions, qq, o, H, nb, scale);
      break;
    case 32:
      paged_decode_kernel<T, D, 32><<<grid, NT, 0, st>>>(k, v, tables, positions, qq, o, H, nb, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int D, int bs, const void* kp, const void* vp, const int* tables,
           const int* positions, const void* q, void* out, int B, int H,
           int nb, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<T, 32>(bs, kp, vp, tables, positions, q, out, B, H, nb, scale, st);
    case 64: return launch_d<T, 64>(bs, kp, vp, tables, positions, q, out, B, H, nb, scale, st);
    case 128: return launch_d<T, 128>(bs, kp, vp, tables, positions, q, out, B, H, nb, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  k_pool/v_pool: [num_blocks, bs, H, D]
// (one layer), tables: [B, nb] int32, positions: [B] int32, q/out: [B, H, D].
extern "C" int paged_decode(int dtype, const void* k_pool, const void* v_pool,
                            const void* tables, const void* positions,
                            const void* q, void* out, int B, int H, int D,
                            int bs, int nb, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(positions);
  if (dtype == 0)
    return launch<float>(D, bs, k_pool, v_pool, t, p, q, out, B, H, nb, scale, st);
  return launch<__nv_bfloat16>(D, bs, k_pool, v_pool, t, p, q, out, B, H, nb, scale, st);
}

// Paged decode attention: one query per batch slot against a paged KV pool.
//
// Replaces: theanompi_tpu/ops/pallas_paged_attention.py::_decode_kernel
// (pallas_call in paged_attend_decode).  Same recurrence as the Pallas body
// and the reference's blockwise fallback: q scaled by Dh^-0.5 in fp32,
// scores in fp32, an online softmax over the sequence's context (running
// max, normalizer, accumulator), positions past positions[b] masked with
// -1e30 (never -inf), one division at the end.
//
// Bound on the H100: bytes.  Every cached K and V element of the sequence
// is read once and used for 2 flops, so the least time is the K/V bytes of
// positions 0..pos of every slot over the memory rate.
//
// Design against that bound (split-context, "flash-decoding"):
// - The grid is (slot, head, split).  A split owns a fixed run of whole
//   pool blocks, TOK tokens (256 in bf16 at head dim 64: 64 KB of K and V),
//   so even one long slot spreads over many SMs (splits of 64 and 128
//   tokens were 4-36 % slower at every shape measured: a split's partial
//   and its merge cost more than the parallelism they add; see
//   decode_variants.py).  The grid comes from the table's width and the
//   block size alone, never from the positions: the host reads nothing,
//   and a call can be captured in a CUDA graph.
// - Within a CTA (4 warps), a token's K or V row (Dh contiguous elements)
//   is read with 16-byte loads by Dh * size / 16 neighbouring lanes, so a
//   warp covers several tokens per load and a thread issues all its K and
//   V loads of the split at once, before any arithmetic.  Tokens past the
//   position are not loaded.
// - A token's score is reduced over its lanes by shuffles, with no barrier;
//   the split's max by shuffles and one shared-memory step; a token's
//   exponential is one instruction of the warp (its lanes take it
//   together), not one per thread and token.  The split writes its partial
//   (m, l, acc[Dh]) in fp32 to a workspace; a split wholly past the
//   position writes m = -1e30, l = 0, acc = 0 without loading anything.
// - A second launch merges each (slot, head)'s partials in split order:
//   M = max m_s, w_s = e^(m_s - M) (exactly 0 for a split past the
//   position, exactly 1 for the split that holds M), L = sum l_s w_s, acc
//   = sum acc_s w_s, out = acc / L.  Every sum runs in a fixed order, so two
//   calls are bit-equal.
// An inactive slot (position 0, table of null blocks) attends to one token
// of the null block: finite output, never NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int WARPS = NT / 32;
constexpr int ROUNDS = 16;  // rounds of K and V loads in flight a split
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

// The split's geometry for element type T, head dim D, block size BS.
template <typename T, int D, int BS>
struct Geo {
  static constexpr int EPL = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int LT = D / EPL;               // lanes per token row
  static constexpr int TPW = 32 / LT;              // tokens per warp load
  static constexpr int TPR = WARPS * TPW;          // tokens per CTA round
  // ROUNDS rounds of loads in flight, and whole pool blocks
  static constexpr int TOK = BS > ROUNDS * TPR ? BS : ROUNDS * TPR;
  static constexpr int R = TOK / TPR;              // rounds per split
  static constexpr int BPS = TOK / BS;             // pool blocks per split
  static_assert(LT >= 1 && LT <= 32 && TOK % BS == 0 && TOK % TPR == 0,
                "tiling");
};

// the EPL elements of one 16-byte word, in fp32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& w, float* f) {
  f[0] = __uint_as_float(w.x); f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z); f[3] = __uint_as_float(w.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& w, float* f) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <typename T, int D, int BS>
__global__ void __launch_bounds__(NT)
paged_split_kernel(const T* __restrict__ kp, const T* __restrict__ vp,
                   const int* __restrict__ tables,
                   const int* __restrict__ positions,
                   const T* __restrict__ q, float* __restrict__ ws, int H,
                   int nb, float scale) {
  using G = Geo<T, D, BS>;
  constexpr int EPL = G::EPL, LT = G::LT, TPW = G::TPW, R = G::R;
  __shared__ float red_m[WARPS], red_l[WARPS];
  __shared__ float red_acc[WARPS][D];

  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tg = lane / LT, li = lane % LT;
  float* part = ws + (((size_t)b * H + h) * S + sp) * (D + 2);
  // the split's table entries and the query need no position: load them
  // beside it, so that the K and V loads wait on one round trip, not two
  int blk[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = sp * G::BPS + (r * G::TPR + warp * TPW + tg) / BS;
    blk[r] = j < nb ? __ldg(tables + (size_t)b * nb + j) : 0;
  }
  const uint4 qw = __ldg(reinterpret_cast<const uint4*>(
      q + ((size_t)b * H + h) * D + li * EPL));
  const int pos = __ldg(positions + b);
  const int t0 = sp * G::TOK;
  if (t0 > pos) {  // wholly past the position: weight exactly 0
    for (int i = tid; i < D + 2; i += NT) part[i] = i == 0 ? NEG_INF : 0.f;
    return;
  }
  float qf[EPL];
  unpack<T>(qw, qf);
#pragma unroll
  for (int e = 0; e < EPL; ++e) qf[e] *= scale;

  // every K and V row of the split this thread reads, all at once
  const size_t row = (size_t)H * D;  // elements between tokens of a block
  uint4 kw[R], vw[R];
  bool ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int tt = r * G::TPR + warp * TPW + tg;  // token within the split
    ok[r] = t0 + tt <= pos && sp * G::BPS + tt / BS < nb;
    kw[r] = vw[r] = make_uint4(0u, 0u, 0u, 0u);
    if (ok[r]) {
      const size_t off =
          ((size_t)blk[r] * BS + tt % BS) * row + (size_t)h * D + li * EPL;
      kw[r] = __ldg(reinterpret_cast<const uint4*>(kp + off));
      vw[r] = __ldg(reinterpret_cast<const uint4*>(vp + off));
    }
  }

  // scores: each lane's EPL products, then the token's LT lanes
  float sc[R];
  float m = NEG_INF;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float kf[EPL];
    unpack<T>(kw[r], kf);
    float part_s = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part_s = fmaf(qf[e], kf[e], part_s);
#pragma unroll
    for (int off = LT / 2; off > 0; off >>= 1)
      part_s += __shfl_xor_sync(0xffffffffu, part_s, off);
    sc[r] = ok[r] ? part_s : NEG_INF;
    m = fmaxf(m, sc[r]);
  }
  // the split's max: the warp's token groups, then the warps
#pragma unroll
  for (int off = LT; off < 32; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red_m[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red_m[w]);

  // one exponential per token; p * v over this thread's tokens
  float l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float p = ok[r] ? expf(sc[r] - m) : 0.f;
    l += p;
    float vf[EPL];
    unpack<T>(vw[r], vf);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
  }
  // the warp's token groups, then the warps in order
#pragma unroll
  for (int off = LT; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (tg == 0) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) red_acc[warp][li * EPL + e] = acc[e];
    if (li == 0) red_l[warp] = l;
  }
  __syncthreads();
  for (int d = tid; d < D; d += NT) {
    float t = red_acc[0][d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += red_acc[w][d];
    part[2 + d] = t;
  }
  if (tid == 0) {
    float t = red_l[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += red_l[w];
    part[0] = m;
    part[1] = t;
  }
}

// Merge the S partials of one (slot, head) in split order; one thread per
// head dimension.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ ws,
                                     T* __restrict__ out, int H, int D,
                                     int S) {
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const float* part = ws + ((size_t)b * H + h) * S * (D + 2);
  float M = NEG_INF;
  for (int s = 0; s < S; ++s) M = fmaxf(M, part[(size_t)s * (D + 2)]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* ps = part + (size_t)s * (D + 2);
    const float w = expf(ps[0] - M);
    L = fmaf(ps[1], w, L);
    acc = fmaf(ps[2 + d], w, acc);
  }
  out[((size_t)b * H + h) * D + d] = from_f<T>(acc / L);
}

template <typename T, int D, int BS>
int launch_g(const void* kp, const void* vp, const int* tables,
             const int* positions, const void* q, void* out, void* ws, int B,
             int H, int nb, float scale, cudaStream_t st) {
  using G = Geo<T, D, BS>;
  const int S = (nb + G::BPS - 1) / G::BPS;
  float* w = static_cast<float*>(ws);
  paged_split_kernel<T, D, BS><<<dim3(B, H, S), NT, 0, st>>>(
      static_cast<const T*>(kp), static_cast<const T*>(vp), tables, positions,
      static_cast<const T*>(q), w, H, nb, scale);
  paged_combine_kernel<T><<<dim3(B, H), D, 0, st>>>(w, static_cast<T*>(out), H,
                                                    D, S);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int tokens_d(int bs) {
  switch (bs) {
    case 8: return Geo<T, D, 8>::TOK;
    case 16: return Geo<T, D, 16>::TOK;
    case 32: return Geo<T, D, 32>::TOK;
    default: return -1;
  }
}

template <typename T>
int tokens(int D, int bs) {
  switch (D) {
    case 32: return tokens_d<T, 32>(bs);
    case 64: return tokens_d<T, 64>(bs);
    case 128: return tokens_d<T, 128>(bs);
    default: return -1;
  }
}

template <typename T, int D>
int launch_d(int bs, const void* kp, const void* vp, const int* tables,
             const int* positions, const void* q, void* out, void* ws, int B,
             int H, int nb, float scale, cudaStream_t st) {
  switch (bs) {
    case 8: return launch_g<T, D, 8>(kp, vp, tables, positions, q, out, ws, B, H, nb, scale, st);
    case 16: return launch_g<T, D, 16>(kp, vp, tables, positions, q, out, ws, B, H, nb, scale, st);
    case 32: return launch_g<T, D, 32>(kp, vp, tables, positions, q, out, ws, B, H, nb, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(int D, int bs, const void* kp, const void* vp, const int* tables,
           const int* positions, const void* q, void* out, void* ws, int B,
           int H, int nb, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<T, 32>(bs, kp, vp, tables, positions, q, out, ws, B, H, nb, scale, st);
    case 64: return launch_d<T, 64>(bs, kp, vp, tables, positions, q, out, ws, B, H, nb, scale, st);
    case 128: return launch_d<T, 128>(bs, kp, vp, tables, positions, q, out, ws, B, H, nb, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Tokens per split for dtype (0 = float32, 1 = bfloat16), head dim D and
// block size bs; -1 for a geometry the kernel does not take.  The caller
// sizes the workspace from it: B * H * ceil(nb * bs / tokens) * (D + 2)
// floats.
extern "C" int paged_decode_split_tokens(int dtype, int D, int bs) {
  return dtype == 0 ? tokens<float>(D, bs) : tokens<__nv_bfloat16>(D, bs);
}

// dtype: 0 = float32, 1 = bfloat16.  k_pool/v_pool: [num_blocks, bs, H, D]
// (one layer), tables: [B, nb] int32, positions: [B] int32, q/out: [B, H, D]
// (16-byte aligned), ws: the fp32 workspace sized as above.
extern "C" int paged_decode(int dtype, const void* k_pool, const void* v_pool,
                            const void* tables, const void* positions,
                            const void* q, void* out, void* ws, int B, int H,
                            int D, int bs, int nb, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(positions);
  if (dtype == 0)
    return launch<float>(D, bs, k_pool, v_pool, t, p, q, out, ws, B, H, nb, scale, st);
  return launch<__nv_bfloat16>(D, bs, k_pool, v_pool, t, p, q, out, ws, B, H, nb, scale, st);
}

// Flash attention backward over [B, T, H, D]: dq, and dk with dv.
//
// Replaces: theanompi_tpu/ops/pallas_attention.py::_bwd_dq_kernel (:228,
// pallas_call :318 in _bwd_call) with flash_bwd_dq, and ::_bwd_dkv_kernel
// (:261, pallas_call :346 in _bwd_call) with flash_bwd_dkv.  Both read the
// forward's per-row lse ([B, H, T] fp32, kernel 1's output) and
// delta = rowsum(dO * O) ([B, H, T] fp32, computed by the wrapper), and
// recompute the probabilities tile by tile, so nothing of size T x T is
// ever stored.  Same arithmetic as the Pallas bodies:
//
//   qs = q * scale                 (in the input dtype: scale rounded to it,
//                                   the product rounded to it)
//   s  = qs . k^T                  fp32
//   p  = exp(s - lse)              fp32, masked probabilities 0
//   dp = dO . v^T                  fp32
//   ds = p * (dp - delta)          fp32, then rounded to the input dtype
//   dq = scale * sum_k ds . k      fp32 accumulator, scale applied once
//   dk = sum_q ds^T . qs           fp32 accumulator
//   dv = sum_q p^T . dO            p rounded to dO's dtype, fp32 accumulator
//
// Bound on the H100: operations.  At the training shape (B=16, H=8,
// D=64, causal T=2048) dq does 3 and dk/dv 4 products of 2*T*T/2*D flops
// per (b, h) against ~7 reads of T*D elements, far past the memory
// roofline's crossover; the least time is those flops over the
// tensor-core peak.
//
// Two deterministic kernels, no atomics, as the reference splits them.
// Only tiles that straddle the diagonal or the end of T pay for the mask;
// any T is taken, the wrapper asks T % 16 == 0 as for kernel 1.
//
// flash_bwd_dq in bf16 (flash_bwd_dq_wgmma_kernel): the forward's tensor-core
// design (flash_fwd.cu, hopper.cuh).  One CTA per (64 query rows, head,
// batch): one consumer warpgroup and one producer warp whose elected thread
// loads q and dO once and streams k and v tiles of 64 keys through a ring
// of two buffers (TMA, full/empty mbarriers), up to the diagonal.  Per tile
// the warpgroup issues S = qs.k^T and dP = dO.v^T as wgmma with both
// operands in shared memory, forms ds on the accumulator fragments, and
// issues dQ += dS.k with dS in registers as bf16 and the same k tile read
// as an MN-major B operand.  dq = scale * acc goes back through shared
// memory and a TMA store.  As in the forward, the warpgroup's products and
// its elementwise ds work run one after the other; only the other CTAs on
// the SM fill the gaps.
//
// fp32, and flash_bwd_dkv in both types: the first kernels, math on the
// CUDA cores (tensor cores have no fp32 product; dk/dv's tensor-core tiles
// are a later step).  flash_bwd_dq: one CTA of 256 threads per (64-row q
// tile, head, batch), looping over 64-key tiles up to the diagonal; dq
// stays in registers.  flash_bwd_dkv: one CTA per (64-row k tile, head,
// batch), looping over q tiles from the first one that can see the k tile
// to the end of T; dk and dv stay in registers.  Tiles sit in shared
// memory as fp32 with padded rows against bank conflicts; each thread owns
// a 4 x 4 block of the score tile and a 4 x D/16 block of each
// accumulator.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

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
// rounding to the input dtype, kept in fp32 registers
template <typename T> __device__ __forceinline__ float round_t(float v);
template <> __device__ __forceinline__ float round_t<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Load rows [t0, t0 + 64) of one head of x ([B, T, H, D]) into a padded
// fp32 tile [64][D + 1], zeros past T; mul (rounded to T first) scales
// each element in the input dtype when scaled is set.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x,
                                          size_t base, size_t row, int t0,
                                          int T_len, bool scaled, float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = t0 + r;
    float v = t < T_len ? to_f<T>(x[base + (size_t)t * row + c]) : 0.f;
    if (scaled) v = round_t<T>(v * mul);
    dst[r * (D + 1) + c] = v;
  }
}

// s = A . B^T and dp = C . E^T over one 64 x 64 tile: rows ty + 16 i of
// A and C, rows tx + 16 j of B and E.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* Bm,
                                             const float* C, const float* E,
                                             int tx, int ty, float s[4][4],
                                             float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * (D + 1) + d];
      c[i] = C[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = Bm[(tx + 16 * j) * (D + 1) + d];
      e[j] = E[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)64 * (D + 1) + (size_t)BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int T_len, int H, int causal, float scale) {
  constexpr int CT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][D + 1], q * scale
  float* dOs = Qs + 64 * (D + 1);        // [BQ][D + 1]
  float* Ks = dOs + 64 * (D + 1);        // [BK][D + 1]
  float* Vs = Ks + 64 * (D + 1);         // [BK][D + 1]
  float* DS = Vs + 64 * (D + 1);         // [BQ][BK + 1], ds
  float* lse_s = DS + BQ * (BK + 1);     // [BQ]
  float* del_s = lse_s + BQ;             // [BQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * BQ;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T_len * row + (size_t)h * D;
  const size_t rbase = ((size_t)b * H + h) * T_len;

  load_tile<T, D>(Qs, q, base, row, q0, T_len, true, round_t<T>(scale));
  load_tile<T, D>(dOs, dout, base, row, q0, T_len, false, 1.f);
  if (tid < BQ) {
    const bool in = q0 + tid < T_len;
    lse_s[tid] = in ? lse[rbase + q0 + tid] : 0.f;
    del_s[tid] = in ? delta[rbase + q0 + tid] : 0.f;
  }
  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  const int nk = (T_len + BK - 1) / BK;
  const int kt_end = causal ? min((q0 + BQ - 1) / BK, nk - 1) : nk - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    load_tile<T, D>(Ks, k, base, row, k0, T_len, false, 1.f);
    load_tile<T, D>(Vs, v, base, row, k0, T_len, false, 1.f);
    __syncthreads();
    const bool masked = (causal && k0 + BK - 1 > q0) || (k0 + BK > T_len) ||
                        (q0 + BQ > T_len);
    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = lse_s[r], dl = del_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = expf(s[i][j] - l);
        if (masked) {
          const int qr = q0 + r, kc = k0 + c;
          const bool ok = qr < T_len && kc < T_len && (!causal || kc <= qr);
          p = ok ? p : 0.f;
        }
        DS[r * (BK + 1) + c] = round_t<T>(p * (dp[i][j] - dl));
      }
    }
    __syncthreads();
    // dq: rows ty + 16 i, dims tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float d[4], kv[CT];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = DS[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CT; ++j) kv[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(d[i], kv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < CT; ++j)
      dq[base + (size_t)t * row + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)64 * (D + 1) + 2 * (size_t)BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int T_len, int H, int causal,
                     float scale) {
  constexpr int CT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                      // [BK][D + 1]
  float* Vs = Ks + 64 * (D + 1);         // [BK][D + 1]
  float* Qs = Vs + 64 * (D + 1);         // [BQ][D + 1], q * scale
  float* dOs = Qs + 64 * (D + 1);        // [BQ][D + 1]
  float* P = dOs + 64 * (D + 1);         // [BQ][BK + 1], p in dO's dtype
  float* DS = P + BQ * (BK + 1);         // [BQ][BK + 1], ds
  float* lse_s = DS + BQ * (BK + 1);     // [BQ]
  float* del_s = lse_s + BQ;             // [BQ]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = kt * BK;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T_len * row + (size_t)h * D;
  const size_t rbase = ((size_t)b * H + h) * T_len;
  const float scale_t = round_t<T>(scale);

  load_tile<T, D>(Ks, k, base, row, k0, T_len, false, 1.f);
  load_tile<T, D>(Vs, v, base, row, k0, T_len, false, 1.f);
  float adk[4][CT], adv[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int nq = (T_len + BQ - 1) / BQ;
  // the first q tile holding a row >= k0 (causal); every tile otherwise
  const int qt_begin = causal ? k0 / BQ : 0;
  for (int qt = qt_begin; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    load_tile<T, D>(Qs, q, base, row, q0, T_len, true, scale_t);
    load_tile<T, D>(dOs, dout, base, row, q0, T_len, false, 1.f);
    if (tid < BQ) {
      const bool in = q0 + tid < T_len;
      lse_s[tid] = in ? lse[rbase + q0 + tid] : 0.f;
      del_s[tid] = in ? delta[rbase + q0 + tid] : 0.f;
    }
    __syncthreads();
    const bool masked = (causal && k0 + BK - 1 > q0) || (k0 + BK > T_len) ||
                        (q0 + BQ > T_len);
    // scores: q rows ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = lse_s[r], dl = del_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = expf(s[i][j] - l);
        if (masked) {
          const int qr = q0 + r, kc = k0 + c;
          const bool ok = qr < T_len && kc < T_len && (!causal || kc <= qr);
          p = ok ? p : 0.f;
        }
        P[r * (BK + 1) + c] = round_t<T>(p);
        DS[r * (BK + 1) + c] = round_t<T>(p * (dp[i][j] - dl));
      }
    }
    __syncthreads();
    // dv, dk: key rows ty + 16 i, dims tx + 16 j
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pp[4], dd[4], o[CT], qq[CT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = P[r * (BK + 1) + ty + 16 * i];
        dd[i] = DS[r * (BK + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        o[j] = dOs[r * (D + 1) + tx + 16 * j];
        qq[j] = Qs[r * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          adv[i][j] = fmaf(pp[i], o[j], adv[i][j]);
          adk[i][j] = fmaf(dd[i], qq[j], adk[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const size_t at = base + (size_t)t * row + tx + 16 * j;
      dk[at] = from_f<T>(adk[i][j]);
      dv[at] = from_f<T>(adv[i][j]);
    }
  }
}

using hopper::configure;

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int T_len,
              int H, int causal, float scale, cudaStream_t st) {
  const size_t bytes = dq_smem_floats<D>() * sizeof(float);
  static bool configured = false;
  int rc = configure(flash_bwd_dq_kernel<T, D>, bytes, configured);
  if (rc) return rc;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), T_len, H, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int T_len, int H, int causal, float scale, cudaStream_t st) {
  const size_t bytes = dkv_smem_floats<D>() * sizeof(float);
  static bool configured = false;
  int rc = configure(flash_bwd_dkv_kernel<T, D>, bytes, configured);
  if (rc) return rc;
  dim3 grid((T_len + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), T_len, H, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_t(int D, const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dq, int B, int T_len,
         int H, int causal, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, B, T_len, H, causal, scale, st);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, B, T_len, H, causal, scale, st);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, B, T_len, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dkv_t(int D, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, void* dk,
          void* dv, int B, int T_len, int H, int causal, float scale,
          cudaStream_t st) {
  switch (D) {
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H, causal, scale, st);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H, causal, scale, st);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- bf16 dq: wgmma products on TMA-fed tiles -------------------------------------

template <int D>
using DqPipe = hopper::Pipeline<D, 2>;  // row tiles: q, dO

template <int D>
__global__ void __launch_bounds__(DqPipe<D>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap qm,
                          __grid_constant__ const CUtensorMap km,
                          __grid_constant__ const CUtensorMap vm,
                          __grid_constant__ const CUtensorMap dom,
                          __grid_constant__ const CUtensorMap dqm,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int T_len,
                          int causal, float scale) {
  using namespace hopper;
  using L = Layout<D>;
  using P = DqPipe<D>;
  extern __shared__ uint8_t smem_raw[];
  const P pipe(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int q0 = P::first_row(causal);
  const int n_kt = P::key_tiles(q0, T_len, causal);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  pipe.init();

  if (warp == P::PRODUCER) {
    // producer warp: one thread issues every load
    if (lane == 0) pipe.produce({&qm, &dom}, &km, &vm, h, q0, b, n_kt);
    return;
  }

  // the consumer warpgroup: query rows q0 .. q0 + 63
  const int tid = threadIdx.x;
  uint8_t* Qw = pipe.row_tile(0);
  const uint32_t q_addr = smem_u32(Qw);
  const uint32_t do_addr = smem_u32(pipe.row_tile(1));
  const int r0 = 16 * (tid / 32) + lane / 4, cq = 2 * (lane % 4);
  // lse in log2 units and delta, rows r0 and r0 + 8 (0 past T, where q and
  // dO are zero rows, so ds is 0 there)
  float lse2[2], dl[2];
  const size_t rbase = ((size_t)b * H + h) * T_len;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    lse2[hh] = row < T_len ? lse[rbase + row] * LOG2E : 0.f;
    dl[hh] = row < T_len ? delta[rbase + row] : 0.f;
  }
  pipe.scale_q(scale, tid);

  float acc[L::NP][L::PW / 2];
#pragma unroll
  for (int p = 0; p < L::NP; ++p)
#pragma unroll
    for (int i = 0; i < L::PW / 2; ++i) acc[p][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = pipe.wait(kt);
    const int k0 = kt * 64;
    const uint32_t k_addr = pipe.k_addr(s), v_addr = pipe.v_addr(s);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, L::desc_k(q_addr, kk), L::desc_k(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, L::desc_k(do_addr, kk), L::desc_k(v_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool masked = (causal && k0 + 63 > q0) || k0 + 64 > T_len;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      float p = exp2f(fmaf(sc[i], LOG2E, -lse2[hh]));
      if (masked) {
        const int key = k0 + 8 * (i / 4) + cq + (i & 1);
        const int row = q0 + r0 + 8 * hh;
        if (key >= T_len || (causal && key > row)) p = 0.f;
      }
      sc[i] = round_bf16(p * (dp[i] - dl[hh]));  // ds, unscaled
    }
    uint32_t da[4][4];
    to_a_frags(sc, da);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[p], da[kk], L::desc_mn(k_addr + p * L::PANEL_B, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < L::NP; ++p) fence_regs(acc[p]);
    pipe.release(s);
  }

  // epilogue: dq = acc * scale through this warpgroup's (now free) q tile
  const float sc2[2] = {scale, scale};
  store_frags<D, L::PW, false>(Qw, acc, sc2, tid);
  pipe.store(&dqm, Qw, tid, h, q0, b);
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int T_len, int H, int causal,
                    float scale, cudaStream_t st) {
  using P = DqPipe<D>;
  static bool configured = false;
  int rc = configure(flash_bwd_dq_wgmma_kernel<D>, P::SMEM_BYTES,
                     configured);
  if (rc) return rc;
  CUtensorMap m[5];
  if ((rc = hopper::make_maps<D, 5>(m, {q, k, v, dout, dq}, B, T_len, H)))
    return rc;
  dim3 grid(H, B, (T_len + 63) / 64);
  flash_bwd_dq_wgmma_kernel<D><<<grid, P::THREADS, P::SMEM_BYTES, st>>>(
      m[0], m[1], m[2], m[3], m[4], static_cast<const float*>(lse),
      static_cast<const float*>(delta), T_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq: [B, T, H, D]
// contiguous in that dtype (16-byte aligned in bf16); lse, delta: [B, H, T]
// fp32.  Returns cudaGetLastError(), or -CUresult when a tensor map fails
// to encode.
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int T, int H,
                            int D, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dq_t<float>(D, q, k, v, dout, lse, delta, dq, B, T, H, causal, scale, st);
  switch (D) {
    case 32: return launch_dq_wgmma<32>(q, k, v, dout, lse, delta, dq, B, T, H, causal, scale, st);
    case 64: return launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, B, T, H, causal, scale, st);
    case 128: return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, B, T, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As flash_bwd_dq; dk, dv: [B, T, H, D] contiguous in the input dtype.
extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int T, int H, int D, int causal, float scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dkv_t<float>(D, q, k, v, dout, lse, delta, dk, dv, B, T, H, causal, scale, st);
  return dkv_t<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk, dv, B, T, H, causal, scale, st);
}

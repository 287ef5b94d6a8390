// Flash attention forward over [B, T, H, D]: out and the per-row lse.
//
// Replaces: theanompi_tpu/ops/pallas_attention.py::_fwd_kernel (pallas_call
// in _fwd_call, reached through _flash and flash_attention).  Same
// arithmetic as the Pallas body: the softmax scale folded on q in the input
// dtype, scores in fp32, an online softmax per row over 64-key tiles
// (running max in fp32, masked scores -1e30 and their probabilities 0),
// probabilities rounded to the input dtype for the P.V product and for the
// normalizer (the Pallas body's ones column of V), fp32 accumulation, out =
// acc / l in the input dtype and lse = m + log(l) in fp32.  Here lse is
// [B, H, T], without the TPU's 8-sublane padding; the backward reads it.
//
// Bound on the H100: operations.  Causal prefill at T >= 128 does
// ~T/2 * 4 flops per loaded element of q, k and v, far above the memory
// roofline's crossover; the least time is the causal flops over the
// tensor-core peak.
//
// bf16 (flash_fwd_wgmma_kernel): the products run on the tensor cores, as
// the Pallas body feeds bf16 operands to the MXU with fp32 accumulation.
// One CTA per (64 query rows, head, batch): one consumer warpgroup and one
// producer warp whose elected thread issues every TMA load, q once, then k
// and v tiles of 64 keys through a ring of two buffers with full/empty
// mbarriers, so the load of tile kt + 1 overlaps the products on tile kt
// (hopper.cuh's Pipeline).  64-row CTAs ran faster than 128-row ones (two
// consumer warpgroups sharing one ring) at every shape timed, the training
// shape included (PERF.md).  Operands stay bf16 in shared memory in the
// hardware's swizzled layout (hopper.cuh); rows past T arrive as zeros.
// Per tile, the warpgroup issues S = qs.k^T as wgmma m64n64k16 with both
// operands in shared memory, takes the row max and sum on the accumulator
// fragment (two shuffles within each quad), converts p to bf16 in
// registers, and issues O += P.v with A from those registers and v as an
// MN-major B operand.  Only tiles that straddle the diagonal or the end of
// T pay for the mask; tiles above the diagonal are neither loaded nor
// computed, and in the causal case the heaviest query tiles start first.
// out goes back through shared memory and a TMA store, lse from the
// fragment.  What holds it below the bound: the warpgroup waits for each
// product before its softmax and for P.v before the next tile, so its own
// products and exp/max work never overlap; only the other CTAs on the SM
// fill those gaps.  Ping-pong scheduling of two warpgroups and a deeper
// ring are the next steps (PERF.md has the times).
//
// fp32 (flash_fwd_kernel): tensor cores have no fp32 product, so fp32 keeps
// the first kernel, math on the CUDA cores.  One CTA of 256 threads per
// (64-row q tile, head, batch); q, k and v tiles sit in shared memory as
// fp32 (padded rows against bank conflicts); each thread owns a 4 x 4 block
// of scores and a 4 x D/16 block of the output accumulator in registers;
// four threads share each row's softmax update through warp shuffles.
//
// Any T is taken (rows and keys past T are masked); the wrapper asks
// T % 16 == 0, which every prefill bucket meets.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

// the CUDA-core kernel below runs fp32 only (bf16 goes to the wgmma kernel)
template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// rounding to the input dtype, kept in fp32 registers
template <typename T> __device__ __forceinline__ float round_t(float v);
template <> __device__ __forceinline__ float round_t<float>(float v) { return v; }

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int T_len, int H, int causal,
                 float scale) {
  constexpr int CT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);         // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);         // [BK][D]
  float* S = Vs + BK * D;                // [BQ][BK + 1]
  float* m_s = S + BQ * (BK + 1);        // [BQ]
  float* l_s = m_s + BQ;                 // [BQ]
  float* c_s = l_s + BQ;                 // [BQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * BQ;
  const size_t row = (size_t)H * D;  // elements between time steps
  const size_t base = (size_t)b * T_len * row + (size_t)h * D;
  const float scale_t = round_t<T>(scale);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    const float x = t < T_len ? to_f<T>(q[base + (size_t)t * row + c]) : 0.f;
    Qs[r * (D + 1) + c] = round_t<T>(x * scale_t);
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float o[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) o[i][j] = 0.f;

  const int nk = (T_len + BK - 1) / BK;
  const int kt_end = causal ? min((q0 + BQ - 1) / BK, nk - 1) : nk - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      const bool in = t < T_len;
      Ks[r * (D + 1) + c] = in ? to_f<T>(k[base + (size_t)t * row + c]) : 0.f;
      Vs[r * D + c] = in ? to_f<T>(v[base + (size_t)t * row + c]) : 0.f;
    }
    __syncthreads();
    const bool masked = (causal && k0 + BK - 1 > q0) || (k0 + BK > T_len);

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float val = s[i][j];
        if (masked) {
          const int kc = k0 + c;
          const bool ok = kc < T_len && (!causal || kc <= q0 + r);
          val = ok ? val : NEG_INF;
        }
        S[r * (BK + 1) + c] = val;
      }
    __syncthreads();

    // online softmax: 4 threads per row, 16 keys each
    {
      const int r = tid / 4, lane = tid % 4;
      const float m_old = m_s[r];
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj)
        mx = fmaxf(mx, S[r * (BK + 1) + lane + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2, 4));
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj) {
        const int c = lane + 4 * jj;
        float p = expf(S[r * (BK + 1) + c] - m_new);
        if (masked) {
          const int kc = k0 + c;
          const bool ok = kc < T_len && (!causal || kc <= q0 + r);
          p = ok ? p : 0.f;
        }
        p = round_t<T>(p);
        S[r * (BK + 1) + c] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1, 4);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2, 4);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // accumulator: rows ty + 16 i, dims tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CT; ++j) o[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[CT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CT; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= T_len) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CT; ++j)
      out[base + (size_t)t * row + tx + 16 * j] = from_f<T>(o[i][j] / l);
  }
  if (tid < BQ && q0 + tid < T_len)
    lse[((size_t)b * H + h) * T_len + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int T_len, int H, int causal, float scale,
           cudaStream_t st) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), T_len, H, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(int D, const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int T_len, int H, int causal, float scale,
             cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, lse, B, T_len, H, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, T_len, H, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, T_len, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- bf16: wgmma products on TMA-fed tiles ----------------------------------------

template <int D>
using FwdPipe = hopper::Pipeline<D, 1, 2>;  // fixed q; streamed k, v

template <int D>
__global__ void __launch_bounds__(FwdPipe<D>::THREADS, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap qm,
                       __grid_constant__ const CUtensorMap km,
                       __grid_constant__ const CUtensorMap vm,
                       __grid_constant__ const CUtensorMap om,
                       float* __restrict__ lse, int T_len, int causal,
                       float scale) {
  using namespace hopper;
  using L = Layout<D>;
  using P = FwdPipe<D>;
  extern __shared__ uint8_t smem_raw[];
  const P pipe(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int q0 = P::first_row(causal);
  const int n_kt = P::key_tiles(q0, T_len, causal);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  pipe.init();

  if (warp == P::PRODUCER) {
    // producer warp: one thread issues every load
    if (lane == 0) pipe.produce({&qm}, q0, {&km, &vm}, nullptr, h, b, 0, n_kt);
    return;
  }

  // the consumer warpgroup: query rows q0 .. q0 + 63
  const int tid = threadIdx.x;
  uint8_t* Qw = pipe.fixed_tile(0);
  const uint32_t q_addr = smem_u32(Qw);
  pipe.wait_fixed();
  pipe.scale(Qw, scale, tid);

  const int r0 = 16 * (tid / 32) + lane / 4, cq = 2 * (lane % 4);
  float o[L::NP][L::PW / 2];
#pragma unroll
  for (int p = 0; p < L::NP; ++p)
#pragma unroll
    for (int i = 0; i < L::PW / 2; ++i) o[p][i] = 0.f;
  // running max (natural units) and this thread's share of the normalizer,
  // rows r0 and r0 + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = pipe.wait(kt);
    const int k0 = kt * 64;
    const uint32_t k_addr = pipe.addr(s, 0), v_addr = pipe.addr(s, 1);
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, L::desc_k(q_addr, kk), L::desc_k(k_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if ((causal && k0 + 63 > q0) || k0 + 64 > T_len) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + cq + (i & 1);
        const int row = q0 + r0 + 8 * ((i >> 1) & 1);
        if (key >= T_len || (causal && key > row)) sc[i] = NEG_INF;
      }
    }
    // every row sees at least one key of every tile it computes (key k0
    // <= its row, k0 < T), so the new max is finite and a masked score's
    // exp is exactly 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float corr[2], ms[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = quad_max(mx[hh]);
      corr[hh] = exp2f((m[hh] - mx[hh]) * LOG2E);
      ms[hh] = mx[hh] * LOG2E;
      m[hh] = mx[hh];
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      // p rounded to bf16 for P.v and for the normalizer alike
      const float p = round_bf16(exp2f(fmaf(sc[i], LOG2E, -ms[hh])));
      sc[i] = p;
      l[hh] += p;
    }
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
#pragma unroll
      for (int i = 0; i < L::PW / 2; ++i) o[p][i] *= corr[(i >> 1) & 1];
    uint32_t pa[4][4];
    to_a_frags(sc, pa);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) fence_regs(o[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[p], pa[kk], L::desc_mn(v_addr + p * L::PANEL_B, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < L::NP; ++p) fence_regs(o[p]);
    pipe.release(s);
  }

  // epilogue: this warpgroup's q tile is free (its last product is done)
  float ls[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) ls[hh] = fmaxf(quad_sum(l[hh]), 1e-30f);
  store_frags<D, L::PW, true>(Qw, o, ls, tid);
  if (lane % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      if (row < T_len)
        lse[((size_t)b * H + h) * T_len + row] = m[hh] + logf(ls[hh]);
    }
  }
  pipe.store(&om, Qw, tid, h, q0, b);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int T_len, int H, int causal, float scale,
                 cudaStream_t st) {
  using P = FwdPipe<D>;
  static bool configured = false;
  int rc = hopper::configure(flash_fwd_wgmma_kernel<D>, P::SMEM_BYTES,
                             configured);
  if (rc) return rc;
  CUtensorMap m[4];
  if ((rc = hopper::make_maps<D, 4>(m, {q, k, v, out}, B, T_len, H)))
    return rc;
  dim3 grid(H, B, (T_len + 63) / 64);
  flash_fwd_wgmma_kernel<D><<<grid, P::THREADS, P::SMEM_BYTES, st>>>(
      m[0], m[1], m[2], m[3], static_cast<float*>(lse), T_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, out: [B, T, H, D] contiguous
// (16-byte aligned in bf16); lse: [B, H, T] fp32.  Returns
// cudaGetLastError(), or -CUresult when a tensor map fails to encode.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* out, void* lse, int B, int T,
                         int H, int D, int causal, float scale,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(D, q, k, v, out, lse, B, T, H, causal, scale, st);
  switch (D) {
    case 32: return launch_wgmma<32>(q, k, v, out, lse, B, T, H, causal, scale, st);
    case 64: return launch_wgmma<64>(q, k, v, out, lse, B, T, H, causal, scale, st);
    case 128: return launch_wgmma<128>(q, k, v, out, lse, B, T, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

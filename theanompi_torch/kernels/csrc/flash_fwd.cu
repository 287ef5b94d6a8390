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
// fp32 (flash_fwd_tf32x3_kernel): the tensor cores have no fp32 product, so
// each product runs as three TF32 passes of mma.sync m16n8k8 (tf32x3.cuh),
// fp32-accurate at 165 TFLOP/s of peak against the CUDA cores' 67: fp32
// dq's layout (flash_bwd.cu).  One CTA of eight warps per (64 query rows,
// head, batch), the heaviest q tiles first in the causal case: four row
// groups of 16, each split between two warps that take 32 keys of every
// 64-key tile, each warp with its own running max, normalizer and
// accumulator over its keys (merged once, at the end, through the free k/v
// stages, in a fixed order: deterministic).  q lands once, is scaled in
// fp32 and split once into its hi and lo parts, two tiles; k and v stream
// up to the diagonal through a two-stage cp.async ring, all as fp32 rows of
// D + 4 floats (conflict-free fragment loads): six tiles, two CTAs an SM
// below D=128.  Per key tile a warp forms its 16 x 32 block of S = qs.k^T,
// takes the row max and sum on the accumulator fragment (two shuffles
// within each quad), and forms P.v with P in registers: the fragment of
// n-tile j is the A fragment of key step j once the keys are taken in the
// order 8j + 2t, 8j + 2t + 1 (v's rows read to match), so P never goes
// through shared memory.  On the diagonal tile a warp skips the key n-tiles
// above its rows.  Each tile's P.v is summed from zero (a chain of 3 x 4
// mma) and added to the running accumulator as acc * corr + tile in fp32,
// which rounds to nearest once a tile as the plain version does: the mma's
// own adds do not round to nearest, and their error grows with the length
// of a chain (summed straight into the accumulator, P.v breaks the fp32
// limit at T=2048; PERF.md).  At D=128 the tiles leave room for one CTA an
// SM, eight warps, and the kernel is slower than SDPA's fp32 forward there
// (PERF.md has the times).
//
// Any T is taken (rows and keys past T are masked); the wrapper asks
// T % 16 == 0, which every prefill bucket meets.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// -- fp32: three-pass TF32 mma.sync on the tensor cores ------------------------

// Eight warps: warp w takes the 16 query rows 16 (w % 4) .. and the 32 keys
// 32 (w / 4) .. of every 64-key tile; the two key halves merge at the end.
// Two stages of k and v in flight.
template <int D>
struct Fwd32 {
  static constexpr int LD = D + 4;      // floats per tile row (tf32x3.cuh)
  static constexpr int TILE = 64 * LD;  // floats per tile
  static constexpr int WARPS_A_GROUP = 2;  // warps per 16-row group
  static constexpr int THREADS = 128 * WARPS_A_GROUP;
  static constexpr int NJ = 8 / WARPS_A_GROUP;  // 8-key n-tiles a warp
  // registers: two CTAs an SM at up to 128 a thread (one at D = 128, where
  // shared memory holds one)
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;
  // each key tile's P.v summed from zero, then added to the accumulator in
  // fp32 (false: the mma adds it into the accumulator)
  static constexpr bool FRESH_TILE = true;
  // qs split into hi and lo once, into two tiles (false: each warp splits
  // every A fragment it loads; 3 % slower at the training shape, PERF.md)
  static constexpr bool Q_SPLIT_ONCE = true;
  // p = 2^(s log2 e - m log2 e) by ex2_ftz (false: e^(s - m) by expf)
  static constexpr bool EXP2 = true;
  // q (its hi part with Q_SPLIT_ONCE), k and v for each of two stages, then
  // q's lo part with Q_SPLIT_ONCE
  static constexpr size_t SMEM_BYTES =
      (5 + Q_SPLIT_ONCE) * (size_t)TILE * sizeof(float);
};

// 2^x by the hardware's ex2.approx.ftz.f32: exp2f without its care for
// results below 2^-126, which flush to 0 here, far below what moves a
// row's sum (whose largest p is 1).  Bit-equal to exp2f at every shape
// of fwd32_variants, and 1.5-3 % faster (PERF.md)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// e^(x - m), exactly 1 where x == m and 0 where x is -1e30 and m is not
// (the rescale of a running max, the merge of the key halves)
template <bool EXP2>
__device__ __forceinline__ float exp_sub(float x, float m) {
  if constexpr (EXP2) return exp2f((x - m) * hopper::LOG2E);
  return expf(x - m);
}

// s[j] = rows r0 .. r0 + 15 of qs . rows nb + 8 j .. nb + 8 j + 7 of k,
// over D, for j < nj (the rest stay 0), in three TF32 passes.  With
// SPLIT_ONCE, Qs holds qs's hi parts and Ql its lo parts
template <int D, int NJ, bool SPLIT_ONCE>
__device__ __forceinline__ void scores(float (&s)[NJ][4], const float* Qs,
                                       const float* Ql, const float* Ks,
                                       int r0, int nb, int lane, int nj) {
  constexpr int LD = D + 4;
  using namespace tf32x3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    float a[4];
    uint32_t ah[4], al[4];
    load_a<LD>(a, Qs, r0, kk, lane);
    if constexpr (SPLIT_ONCE) {
      float lo[4];
      load_a<LD>(lo, Ql, r0, kk, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = __float_as_uint(a[i]);
        al[i] = __float_as_uint(lo[i]);
      }
    } else {
      split(a, ah, al);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) continue;
      float bv[2];
      uint32_t bh[2], bl[2];
      load_b_t<LD>(bv, Ks, nb + 8 * j, kk, lane);
      split(bv, bh, bl);
      mma3(s[j], ah, al, bh, bl);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Fwd32<D>::THREADS, Fwd32<D>::MIN_BLOCKS)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int T_len, int causal,
                        float scale) {
  using S = Fwd32<D>;
  using namespace tf32x3;
  constexpr int LD = S::LD, TILE = S::TILE, NT32 = S::THREADS, NJ = S::NJ;
  constexpr int N8 = D / 8;  // 8-column n-tiles of the output
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;         // q, then qs (its hi parts with Q_SPLIT_ONCE)
  float* KV = smem_f + TILE;  // stage s: k at KV + 2 s TILE, v after it
  float* Ql = KV + 4 * TILE;  // qs's lo parts (Q_SPLIT_ONCE only)
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  // causal: the q tiles that see the most keys start first
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * 64;
  const int nk = (T_len + 63) / 64;
  const int n_kt = causal ? min(qt, nk - 1) + 1 : nk;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T_len * row + (size_t)h * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % 4, kh = warp / 4;
  const int r0 = 16 * rg;       // this warp's rows of the tile: r0 .. r0 + 15
  const int kb = 8 * NJ * kh;   // and its keys of each tile: kb .. kb + 8 NJ - 1
  const int g = lane / 4, t2 = 2 * (lane % 4);

  // group 0: q and stage 0; group 1: stage 1 (empty if there is none)
  load_tile_async<D, LD, NT32>(Qs, q + base, row, q0, T_len, tid);
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    if (st < n_kt) {
      load_tile_async<D, LD, NT32>(KV + 2 * st * TILE, k + base, row, 64 * st,
                                   T_len, tid);
      load_tile_async<D, LD, NT32>(KV + (2 * st + 1) * TILE, v + base, row,
                                   64 * st, T_len, tid);
    }
    cp_async_commit();
  }

  // the output accumulator over this warp's keys; element (n, e) is row
  // r0 + g + 8 (e >> 1), column 8 n + t2 + (e & 1).  Running max and this
  // thread's share of the normalizer of rows r0 + g and r0 + g + 8
  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    if (kt == 0) {
      // qs = q * scale in fp32, as the plain version forms it, and its
      // hi and lo parts
#pragma unroll 4
      for (int i = tid; i < 64 * D; i += NT32) {
        const int at = (i / D) * LD + i % D;
        const float x = Qs[at] * scale;
        if constexpr (S::Q_SPLIT_ONCE) {
          uint32_t hi, lo;
          split(x, hi, lo);
          Qs[at] = __uint_as_float(hi);
          Ql[at] = __uint_as_float(lo);
        } else {
          Qs[at] = x;
        }
      }
      __syncthreads();
    }
    const int st = kt & 1;
    const float* Ks = KV + 2 * st * TILE;
    const float* Vs = Ks + TILE;
    const int k0 = kt * 64;
    const bool diag = causal && k0 == q0;
    // the key n-tiles this warp's rows see: on the diagonal tile, keys up
    // to row r0 + 15 (none for the second half's first two row groups)
    const int nj = diag ? min(max(2 * rg + 2 - NJ * kh, 0), NJ) : NJ;
    if (nj > 0) {
      float s[NJ][4];
      scores<D, NJ, S::Q_SPLIT_ONCE>(s, Qs, Ql, Ks, r0, kb, lane, nj);
      // element (j, e) of s is row q0 + r0 + g + 8 (e >> 1), key
      // k0 + kb + 8 j + t2 + (e & 1)
      const bool masked = diag || k0 + 64 > T_len;
      auto hidden = [&](int j, int e) {
        const int key = k0 + kb + 8 * j + t2 + (e & 1);
        return key >= T_len ||
               (causal && key > q0 + r0 + g + 8 * (e >> 1));
      };
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked && hidden(j, e)) s[j][e] = NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2], ms[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = hopper::quad_max(mx[hh]);
        corr[hh] = exp_sub<S::EXP2>(m[hh], mx[hh]);
        m[hh] = mx[hh];
        ms[hh] = mx[hh] * hopper::LOG2E;
        l[hh] *= corr[hh];
      }
      // p, and its hi and lo parts as the A fragments of P.v.  A row of
      // this warp may see none of its keys yet (max still -1e30): its
      // masked p are set to 0, not e^0
      uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          p[e] = S::EXP2 ? ex2_ftz(fmaf(s[j][e], hopper::LOG2E, -ms[hh]))
                         : expf(s[j][e] - m[hh]);
          if (masked && hidden(j, e)) p[e] = 0.f;
          l[hh] += p[e];
        }
        float a[4];
        acc_as_a(a, p);
        split(a, ph[j], pl[j]);
      }
      // acc = acc * corr + P.v, each 8-column n-tile of P.v summed from
      // zero over this warp's key steps, v read in the matching row order
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (!S::FRESH_TILE) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nj) continue;
          float bv[2];
          uint32_t bh[2], bl[2];
          load_b_pairs<LD>(bv, Vs, kb + 8 * j, 8 * n, lane);
          split(bv, bh, bl);
          if constexpr (S::FRESH_TILE)
            mma3(t, ph[j], pl[j], bh, bl);
          else
            mma3(acc[n], ph[j], pl[j], bh, bl);
        }
        if constexpr (S::FRESH_TILE) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = fmaf(acc[n][e], corr[e >> 1], t[e]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage's k and v
    if (kt + 2 < n_kt) {
      float* Kn = KV + 2 * st * TILE;
      load_tile_async<D, LD, NT32>(Kn, k + base, row, k0 + 128, T_len, tid);
      load_tile_async<D, LD, NT32>(Kn + TILE, v + base, row, k0 + 128, T_len,
                                   tid);
    }
    cp_async_commit();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = hopper::quad_sum(l[hh]);
  if constexpr (NJ < 8) {
    // the second key half's warps hand acc, m and l to the first's through
    // the free k/v stages, [row group][n][lane] float4 (conflict-free),
    // then m and l; the first half rescales both to the larger max and
    // adds, its own terms first.  A second-half row that saw no key (the
    // first q tile's first 32 rows, causal) has m = -1e30, l = 0 and
    // acc = 0, and merges with weight exactly 0
    float4* red = reinterpret_cast<float4*>(KV) + rg * (N8 + 1) * 32 + lane;
    if (kh == 1) {
#pragma unroll
      for (int n = 0; n < N8; ++n)
        red[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      red[N8 * 32] = make_float4(m[0], m[1], l[0], l[1]);
    }
    __syncthreads();
    if (kh == 1) return;
    const float4 ml = red[N8 * 32];
    const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
    float c0[2], c1[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mm = fmaxf(m[hh], m1[hh]);
      c0[hh] = exp_sub<S::EXP2>(m[hh], mm);
      c1[hh] = exp_sub<S::EXP2>(m1[hh], mm);
      m[hh] = mm;
      l[hh] = fmaf(l1[hh], c1[hh], l[hh] * c0[hh]);
    }
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const float4 o = red[n * 32];
      acc[n][0] = fmaf(o.x, c1[0], acc[n][0] * c0[0]);
      acc[n][1] = fmaf(o.y, c1[0], acc[n][1] * c0[0]);
      acc[n][2] = fmaf(o.z, c1[1], acc[n][2] * c0[1]);
      acc[n][3] = fmaf(o.w, c1[1], acc[n][3] * c0[1]);
    }
  }

  // out = acc / l, lse = m + log(l), rows past T not stored
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + r0 + g + 8 * hh;
    if (t >= T_len) continue;
    const float ls = fmaxf(l[hh], 1e-30f);
    float* o = out + base + (size_t)t * row + t2;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * hh] / ls, acc[n][2 * hh + 1] / ls);
    if (lane % 4 == 0)
      lse[((size_t)b * H + h) * T_len + t] = m[hh] + logf(ls);
  }
}

template <int D>
int launch_tf32x3(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int T_len, int H, int causal, float scale,
                  cudaStream_t st) {
  using S = Fwd32<D>;
  // 16-byte copies (cp.async) and 8-byte stores
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  static bool configured = false;
  int rc = hopper::configure(flash_fwd_tf32x3_kernel<D>, S::SMEM_BYTES,
                             configured);
  if (rc) return rc;
  dim3 grid(H, B, (T_len + 63) / 64);
  flash_fwd_tf32x3_kernel<D><<<grid, S::THREADS, S::SMEM_BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), T_len, causal, scale);
  return (int)cudaGetLastError();
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
// and 16-byte aligned; lse: [B, H, T] fp32.  Returns
// cudaGetLastError(), or -CUresult when a tensor map fails to encode.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* out, void* lse, int B, int T,
                         int H, int D, int causal, float scale,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_tf32x3<32>(q, k, v, out, lse, B, T, H, causal, scale, st);
      case 64: return launch_tf32x3<64>(q, k, v, out, lse, B, T, H, causal, scale, st);
      case 128: return launch_tf32x3<128>(q, k, v, out, lse, B, T, H, causal, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 32: return launch_wgmma<32>(q, k, v, out, lse, B, T, H, causal, scale, st);
    case 64: return launch_wgmma<64>(q, k, v, out, lse, B, T, H, causal, scale, st);
    case 128: return launch_wgmma<128>(q, k, v, out, lse, B, T, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

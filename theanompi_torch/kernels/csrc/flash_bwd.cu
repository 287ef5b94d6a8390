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
// bf16: both kernels run on the tensor cores, on the blocks of hopper.cuh
// (the forward's design, flash_fwd.cu).  One CTA per (64 rows, head,
// batch): one consumer warpgroup, whose products read two fixed tiles,
// loaded once, and two tiles per stage streamed through a ring of two
// buffers (TMA, full/empty mbarriers, hopper::Pipeline).
//
// flash_bwd_dq (flash_bwd_dq_wgmma_kernel): 64 query rows; q and dO fixed, k
// and v streamed up to the diagonal by a producer warp.  Per key tile the
// warpgroup issues S = qs.k^T and dP = dO.v^T as wgmma with both operands in
// shared memory, forms ds on the accumulator fragments, and issues dQ +=
// dS.k with dS in registers as bf16 and the same k tile read as an MN-major
// B operand.  dq = scale * acc goes back through shared memory and a TMA
// store.  The warpgroup's products and its elementwise ds work run one after
// the other; only the other CTAs on the SM fill the gaps.
//
// flash_bwd_dkv (flash_bwd_dkv_wgmma_kernel): the roles of the two pairs
// swapped.  64 key rows; k and v fixed, q and dO streamed from the first q
// tile that sees the keys to the end of T, each stage with its 64 rows of
// lse and delta (TMA over the [B * H, T] fp32 arrays); in the causal case
// key tile 0, which sees every q tile, starts first.  No producer warp:
// thread 0 issues the loads, a stage ahead, so a CTA is four warps and two
// fit on an SM at up to 255 registers a thread (189 at D=64; with a fifth
// warp the limit is 168, where ptxas serialized the wgmma; PERF.md has the
// times).  Each landed q tile is scaled in place to qs, unless the rounded
// scale is a power of two (D=64): qs is then q times it exactly, and S^T and
// dK take it in fp32 instead.  Keys are the accumulators' rows, so the
// products S^T = k.qs^T and dP^T = v.dO^T leave P^T and dS^T in registers in
// the A layout of dV += P^T.dO and dK += dS^T.qs (dO and qs read MN-major);
// lse and delta are indexed by the accumulator's column.  The elementwise
// work overlaps the warpgroup's own products: P^T is formed while dP^T runs,
// dS^T while dV runs.  dk and dv go out through the free k and v tiles and
// TMA stores.
//
// fp32 flash_bwd_dq (flash_bwd_dq_tf32x3_kernel): the tensor cores have no
// fp32 product, so each product runs as three TF32 passes of mma.sync
// m16n8k8 (tf32x3.cuh), fp32-accurate at 165 TFLOP/s of peak against the
// CUDA cores' 67.  One CTA of eight warps per (64 query rows, head, batch):
// four row groups of 16, each split between two warps that take 32 keys of
// every 64-key tile (twice the warps of one warp a row group, in the same
// shared memory; their dq is summed once, at the end).  q and dO land once,
// q scaled in place; k and v stream up to the diagonal through a two-stage
// cp.async ring, all as fp32 rows of D + 4 floats (conflict-free fragment
// loads).  Per key tile a warp forms its 16 x 32 block of S = qs.k^T and
// dP = dO.v^T, ds on those accumulator fragments, and dQ += dS.k with dS in
// registers: the fragment of n-tile j is the A fragment of key step j once
// the keys are taken in the order 8j + 2t, 8j + 2t + 1 (k's rows read to
// match), so dS never goes through shared memory.  On the diagonal tile a
// warp skips the key columns above its rows.  The first causal rows (those
// of the first key tile of the first q tile) take dp in FFMA, as the plain
// version's fp32 product sums it: see the kernel.  Deterministic: each CTA
// owns its rows of dq, summed in a fixed order.
//
// fp32 flash_bwd_dkv (flash_bwd_dkv_tf32x3_kernel): kernel 2's fp32 design
// with the roles of the two pairs swapped, as in bf16.  One CTA of eight
// warps per (64 key rows, head, batch), key tile 0 (which sees every q tile)
// first in the causal case: four key-row groups of 16, each split between
// two warps that take 32 of the 64 queries of every q tile (their dk and dv
// are summed once, at the end, through the free stages, in a fixed order:
// deterministic).  k and v land once; q, dO and each stage's 64 values of
// lse and delta stream from the first q tile that sees the keys to the end
// of T through a two-stage cp.async ring, the tiles as fp32 rows of D + 4
// floats.  Keys are the accumulators' rows: per q tile a warp forms its
// 16 x 32 blocks of S^T = k.qs^T and dP^T = v.dO^T, P^T and dS^T on those
// fragments (lse and delta by the column), and dV += P^T.dO and
// dK += dS^T.qs with P^T and dS^T in registers as A fragments (acc_as_a,
// dO's and q's rows read in the pair order).  qs = q * scale in fp32: each
// q element is scaled as it is loaded for a product, before its split.  On
// the diagonal tile a warp skips the query n-tiles that lie wholly before
// its keys.  The last causal keys (the diagonal tile of the last key tile)
// take dp in FFMA, as the plain version's fp32 product sums it: the last
// key's dk is one term whose dp - delta may cancel (see the kernel, and
// tests/test_torch_tf32x3_dkv.py, which emulates the kernel on the CPU).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

// -- fp32 dq: three-pass TF32 mma.sync on the tensor cores --------------------

// Eight warps: warp w takes the 16 query rows 16 (w % 4) .. and the 32 keys
// 32 (w / 4) .. of every 64-key tile; the two key halves' dq are summed at
// the end.  Two stages of k and v in flight.
template <int D>
struct Dq32 {
  static constexpr int LD = D + 4;      // floats per tile row (tf32x3.cuh)
  static constexpr int TILE = 64 * LD;  // floats per tile
  static constexpr int THREADS = 256;
  static constexpr int NJ = 4;          // 8-key n-tiles a warp
  // registers: two CTAs an SM at up to 128 a thread (one at D = 128, where
  // shared memory holds one)
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;
  // q and dO, then k and v for each of two stages
  static constexpr size_t SMEM_BYTES = 6 * (size_t)TILE * sizeof(float);
};

// c1[j] = rows r0 .. r0 + 15 of A1 . rows nb + 8 j .. nb + 8 j + 7 of B1
// (each B1 element times b1_mul in fp32 before its split), and c2[j] the
// same of A2 and B2, over D, for j0 <= j < j1 (the rest stay 0), in three
// TF32 passes: S = qs.k^T and dP = dO.v^T in dq, S^T = k.qs^T and
// dP^T = v.dO^T in dk/dv.  Tiles in rows of D + 4 floats (Dq32, Dkv32)
template <int D, int NJ>
__device__ __forceinline__ void two_products(float (&c1)[NJ][4],
                                             float (&c2)[NJ][4],
                                             const float* A1, const float* A2,
                                             const float* B1, const float* B2,
                                             int r0, int nb, int lane, int j0,
                                             int j1, float b1_mul) {
  constexpr int LD = D + 4;
  using namespace tf32x3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    float a[4], o[4];
    uint32_t ah[4], al[4], oh[4], ol[4];
    load_a<LD>(a, A1, r0, kk, lane);
    split(a, ah, al);
    load_a<LD>(o, A2, r0, kk, lane);
    split(o, oh, ol);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < j0 || j >= j1) continue;
      float bv[2];
      uint32_t bh[2], bl[2];
      load_b_t<LD>(bv, B1, nb + 8 * j, kk, lane);
      bv[0] *= b1_mul;
      bv[1] *= b1_mul;
      split(bv, bh, bl);
      mma3(c1[j], ah, al, bh, bl);
      load_b_t<LD>(bv, B2, nb + 8 * j, kk, lane);
      split(bv, bh, bl);
      mma3(c2[j], oh, ol, bh, bl);
    }
  }
}

// c2[j] of two_products() again in fp32 FFMA, each element one fma chain
// over d in order from 0, as an fp32 matrix product sums it (for the first
// causal rows of dq and the last causal keys of dk/dv, see the kernels)
template <int D, int NJ>
__device__ __forceinline__ void dp_ffma(float (&dp)[NJ][4], const float* A2,
                                        const float* B2, int r0, int nb,
                                        int lane, int j0, int j1) {
  constexpr int LD = D + 4;
  const float* a0 = A2 + (r0 + lane / 4) * LD;
  const float* a1 = a0 + 8 * LD;
  const float* b0 = B2 + (nb + 2 * (lane % 4)) * LD;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float x0 = a0[d], x1 = a1[d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < j0 || j >= j1) continue;
      const float y0 = b0[8 * j * LD + d], y1 = b0[(8 * j + 1) * LD + d];
      dp[j][0] = fmaf(x0, y0, dp[j][0]);
      dp[j][1] = fmaf(x0, y1, dp[j][1]);
      dp[j][2] = fmaf(x1, y0, dp[j][2]);
      dp[j][3] = fmaf(x1, y1, dp[j][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Dq32<D>::THREADS, Dq32<D>::MIN_BLOCKS)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int T_len, int causal,
                           float scale) {
  using S = Dq32<D>;
  using namespace tf32x3;
  constexpr int LD = S::LD, TILE = S::TILE, NT32 = S::THREADS, NJ = S::NJ;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;             // q, scaled in place once it lands
  float* dOs = smem_f + TILE;
  float* KV = smem_f + 2 * TILE;  // stage s: k at KV + 2 s TILE, v after it
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

  // group 0: q, dO and stage 0; group 1: stage 1 (empty if there is none)
  load_tile_async<D, LD, NT32>(Qs, q + base, row, q0, T_len, tid);
  load_tile_async<D, LD, NT32>(dOs, dout + base, row, q0, T_len, tid);
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

  // lse in log2 units and delta of rows g and g + 8 of this warp's 16 (0
  // past T, where q and dO are zero rows, so ds is 0 there)
  float lse2[2], dl[2];
  const size_t rbase = ((size_t)b * H + h) * T_len;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + r0 + g + 8 * hh;
    lse2[hh] = t < T_len ? lse[rbase + t] * hopper::LOG2E : 0.f;
    dl[hh] = t < T_len ? delta[rbase + t] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    if (kt == 0) {
      // qs = q * scale in fp32, as the plain version forms it
#pragma unroll 4
      for (int i = tid; i < 64 * D; i += NT32) {
        float* x = Qs + (i / D) * LD + i % D;
        *x *= scale;
      }
      __syncthreads();
    }
    const int st = kt & 1;
    const float* Ks = KV + 2 * st * TILE;
    const float* Vs = Ks + TILE;
    const int k0 = kt * 64;
    const bool diag = causal && k0 == q0;
    // the key n-tiles this warp's rows see: on the diagonal tile, keys up
    // to row r0 + 15
    const int nj = diag ? min(max(2 * rg + 2 - NJ * kh, 0), NJ) : NJ;
    float s[NJ][4], dp[NJ][4];
    two_products<D, NJ>(s, dp, Qs, dOs, Ks, Vs, r0, kb, lane, 0, nj, 1.f);
    // The first causal query sees one key: its exact gradient is 0, and
    // dq there is the rounding left by dp - delta.  On the first key tile
    // of the first q tile (the rows that see fewer than 64 keys) dp is
    // summed again as the plain version's fp32 matrix product sums it, so
    // those rows cancel as its rows do (one tile of a head; the hot loop
    // keeps no branch for it)
    const bool exact = causal && q0 == 0 && kt == 0;
    if (exact) dp_ffma<D, NJ>(dp, dOs, Vs, r0, kb, lane, 0, nj);

    // ds = p * (dp - delta) on the fragments: element (j, e) is row
    // r0 + g + 8 (e >> 1), key k0 + kb + 8 j + t2 + (e & 1)
    const bool masked = diag || k0 + 64 > T_len;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float p = exp2f(fmaf(s[j][e], hopper::LOG2E, -lse2[hh]));
        if (masked) {
          const int key = k0 + kb + 8 * j + t2 + (e & 1);
          const int t = q0 + r0 + g + 8 * hh;
          if (key >= T_len || (causal && key > t)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[hh]);  // ds, unscaled
      }

    // dQ += dS.K: ds stays in registers as the A fragments, k read in the
    // matching row order
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) continue;
      float a[4];
      uint32_t ah[4], al[4];
      acc_as_a(a, s[j]);
      split(a, ah, al);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float bv[2];
        uint32_t bh[2], bl[2];
        load_b_pairs<LD>(bv, Ks, kb + 8 * j, 8 * n, lane);
        split(bv, bh, bl);
        mma3(acc[n], ah, al, bh, bl);
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

  if constexpr (NJ < 8) {
    // the second key half's warps hand their sums to the first's through
    // the free k/v stages, [row group][n][lane] float4 (conflict-free); the
    // first half's sum plus the second's, in that order
    float4* red = reinterpret_cast<float4*>(KV);
    if (kh == 1) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        red[(rg * (D / 8) + n) * 32 + lane] =
            make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
    __syncthreads();
    if (kh == 1) return;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float4 o = red[(rg * (D / 8) + n) * 32 + lane];
      acc[n][0] += o.x;
      acc[n][1] += o.y;
      acc[n][2] += o.z;
      acc[n][3] += o.w;
    }
  }

  // dq = scale * acc; element (n, e) is row r0 + g + 8 (e >> 1), column
  // 8 n + t2 + (e & 1)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + r0 + g + 8 * hh;
    if (t >= T_len) continue;
    float* out = dq + base + (size_t)t * row + t2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
  }
}

// -- fp32 dk, dv: the same products with the roles of the two pairs swapped --------

// Eight warps: warp w takes the 16 key rows 16 (w % 4) .. and the 32 queries
// 32 (w / 4) .. of every 64-query tile; the two query halves' dk and dv are
// summed at the end (four warps, each taking all 64 queries, ran 5 % slower
// at D = 64 and 2.6x at D = 128: kernels/dkv32_variants.py).  Two stages of
// q, dO, lse and delta in flight.
template <int D>
struct Dkv32 {
  static constexpr int LD = D + 4;      // floats per tile row (tf32x3.cuh)
  static constexpr int TILE = 64 * LD;  // floats per tile
  static constexpr int WARPS_A_GROUP = 2;  // warps per 16-key row group
  static constexpr int THREADS = 128 * WARPS_A_GROUP;
  static constexpr int NJ = 8 / WARPS_A_GROUP;  // 8-query n-tiles a warp
  // registers: two CTAs an SM at up to 128 a thread (one at D = 128, where
  // shared memory holds one).  At D = 64 ptxas spills some 48 bytes there;
  // one CTA an SM, with no spill, ran 8 % slower at the training shape
  static constexpr int MIN_BLOCKS = D < 128 ? 2 : 1;
  // k and v, then q and dO for each of two stages, then each stage's 64
  // values of lse and of delta
  static constexpr size_t SMEM_BYTES =
      (6 * (size_t)TILE + 4 * 64) * sizeof(float);
};

// Rows t0 .. t0 + 63 of one (b, h) row of lse and of delta ([B, H, T]
// fp32) into 64 floats each, zeros past T, by threads 0 .. 31.  T is a
// multiple of 16, so each 16-byte copy lies wholly before T or past it.
__device__ __forceinline__ void load_vecs_async(float* dst,
                                                const float* lse_row,
                                                const float* delta_row,
                                                int t0, int T_len, int tid) {
  if (tid >= 32) return;
  const float* src = tid < 16 ? lse_row : delta_row;
  const int c = 4 * (tid % 16);
  const bool in = t0 + c < T_len;
  tf32x3::cp_async16(dst + 64 * (tid / 16) + c, in ? src + t0 + c : src, in);
}

template <int D>
__global__ void __launch_bounds__(Dkv32<D>::THREADS, Dkv32<D>::MIN_BLOCKS)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int T_len, int causal, float scale) {
  using S = Dkv32<D>;
  using namespace tf32x3;
  constexpr int LD = S::LD, TILE = S::TILE, NT32 = S::THREADS, NJ = S::NJ;
  constexpr int N8 = D / 8;
  extern __shared__ __align__(16) float smem_f[];
  float* Ks = smem_f;
  float* Vs = smem_f + TILE;
  float* QD = smem_f + 2 * TILE;  // stage s: q at QD + 2 s TILE, dO after it
  float* LV = smem_f + 6 * TILE;  // stage s: lse at LV + 128 s, delta after
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  // key tile 0 sees every q tile: in the causal case the heaviest go first
  const int k0 = blockIdx.z * 64;
  const int qt0 = causal ? blockIdx.z : 0;  // the first q tile that sees it
  const int n_qt = (T_len + 63) / 64 - qt0;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T_len * row + (size_t)h * D;
  const float* lse_row = lse + ((size_t)b * H + h) * T_len;
  const float* delta_row = delta + ((size_t)b * H + h) * T_len;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % 4, qh = warp / 4;
  const int r0 = 16 * rg;      // this warp's keys of the tile: r0 .. r0 + 15
  const int qb = 8 * NJ * qh;  // its queries of each tile: qb .. qb + 8 NJ - 1
  const int g = lane / 4, t2 = 2 * (lane % 4);

  // group 0: k, v and stage 0; group 1: stage 1 (empty if there is none)
  load_tile_async<D, LD, NT32>(Ks, k + base, row, k0, T_len, tid);
  load_tile_async<D, LD, NT32>(Vs, v + base, row, k0, T_len, tid);
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    if (st < n_qt) {
      const int t0 = (qt0 + st) * 64;
      load_tile_async<D, LD, NT32>(QD + 2 * st * TILE, q + base, row, t0,
                                   T_len, tid);
      load_tile_async<D, LD, NT32>(QD + (2 * st + 1) * TILE, dout + base, row,
                                   t0, T_len, tid);
      load_vecs_async(LV + 128 * st, lse_row, delta_row, t0, T_len, tid);
    }
    cp_async_commit();
  }

  float dka[N8][4], dva[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    cp_async_wait<1>();  // this stage's group has landed
    __syncthreads();
    const int st = it & 1;
    const float* Qs = QD + 2 * st * TILE;
    const float* dOs = Qs + TILE;
    const float* lse_s = LV + 128 * st;
    const float* del_s = lse_s + 64;
    const int q0 = (qt0 + it) * 64;
    const bool diag = causal && q0 == k0;
    // the query n-tiles this warp's keys see: on the diagonal tile, from
    // the first that holds a query at or after key r0 (a first index: the
    // n-tiles before it are wholly above the diagonal)
    const int j0 = diag ? min(max((r0 - qb) / 8, 0), NJ) : 0;
    float s[NJ][4], dp[NJ][4];
    // S^T and dP^T, q's elements scaled to qs = q * scale in fp32 as they
    // are loaded, before their split
    two_products<D, NJ>(s, dp, Ks, Vs, Qs, dOs, r0, qb, lane, j0, NJ, scale);
    // The last causal key sees one query, so its dk is one term, dS.qs, and
    // dS = p * (dp - delta) may cancel to a small part of dp: there the
    // limit, set by the row's own size, is finer than three TF32 passes
    // leave dp.  On the diagonal tile of the last key tile (the keys that
    // see at most 64 queries) dp is summed again as the plain version's
    // fp32 matrix product sums it, so those keys round as its keys do (one
    // tile of a head; the hot loop keeps no branch for it)
    const bool exact = diag && k0 + 64 >= T_len;
    if (exact) dp_ffma<D, NJ>(dp, Vs, dOs, r0, qb, lane, j0, NJ);

    // P^T and dS^T = P^T * (dP^T - delta) on the fragments: element (j, e)
    // is key k0 + r0 + g + 8 (e >> 1), query q0 + qb + 8 j + t2 + (e & 1),
    // so lse and delta go by the column.  Queries past T are zero rows of q
    // with lse 0 there, p = 1: masked
    const bool masked = diag || q0 + 64 > T_len;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int qc = qb + 8 * j + t2;
      const float2 l = *reinterpret_cast<const float2*>(lse_s + qc);
      const float2 dl = *reinterpret_cast<const float2*>(del_s + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], hopper::LOG2E,
                             -(e & 1 ? l.y : l.x) * hopper::LOG2E));
        if (masked) {
          const int key = k0 + r0 + g + 8 * (e >> 1);
          const int query = q0 + qc + (e & 1);
          if (query >= T_len || (causal && key > query)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - (e & 1 ? dl.y : dl.x));
      }
    }

    // dV += P^T.dO and dK += dS^T.qs: P^T and dS^T stay in registers as the
    // A fragments, dO's and q's rows read in the matching order
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < j0) continue;
      float a[4];
      uint32_t ph[4], pl[4], dh[4], dlo[4];
      acc_as_a(a, s[j]);
      split(a, ph, pl);
      acc_as_a(a, dp[j]);
      split(a, dh, dlo);
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        float bv[2];
        uint32_t bh[2], bl[2];
        load_b_pairs<LD>(bv, dOs, qb + 8 * j, 8 * n, lane);
        split(bv, bh, bl);
        mma3(dva[n], ph, pl, bh, bl);
        load_b_pairs<LD>(bv, Qs, qb + 8 * j, 8 * n, lane);
        bv[0] *= scale;
        bv[1] *= scale;
        split(bv, bh, bl);
        mma3(dka[n], dh, dlo, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_qt) {
      const int t0 = q0 + 128;
      float* Qn = QD + 2 * st * TILE;
      load_tile_async<D, LD, NT32>(Qn, q + base, row, t0, T_len, tid);
      load_tile_async<D, LD, NT32>(Qn + TILE, dout + base, row, t0, T_len,
                                   tid);
      load_vecs_async(LV + 128 * st, lse_row, delta_row, t0, T_len, tid);
    }
    cp_async_commit();
  }

  if constexpr (NJ < 8) {
    // the second query half's warps hand their sums to the first's through
    // the free stages, [dk | dv][row group][n][lane] float4 (conflict-free);
    // the first half's sum plus the second's, in that order
    float4* red = reinterpret_cast<float4*>(QD);
    if (qh == 1) {
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        red[(rg * N8 + n) * 32 + lane] =
            make_float4(dka[n][0], dka[n][1], dka[n][2], dka[n][3]);
        red[((4 + rg) * N8 + n) * 32 + lane] =
            make_float4(dva[n][0], dva[n][1], dva[n][2], dva[n][3]);
      }
    }
    __syncthreads();
    if (qh == 1) return;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const float4 ok = red[(rg * N8 + n) * 32 + lane];
      const float4 ov = red[((4 + rg) * N8 + n) * 32 + lane];
      dka[n][0] += ok.x;
      dka[n][1] += ok.y;
      dka[n][2] += ok.z;
      dka[n][3] += ok.w;
      dva[n][0] += ov.x;
      dva[n][1] += ov.y;
      dva[n][2] += ov.z;
      dva[n][3] += ov.w;
    }
  }

  // element (n, e) is key row k0 + r0 + g + 8 (e >> 1), column
  // 8 n + t2 + (e & 1)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k0 + r0 + g + 8 * hh;
    if (t >= T_len) continue;
    const size_t at = base + (size_t)t * row + t2;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) =
          make_float2(dka[n][2 * hh], dka[n][2 * hh + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * n) =
          make_float2(dva[n][2 * hh], dva[n][2 * hh + 1]);
    }
  }
}

using hopper::configure;

template <int D>
int launch_dq_tf32x3(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int T_len, int H, int causal,
                     float scale, cudaStream_t st) {
  using S = Dq32<D>;
  // 16-byte copies (cp.async) and 8-byte stores
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  static bool configured = false;
  int rc = configure(flash_bwd_dq_tf32x3_kernel<D>, S::SMEM_BYTES,
                     configured);
  if (rc) return rc;
  dim3 grid(H, B, (T_len + 63) / 64);
  flash_bwd_dq_tf32x3_kernel<D><<<grid, S::THREADS, S::SMEM_BYTES, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dq), T_len, causal, scale);
  return (int)cudaGetLastError();
}

int dq_fp32(int D, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta, void* dq,
            int B, int T_len, int H, int causal, float scale,
            cudaStream_t st) {
  switch (D) {
    case 32: return launch_dq_tf32x3<32>(q, k, v, dout, lse, delta, dq, B, T_len, H, causal, scale, st);
    case 64: return launch_dq_tf32x3<64>(q, k, v, dout, lse, delta, dq, B, T_len, H, causal, scale, st);
    case 128: return launch_dq_tf32x3<128>(q, k, v, dout, lse, delta, dq, B, T_len, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_dkv_tf32x3(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int T_len, int H, int causal,
                      float scale, cudaStream_t st) {
  using S = Dkv32<D>;
  // 16-byte copies (cp.async) and 8-byte stores
  for (const void* p : {q, k, v, dout, lse, delta, static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  static bool configured = false;
  int rc = configure(flash_bwd_dkv_tf32x3_kernel<D>, S::SMEM_BYTES,
                     configured);
  if (rc) return rc;
  dim3 grid(H, B, (T_len + 63) / 64);
  flash_bwd_dkv_tf32x3_kernel<D><<<grid, S::THREADS, S::SMEM_BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), T_len, causal, scale);
  return (int)cudaGetLastError();
}

int dkv_fp32(int D, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dk,
             void* dv, int B, int T_len, int H, int causal, float scale,
             cudaStream_t st) {
  switch (D) {
    case 32: return launch_dkv_tf32x3<32>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H, causal, scale, st);
    case 64: return launch_dkv_tf32x3<64>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H, causal, scale, st);
    case 128: return launch_dkv_tf32x3<128>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- bf16 dq: wgmma products on TMA-fed tiles -------------------------------------

template <int D>
using DqPipe = hopper::Pipeline<D, 2, 2>;  // fixed q, dO; streamed k, v

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
    if (lane == 0) pipe.produce({&qm, &dom}, q0, {&km, &vm}, nullptr, h, b, 0, n_kt);
    return;
  }

  // the consumer warpgroup: query rows q0 .. q0 + 63
  const int tid = threadIdx.x;
  uint8_t* Qw = pipe.fixed_tile(0);
  const uint32_t q_addr = smem_u32(Qw);
  const uint32_t do_addr = smem_u32(pipe.fixed_tile(1));
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
  pipe.wait_fixed();
  pipe.scale(Qw, scale, tid);

  float acc[L::NP][L::PW / 2];
#pragma unroll
  for (int p = 0; p < L::NP; ++p)
#pragma unroll
    for (int i = 0; i < L::PW / 2; ++i) acc[p][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = pipe.wait(kt);
    const int k0 = kt * 64;
    const uint32_t k_addr = pipe.addr(s, 0), v_addr = pipe.addr(s, 1);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, L::desc_k(q_addr, kk), L::desc_k(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, L::desc_k(do_addr, kk), L::desc_k(v_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
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
    wgmma_wait<0>();
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

// -- bf16 dk, dv: the same blocks with the roles of the two pairs swapped -----------

template <int D>
using DkvPipe = hopper::Pipeline<D, 2, 2, 2>;  // fixed k, v; streamed q, dO;
                                               // vectors lse, delta
constexpr int DKV_THREADS = 128;               // no producer warp

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 2)
flash_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap qm,
                           __grid_constant__ const CUtensorMap km,
                           __grid_constant__ const CUtensorMap vm,
                           __grid_constant__ const CUtensorMap dom,
                           __grid_constant__ const CUtensorMap lsem,
                           __grid_constant__ const CUtensorMap deltam,
                           __grid_constant__ const CUtensorMap dkm,
                           __grid_constant__ const CUtensorMap dvm,
                           int T_len, int causal, float scale) {
  using namespace hopper;
  using L = Layout<D>;
  using P = DkvPipe<D>;
  extern __shared__ uint8_t smem_raw[];
  const P pipe(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  // key tile 0 sees every q tile: in the causal case the heaviest go first
  const int k0 = blockIdx.z * 64;
  const int qt0 = causal ? blockIdx.z : 0;     // the first q tile that sees it
  const int n_qt = (T_len + 63) / 64 - qt0;
  const int tid = threadIdx.x, lane = tid % 32;
  pipe.init();

  // thread 0 issues every load: k and v, then stages ahead of the products
  const CUtensorMap* const rows[2] = {&qm, &dom};
  const CUtensorMap* const vecs[2] = {&lsem, &deltam};
  if (tid == 0) {
    pipe.load_fixed({&km, &vm}, k0, h, b);
    for (int i = 0; i < min(P::STAGES, n_qt); ++i)
      pipe.load_stage(i, rows, vecs, h, b, qt0 * 64);
  }

  // the warpgroup: keys k0 .. k0 + 63, the accumulators' rows
  uint8_t* Kw = pipe.fixed_tile(0);
  uint8_t* Vw = pipe.fixed_tile(1);
  const uint32_t k_addr = smem_u32(Kw), v_addr = smem_u32(Vw);
  const int r0 = 16 * (tid / 32) + lane / 4, cq = 2 * (lane % 4);
  // qs = round(q * round(scale)).  Where round(scale) is a power of two
  // (D = 64), that is q times it exactly, and so are S^T and dK, which take
  // it in fp32 instead, bit for bit the same: the q tiles stay as they land
  const float qscale = round_bf16(scale);
  const bool fold = (__float_as_uint(qscale) & 0x7FFFFFu) == 0;
  const float s_mul = fold ? LOG2E * qscale : LOG2E;
  float dk[L::NP][L::PW / 2], dv[L::NP][L::PW / 2];
#pragma unroll
  for (int p = 0; p < L::NP; ++p)
#pragma unroll
    for (int i = 0; i < L::PW / 2; ++i) dk[p][i] = dv[p][i] = 0.f;
  pipe.wait_fixed();

  for (int it = 0; it < n_qt; ++it) {
    // thread 0: the slot stage it - 1 frees takes stage it + STAGES - 1
    const int ahead = it + P::STAGES - 1;
    if (tid == 0 && it > 0 && ahead < n_qt)
      pipe.load_stage(ahead, rows, vecs, h, b, qt0 * 64);
    const int s = pipe.wait(it);
    const int q0 = (qt0 + it) * 64;
    uint8_t* Qs = pipe.tile(s, 0);
    if (!fold) pipe.scale(Qs, scale, tid);
    const uint32_t q_addr = smem_u32(Qs), do_addr = pipe.addr(s, 1);
    // S^T = k.qs^T and dP^T = v.dO^T: keys down the rows, queries across
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, L::desc_k(k_addr, kk), L::desc_k(q_addr, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, L::desc_k(v_addr, kk), L::desc_k(do_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T landed; dP^T may still run
    fence_regs(st);

    // P^T, masked where the tile straddles the diagonal or the end of T;
    // lse indexed by the column (query 8 j + cq + e at register 4 j + e and
    // 4 j + 2 + e); 0 past T, where q and dO are zero rows
    const float* lse_s = pipe.vec(s, 0);
    const bool masked =
        (causal && q0 == k0) || q0 + 64 > T_len || k0 + 64 > T_len;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = exp2f(fmaf(st[i], s_mul, -(e & 1 ? l.y : l.x) * LOG2E));
        if (masked) {
          const int key = k0 + r0 + 8 * (e >> 1);
          const int query = q0 + 8 * j + cq + (e & 1);
          if (query >= T_len || key >= T_len || (causal && key > query))
            p = 0.f;
        }
        st[i] = p;
      }
    }
    // dV += round(P^T).dO, dO read MN-major panel by panel
    uint32_t pa[4][4];
    to_a_frags(st, pa);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) fence_regs(dv[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv[p], pa[kk], L::desc_mn(do_addr + p * L::PANEL_B, kk));
    wgmma_commit();

    // dS^T = P^T * (dP^T - delta) while dV runs, rounded to bf16 once, by
    // to_a_frags
    wgmma_wait<1>();  // dP^T landed; dV may still run
    fence_regs(dpt);
    const float* delta_s = pipe.vec(s, 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(delta_s + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dpt[i] = st[i] * (dpt[i] - (e & 1 ? d.y : d.x));
      }
    }
    // dK += dS^T.qs, qs read MN-major
    uint32_t da[4][4];
    to_a_frags(dpt, da);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) fence_regs(dk[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk[p], da[kk], L::desc_mn(q_addr + p * L::PANEL_B, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      fence_regs(dk[p]);
      fence_regs(dv[p]);
    }
    pipe.release(s);
  }

  // epilogue: the k and v tiles are free (their last products are done);
  // each warp writes the 16 rows its own products read
  const float one[2] = {1.f, 1.f}, dk_mul[2] = {fold ? qscale : 1.f,
                                                fold ? qscale : 1.f};
  store_frags<D, L::PW, false>(Kw, dk, dk_mul, tid);
  store_frags<D, L::PW, false>(Vw, dv, one, tid);
  pipe.store(&dkm, Kw, tid, h, k0, b);
  pipe.store(&dvm, Vw, tid, h, k0, b);
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int T_len, int H, int causal,
                     float scale, cudaStream_t st) {
  using P = DkvPipe<D>;
  static bool configured = false;
  int rc = configure(flash_bwd_dkv_wgmma_kernel<D>, P::SMEM_BYTES,
                     configured);
  if (rc) return rc;
  CUtensorMap m[6], lm, dm;
  if ((rc = hopper::make_maps<D, 6>(m, {q, k, v, dout, dk, dv}, B, T_len,
                                    H)) ||
      (rc = hopper::make_vec_map(&lm, lse, B * H, T_len)) ||
      (rc = hopper::make_vec_map(&dm, delta, B * H, T_len)))
    return rc;
  dim3 grid(H, B, (T_len + 63) / 64);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, DKV_THREADS, P::SMEM_BYTES, st>>>(
      m[0], m[1], m[2], m[3], lm, dm, m[4], m[5], T_len, causal, scale);
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
    return dq_fp32(D, q, k, v, dout, lse, delta, dq, B, T, H, causal, scale, st);
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
    return dkv_fp32(D, q, k, v, dout, lse, delta, dk, dv, B, T, H, causal, scale, st);
  switch (D) {
    case 32: return launch_dkv_wgmma<32>(q, k, v, dout, lse, delta, dk, dv, B, T, H, causal, scale, st);
    case 64: return launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, B, T, H, causal, scale, st);
    case 128: return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, B, T, H, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

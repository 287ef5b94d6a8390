// Hopper building blocks of the bf16 flash kernels (flash_fwd.cu,
// flash_bwd.cu): mbarriers, TMA loads and stores of 64-row tiles of one head
// of a [B, T, H, D] bf16 tensor (and of 64-value rows of an fp32 vector),
// the wgmma descriptors of those tiles, the wgmma shapes the kernels issue,
// the load ring they share, and the host side that encodes a tensor map.
// Compiled for sm_90a only (wgmma does not exist on plain sm_90).
//
// Tile layout in shared memory.  A tile is 64 rows (time steps) of one head,
// D bf16 columns, cut into panels of PW = min(D, 64) columns: one TMA box
// {PW, 1, 64, 1} over the tensor's dims {D, H, T, B} fills one panel, rows
// of PW * 2 bytes, swizzled by the hardware (128-byte swizzle at PW = 64,
// 64-byte at PW = 32).  Rows past T arrive as zeros.  The same layout serves
// wgmma as a K-major operand (the contracted dim along the row: q, dO, and
// k or v in S = q.k^T and dP = dO.v^T, or in S^T = k.qs^T and dP^T =
// v.dO^T) and as an MN-major B operand (the contracted dim down the rows: v
// in O += P.v, k in dQ += dS.k, dO in dV += P^T.dO, qs in dK += dS^T.qs),
// through the two descriptor forms below.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int PW = D < 64 ? D : 64;        // columns per panel
  static constexpr int NP = D / PW;                 // panels per tile
  static constexpr int ROW_B = PW * 2;              // bytes per panel row
  static constexpr int PANEL_B = 64 * ROW_B;        // bytes per panel
  static constexpr int TILE_B = NP * PANEL_B;       // bytes per tile
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t SWZ = ROW_B == 128 ? 1 : 2;
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");

  // byte offset of element (row, col) of a tile: the hardware's swizzle
  // XORs the 16-byte chunk index with the row's phase (row % 8 at 128-byte
  // rows, (row / 2) % 4 at 64-byte rows); tiles start 1024-byte aligned
  static __device__ __forceinline__ uint32_t offset(int row, int col) {
    const int p = col / PW, cb = (col % PW) * 2;
    const int phase = ROW_B == 128 ? (row & 7) : ((row >> 1) & 3);
    return p * PANEL_B + row * ROW_B + (((cb >> 4) ^ phase) << 4) + (cb & 15);
  }

  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (SWZ << 62);
  }
  // K-major operand at shared address `tile`, contracted dim along the row:
  // k-step kk covers columns 16 kk .. 16 kk + 15 (32 bytes into the row of
  // its panel); 8-row groups lie 8 rows apart (SBO); LBO is unused
  static __device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
    constexpr int per = PW / 16;
    return desc(tile + (kk / per) * PANEL_B + (kk % per) * 32, 16,
                8 * ROW_B);
  }
  // MN-major B operand from one panel, contracted dim down the rows: k-step
  // kk covers rows 16 kk .. 16 kk + 15; N = PW is one swizzle atom wide
  static __device__ __forceinline__ uint64_t desc_mn(uint32_t panel, int kk) {
    return desc(panel + kk * 16 * ROW_B, PANEL_B, 8 * ROW_B);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// spin until the barrier's phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy writes to shared memory -> visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier over `count` threads (a warpgroup), id 1.. (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// -- TMA -------------------------------------------------------------------------

// one 64-row tile of head h, time steps t0 .. t0 + 63 of batch b, panel by
// panel; completion counted on `bar`
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int h, int t0,
                                              int b) {
  using L = Layout<D>;
#pragma unroll
  for (int p = 0; p < L::NP; ++p)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(
            smem_u32(dst + p * L::PANEL_B)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(p * L::PW), "r"(h), "r"(t0), "r"(b)
        : "memory");
}

// 64 fp32 values t0 .. t0 + 63 of row `row` of an [R, T] array (a map from
// make_vec_map); zeros past T; completion counted on `bar`
__device__ __forceinline__ void tma_load_vec(float* dst, const CUtensorMap* map,
                                             uint64_t* bar, int t0, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(t0),
      "r"(row)
      : "memory");
}

// the reverse: rows past T are not written; returns once shared memory has
// been read
template <int D>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               const uint8_t* src, int h,
                                               int t0, int b) {
  using L = Layout<D>;
#pragma unroll
  for (int p = 0; p < L::NP; ++p)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src + p * L::PANEL_B)), "r"(p * L::PW), "r"(h), "r"(t0),
        "r"(b)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// -- wgmma -----------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups are still running (they complete
// in the order they were committed)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory,
// both K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (four bf16
// pairs in the accumulator's layout), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], as above (head dim 32)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- fragments -------------------------------------------------------------------
//
// A 64 x N fp32 accumulator: thread t of the warpgroup holds rows
// r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8; register 4 j + e holds row
// r0 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a 64 x 64 score-shaped accumulator as the A operand of the next product:
// k-step kk (keys 16 kk .. 16 kk + 15) is registers 8 kk .. 8 kk + 7, which
// is the register layout wgmma asks of A
__device__ __forceinline__ void to_a_frags(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// the sum over the four threads of a quad (one row's 64 columns)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// x * mul rounded to bf16, in place over a warpgroup's tile (the layout does
// not matter to an elementwise pass); 128 threads, 16 bytes each per step
template <int D>
__device__ __forceinline__ void scale_tile(uint8_t* tile, float mul,
                                           int tid) {
  for (int i = tid * 16; i < Layout<D>::TILE_B; i += 128 * 16) {
    uint4 v = *reinterpret_cast<uint4*>(tile + i);
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      e[j] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    *reinterpret_cast<uint4*>(tile + i) = v;
  }
}

// a warpgroup's 64 x D fp32 result (D / N panels of N columns) into its
// tile as bf16 in the TMA layout, rows r0 and r0 + 8 divided by div[0] and
// div[1] (DIVIDE) or multiplied by them
template <int D, int N, bool DIVIDE>
__device__ __forceinline__ void store_frags(uint8_t* tile,
                                            const float (&acc)[D / N][N / 2],
                                            const float (&by)[2], int tid) {
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4, cq = 2 * (tid % 4);
#pragma unroll
  for (int p = 0; p < D / N; ++p)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh, col = p * N + 8 * j + cq;
        const float x = acc[p][4 * j + 2 * hh], y = acc[p][4 * j + 2 * hh + 1];
        *reinterpret_cast<uint32_t*>(tile + Layout<D>::offset(row, col)) =
            DIVIDE ? pack_bf16(x / by[hh], y / by[hh])
                   : pack_bf16(x * by[hh], y * by[hh]);
      }
}

// -- the CTA's load pipeline -------------------------------------------------------
//
// A CTA of one consumer warpgroup (warps 0-3, 64 rows of the result) and
// one producer warp (warp 4), or of the consumer warpgroup alone, its thread
// 0 issuing the loads (dk/dv: a fifth warp would take a full register
// share on one of the SM's four sub-partitions, so two CTAs of five warps
// fit on an SM only at <= 168 registers a thread).  Shared memory, from a
// 1024-byte aligned base: NF fixed tiles, loaded once on `fbar` (q, and dO
// in dq; k and v in dk/dv); then a ring of STAGES slots, each NS streamed
// tiles (k and v; q and dO in dk/dv) and NV fp32 vectors of 64 values (lse
// and delta of the stage's 64 query rows in dk/dv), with a `full` mbarrier
// (the stage's TMA bytes landed) and an `empty` one (the four consumer
// warps are done with the slot), so the load of stage i + 1 overlaps the
// products on stage i.  Stage i holds rows t0 + 64 i .. t0 + 64 i + 63.
template <int D, int NF, int NS, int NV = 0>
struct Pipeline {
  using L = Layout<D>;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 + 32;           // with a producer warp
  static constexpr int PRODUCER = 4;                 // the producer's warp
  static constexpr int VEC_B = 64 * 4;               // bytes per vector
  static constexpr size_t SMEM_BYTES =
      1024 + (size_t)(NF + STAGES * NS) * L::TILE_B +
      (size_t)STAGES * NV * VEC_B + (2 * STAGES + 1) * 8;

  uint8_t* fixed;                                    // [NF] tiles
  uint8_t* ring;                                     // [STAGES][NS] tiles
  float* vecs;                                       // [STAGES][NV][64]
  uint64_t* full;                                    // [STAGES]
  uint64_t* empty;                                   // [STAGES]
  uint64_t* fbar;

  __device__ explicit Pipeline(uint8_t* raw)
      : fixed(align1024(raw)),
        ring(fixed + NF * L::TILE_B),
        vecs(reinterpret_cast<float*>(ring + STAGES * NS * L::TILE_B)),
        full(reinterpret_cast<uint64_t*>(vecs + STAGES * NV * 64)),
        empty(full + STAGES),
        fbar(empty + STAGES) {}

  __device__ uint8_t* fixed_tile(int f) const { return fixed + f * L::TILE_B; }
  __device__ uint8_t* tile(int s, int j) const {
    return ring + (s * NS + j) * L::TILE_B;
  }
  __device__ uint32_t addr(int s, int j) const { return smem_u32(tile(s, j)); }
  __device__ const float* vec(int s, int j) const {
    return vecs + (s * NV + j) * 64;
  }

  // the first query row of this CTA; grid (H, B, ceil(T / 64)), and in the
  // causal case the heaviest row tiles (most key tiles) go first
  static __device__ int first_row(int causal) {
    return (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * 64;
  }
  // key tiles that rows q0 .. q0 + 63 see (up to the diagonal)
  static __device__ int key_tiles(int q0, int T, int causal) {
    const int nk = (T + 63) / 64;
    return causal ? min(q0 / 64, nk - 1) + 1 : nk;
  }

  // every thread of the CTA: thread 0 sets up the barriers
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4);  // one arrival per consumer warp
      }
      mbar_init(fbar, 1);
      fence_barrier_init();
    }
    __syncthreads();
  }

  // -- the loads, all from one thread --
  // the fixed tiles of the NF maps at row f0
  __device__ void load_fixed(const CUtensorMap* const (&fmaps)[NF], int f0,
                             int h, int b) const {
    mbar_expect_tx(fbar, NF * L::TILE_B);
    for (int f = 0; f < NF; ++f)
      tma_load_tile<D>(fixed_tile(f), fmaps[f], fbar, h, f0, b);
  }
  // stage i, once its slot is free (the consumers released stage i -
  // STAGES): the tiles of the NS maps at row t0 + 64 i and the vectors of
  // the NV maps (make_vec_map) at the same rows of this CTA's (batch, head)
  // row; grid (H, B, ...)
  __device__ void load_stage(int i, const CUtensorMap* const (&smaps)[NS],
                             const CUtensorMap* const* vmaps, int h, int b,
                             int t0) const {
    const int s = i % STAGES, t = t0 + 64 * i;
    if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
    mbar_expect_tx(&full[s], NS * L::TILE_B + NV * VEC_B);
    for (int j = 0; j < NS; ++j)
      tma_load_tile<D>(tile(s, j), smaps[j], &full[s], h, t, b);
    for (int j = 0; j < NV; ++j)
      tma_load_vec(vecs + (s * NV + j) * 64, vmaps[j], &full[s], t,
                   b * gridDim.x + h);
  }
  // the producer warp's elected thread: every load, stages 0 .. n - 1
  __device__ void produce(const CUtensorMap* const (&fmaps)[NF], int f0,
                          const CUtensorMap* const (&smaps)[NS],
                          const CUtensorMap* const* vmaps, int h, int b,
                          int t0, int n) const {
    load_fixed(fmaps, f0, h, b);
    for (int i = 0; i < n; ++i) load_stage(i, smaps, vmaps, h, b, t0);
  }

  // the consumers: wait for the fixed tiles
  __device__ void wait_fixed() const { mbar_wait(fbar, 0); }
  // the consumers: a landed q tile scaled in place to qs = round_bf16(q *
  // round_bf16(scale)) and made visible to wgmma
  __device__ void scale(uint8_t* q_tile, float scale, int tid) const {
    scale_tile<D>(q_tile, round_bf16(scale), tid);
    fence_proxy_async();
    bar_sync(1, 128);
  }
  // wait for stage i; -> its slot
  __device__ int wait(int i) const {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    return s;
  }
  // every consumer warp, once done with slot s
  __device__ void release(int s) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }
  // the result, written to `tile` (store_frags), to global rows t0 .. t0 +
  // 63 (those before T)
  __device__ void store(const CUtensorMap* map, uint8_t* tile, int tid, int h,
                        int t0, int b) const {
    fence_proxy_async();
    bar_sync(1, 128);
    if (tid == 0) tma_store_tile<D>(map, tile, h, t0, b);
  }
};

// -- host --------------------------------------------------------------------------

// raise a kernel's dynamic shared memory limit once
template <typename F>
static inline int configure(F kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API, through the runtime (no
// -lcuda)
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// the tensor map of a contiguous [B, T, H, D] bf16 tensor (16-byte aligned)
// with the box {PW, 1, 64, 1}; -> 0, cudaErrorNotSupported when the CUDA
// driver API has no cuTensorMapEncodeTiled, or -CUresult when encoding
// fails
template <int D>
static inline int make_map(CUtensorMap* map, const void* ptr, int B, int T,
                           int H) {
  using L = Layout<D>;
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::PW, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::ROW_B == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// the tensor map of a contiguous [R, T] fp32 array (16-byte aligned, T % 4
// == 0) with the box {64, 1}: one stage's vector; returns as make_map
static inline int make_vec_map(CUtensorMap* map, const void* ptr, int R,
                               int T) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)T, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)T * 4};
  const cuuint32_t box[2] = {64, 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// make_map for N tensors of one shape; -> the first failure
template <int D, int N>
static inline int make_maps(CUtensorMap (&maps)[N],
                            const void* const (&ptrs)[N], int B, int T,
                            int H) {
  for (int i = 0; i < N; ++i)
    if (const int rc = make_map<D>(&maps[i], ptrs[i], B, T, H)) return rc;
  return 0;
}

}  // namespace hopper

// int8 weight matmul: out = x @ dequantize(W), straight from the chunked
// int8 payload.
//
// Replaces: theanompi_tpu/ops/quant.py::_int8_mm_kernel (pallas_call in
// int8_matmul).  Same association as the Pallas body: the band's per-row
// fp32 scales multiply the activation first, (x * s) in fp32, rounded to
// bf16 when the output is bf16, then the product with the raw int8 weight
// (exact in bf16 or fp32) accumulates in fp32.  Only the order of the sum
// over K differs.
//
// Bound on the H100: bytes.  Decode feeds M = 1..8 rows, so each weight
// byte is used by at most 8 rows (16 flops per byte, far under the ~295
// flops per byte where bf16 tensor cores would become the limit).  The
// least time is reading the int8 weight once.
//
// Design against that bound (one launch a call, deterministic).  bf16 with
// M >= 3 takes the tensor-core kernel below (int8_mm_tc_kernel); fp32, and
// bf16 at M <= 2 or at shapes it does not take, the CUDA-core kernel:
// - A CTA of 128 threads owns a 64-column tile and a run of K rows.  Four
//   lanes cover one K row of the tile with a 16-byte load each (64 bytes,
//   two full sectors), so a warp reads 8 rows and the CTA 32 rows at once;
//   each thread keeps 8 rows' loads in flight (256 rows a chunk), issued
//   at the chunk's start, before its activation is staged.
//   At M = 8 a thread holds 128 fp32 sums (about 220 registers), so two
//   CTAs fit an SM (256-thread CTAs, one an SM, were 15-50 % slower at the
//   head and at [512, 2048]; decode_variants.py).
// - The activation is pre-scaled once into shared memory (512 K rows at a
//   time: a CTA's whole K run at the decode shapes) as the fp32 value of
//   operand(x * s) (a tile lies in one band on the wide path).  The inner
//   loop is then, per weight byte, an exact int8 -> fp32 conversion (byte
//   permute into 2^23's mantissa and one subtract) and M FMAs from a
//   broadcast shared read.
// - K is split across the warps of the CTA: each thread's 16 columns x M
//   rows of partial sums are folded across the warp's 8 row groups by a
//   butterfly that halves the values each round (each lane ends with one
//   row's 16 columns), then summed across the 4 warps through shared
//   memory in warp order.
// - A grid with too few tiles to fill the card (the decode step's [512,
//   512], [512, 2048] and [2048, 512] weights) also splits K across the
//   CTAs of a thread block cluster (up to 8); the cluster's partial tiles
//   are added in rank order through distributed shared memory.  No
//   workspace, no second launch.
// - A band or Dout that is not a multiple of 16 columns, a tile that spans
//   several bands, or a payload that is not 16-byte aligned takes the
//   narrow path: 4-byte loads, and the scale applied per 4-column group.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 16;              // columns per lane: one 16-byte load
constexpr int LPR = 4;                // lanes per K row
constexpr int TN = LPR * COLS;        // 64 columns per CTA
constexpr int RS = THREADS / LPR;     // 32 K rows per CTA step
constexpr int ROWS = 8;               // K rows per thread per chunk
constexpr int KCH = RS * ROWS;        // 256 K rows per chunk
constexpr int ACH = 512;              // K rows of activation staged at once
static_assert(ACH % KCH == 0, "activation stages hold whole chunks");
constexpr int MAX_SPLITS = 8;         // portable cluster size
constexpr int MIN_K = 128;            // K rows a CTA keeps at least
// a warp's folded sums in shared memory: each 16-column group padded to
// 17 and each row to 68 floats, so that the 32 lanes of a store (8 rows x
// 4 groups) fall in 32 different banks
constexpr int GP = COLS + 1;
constexpr int RP = LPR * GP;
constexpr int SMS = 132;

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

// 16 int8 weights -> fp32, exactly: each byte biased to b + 128 (xor
// 0x80) sits in the low mantissa byte of 2^23, 0x4B0000xx == 2^23 + b + 128
__device__ __forceinline__ void i8x16_to_f32(const uint4& w, float (&f)[COLS]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = words[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) - 8388736.f;
  }
}

// Fold V partial sums across the 8 lanes that share a lane's columns
// (lane bits 4, 3, 2): each round a lane keeps one half, adds its
// partner's copy of that half and sends the other.  Lane l ends with
// v[0, V/8) = entries base(l) + i, base(l) = (l&16 ? V/2) + (l&8 ? V/4)
// + (l&4 ? V/8).  Each round's half is a template argument, so that every
// index is known at compile time and v stays in registers.
template <int HALF, int MASK, int V>
__device__ __forceinline__ void fold_round(float (&v)[V], int lane) {
  const bool up = lane & MASK;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}
template <int V>
__device__ __forceinline__ void warp_fold(float (&v)[V], int lane) {
  fold_round<V / 2, 16>(v, lane);
  fold_round<V / 4, 8>(v, lane);
  fold_round<V / 8, 4>(v, lane);
}

// one K row of the staged activation, as 16-byte words where MR allows
template <int MR>
__device__ __forceinline__ void store_row(float* dst, const float (&a)[MR]) {
  if constexpr (MR % 4 == 0) {
#pragma unroll
    for (int m = 0; m < MR; m += 4)
      *reinterpret_cast<float4*>(dst + m) =
          make_float4(a[m], a[m + 1], a[m + 2], a[m + 3]);
  } else {
#pragma unroll
    for (int m = 0; m < MR; ++m) dst[m] = a[m];
  }
}
template <int MR>
__device__ __forceinline__ void load_row(const float* src, float (&a)[MR]) {
  if constexpr (MR % 4 == 0) {
#pragma unroll
    for (int m = 0; m < MR; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + m);
      a[m] = v.x; a[m + 1] = v.y; a[m + 2] = v.z; a[m + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MR; ++m) a[m] = src[m];
  }
}

// the registers a thread of an MR-row tile needs (ptxas: about 220 at
// MR = 8), so that __launch_bounds__ asks for as many CTAs an SM as fit
constexpr int regs_for(int mr) { return mr >= 8 ? 232 : mr >= 4 ? 160 : 120; }

template <typename T, int MR, bool WIDE>
__global__ void __launch_bounds__(THREADS, 65536 / (THREADS * regs_for(MR)))
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, T* __restrict__ out, int M,
               int Din, int Dout, int cc, int k_per) {
  constexpr int V = MR * COLS;
  __shared__ __align__(16) float a_s[ACH][MR];  // staged activation
  __shared__ float red[WARPS][MR * RP];  // each warp's folded sums
  __shared__ float part[MR * TN];         // the CTA's sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid / LPR, c = tid % LPR;
  const int n0 = blockIdx.x * TN;
  const int n = n0 + c * COLS;           // this lane's first column
  const int m0 = blockIdx.y * MR;
  const int k_begin = blockIdx.z * k_per;
  const int k_end = min(Din, k_begin + k_per);
  const float* s_tile = s + (size_t)(n0 / cc) * Din;  // wide: one band

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  // one K row of this thread's 16 columns (zero past the K run)
  auto load_row_w = [&](int k) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (k >= k_end) return w;
    const int8_t* row = q + (size_t)k * Dout + n;
    if (WIDE) {
      if (n < Dout) w = __ldg(reinterpret_cast<const uint4*>(row));
    } else {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (n + 4 * g < Dout)
          wd[g] = __ldg(reinterpret_cast<const uint32_t*>(row + 4 * g));
      w = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    return w;
  };
  for (int kc = k_begin; kc < k_end; kc += KCH) {
    // the chunk's weights first: they need no activation
    uint4 wv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) wv[u] = load_row_w(kc + u * RS + rg);
    const int ka = k_begin + (kc - k_begin) / ACH * ACH;  // a_s's first row
    if (kc == ka) {
      // stage the next ACH rows of activation (all of a CTA's K run at
      // the decode shapes: one wait on x and s a CTA)
      if (kc != k_begin) __syncthreads();  // the last rows of a_s are read
      const int an = min(ACH, k_end - kc);
      for (int kk = tid; kk < an; kk += THREADS) {
        const int k = kc + kk;
        const float sk = WIDE ? __ldg(s_tile + k) : 1.f;
        float a[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          a[m] = m0 + m < M ? to_f<T>(x[(size_t)(m0 + m) * Din + k]) : 0.f;
          if (WIDE) a[m] = operand<T>(a[m] * sk);
        }
        store_row<MR>(a_s[kk], a);
      }
      __syncthreads();
    }
    const int kn = min(KCH, k_end - kc);
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int kk = u * RS + rg;
      if (kk >= kn) continue;
      float f[COLS];
      i8x16_to_f32(wv[u], f);
      float a[MR];
      load_row<MR>(a_s[kc - ka + kk], a);
      if (WIDE) {
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[m * COLS + j] = fmaf(a[m], f[j], acc[m * COLS + j]);
      } else {
        // the scale of each 4-column group's own band
        const int k = kc + kk;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int ng = min(n + 4 * g, Dout - 4);
          const float sk = __ldg(s + (size_t)(ng / cc) * Din + k);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float ag = operand<T>(a[m] * sk);
#pragma unroll
            for (int j = 4 * g; j < 4 * g + 4; ++j)
              acc[m * COLS + j] = fmaf(ag, f[j], acc[m * COLS + j]);
          }
        }
      }
    }
  }

  // the warp's 8 row groups, then the CTA's warps in order
  warp_fold<V>(acc, lane);
  const int base = ((lane & 16) ? V / 2 : 0) + ((lane & 8) ? V / 4 : 0) +
                   ((lane & 4) ? V / 8 : 0);
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const int e = base + i;
    red[warp][(e / COLS) * RP + c * GP + e % COLS] = acc[i];
  }
  __syncthreads();
  for (int o = tid; o < MR * TN; o += THREADS) {
    const int idx = (o / TN) * RP + (o % TN / COLS) * GP + o % COLS;
    float t = red[0][idx];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += red[w][idx];
    part[o] = t;
    const int m = m0 + o / TN, col = n0 + o % TN;
    if (gridDim.z == 1 && m < M && col < Dout)
      out[(size_t)m * Dout + col] = from_f<T>(t);
  }
  if (gridDim.z == 1) return;

  // K split over the cluster: rank r adds its slice of the tile over the
  // ranks' partial tiles in rank order
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int splits = gridDim.z;
  const int per = MR * TN / splits;
  const int r = (int)cl.block_rank();
  for (int o = r * per + tid; o < (r + 1) * per; o += THREADS) {
    float t = 0.f;
    for (int p = 0; p < splits; ++p) t += cl.map_shared_rank(part, p)[o];
    const int m = m0 + o / TN, col = n0 + o % TN;
    if (m < M && col < Dout) out[(size_t)m * Dout + col] = from_f<T>(t);
  }
  cl.sync();  // keep every rank's shared memory until all have read it
}

// ---- bf16 on the tensor cores ---------------------------------------------
//
// mma.sync.m16n8k16 with the weight as the 16-row operand (16 output
// columns x 16 K rows) and the activation's <= 8 rows as n = 8: the int8
// weight and the bf16 operand(x * s) are exact in bf16, so every product
// is the reference's; the mma sums them in fp32.  The weight comes in the
// fragment order (``tc_pack`` in ops/quant.py): each lane's 16-byte load
// is its A fragment for two consecutive 16-row K tiles of one 16-column
// n-tile, a warp's load 512 contiguous bytes.  A CTA of 4 warps owns 4
// n-tiles (64 columns); the warps take the K tile pairs in turn and add
// their accumulators in warp order through shared memory.

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_TILES = 4;             // 16-column n-tiles a CTA
constexpr int TC_KCH = 512;             // K rows a chunk (staged activation)
constexpr int TC_PAIRS = TC_KCH / 32;   // K tile pairs a chunk
constexpr int TC_ROW = TC_KCH / 2 + 4;  // words a staged row: conflict-free
// take the tensor-core kernel for bf16 where the weight is packed for it
// and M has at least TC_MIN_M rows (at M = 1 and 2 the CUDA-core kernel,
// with one or two FMAs a weight byte, is faster; decode_variants.py)
constexpr bool TC = true;
constexpr int TC_MIN_M = 3;

// fp32 values whose low 16 bits are 0 (small integers) -> one bf16x2 word
__device__ __forceinline__ uint32_t bf16x2_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(TC_THREADS)
int8_mm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint4* __restrict__ qp, const float* __restrict__ s,
                  __nv_bfloat16* __restrict__ out, int M, int Din, int Dout,
                  int cc, int k_per) {
  __shared__ uint32_t a_s[8][TC_ROW];                  // bf16 pairs along K
  __shared__ float red[TC_WARPS][TC_TILES * 16][9];    // n x m, padded
  __shared__ float part[TC_TILES * 16 * 8];            // the CTA's sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TC_TILES * 16;
  const int m0 = blockIdx.y * 8;
  const int k_begin = blockIdx.z * k_per;
  const int k_end = min(Din, k_begin + k_per);
  const int n_tiles = Dout / 16, pairs = Din / 32;
  const float* s_tile = s + (size_t)(n0 / cc) * Din;  // one band a tile

  float c[TC_TILES][4];
#pragma unroll
  for (int j = 0; j < TC_TILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += TC_KCH) {
    // this warp's K tile pairs of the chunk: every weight load first
    const int p0 = kc / 32, pn = min(TC_PAIRS, (k_end - kc) / 32);
    uint4 w[TC_PAIRS / TC_WARPS][TC_TILES];
#pragma unroll
    for (int i = 0; i < TC_PAIRS / TC_WARPS; ++i) {
      const int pr = warp + TC_WARPS * i;
#pragma unroll
      for (int j = 0; j < TC_TILES; ++j) {
        const int nt = n0 / 16 + j;
        w[i][j] = (pr < pn && nt < n_tiles)
                      ? __ldg(qp + ((size_t)nt * pairs + p0 + pr) * 32 + lane)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (kc != k_begin) __syncthreads();  // the last chunk's a_s is read
    for (int kp = tid; kp < pn * 16; kp += TC_THREADS) {
      const int k = kc + 2 * kp;
      const float s0 = __ldg(s_tile + k), s1 = __ldg(s_tile + k + 1);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float a0 = 0.f, a1 = 0.f;
        if (m0 + m < M) {
          const __nv_bfloat16* xr = x + (size_t)(m0 + m) * Din + k;
          a0 = __bfloat162float(__float2bfloat16(__bfloat162float(xr[0]) * s0));
          a1 = __bfloat162float(__float2bfloat16(__bfloat162float(xr[1]) * s1));
        }
        a_s[m][kp] = bf16x2_hi(a0, a1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TC_PAIRS / TC_WARPS; ++i) {
      const int pr = warp + TC_WARPS * i;
      if (pr >= pn) continue;
      // the activation's B fragments of the pair's two K tiles
      uint32_t b[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b[h][0] = a_s[g][pr * 16 + h * 8 + t];
        b[h][1] = a_s[g][pr * 16 + h * 8 + t + 4];
      }
#pragma unroll
      for (int j = 0; j < TC_TILES; ++j) {
        float f[COLS];
        i8x16_to_f32(w[i][j], f);
        uint32_t a[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = bf16x2_hi(f[2 * e], f[2 * e + 1]);
        mma_bf16(c[j], a, b[0][0], b[0][1]);
        mma_bf16(c[j], a + 4, b[1][0], b[1][1]);
      }
    }
  }

  // the warps' accumulators (n = 16 j + g (+8), m = 2 t (+1)) in warp order
#pragma unroll
  for (int j = 0; j < TC_TILES; ++j) {
    red[warp][16 * j + g][2 * t] = c[j][0];
    red[warp][16 * j + g][2 * t + 1] = c[j][1];
    red[warp][16 * j + g + 8][2 * t] = c[j][2];
    red[warp][16 * j + g + 8][2 * t + 1] = c[j][3];
  }
  __syncthreads();
  for (int o = tid; o < TC_TILES * 16 * 8; o += TC_THREADS) {
    const int nl = o / 8, m = o % 8;
    float acc = red[0][nl][m];
#pragma unroll
    for (int w2 = 1; w2 < TC_WARPS; ++w2) acc += red[w2][nl][m];
    part[o] = acc;
    if (gridDim.z == 1 && m0 + m < M && n0 + nl < Dout)
      out[(size_t)(m0 + m) * Dout + n0 + nl] = __float2bfloat16(acc);
  }
  if (gridDim.z == 1) return;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int splits = gridDim.z;
  const int per = TC_TILES * 16 * 8 / splits;
  const int r = (int)cl.block_rank();
  for (int o = r * per + tid; o < (r + 1) * per; o += TC_THREADS) {
    float acc = 0.f;
    for (int p = 0; p < splits; ++p) acc += cl.map_shared_rank(part, p)[o];
    const int nl = o / 8, m = o % 8;
    if (m0 + m < M && n0 + nl < Dout)
      out[(size_t)(m0 + m) * Dout + n0 + nl] = __float2bfloat16(acc);
  }
  cl.sync();  // keep every rank's shared memory until all have read it
}

// The K split over a thread block cluster: doubled while the grid stays
// within 2 x 132 CTAs and each CTA keeps at least MIN_K rows.  -> splits;
// the K rows a CTA, rounded up to a multiple of ``align``, in k_per.
int k_splits(int tiles, int Din, int align, int* k_per) {
  int splits = 1;
  while (splits < MAX_SPLITS && tiles * splits * 2 <= 2 * SMS &&
         Din >= splits * 2 * MIN_K)
    splits *= 2;
  const int rows = (Din + splits - 1) / splits;
  *k_per = (rows + align - 1) / align * align;
  return splits;
}

template <typename... P, typename... A>
cudaError_t cluster_launch(void (*kernel)(P...), dim3 grid, int threads,
                           cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;  // the K split: one cluster a tile
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int MR>
cudaError_t launch_mr(bool wide, const void* x, const void* q, const void* s,
                      void* out, int M, int Din, int Dout, int cc,
                      cudaStream_t st) {
  int k_per;
  const int splits = k_splits(((Dout + TN - 1) / TN) * ((M + MR - 1) / MR),
                              Din, RS, &k_per);
  const dim3 grid((Dout + TN - 1) / TN, (M + MR - 1) / MR, splits);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  T* op = static_cast<T*>(out);
  return wide ? cluster_launch(int8_mm_kernel<T, MR, true>, grid, THREADS, st,
                               xp, qp, sp, op, M, Din, Dout, cc, k_per)
              : cluster_launch(int8_mm_kernel<T, MR, false>, grid, THREADS,
                               st, xp, qp, sp, op, M, Din, Dout, cc, k_per);
}

template <typename T>
int launch(const void* x, const void* q, const void* s, void* out, int M,
           int Din, int Dout, int cc, cudaStream_t st) {
  // wide: 16-byte loads, and every 64-column tile within one band
  const bool wide = Dout % COLS == 0 && (cc == Dout || cc % TN == 0) &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (M <= 1) return (int)launch_mr<T, 1>(wide, x, q, s, out, M, Din, Dout, cc, st);
  if (M <= 2) return (int)launch_mr<T, 2>(wide, x, q, s, out, M, Din, Dout, cc, st);
  if (M <= 4) return (int)launch_mr<T, 4>(wide, x, q, s, out, M, Din, Dout, cc, st);
  return (int)launch_mr<T, 8>(wide, x, q, s, out, M, Din, Dout, cc, st);
}

int launch_tc(const void* x, const void* qp, const void* s, void* out, int M,
              int Din, int Dout, int cc, cudaStream_t st) {
  const int cols = TC_TILES * 16;
  int k_per;
  const int splits = k_splits(((Dout + cols - 1) / cols) * ((M + 7) / 8), Din,
                              32, &k_per);
  return (int)cluster_launch(
      int8_mm_tc_kernel, dim3((Dout + cols - 1) / cols, (M + 7) / 8, splits),
      TC_THREADS, st, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint4*>(qp), static_cast<const float*>(s),
      static_cast<__nv_bfloat16*>(out), M, Din, Dout, cc, k_per);
}

}  // namespace

// Whether int8_matmul takes the tensor-core kernel for a bf16 weight of
// [Din, Dout] in bands of cc columns, given its packed payload: K in whole
// pairs of 16-row tiles, whole 16-column n-tiles, each 64-column tile in
// one band.
extern "C" int int8_matmul_tc_shape(int Din, int Dout, int cc) {
  return TC && Din % 32 == 0 && Dout % 16 == 0 && (cc == Dout || cc % 64 == 0);
}

// dtype: 0 = float32, 1 = bfloat16 (x and out share it).  q is [Din, Dout]
// int8 row-major (4-byte aligned, Dout and cc multiples of 4), s is
// [bands, Din] fp32 with band = column / cc.  qp, where not null, is the
// same weight packed in the tensor cores' fragment order (16-byte aligned;
// bf16 only, for a shape int8_matmul_tc_shape takes).
extern "C" int int8_matmul(int dtype, const void* x, const void* q,
                           const void* qp, const void* s, void* out, int M,
                           int Din, int Dout, int cc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, q, s, out, M, Din, Dout, cc, st);
  if (qp != nullptr && M >= TC_MIN_M &&
      int8_matmul_tc_shape(Din, Dout, cc) &&
      reinterpret_cast<uintptr_t>(qp) % 16 == 0)
    return launch_tc(x, qp, s, out, M, Din, Dout, cc, st);
  return launch<__nv_bfloat16>(x, q, s, out, M, Din, Dout, cc, st);
}

// The MoE layer's expert products as a grouped GEMM over the sorted
// (token, choice) pairs, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no Pallas kernel: the reference's expert products are einsums
// over padded (E, C+1, D) buffers (src/repro/models/moe.py, moe_ffn) left
// to XLA.  It was added because at serving's drop-free capacity C = T·k
// those buffers hold E times the rows that exist (64 at deepseek-moe-16b),
// and their fill, scatter and products took nearly all of an admission.
//
// Computes, for the P = T·k pairs in the stable sort of their expert ids
// (``order``; pair j is token j / k's choice j % k) and each expert e's
// run bounds[e] .. bounds[e + 1] of that order:
//     h[j]          = silu(x W_g[e]) · (x W_u[e])     x = tokens[order[j] / k]
//     out[order[j]] = h[j] W_d[e]
// with W_g, W_u (E, D, F) and W_d (E, F, D) row-major.  h (P, F) is kept
// in sorted order in the working dtype; out (P, D) is in pair order.
//
// Bound: at an admission (36,864 pairs at deepseek-moe-16b's D 2048, F
// 1408) by operations (0.64 TFLOP a layer against 1.1 GB of weights:
// 0.65 ms at 989 TFLOP/s); at a decode step (288 pairs) by bytes (the
// weights of the experts routed to, read once: 0.33 ms at 3.35 TB/s).
//
// Design.  The pairs are cut into tiles of BM rows of one expert's run
// (an expert's last tile is ragged and masked).  The schedule comes from
// the wrapper, built on the device with no host sync: tile i's expert
// (E past the last real tile) and each expert's cumulative tile count;
// the grid is the host-known bound ceil(P / BM) + E tiles, each tile's
// column blocks next to each other so that they share its A rows and its
// expert's weights in L2, and blocks past the real tiles exit at once.
// A block stages its rows' sources once (the token of each pair for
// gate/up, the pair's own index for down), then runs a ring of cp.async
// copies (16 bytes a thread, zeros past a ragged edge) of a slice of A
// (gathered rows: no copy of the tokens is made) and of the weights.
// gate/up keeps two accumulators over the same A and writes h =
// silu(g)·u once; down stores each row at its pair's own index, and every
// row is unique, so there are no atomics and no padded buffer, fill or
// scatter.  BM follows the capacity an expert (16 rows at a decode step,
// 128 at an admission); the rest of the tile is fixed per BM at compile
// time, and the depth is summed in one fixed order.  A row is computed
// from its own A row and its expert's weights alone, so its bits depend
// neither on its companions nor on its place in a tile.
//
// At 128 rows (an admission, bound by operations): wgmma, two
// warpgroups of 64 rows, 64-deep slices under the 128-byte swizzle (A
// K-major, the weights MN-major as they lie), gate/up 128 columns of each
// of W_g and W_u, down 256; a ring of 4 slices with one slice's products
// left in flight while the next is issued; ~200 registers a thread, one
// block an SM.  At 16 to 64 rows (a decode step, bound by the weights'
// bytes): mma.sync m16n8k16 fed by ldmatrix from 32-deep slices, rows
// padded by 8 elements (free of bank conflicts), 4 warps in a row at 16
// and 32 rows with rings of 6 and 5, so that many weight bytes are in
// flight.  Measured (PERF.md): 0.41 of the operations bound at an
// admission, 0.7 of the bytes bound at a decode step.
//
// fp32: the same schedule with fp32 FMA on the CUDA cores (IEEE fp32, no
// TF32), BM up to 64; serving is bf16.
//
// moe_grouped_launch launches both kernels and returns cudaGetLastError()
// after them, so a refused launch reaches the Python wrapper, which raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;            // depth of a staged slice
constexpr int kPitchA = kBK + 8;   // 80-byte A rows: ldmatrix free of bank conflicts

__device__ __forceinline__ float silu_glu(float g, float u) { return g / (1.f + expf(-g)) * u; }

// Tile `tile`'s expert e, first sorted row and the end of e's run; false
// past the last real tile.
__device__ __forceinline__ bool find_tile(const int64_t* expert, const int64_t* ends,
                                          const int64_t* bounds, int tile, int E, int BM,
                                          int& e, int64_t& row0, int64_t& hi) {
  const int64_t ex = expert[tile];
  if (ex >= E) return false;
  e = (int)ex;
  const int64_t lo = bounds[e];
  hi = bounds[e + 1];
  row0 = lo + (tile - (ends[e] - (hi - lo + BM - 1) / BM)) * BM;
  return true;
}

// Each tile row's A row (-1: none) and output row: for gate/up the pair's
// token and its sorted index, for down its sorted index and the pair.
template <int BM, bool kGateUp>
__device__ __forceinline__ void stage_rows(int64_t* src, int64_t* dst, const int64_t* order,
                                           int64_t row0, int64_t hi, int k, int tid,
                                           int threads) {
  for (int r = tid; r < BM; r += threads) {
    const int64_t j = row0 + r;
    if (j < hi) {
      const int64_t pair = order[j];
      src[r] = kGateUp ? pair / k : j;
      dst[r] = kGateUp ? j : pair;
    } else {
      src[r] = dst[r] = -1;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at 16 to 64 rows: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and r[m] holds matrix m's (row l / 4, columns 2 (l % 4),
// +1), or with .trans its (rows 2 (l % 4), +1, column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16 x 8, fp32) += a (16 x 16, row major) b (16 x 8, column major).
// Lane l = 4g + t holds a's rows g and g + 8 at columns 2t, 2t + 1 and
// 2t + 8, 2t + 9, b's rows 2t, 2t + 1 and 2t + 8, 2t + 9 at column g, and
// d's rows g and g + 8 at columns 2t, 2t + 1.
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without registers; zeros if !full (nothing read)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The tile shape of one kernel: BM rows x BN columns of the output (of
// each of W_g and W_u for gate/up), WM x WN warps, each owning a (BM /
// WM) x (BN / WN) block of the output, STAGES slices in flight.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_, bool kGateUp_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr bool kGateUp = kGateUp_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kMats = kGateUp ? 2 : 1;
  static constexpr int kPitchB = BN + 8;  // (BN + 8) * 2 bytes = 4 words mod 32: no conflicts
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int kStageA = BM * kPitchA, kStageB = kBK * kPitchB;
  static constexpr int kStage = kStageA + kMats * kStageB;  // elements
  static constexpr size_t kSmemBytes = (size_t)STAGES * kStage * sizeof(bf16);
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0 && BM % (16 * WM) == 0, "tile");
};

// The gate/up (kGateUp) or down product of one tile of BM sorted pairs and
// BN columns: block (tile, column block) = (blockIdx.x / n_cols,
// blockIdx.x % n_cols).  gate/up: A rows tokens[order[j] / k] (K = D),
// W_g and W_u (N = F), h[j] = silu(g)·u.  down: A rows h[j] (K = F), W_d
// (N = D), out[order[j]].
template <class Tl>
__device__ __forceinline__ void mma_body(const bf16* __restrict__ a,
                                         const int64_t* __restrict__ order,
                                         const int64_t* __restrict__ bounds,
                                         const int64_t* __restrict__ expert,
                                         const int64_t* __restrict__ ends,
                                         const bf16* __restrict__ w0,
                                         const bf16* __restrict__ w1, bf16* __restrict__ out,
                                         int E, int K, int N, int k, int n_cols) {
  constexpr int BM = Tl::BM, BN = Tl::BN, MT = Tl::MT, NT = Tl::NT, STAGES = Tl::STAGES;
  constexpr int kThreads = Tl::kThreads, kPitchB = Tl::kPitchB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int64_t s_src[BM], s_dst[BM];

  const int tile = blockIdx.x / n_cols;
  const int col0 = (blockIdx.x % n_cols) * BN;
  int e;
  int64_t row0, hi;
  if (!find_tile(expert, ends, bounds, tile, E, BM, e, row0, hi)) return;
  const int tid = threadIdx.x;
  stage_rows<BM, Tl::kGateUp>(s_src, s_dst, order, row0, hi, k, tid, kThreads);
  __syncthreads();

  const bf16* wb0 = w0 + (int64_t)e * K * N;
  const bf16* wb1 = Tl::kGateUp ? w1 + (int64_t)e * K * N : wb0;
  const int n_k = (K + kBK - 1) / kBK;

  auto load = [&](int stage, int kt) {
    bf16* sA = smem + stage * Tl::kStage;
    bf16* sB = sA + Tl::kStageA;
    const int k0 = kt * kBK;
    constexpr int kChunksA = BM * (kBK / 8);
#pragma unroll
    for (int c0 = 0; c0 < kChunksA; c0 += kThreads) {
      const int c = c0 + tid;
      if (kChunksA % kThreads == 0 || c < kChunksA) {
        const int r = c / (kBK / 8), kk = k0 + c % (kBK / 8) * 8;
        const int64_t src = s_src[r];
        const bool full = src >= 0 && kk < K;
        cp_async16(sA + r * kPitchA + c % (kBK / 8) * 8, full ? a + src * K + kk : a, full);
      }
    }
    constexpr int kChunksB = kBK * (BN / 8);
#pragma unroll
    for (int c0 = 0; c0 < kChunksB; c0 += kThreads) {
      const int c = c0 + tid;
      if (kChunksB % kThreads == 0 || c < kChunksB) {
        const int r = c / (BN / 8), n = col0 + c % (BN / 8) * 8;
        const bool full = k0 + r < K && n < N;
        const int64_t off = (int64_t)(k0 + r) * N + n;
        bf16* d = sB + r * kPitchB + c % (BN / 8) * 8;
        cp_async16(d, full ? wb0 + off : wb0, full);
        if constexpr (Tl::kGateUp) cp_async16(d + Tl::kStageB, full ? wb1 + off : wb1, full);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  float acc[Tl::kMats][MT][NT][4];
#pragma unroll
  for (int m = 0; m < Tl::kMats; ++m)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[m][i][j][0] = acc[m][i][j][1] = acc[m][i][j][2] = acc[m][i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  // this lane's ldmatrix offsets: A rows (lane % 16) at column 8 (lane /
  // 16); B (.trans) depth rows lane % 8 + 8 ((lane / 8) % 2) at column 8
  // (lane / 16)
  const int a_off = (wm * (BM / Tl::WM) + (lane & 15)) * kPitchA + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitchB + wn * (BN / Tl::WN) +
                    (lane >> 4) * 8;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt has landed; slice kt - 1's buffer is free
    if (kt + STAGES - 1 < n_k) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const bf16* sA = smem + (kt % STAGES) * Tl::kStage;
    const bf16* sB = sA + Tl::kStageA;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldsm_x4(af[i], sA + a_off + i * 16 * kPitchA + ks * 16);
#pragma unroll
      for (int m = 0; m < Tl::kMats; ++m) {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t bq[4];
          ldsm_x4_t(bq, sB + m * Tl::kStageB + b_off + ks * 16 * kPitchB + jp * 16);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma(acc[m][i][2 * jp], af[i], bq[0], bq[1]);
            mma(acc[m][i][2 * jp + 1], af[i], bq[2], bq[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t dst = s_dst[wm * (BM / Tl::WM) + i * 16 + g + 8 * half];
      if (dst < 0) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = col0 + wn * (BN / Tl::WN) + j * 8 + 2 * t;
        if (n >= N) continue;
        float v0 = acc[0][i][j][2 * half], v1 = acc[0][i][j][2 * half + 1];
        if constexpr (Tl::kGateUp) {
          v0 = silu_glu(v0, acc[Tl::kMats - 1][i][j][2 * half]);
          v1 = silu_glu(v1, acc[Tl::kMats - 1][i][j][2 * half + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + dst * N + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN)
moe_gate_up_kernel(const bf16* __restrict__ x, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ bounds, const int64_t* __restrict__ expert,
                   const int64_t* __restrict__ ends, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu, bf16* __restrict__ h, int E, int D, int F,
                   int k, int n_cols) {
  mma_body<MmaTile<BM, BN, WM, WN, STAGES, true>>(x, order, bounds, expert, ends, wg, wu, h,
                                                  E, D, F, k, n_cols);
}

template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN)
moe_down_kernel(const bf16* __restrict__ h, const int64_t* __restrict__ order,
                const int64_t* __restrict__ bounds, const int64_t* __restrict__ expert,
                const int64_t* __restrict__ ends, const bf16* __restrict__ wd,
                bf16* __restrict__ out, int E, int D, int F, int k, int n_cols) {
  mma_body<MmaTile<BM, BN, WM, WN, STAGES, false>>(h, order, bounds, expert, ends, wd, wd,
                                                   out, E, F, D, k, n_cols);
}

template <class Tl, class Kernel>
cudaError_t launch_mma(Kernel kernel, int tiles, int N, cudaStream_t st,
                       const bf16* a, const int64_t* order, const int64_t* bounds,
                       const int64_t* expert, const int64_t* ends, const bf16* w0,
                       const bf16* w1, bf16* out, int E, int D, int F, int k) {
  static bool granted = false;  // one grant per instance
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmemBytes);
    if (e != cudaSuccess) return e;
    granted = true;
  }
  const int n_cols = (N + Tl::BN - 1) / Tl::BN;
  if constexpr (Tl::kGateUp) {
    kernel<<<tiles * n_cols, Tl::kThreads, Tl::kSmemBytes, st>>>(
        a, order, bounds, expert, ends, w0, w1, out, E, D, F, k, n_cols);
  } else {
    kernel<<<tiles * n_cols, Tl::kThreads, Tl::kSmemBytes, st>>>(
        a, order, bounds, expert, ends, w0, out, E, D, F, k, n_cols);
  }
  return cudaGetLastError();
}

// The two kernels of one BM: gate/up (BN columns of each of W_g and W_u)
// then down.
template <class Up, class Down>
cudaError_t launch_bf16(const bf16* x, const int64_t* order, const int64_t* bounds,
                        const int64_t* expert, const int64_t* ends, const bf16* wg,
                        const bf16* wu, const bf16* wd, bf16* h, bf16* out, int E, int D,
                        int F, int k, int tiles, cudaStream_t st) {
  static_assert(Up::BM == Down::BM && Up::kGateUp && !Down::kGateUp, "pair");
  cudaError_t e = launch_mma<Up>(moe_gate_up_kernel<Up::BM, Up::BN, Up::WM, Up::WN, Up::STAGES>,
                                 tiles, F, st, x, order, bounds, expert, ends, wg, wu, h, E, D,
                                 F, k);
  if (e != cudaSuccess) return e;
  return launch_mma<Down>(
      moe_down_kernel<Down::BM, Down::BN, Down::WM, Down::WN, Down::STAGES>, tiles, D, st, h,
      order, bounds, expert, ends, wd, wd, out, E, D, F, k);
}

// ---------------------------------------------------------------------------
// bf16 at 128 rows: wgmma on the tensor cores
// ---------------------------------------------------------------------------

// wgmma matrix descriptor: start address, leading and stride byte offsets
// (16-byte units), layout type (1: 128B swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swz << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's product groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pins registers across the asynchronous product: nothing reads or writes
// them between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32) += A B, A (64 x 16) bf16 K-major and B (16 x N) bf16
// MN-major (N contiguous) in shared memory under the 128-byte swizzle,
// each named by a descriptor.  Accumulator: warp w of the warpgroup holds
// rows 16w..16w+15; with g = lane / 4, t = lane % 4, d[4j + e] is row 16w
// + g + 8 (e / 2), column 8j + 2t + (e % 2).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63},"
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "
      "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// The tile of the 128-row kernels: two warpgroups of 64 rows each, BK =
// 64 deep, gate/up 128 columns of each of W_g and W_u, down 256 of W_d.
// Under the 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8)),
// 1024-byte aligned: A as 128 rows of 128 bytes (K-major), B in 64-column
// chunks of 64 rows x 128 bytes (MN-major).
template <bool kGateUp_>
struct WgTile {
  static constexpr bool kGateUp = kGateUp_;
  static constexpr int BM = 128, BK = 64, STAGES = 4, kThreads = 256;
  static constexpr int BN = kGateUp ? 128 : 256;
  static constexpr int kMats = kGateUp ? 2 : 1;
  static constexpr int kChunk = BK * 128;  // bytes of one 64-column chunk of B
  static constexpr int kStageA = BM * 128;
  static constexpr int kStage = kStageA + kMats * (BN / 64) * kChunk;
  static constexpr size_t kSmemBytes = (size_t)STAGES * kStage + 1024;  // + alignment
  static_assert(kStageA % 1024 == 0 && kStage % 1024 == 0, "chunks 1024-aligned");
};

// As mma_body, at 128 rows with wgmma: the same products, schedule and
// epilogue.
template <class Tl>
__device__ __forceinline__ void wg_body(const bf16* __restrict__ a,
                                        const int64_t* __restrict__ order,
                                        const int64_t* __restrict__ bounds,
                                        const int64_t* __restrict__ expert,
                                        const int64_t* __restrict__ ends,
                                        const bf16* __restrict__ w0,
                                        const bf16* __restrict__ w1, bf16* __restrict__ out,
                                        int E, int K, int N, int k, int n_cols) {
  constexpr int BM = Tl::BM, BN = Tl::BN, BK = Tl::BK, STAGES = Tl::STAGES;
  constexpr int kThreads = Tl::kThreads, kMats = Tl::kMats;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int64_t s_src[BM], s_dst[BM];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);

  const int tile = blockIdx.x / n_cols;
  const int col0 = (blockIdx.x % n_cols) * BN;
  int e;
  int64_t row0, hi;
  if (!find_tile(expert, ends, bounds, tile, E, BM, e, row0, hi)) return;
  const int tid = threadIdx.x;
  stage_rows<BM, Tl::kGateUp>(s_src, s_dst, order, row0, hi, k, tid, kThreads);
  __syncthreads();

  const bf16* wb[2] = {w0 + (int64_t)e * K * N, (Tl::kGateUp ? w1 : w0) + (int64_t)e * K * N};
  const int n_k = (K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    unsigned char* sA = smem + stage * Tl::kStage;
    unsigned char* sB = sA + Tl::kStageA;
    const int k0 = kt * BK;
    constexpr int kChunksA = BM * (BK / 8);
#pragma unroll
    for (int c0 = 0; c0 < kChunksA; c0 += kThreads) {
      const int c = c0 + tid, r = c / (BK / 8), u = c % (BK / 8);
      const int64_t src = s_src[r];
      const bool full = src >= 0 && k0 + u * 8 < K;
      cp_async16(reinterpret_cast<bf16*>(sA + r * 128 + ((u ^ (r & 7)) << 4)),
                 full ? a + src * K + k0 + u * 8 : a, full);
    }
    constexpr int kUnitsB = (BN / 64) * BK * 8;  // 16-byte units of one matrix
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
#pragma unroll
      for (int c0 = 0; c0 < kUnitsB; c0 += kThreads) {
        const int c = c0 + tid, cc = c / (BK * 8), r = c / 8 % BK, u = c % 8;
        const int n = col0 + cc * 64 + u * 8;
        const bool full = k0 + r < K && n < N;
        unsigned char* d = sB + (m * (BN / 64) + cc) * Tl::kChunk + r * 128 + ((u ^ (r & 7)) << 4);
        cp_async16(reinterpret_cast<bf16*>(d),
                   full ? wb[m] + (int64_t)(k0 + r) * N + n : wb[m], full);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wgr = warp / 4, w = warp % 4;  // warpgroup (64 rows) and its warp (16 rows)
  float acc[kMats][BN / 2];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;

  // The ring runs kAhead = STAGES - 2 slices ahead, so that one slice's
  // products stay in flight while the next is issued: the buffer a load
  // refills was read by the products of two slices back, which have
  // finished (each warpgroup waits for all but its latest group, and the
  // barrier follows that wait).
  constexpr int kAhead = STAGES - 2;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kAhead - 1>();
    // what this thread's copies wrote, made visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // slice kt has landed; slice kt - 2's products are done
    if (kt + kAhead < n_k) load((kt + kAhead) % STAGES, kt + kAhead);
    cp_async_commit();
    const uint32_t sA = base + (kt % STAGES) * Tl::kStage + wgr * 64 * 128;
    const uint32_t sB = base + (kt % STAGES) * Tl::kStage + Tl::kStageA;
#pragma unroll
    for (int m = 0; m < kMats; ++m) fence_regs(acc[m]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
      for (int m = 0; m < kMats; ++m)
        wgmma_ss<BN>(acc[m], desc(sA + ks * 32, 16, 1024, 1),
                     desc(sB + m * (BN / 64) * Tl::kChunk + ks * 16 * 128, Tl::kChunk, 1024, 1));
    }
    wg_commit();
#pragma unroll
    for (int m = 0; m < kMats; ++m) fence_regs(acc[m]);
    wg_wait<1>();
  }
  wg_wait<0>();
#pragma unroll
  for (int m = 0; m < kMats; ++m) fence_regs(acc[m]);
  cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t dst = s_dst[wgr * 64 + w * 16 + g + 8 * half];
    if (dst < 0) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = col0 + j * 8 + 2 * t;
      if (n >= N) continue;
      float v0 = acc[0][4 * j + 2 * half], v1 = acc[0][4 * j + 2 * half + 1];
      if constexpr (Tl::kGateUp) {
        v0 = silu_glu(v0, acc[kMats - 1][4 * j + 2 * half]);
        v1 = silu_glu(v1, acc[kMats - 1][4 * j + 2 * half + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + dst * N + n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

using WgUp = WgTile<true>;
using WgDown = WgTile<false>;

__global__ void __launch_bounds__(256)
moe_gate_up_wgmma_kernel(const bf16* __restrict__ x, const int64_t* __restrict__ order,
                         const int64_t* __restrict__ bounds, const int64_t* __restrict__ expert,
                         const int64_t* __restrict__ ends, const bf16* __restrict__ wg,
                         const bf16* __restrict__ wu, bf16* __restrict__ h, int E, int D, int F,
                         int k, int n_cols) {
  wg_body<WgUp>(x, order, bounds, expert, ends, wg, wu, h, E, D, F, k, n_cols);
}

__global__ void __launch_bounds__(256)
moe_down_wgmma_kernel(const bf16* __restrict__ h, const int64_t* __restrict__ order,
                      const int64_t* __restrict__ bounds, const int64_t* __restrict__ expert,
                      const int64_t* __restrict__ ends, const bf16* __restrict__ wd,
                      bf16* __restrict__ out, int E, int D, int F, int k, int n_cols) {
  wg_body<WgDown>(h, order, bounds, expert, ends, wd, wd, out, E, F, D, k, n_cols);
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // 16 x 16: thread (ty, tx) owns rows ty + 16 i, columns 4 tx..+3
constexpr int kFmaBN = 64, kFmaBK = 16;

template <int BM, bool kGateUp>
__device__ __forceinline__ void fma_body(const float* __restrict__ a,
                                         const int64_t* __restrict__ order,
                                         const int64_t* __restrict__ bounds,
                                         const int64_t* __restrict__ expert,
                                         const int64_t* __restrict__ ends,
                                         const float* __restrict__ w0,
                                         const float* __restrict__ w1, float* __restrict__ out,
                                         int E, int K, int N, int k, int n_cols) {
  constexpr int kMats = kGateUp ? 2 : 1, RM = BM / 16;
  __shared__ float sA[kFmaBK][BM];
  __shared__ __align__(16) float sB[kMats][kFmaBK][kFmaBN];
  __shared__ int64_t s_src[BM], s_dst[BM];

  const int tile = blockIdx.x / n_cols;
  const int col0 = (blockIdx.x % n_cols) * kFmaBN;
  int e;
  int64_t row0, hi;
  if (!find_tile(expert, ends, bounds, tile, E, BM, e, row0, hi)) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  stage_rows<BM, kGateUp>(s_src, s_dst, order, row0, hi, k, tid, kFmaThreads);
  __syncthreads();
  const float* wb[2] = {w0 + (int64_t)e * K * N, (kGateUp ? w1 : w0) + (int64_t)e * K * N};

  float acc[kMats][RM][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
    for (int c = tid; c < BM * kFmaBK; c += kFmaThreads) {
      const int r = c / kFmaBK, kk = c % kFmaBK;
      const int64_t src = s_src[r];
      sA[kk][r] = src >= 0 && k0 + kk < K ? a[src * K + k0 + kk] : 0.f;
    }
    for (int c = tid; c < kFmaBK * kFmaBN; c += kFmaThreads) {
      const int r = c / kFmaBN, n = col0 + c % kFmaBN;
      const bool in = k0 + r < K && n < N;
#pragma unroll
      for (int m = 0; m < kMats; ++m)
        sB[m][r][c % kFmaBN] = in ? wb[m][(int64_t)(k0 + r) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float4 b = *reinterpret_cast<const float4*>(&sB[m][kk][4 * tx]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = sA[kk][ty + 16 * i];
          acc[m][i][0] = fmaf(av, b.x, acc[m][i][0]);
          acc[m][i][1] = fmaf(av, b.y, acc[m][i][1]);
          acc[m][i][2] = fmaf(av, b.z, acc[m][i][2]);
          acc[m][i][3] = fmaf(av, b.w, acc[m][i][3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t dst = s_dst[ty + 16 * i];
    if (dst < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + 4 * tx + j;
      if (n < N)
        out[dst * N + n] = kGateUp ? silu_glu(acc[0][i][j], acc[kMats - 1][i][j]) : acc[0][i][j];
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(kFmaThreads)
moe_gate_up_fma_kernel(const float* __restrict__ x, const int64_t* __restrict__ order,
                       const int64_t* __restrict__ bounds, const int64_t* __restrict__ expert,
                       const int64_t* __restrict__ ends, const float* __restrict__ wg,
                       const float* __restrict__ wu, float* __restrict__ h, int E, int D, int F,
                       int k, int n_cols) {
  fma_body<BM, true>(x, order, bounds, expert, ends, wg, wu, h, E, D, F, k, n_cols);
}

template <int BM>
__global__ void __launch_bounds__(kFmaThreads)
moe_down_fma_kernel(const float* __restrict__ h, const int64_t* __restrict__ order,
                    const int64_t* __restrict__ bounds, const int64_t* __restrict__ expert,
                    const int64_t* __restrict__ ends, const float* __restrict__ wd,
                    float* __restrict__ out, int E, int D, int F, int k, int n_cols) {
  fma_body<BM, false>(h, order, bounds, expert, ends, wd, wd, out, E, F, D, k, n_cols);
}

template <int BM>
cudaError_t launch_fp32(const float* x, const int64_t* order, const int64_t* bounds,
                        const int64_t* expert, const int64_t* ends, const float* wg,
                        const float* wu, const float* wd, float* h, float* out, int E, int D,
                        int F, int k, int tiles, cudaStream_t st) {
  int n_cols = (F + kFmaBN - 1) / kFmaBN;
  moe_gate_up_fma_kernel<BM><<<tiles * n_cols, kFmaThreads, 0, st>>>(
      x, order, bounds, expert, ends, wg, wu, h, E, D, F, k, n_cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  n_cols = (D + kFmaBN - 1) / kFmaBN;
  moe_down_fma_kernel<BM><<<tiles * n_cols, kFmaThreads, 0, st>>>(
      h, order, bounds, expert, ends, wd, out, E, D, F, k, n_cols);
  return cudaGetLastError();
}

// mma.sync tiles by BM: gate/up then down, each <BM, BN, WM, WN, STAGES>.
// 64: 8 warps on 64 x 128; 16 and 32 (decode): 4 warps in a row on 64 and
// 128 columns, deeper rings for the weight reads that bound them.
using Up64 = MmaTile<64, 128, 2, 4, 4, true>;
using Down64 = MmaTile<64, 128, 2, 4, 4, false>;
using Up32 = MmaTile<32, 64, 1, 4, 5, true>;
using Down32 = MmaTile<32, 128, 1, 4, 5, false>;
using Up16 = MmaTile<16, 64, 1, 4, 6, true>;
using Down16 = MmaTile<16, 128, 1, 4, 6, false>;

}  // namespace

// tokens (T, D), the stacks W_g, W_u (E, D, F) and W_d (E, F, D) in one
// dtype (0 = float32, 1 = bfloat16), h (P, F) and out (P, D) in it, all
// contiguous; order (P,), bounds (E + 1,), expert (tiles,) and ends (E,)
// int64.  block_m is 16, 32, 64 or 128 (at most 64 in fp32); in bf16 D
// and F are multiples of 8.  Returns a cudaError_t (0 = launched).
extern "C" int moe_grouped_launch(const void* tokens, const void* order, const void* bounds,
                                  const void* expert, const void* ends, const void* w_gate,
                                  const void* w_up, const void* w_down, void* h, void* out,
                                  int E, int D, int F, int k, int tiles, int block_m,
                                  int dtype, void* stream) {
  if (E <= 0 || D <= 0 || F <= 0 || k <= 0 || tiles <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t* o = (const int64_t*)order;
  const int64_t* b = (const int64_t*)bounds;
  const int64_t* ex = (const int64_t*)expert;
  const int64_t* en = (const int64_t*)ends;
  if (dtype == 0) {
    const float *x = (const float*)tokens, *wg = (const float*)w_gate,
                *wu = (const float*)w_up, *wd = (const float*)w_down;
    float *hf = (float*)h, *y = (float*)out;
    switch (block_m) {
      case 16: return (int)launch_fp32<16>(x, o, b, ex, en, wg, wu, wd, hf, y, E, D, F, k, tiles, st);
      case 32: return (int)launch_fp32<32>(x, o, b, ex, en, wg, wu, wd, hf, y, E, D, F, k, tiles, st);
      case 64: return (int)launch_fp32<64>(x, o, b, ex, en, wg, wu, wd, hf, y, E, D, F, k, tiles, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  const bf16 *x = (const bf16*)tokens, *wg = (const bf16*)w_gate, *wu = (const bf16*)w_up,
             *wd = (const bf16*)w_down;
  bf16 *hb = (bf16*)h, *y = (bf16*)out;
  switch (block_m) {
    case 16: return (int)launch_bf16<Up16, Down16>(x, o, b, ex, en, wg, wu, wd, hb, y, E, D, F, k, tiles, st);
    case 32: return (int)launch_bf16<Up32, Down32>(x, o, b, ex, en, wg, wu, wd, hb, y, E, D, F, k, tiles, st);
    case 64: return (int)launch_bf16<Up64, Down64>(x, o, b, ex, en, wg, wu, wd, hb, y, E, D, F, k, tiles, st);
    case 128: {
      const cudaError_t e = launch_mma<WgUp>(moe_gate_up_wgmma_kernel, tiles, F, st, x, o, b,
                                                     ex, en, wg, wu, hb, E, D, F, k);
      if (e != cudaSuccess) return (int)e;
      return (int)launch_mma<WgDown>(moe_down_wgmma_kernel, tiles, D, st, hb, o, b, ex, en,
                                            wd, wd, y, E, D, F, k);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

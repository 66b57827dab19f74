// RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm, the Pallas TPU kernel
// behind src/repro/kernels/ops.py::rmsnorm_op.
//
// Computes, for each row r of x (M, D):
//     y = x * rsqrt(mean(x^2) + eps) * (1 + w[r mod G])
// with the sum of squares in fp32 and y in x's dtype (fp32 or bf16);
// w is G rows of D fp32 values, as the models keep their norm weights.
// G is 1 but for a norm by groups (Zamba2's gated norm over d_inner in
// mamba_ngroups groups: the rows of (B, S, G, D) each take their group's
// weight).
//
// Bound: device memory.  The kernel does ~4 flops per element, far below
// the card's ~295 flops per byte, so the least time is the bytes it must
// move: 2*M*D*sizeof(x) + 4*D at 3.35 TB/s.  At the serve paths' decode
// shapes (4 rows) that is ~0.01 us, so there the time is the launch and
// the latency of one load round trip, not bytes.
//
// Design.  One block a row.  The row is cut into 16-byte vectors (8 bf16
// or 4 fp32 values); thread t holds the row's vectors t, t + kThreads,
// ... in registers.  It issues its loads of w (two float4 per bf16
// vector, one per fp32 vector) and of x together, before any
// arithmetic, so the row costs one load round trip and device memory
// sees one read and one write per element.  The sum of squares reduces
// in registers, then by warp shuffles, then through one shared-memory
// step behind a single __syncthreads; each thread then scales the
// registers it loaded and stores them.
//
// Layout per width.  Threads a row and vectors a thread are template
// parameters, fixed at compile time by (D, dtype) alone (struct Width
// below), so a thread's loads unroll and are in flight together.  They
// never depend on M: a row's reduction tree, and so its output bits, are
// the same whatever rows it is computed with (the serve path's greedy
// tokens rely on that: a prefill's M is how many requests were admitted
// together).  rmsnorm_layout() reports the layout; the choice itself
// lives only here, and tests/test_torch_gpu.py's row-independence test
// stands for it.
//   D                     bf16: threads x vectors   fp32: threads x vectors
//   2048 (gemma-2b)       256 x 1                   256 x 2
//   2560 (zamba2-2.7b)    320 x 1                   320 x 2
//   5120 (zamba2 d_inner) 128 x 5                   256 x 5
// Why (PERF.md §6, rmsnorm findings: two sweeps on the card with
// benchmarks/rmsnorm_ab_torch.py over variants of this table).  Most
// launches run at 4-row decode shapes, where the time is a chain of
// latencies (load, shuffles, barrier, store): the fewer vectors a thread
// walks, the shorter the chain, so one vector a thread (8 to 10 warps a
// row) won at 2048 and 2560 in bf16 (at 2048 also at 512 rows).  At
// 5120 in bf16, 640 one-vector threads lost at both shapes; 4, 5 and 10
// warps tied at decode, 4 kept.  Several rows a block (a warp or two a
// row) lost at every shape.
//
// Other widths whose rows are a multiple of 16 bytes and at most 2048
// vectors take the generic instance (512 threads a row, up to 4 vectors
// a thread, loads and stores predicated by the run-time width).  Wider
// rows, rows that are not a multiple of 16 bytes and pointers off a
// 16-byte boundary take the scalar path: one block of 256 threads a row,
// reading x twice.
//
// rmsnorm_launch returns cudaGetLastError() after the launch, so a
// refused launch reaches the Python wrapper, which raises.
// rmsnorm_floor_launch launches an empty kernel with a given grid and
// block: the time a launch takes when the kernel does nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum over the 32 lanes by a butterfly: both lanes of every pair add the
// same two values, so all lanes end with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---------------------------------------------------------------- vectors

// Element j of v; j is a constant once the loops unroll.
__device__ __forceinline__ float elem(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One block of kThreads threads (a multiple of 32) a row, kVecs 16-byte
// vectors a thread.  kExact: the row is exactly kThreads * kVecs vectors
// (a width of its own); otherwise nv (at most that) comes at run time
// and loads and stores past it are skipped.
template <typename T, int kThreads, int kVecs, bool kExact>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ y, int nv_arg, int wg, float eps) {
  constexpr int kN = 16 / sizeof(T);  // elements a vector
  constexpr int kW4 = kN / 4;         // float4 of w a vector
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0, "whole warps a row");
  const int nv = kExact ? kThreads * kVecs : nv_arg;
  const int t = threadIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (int64_t)blockIdx.x * nv;
  // the row's weight (a uniform select: no division where wg is 1)
  const int wrow = wg == 1 ? 0 : (int)(blockIdx.x % wg);
  const float4* w4 = reinterpret_cast<const float4*>(w) + (int64_t)wrow * nv * kW4;

  // every load first: w, then x
  float4 wv[kVecs][kW4];
  uint4 xv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = i * kThreads + t;
    const bool in = kExact || v < nv;
#pragma unroll
    for (int q = 0; q < kW4; ++q) {
      wv[i][q] = in ? __ldg(w4 + v * kW4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    xv[i] = in ? xr[v] : make_uint4(0u, 0u, 0u, 0u);
  }

  // sum of squares: one chain a vector, then the vectors in order
  float part[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const T* e = reinterpret_cast<const T*>(&xv[i]);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float f = to_f32(e[j]);
      s += f * f;
    }
    part[i] = s;
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) ss += part[i];
  ss = warp_sum(ss);
  if constexpr (kWarps > 1) {  // the warps' sums, in order, in every thread
    __shared__ float red[kWarps];
    if (t % 32 == 0) red[t / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) ss += red[k];
  }
  const float rs = rsqrtf(ss / (nv * kN) + eps);

  uint4* yr = reinterpret_cast<uint4*>(y) + (int64_t)blockIdx.x * nv;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = i * kThreads + t;
    const T* e = reinterpret_cast<const T*>(&xv[i]);
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      oe[j] = from_f32<T>(to_f32(e[j]) * rs * (1.f + elem(wv[i][j / 4], j % 4)));
    }
    if (kExact || v < nv) yr[v] = o;
  }
}

struct Geometry {
  int threads, vecs;  // threads a row (and a block), vectors a thread
};

template <typename T, int kThreads, int kVecs, bool kExact = true>
struct Inst {
  static constexpr Geometry geometry{kThreads, kVecs};
  static void launch(const void* x, const float* w, void* y, long long m, int nv,
                     int wg, float eps, cudaStream_t s) {
    rmsnorm_vec_kernel<T, kThreads, kVecs, kExact>
        <<<(unsigned)m, kThreads, 0, s>>>((const T*)x, w, (T*)y, nv, wg, eps);
  }
};

// The widths the serve paths run: gemma-2b's d_model 2048, zamba2-2.7b's
// d_model 2560 and its gate norm over d_inner 5120 (the header says why
// each has its layout).
template <typename T, int kD> struct Width;
template <> struct Width<__nv_bfloat16, 2048> : Inst<__nv_bfloat16, 256, 1> {};
template <> struct Width<__nv_bfloat16, 2560> : Inst<__nv_bfloat16, 320, 1> {};
template <> struct Width<__nv_bfloat16, 5120> : Inst<__nv_bfloat16, 128, 5> {};
template <> struct Width<float, 2048> : Inst<float, 256, 2> {};
template <> struct Width<float, 2560> : Inst<float, 320, 2> {};
template <> struct Width<float, 5120> : Inst<float, 256, 5> {};

template <typename T> using Generic = Inst<T, 512, 4, false>;

// Calls fn with the instance that serves width d (vectors of 16 bytes;
// d * sizeof(T) a multiple of 16, at most Generic's 2048 vectors).
template <typename T, typename Fn>
void with_width(int d, Fn&& fn) {
  switch (d) {
    case 2048: fn(Width<T, 2048>{}); break;
    case 2560: fn(Width<T, 2560>{}); break;
    case 5120: fn(Width<T, 5120>{}); break;
    default: fn(Generic<T>{});
  }
}

template <typename T>
bool vector_width(int d) {
  const Geometry g = Generic<T>::geometry;
  return (d * sizeof(T)) % 16 == 0 && d / (16 / (int)sizeof(T)) <= g.threads * g.vecs;
}

// ----------------------------------------------------------------- scalar

constexpr int kScalarThreads = 256;

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  constexpr int kWarps = kScalarThreads / 32;
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < kWarps ? red[lane] : 0.f);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

// One block a row, any width and alignment: x is read twice.
template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ y, int d, int wg, float eps) {
  __shared__ float red[kScalarThreads / 32 + 1];
  const T* xr = x + (int64_t)blockIdx.x * d;
  const float* wr = w + (int64_t)(wg == 1 ? 0 : blockIdx.x % wg) * d;
  T* yr = y + (int64_t)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    const float f = to_f32(xr[i]);
    ss += f * f;
  }
  const float r = rsqrtf(block_sum(ss, red) / d + eps);
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    yr[i] = from_f32<T>(to_f32(xr[i]) * r * (1.f + wr[i]));
  }
}

template <typename T>
void launch(const void* x, const float* w, void* y, long long m, int d, int wg,
            float eps, cudaStream_t stream) {
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                       (uintptr_t)w % 16 == 0;
  if (aligned && vector_width<T>(d)) {
    const int nv = d / (16 / (int)sizeof(T));
    with_width<T>(d, [&](auto inst) { inst.launch(x, w, y, m, nv, wg, eps, stream); });
  } else {
    rmsnorm_scalar_kernel<T><<<(unsigned)m, kScalarThreads, 0, stream>>>(
        (const T*)x, w, (T*)y, d, wg, eps);
  }
}

template <typename T>
Geometry layout(int d) {
  Geometry g{kScalarThreads, 0};
  if (vector_width<T>(d)) with_width<T>(d, [&](auto inst) { g = inst.geometry; });
  return g;
}

__global__ void rmsnorm_floor_kernel() {}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  m rows of d elements, contiguous;
// w is wg rows of d fp32 values, row r of x taking w's row r mod wg
// (wg divides m).  Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_grouped_launch(const void* x, const void* w, void* y,
                                      long long m, int d, int wg, float eps, int dtype,
                                      void* stream) {
  if (m <= 0 || m > 0x7fffffffLL || d <= 0 || wg <= 0 || m % wg) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(x, (const float*)w, y, m, d, wg, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, (const float*)w, y, m, d, wg, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One weight row for every row of x: w is d fp32 values.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y,
                              long long m, int d, float eps, int dtype,
                              void* stream) {
  return rmsnorm_grouped_launch(x, w, y, m, d, 1, eps, dtype, stream);
}

// The layout rmsnorm_launch takes for width d and dtype on 16-byte-aligned
// pointers (one block a row): out[0] threads a row, out[1] vectors a
// thread (0 on the scalar path).  Returns 0, or cudaErrorInvalidValue.
extern "C" int rmsnorm_layout(int d, int dtype, int* out) {
  if (d <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Geometry g = dtype == 0 ? layout<float>(d) : layout<__nv_bfloat16>(d);
  out[0] = g.threads;
  out[1] = g.vecs;
  return 0;
}

// An empty kernel of `blocks` blocks of `threads` threads.
extern "C" int rmsnorm_floor_launch(long long blocks, int threads, void* stream) {
  if (blocks <= 0 || blocks > 0x7fffffffLL || threads <= 0) return (int)cudaErrorInvalidValue;
  rmsnorm_floor_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// STREAM triad for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/stream_triad.py::stream_triad, the Pallas TPU
// kernel behind src/repro/kernels/ops.py::triad.
//
// Computes, elementwise over n values of fp32 or bf16:
//     a = b + s * c
// in fp32 as one fused multiply-add, fmaf(s, c, b), rounded once to the
// output dtype (round to nearest even for bf16).
//
// Bound: device memory.  2 flops per element against 3*e bytes moved
// (e = 4 for fp32, 2 for bf16) is 1/6 or 1/3 flop per byte, two orders
// of magnitude under the card's ~20 fp32 flops per byte, so the least
// time is 3*e*n bytes at 3.35 TB/s.  The design only moves bytes well:
// - each thread moves 16 bytes per load and store (4 fp32 or 8 bf16
//   values), so a warp reads 512 contiguous bytes per instruction;
// - the inputs come through the read-only path (__ldg), and the output
//   is stored with the streaming hint (__stcs, evict first), since
//   nothing reads it again here;
// - the grid has one thread per vector, each with two 16-byte loads in
//   flight, 2048 threads per SM, and blocks that retire early make room
//   for the next.  A grid capped at a few blocks per SM, looping over the
//   data, was slower at 2^26 elements on the H100 (PERF.md).  Indices are
//   64-bit: a grid of up to 2^31 - 1 blocks of 256 vectors covers n far
//   past 2^31;
// - the ragged tail of fewer than one vector is done by the first threads
//   of the grid in the same launch: nothing is padded or copied, where the
//   Pallas wrapper pads to 262144-element tiles;
// - a pointer off a 16-byte boundary (a view such as b[1:]) sends the
//   launch to a scalar kernel of the same shape, one element per access.
//
// stream_triad_launch returns cudaGetLastError() after the launch, so a
// refused launch reaches the Python wrapper, which raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Elements are stored as float (fp32) or as the 16 bits of a bf16.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short v) {
  return __uint_as_float((unsigned int)v << 16);  // exact
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ unsigned short from_f32<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T triad1(T b, T c, float s) {
  return from_f32<T>(fmaf(s, to_f32(c), to_f32(b)));
}

// All three pointers 16-byte aligned: thread i does vector i, and the
// first n % kN threads of the grid also do one element of the tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
triad_vec_kernel(const T* __restrict__ b, const T* __restrict__ c,
                 T* __restrict__ a, int64_t n, float s) {
  constexpr int kN = 16 / sizeof(T);  // elements per 16-byte vector
  union Pack {
    uint4 u;
    T e[kN];
  };
  const int64_t nvec = n / kN;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    Pack pb, pc, pa;
    pb.u = __ldg(reinterpret_cast<const uint4*>(b) + i);
    pc.u = __ldg(reinterpret_cast<const uint4*>(c) + i);
#pragma unroll
    for (int j = 0; j < kN; ++j) pa.e[j] = triad1(pb.e[j], pc.e[j], s);
    __stcs(reinterpret_cast<uint4*>(a) + i, pa.u);
  }
  const int64_t t = nvec * kN + i;
  if (t < n) __stcs(a + t, triad1(__ldg(b + t), __ldg(c + t), s));
}

// Any alignment: thread i does element i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
triad_scalar_kernel(const T* __restrict__ b, const T* __restrict__ c,
                    T* __restrict__ a, int64_t n, float s) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) __stcs(a + i, triad1(__ldg(b + i), __ldg(c + i), s));
}

template <typename T>
cudaError_t launch(const void* b, const void* c, void* a, int64_t n, float s,
                   cudaStream_t stream) {
  constexpr int kN = 16 / sizeof(T);
  const bool vec = (((uintptr_t)b | (uintptr_t)c | (uintptr_t)a) % 16) == 0;
  // one thread per vector (the tail needs fewer than kN < kThreads)
  const int64_t items = vec ? (n / kN > 0 ? n / kN : 1) : n;
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;  // the grid's x limit
  if (vec) {
    triad_vec_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)b, (const T*)c, (T*)a, n, s);
  } else {
    triad_scalar_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)b, (const T*)c, (T*)a, n, s);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  b, c and a hold n contiguous
// elements each.  Returns a cudaError_t (0 = launched).
extern "C" int stream_triad_launch(const void* b, const void* c, void* a,
                                   long long n, float s, int dtype,
                                   void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(b, c, a, n, s, st);
  if (dtype == 1) return (int)launch<unsigned short>(b, c, a, n, s, st);
  return (int)cudaErrorInvalidValue;
}

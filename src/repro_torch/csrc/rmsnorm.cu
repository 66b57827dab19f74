// RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm, the Pallas TPU kernel
// behind src/repro/kernels/ops.py::rmsnorm_op.
//
// Computes, for each row of x (M, D):
//     y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// with the sum of squares in fp32 and y in x's dtype (fp32 or bf16);
// w is fp32, as the models keep their norm weights.
//
// Bound: device memory.  The kernel does ~4 flops per element, far below
// the card's ~295 flops per byte, so the least time is the bytes it must
// move: 2*M*D*sizeof(x) + 4*D at 3.35 TB/s.
//
// Design: one block of 256 threads per row.  Rows whose bytes are a
// multiple of 16 are read with 16-byte vector loads (D = 2048 in bf16 is
// exactly one 8-element load per thread); the sum of squares reduces in
// registers, then through warp shuffles and one shared-memory step.  The
// scaled store reads the row a second time; a 4-8 KB row is still in L1
// then, so device memory sees one read and one write per element.  Any
// other D (or an unaligned pointer) takes the scalar path.
//
// rmsnorm_launch returns cudaGetLastError() after the launch, so a
// refused launch reaches the Python wrapper, which raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  __shared__ float red[kWarps + 1];
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* yr = y + (int64_t)blockIdx.x * d;
  constexpr int kN = 16 / sizeof(T);  // elements per 16-byte vector

  float ss = 0.f;
  if (kVec) {
    for (int i = threadIdx.x; i < d / kN; i += kThreads) {
      const uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / d + eps);

  if (kVec) {
    for (int i = threadIdx.x; i < d / kN; i += kThreads) {
      const uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&u);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        oe[j] = from_f32<T>(to_f32(e[j]) * r * (1.f + w[i * kN + j]));
      }
      reinterpret_cast<uint4*>(yr)[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * (1.f + w[i]));
    }
  }
}

template <typename T>
void launch(const void* x, const float* w, void* y, long long m, int d,
            float eps, cudaStream_t stream) {
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const dim3 grid((unsigned)m);
  if (vec) {
    rmsnorm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        (const T*)x, w, (T*)y, d, eps);
  } else {
    rmsnorm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        (const T*)x, w, (T*)y, d, eps);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  m rows of d elements, contiguous;
// w is d fp32 values.  Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y,
                              long long m, int d, float eps, int dtype,
                              void* stream) {
  if (m <= 0 || m > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(x, (const float*)w, y, m, d, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, (const float*)w, y, m, d, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Mamba2 SSD chunk scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas TPU kernel
// behind src/repro/kernels/ops.py::ssd, and the wrapper's pre-scaling
// passes around it.
//
// Computes, per (batch row b, head h), over the chunks of Q positions in
// order, with cs = the within-chunk cumulative sum of dt * A, A =
// -exp(a_log[h]), and X = x * dt:
//     M       = ((C B^T) . exp(cs_i - cs_j) . tril)        (Q x Q)
//     y       = M X + (C . exp(cs)) state                   (Q x P)
//     state   = state * exp(cs_Q) + (B . exp(cs_Q - cs))^T X (N x P)
// and writes y (B, S, H, P) in x's dtype and the final state, transposed
// to the decode layout (B, H, P, N), in fp32.  The Pallas kernel does not
// emit the state; the serve prefill needs it.  Like the model's
// ssd_chunked (src/repro/models/mamba2.py), X and M are rounded to x's
// dtype before their products, and each half of y is rounded before the
// sum: at fp32 these are no-ops, at bf16 the kernel rounds where the
// reference rounds.  The state and every decay factor stay fp32.
//
// Exactness on pads: the serve prefill sets dt = 0 on pads.  Then X = 0,
// the cumulative sum runs sequentially (a pad adds -0 exactly), and
// exp(0) = 1 (expf, no fast-math shortcut), so a trailing pad leaves the
// state exactly as the last real token left it.
//
// Bound: at the serving shape (B 4, S 128, H 80, P = N = Q = 64) the
// bytes (bf16 x in and y out, fp32 state out, ~16 MB; ~4.8 us at
// 3.35 TB/s) exceed the ~1.3 GFLOP on the bf16 tensor cores (~1.4 us),
// but this kernel does its products with fp32 FMA on the CUDA cores
// (~20 us at 67 TFLOP/s), so as written it is bound by operations.
//
// Design: the TPU kernel's sequential chunk grid axis and its VMEM state
// scratch become a loop over chunks inside one block per (b, h): 320
// blocks at the serving shape.  The N x P state stays in shared memory
// for the whole sequence.  Per chunk the block stages dt, B, C (row
// major and transposed, read straight from the in_proj output through
// its row stride: no copies), and X, all as fp32; one thread takes the
// cumulative sum; then 256 threads each own a 4 x 4 output tile for the
// three products (M, y, the new state), reading float4 rows of the
// staged operands so that within a warp one operand is a broadcast and
// the other 16 consecutive vectors.  A row b is computed by its own
// blocks only, so a request's result does not depend on its batch
// companions.  mma/wgmma on bf16 operands, TMA staging and sharing
// C B^T across heads (B and C are per position, not per head) are later
// work.
//
// ssd_scan_launch returns cudaGetLastError() after the launch, so a
// refused launch reaches the Python wrapper, which raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxDim = 64;  // the largest Q, N and P

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and widened again: the reference's .astype(x.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[a][b] += u[a] * v[b]
__device__ __forceinline__ void outer(float acc[4][4], float4 u, float4 v) {
  const float ua[4] = {u.x, u.y, u.z, u.w}, va[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ua[a], va[b], acc[a][b]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
}

// Row pitch of the transposed B and C: a multiple of 4 (float4 rows) that
// spreads the transposing stores over 8 banks instead of one.
__host__ __device__ constexpr int pitch_t(int q) { return q + 4; }

__host__ __device__ constexpr size_t smem_floats(int q, int n, int p) {
  return (size_t)q * p + (size_t)q * n + 2 * (size_t)n * pitch_t(q) +
         (size_t)q * q + (size_t)n * p + 4 * (size_t)q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, int64_t xsb, int64_t xss, int64_t xsh,
           const float* __restrict__ dt, int64_t dsb, int64_t dss, int64_t dsh,
           const float* __restrict__ a_log,
           const T* __restrict__ bm, int64_t bsb, int64_t bss,
           const T* __restrict__ cm, int64_t csb, int64_t css,
           T* __restrict__ y, float* __restrict__ state_out,
           int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int QP = pitch_t(Q);
  float* sX = smem;              // [Q][P]  x * dt, rounded to T
  float* sB = sX + Q * P;        // [Q][N]
  float* sBT = sB + Q * N;       // [N][QP]
  float* sCT = sBT + N * QP;     // [N][QP]
  float* sMT = sCT + N * QP;     // [Q][Q]  sMT[j][i] = M[i][j]
  float* sSt = sMT + Q * Q;      // [N][P]  the state
  float* sDt = sSt + N * P;      // [Q]
  float* sCs = sDt + Q;          // [Q]     cumulative dt * A
  float* sEcs = sCs + Q;         // [Q]     exp(cs)
  float* sDend = sEcs + Q;       // [Q]     exp(cs_Q - cs)

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int QT = Q / 4, PT = P / 4, NT = N / 4;
  const float A = -expf(a_log[h]);
  const T* xb = x + b * xsb + h * xsh;
  const float* dtb = dt + b * dsb + h * dsh;
  const T* bb = bm + b * bsb;
  const T* cb = cm + b * csb;
  T* yb = y + ((int64_t)b * S * H + h) * P;  // y is contiguous (B, S, H, P)
  const int64_t y_row = (int64_t)H * P;

  for (int e = tid; e < N * P; e += kThreads) sSt[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // 1. the chunk's dt, B and C
    for (int i = tid; i < Q; i += kThreads) sDt[i] = dtb[(int64_t)(c0 + i) * dss];
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const float bv = to_f32(bb[(int64_t)(c0 + i) * bss + n]);
      sB[e] = bv;
      sBT[n * QP + i] = bv;
      sCT[n * QP + i] = to_f32(cb[(int64_t)(c0 + i) * css + n]);
    }
    __syncthreads();

    // 2. warp 0: the cumulative sum (sequential, as the reference's
    // cumsum) and its exponentials; the other warps: X = x * dt
    if (tid < 32) {
      if (tid == 0) {
        float acc = 0.f;
        for (int i = 0; i < Q; ++i) {
          acc = __fadd_rn(acc, __fmul_rn(sDt[i], A));
          sCs[i] = acc;
        }
      }
      __syncwarp();
      const float last = sCs[Q - 1];
      for (int i = tid; i < Q; i += 32) {
        sEcs[i] = expf(sCs[i]);
        sDend[i] = expf(last - sCs[i]);
      }
    } else {
      for (int e = tid - 32; e < Q * P; e += kThreads - 32) {
        const int i = e / P, p = e % P;
        sX[e] = round_to<T>(to_f32(xb[(int64_t)(c0 + i) * xss + p]) * sDt[i]);
      }
    }
    __syncthreads();

    // 3. M = (C B^T) . L, rounded to T, stored transposed; the tiles above
    // the diagonal are never read
    for (int t = tid; t < QT * QT; t += kThreads) {
      const int ti = t % QT, tj = t / QT;
      if (tj > ti) continue;
      float acc[4][4];
      zero(acc);
      for (int n = 0; n < N; ++n) {
        outer(acc, ld4(sCT + n * QP + 4 * ti), ld4(sBT + n * QP + 4 * tj));
      }
#pragma unroll
      for (int bj = 0; bj < 4; ++bj) {
        const int j = 4 * tj + bj;
        float m[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 4 * ti + a;
          m[a] = j <= i ? round_to<T>(acc[a][bj] * expf(sCs[i] - sCs[j])) : 0.f;
        }
        *reinterpret_cast<float4*>(sMT + j * Q + 4 * ti) = make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // 4. y = M X + (C . exp(cs)) state, each half rounded to T
    for (int t = tid; t < QT * PT; t += kThreads) {
      const int ti = t / PT, tp = t % PT;
      float in[4][4], ex[4][4];
      zero(in);
      zero(ex);
      for (int j = 0; j < 4 * ti + 4; ++j) {
        outer(in, ld4(sMT + j * Q + 4 * ti), ld4(sX + j * P + 4 * tp));
      }
      for (int n = 0; n < N; ++n) {
        outer(ex, ld4(sCT + n * QP + 4 * ti), ld4(sSt + n * P + 4 * tp));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ti + a;
        const float e = sEcs[i];
        T* yr = yb + (int64_t)(c0 + i) * y_row + 4 * tp;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yr[c] = from_f32<T>(round_to<T>(in[a][c]) + round_to<T>(ex[a][c] * e));
        }
      }
    }
    __syncthreads();

    // 5. state = state * exp(cs_Q) + (B . exp(cs_Q - cs))^T X
    const float decay = sEcs[Q - 1];
    for (int t = tid; t < NT * PT; t += kThreads) {
      const int tn = t / PT, tp = t % PT;
      float acc[4][4];
      zero(acc);
      for (int j = 0; j < Q; ++j) {
        const float d = sDend[j];
        float4 bw = ld4(sB + j * N + 4 * tn);
        bw.x *= d;
        bw.y *= d;
        bw.z *= d;
        bw.w *= d;
        outer(acc, bw, ld4(sX + j * P + 4 * tp));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float* sr = sSt + (4 * tn + a) * P + 4 * tp;
#pragma unroll
        for (int c = 0; c < 4; ++c) sr[c] = sr[c] * decay + acc[a][c];
      }
    }
    __syncthreads();
  }

  // the final state in the decode layout (B, H, P, N)
  float* so = state_out + ((int64_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    so[e] = sSt[n * P + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, int64_t xsb, int64_t xss, int64_t xsh,
                   const float* dt, int64_t dsb, int64_t dss, int64_t dsh,
                   const float* a_log, const void* bm, int64_t bsb, int64_t bss,
                   const void* cm, int64_t csb, int64_t css, void* y,
                   float* state, int B, int S, int H, int P, int N, int Q,
                   cudaStream_t st) {
  static bool granted = false;
  constexpr size_t kMaxBytes = sizeof(float) * smem_floats(kMaxDim, kMaxDim, kMaxDim);
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxBytes);
    if (e != cudaSuccess) return e;
    granted = true;
  }
  const size_t bytes = sizeof(float) * smem_floats(Q, N, P);
  const dim3 grid(H, B);
  ssd_kernel<T><<<grid, kThreads, bytes, st>>>(
      (const T*)x, xsb, xss, xsh, dt, dsb, dss, dsh, a_log, (const T*)bm, bsb,
      bss, (const T*)cm, csb, css, (T*)y, state, S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, H, P), bm and cm (B, S, N) in one dtype (0 = float32, 1 =
// bfloat16), each with a unit stride in its last dim and the other
// strides (in elements) given; dt (B, S, H) and a_log (H,) fp32.  y
// (B, S, H, P) in x's dtype and state (B, H, P, N) fp32, both contiguous.
// Q divides S; Q, N and P are multiples of 4 in [4, 64].  Returns a
// cudaError_t (0 = launched).
extern "C" int ssd_scan_launch(const void* x, long long xsb, long long xss,
                               long long xsh, const void* dt, long long dsb,
                               long long dss, long long dsh, const void* a_log,
                               const void* bm, long long bsb, long long bss,
                               const void* cm, long long csb, long long css,
                               void* y, void* state, int B, int S, int H, int P,
                               int N, int Q, int dtype, void* stream) {
  const bool dims_ok = Q >= 4 && N >= 4 && P >= 4 && Q <= kMaxDim && N <= kMaxDim &&
                       P <= kMaxDim && Q % 4 == 0 && N % 4 == 0 && P % 4 == 0;
  if (B <= 0 || S <= 0 || H <= 0 || !dims_ok || S % Q || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const float* dtf = (const float*)dt;
  const float* al = (const float*)a_log;
  if (dtype == 0) {
    return (int)launch<float>(x, xsb, xss, xsh, dtf, dsb, dss, dsh, al, bm, bsb, bss,
                              cm, csb, css, y, (float*)state, B, S, H, P, N, Q, st);
  }
  if (dtype == 1) {
    return (int)launch<bf16>(x, xsb, xss, xsh, dtf, dsb, dss, dsh, al, bm, bsb, bss,
                             cm, csb, css, y, (float*)state, B, S, H, P, N, Q, st);
  }
  return (int)cudaErrorInvalidValue;
}

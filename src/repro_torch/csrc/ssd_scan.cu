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
// reference rounds.  The state and every decay factor stay fp32; the
// bf16 kernel also rounds a copy of the state to be the operand of
// C state, and carries the decay-scaled B of the state update as two
// bf16 parts.
//
// Exactness on pads: the serve prefill sets dt = 0 on pads.  Then X = 0,
// the cumulative sum runs sequentially (a pad adds -0 exactly), and
// exp(0) = 1 (expf, no fast-math shortcut), so a trailing pad leaves the
// state exactly as the last real token left it.
//
// Bound: at the serving shape (B 4, S 128, H 80, P = N = Q = 64) the
// bytes (bf16 x in and y out, fp32 dt in and state out, ~16 MB; ~4.8 us
// at 3.35 TB/s) exceed the ~1.3 GFLOP on the bf16 tensor cores
// (~1.4 us): the function is bound by bytes.  At a 4096-token prompt
// (B 1, H 80) it is ~87.5 MB (~26 us) against ~8.1 GFLOP (~8.2 us).
//
// Both instances keep the TPU kernel's sequential chunk grid axis and
// its VMEM state scratch as a loop over chunks inside one block per
// (b, h): 320 blocks at the serving shape.  A row b is computed by its
// own blocks only, so a request's result does not depend on its batch
// companions.  Each block stages the chunk's dt, B and C (read straight
// from the in_proj output through its row stride: no copies) and X, and
// the within-chunk cumulative sum is taken by one chain in order.
//
// bf16, ssd_mma_kernel: every product on the tensor cores, with
// mma.sync m16n8k16 (bf16 operands, fp32 sums) fed by ldmatrix.  128
// threads; warp w owns rows 16w..16w+15 of the chunk and of the state.
// x, B and C are staged as bf16 in two buffers at a row pitch of 72
// elements (ldmatrix free of bank conflicts): the next chunk's rows
// arrive by cp.async (16-byte copies where the pointers and strides
// allow, chosen at launch; scalar loads otherwise) while this chunk
// computes, and X = bf16(x dt) is made in place.  S = C B^T is taken for
// the blocks on and below the diagonal, and M = bf16(S exp(cs_i - cs_j))
// never leaves the registers: the m16n8 accumulator pairs are the m16k16
// A operand of M X.  y_inter = exp(cs_i) (C bf16(state)) reads a bf16
// copy of the state that the warp owning its rows writes after each
// update (two copies, by chunk parity, so no extra barrier).  The fp32
// state lives in the mma accumulators for the whole sequence (32 floats
// a thread) and is updated as state exp(cs_Q) + Bd_hi^T X + Bd_lo^T X,
// where the decay-scaled Bd = B exp(cs_Q - cs) is split in registers
// into a bf16 high and low part: without the lo part the state would
// carry bf16's 2^-9 into every term and miss 1e-4 of max|state|.  Q, N
// and P are padded to 64 (zeros in X, B and C, cs_{Q-1} on rows past
// Q), which adds exact zeros and fixes every loop bound at compile time.
// ~74 KB of shared memory and at most 168 registers a thread fit 3
// blocks an SM: the 320 blocks run in one wave.
//
// fp32, ssd_kernel<float>: fp32 FMA on the CUDA cores (~20 us of
// operations at 67 TFLOP/s).  The N x P state stays in shared memory;
// 256 threads each own a 4 x 4 output tile of the three products (M, y,
// the new state), reading float4 rows of fp32 operands so that within a
// warp one operand is a broadcast and the other 16 consecutive vectors.
//
// wgmma, TMA staging, sharing C B^T across heads (B and C are per
// position, not per head) and a chunk-parallel grid for long prompts are
// later work.
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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

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

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps; warp w owns rows 16w..16w+15
constexpr int kPitch = 72;        // staged row pitch (bf16): 144 bytes, 8 rows on 32 banks
constexpr int kTile = kMaxDim * kPitch;  // one staged [64][kPitch] tile
// two buffers of X, B and C, two bf16 copies of the state; two of cs,
// exp(cs) and exp(cs_Q - cs), and dt * A
constexpr size_t kMmaSmemBytes = 8 * kTile * sizeof(bf16) + 7 * kMaxDim * sizeof(float);

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf_round(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Elements col0..col0+7 of a row, zeros at and past ncols, in scalar loads
__device__ __forceinline__ uint4 load8_scalar(const bf16* row, int col0, int ncols) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row) + col0;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (col0 + k < ncols) w[k / 2] |= static_cast<uint32_t>(__ldg(r + k)) << (16 * (k % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Elements col0..col0+7 of a row, those before ncols; kVec: one 16-byte
// store (the launch checked the alignment; ncols % 8 == 0)
template <bool kVec>
__device__ __forceinline__ void store8(bf16* row, int col0, int ncols, uint4 v) {
  if (kVec) {
    if (col0 < ncols) *reinterpret_cast<uint4*>(row + col0) = v;
  } else {
    unsigned short* r = reinterpret_cast<unsigned short*>(row) + col0;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (col0 + k < ncols) r[k] = static_cast<unsigned short>(w[k / 2] >> (16 * (k % 2)));
    }
  }
}

__device__ __forceinline__ void st_shared4(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// The bf16 scan.  Q, N and P are padded to 64 in shared memory (zeros in
// X, B and C past the real rows and columns; dt = 0 past Q, so the
// sequential cumsum carries cs_{Q-1} onto those rows), so every loop
// bound is a compile-time constant and the ldmatrix and mma of a product
// interleave without branches; the only branches skip the 16-column
// blocks above the diagonal in S and M X (warp w takes w + 1 of 4).
// Chunk c + 1's x, B and C are copied by cp.async (by scalar loads if
// !kVec) into the other buffer while chunk c computes; each thread then
// scales the x vectors it copied, and warp 0 takes chunk c + 1's
// cumulative sum, so one barrier a chunk suffices.
template <bool kVec>
__global__ void __launch_bounds__(kMmaThreads, 3)
ssd_mma_kernel(const bf16* __restrict__ x, int64_t xsb, int64_t xss, int64_t xsh,
               const float* __restrict__ dt, int64_t dsb, int64_t dss, int64_t dsh,
               const float* __restrict__ a_log,
               const bf16* __restrict__ bm, int64_t bsb, int64_t bss,
               const bf16* __restrict__ cm, int64_t csb, int64_t css,
               bf16* __restrict__ y, float* __restrict__ state_out,
               int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // 2 x [64][kPitch] bf16(x * dt), by position j
  bf16* sB = sX + 2 * kTile;  // 2 x [64][kPitch] B, by position j
  bf16* sC = sB + 2 * kTile;  // 2 x [64][kPitch] C, by position i; then each warp's rows of y
  bf16* sSt = sC + 2 * kTile;  // 2 x [64][kPitch] the state in bf16, [n][p]
  float* sCs = reinterpret_cast<float*>(sSt + 2 * kTile);  // 2 x [64] cumulative dt * A
  float* sEcs = sCs + 2 * kMaxDim;    // 2 x [64] exp(cs)
  float* sDend = sEcs + 2 * kMaxDim;  // 2 x [64] exp(cs_{Q-1} - cs)
  float* sDa = sDend + 2 * kMaxDim;   // [64] dt * A, warp 0's scratch

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const float A = -expf(a_log[h]);
  const bf16* xb = x + b * xsb + h * xsh;
  const float* dtb = dt + b * dsb + h * dsh;
  const bf16* bb = bm + b * bsb;
  const bf16* cb = cm + b * csb;
  bf16* yb = y + ((int64_t)b * S * H + h) * P;  // y is contiguous (B, S, H, P)
  const int64_t y_row = (int64_t)H * P;
  const int r0 = 16 * warp;  // the warp's rows of the chunk and of the state
  // staging: this thread's 8-element vector v of rows sr + 16 k
  const int sr = tid >> 3, sv = 8 * (tid & 7);
  // ldmatrix row and column offsets of this lane: an A tile of row-major
  // storage (a_), two n-tiles of [n][k] storage (nk_), and two n-tiles of
  // [k][n] storage or an A tile of [k][m] storage through .trans (kn_, km_)
  const int a_row = lane & 15, a_col = 8 * (lane >> 4);
  const int nk_row = (lane & 7) + 8 * (lane >> 4), nk_col = 8 * ((lane >> 3) & 1);
  const int kn_row = (lane & 7) + 8 * ((lane >> 3) & 1), kn_col = 8 * (lane >> 4);

  // chunk c0's x, B and C rows into buffer buf (zeros past Q, P, N), and
  // the dt of this thread's staging rows and of warp 0's cumsum rows
  float dts[4], dtw[2];
  auto stage = [&](int c0, int buf) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = sr + 16 * k, off = buf * kTile + i * kPitch + sv;
      const int64_t j = c0 + min(i, Q - 1);
      const bool row = i < Q;
      if (kVec) {
        cp_async16(sX + off, xb + j * xss + sv, row && sv < P);
        cp_async16(sB + off, bb + j * bss + sv, row && sv < N);
        cp_async16(sC + off, cb + j * css + sv, row && sv < N);
      } else {
        *reinterpret_cast<uint4*>(sX + off) = load8_scalar(xb + j * xss, sv, row ? P : 0);
        *reinterpret_cast<uint4*>(sB + off) = load8_scalar(bb + j * bss, sv, row ? N : 0);
        *reinterpret_cast<uint4*>(sC + off) = load8_scalar(cb + j * css, sv, row ? N : 0);
      }
      dts[k] = row ? __ldg(dtb + j * dss) : 0.f;
    }
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        dtw[k] = i < Q ? __ldg(dtb + (int64_t)(c0 + i) * dss) : 0.f;
      }
    }
  };
  // once the copies into buf have landed: X = bf16(x dt) in place, each
  // thread on the vectors it copied; warp 0: the cumulative sum
  // (sequential, as the reference's cumsum: a pad adds -0 exactly) and
  // its exponentials
  auto finish = [&](int buf) {
    if (kVec) cp_async_wait_all();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint4* v = reinterpret_cast<uint4*>(sX + buf * kTile + (sr + 16 * k) * kPitch + sv);
      const uint4 w = *v;
      const uint32_t in[4] = {w.x, w.y, w.z, w.w};
      uint32_t out[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        out[m] = pack2(__fmul_rn(lo_f32(in[m]), dts[k]), __fmul_rn(hi_f32(in[m]), dts[k]));
      }
      *v = make_uint4(out[0], out[1], out[2], out[3]);
    }
    if (warp == 0) {
      float* cs = sCs + buf * kMaxDim;
      sDa[lane] = __fmul_rn(dtw[0], A);
      sDa[lane + 32] = __fmul_rn(dtw[1], A);
      __syncwarp();
      // every lane takes the same chain (no divergence); lane 0 stores it
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDim; i += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(sDa + i);
        const float da[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc = __fadd_rn(acc, da[k]);
          if (lane == 0) cs[i + k] = acc;
        }
      }
      __syncwarp();
      const float last = acc;  // cs_{Q-1}
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        sEcs[buf * kMaxDim + i] = expf(cs[i]);
        sDend[buf * kMaxDim + i] = expf(last - cs[i]);
      }
    }
  };

  for (int e = tid; e < kTile / 8; e += kMmaThreads) {
    reinterpret_cast<uint4*>(sSt)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  stage(0, 0);
  finish(0);
  __syncthreads();

  float st[8][4];  // the warp's rows n of the fp32 state, columns p by 8
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) st[pt][0] = st[pt][1] = st[pt][2] = st[pt][3] = 0.f;

  for (int c0 = 0, ci = 0; c0 < S; c0 += Q, ++ci) {
    const int cur = ci & 1, nxt = cur ^ 1;
    const bool more = c0 + Q < S;
    if (more) stage(c0 + Q, nxt);  // the other buffer: free since the last barrier

    const bf16* X = sX + cur * kTile;
    const bf16* Bt = sB + cur * kTile;
    bf16* Ct = sC + cur * kTile;
    const float* cs = sCs + cur * kMaxDim;
    const float* ecs = sEcs + cur * kMaxDim;
    const float* dend = sDend + cur * kMaxDim;

    // C, the A operand of S = C B^T and of C state
    uint32_t cf[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) ldsm_x4(cf[kt], Ct + (r0 + a_row) * kPitch + 16 * kt + a_col);
    // S for the column blocks jm on and below the diagonal block, then M =
    // bf16(S exp(cs_i - cs_j)) on and below the diagonal and 0 above it,
    // kept as the A operand of M X: accumulator tiles 2 jm and 2 jm + 1
    // are columns 0-7 and 8-15 of k-step jm
    const int i0 = r0 + g;
    const float cs0 = cs[i0], cs1 = cs[i0 + 8];
    uint32_t mf[4][4];
#pragma unroll
    for (int jm = 0; jm < 4; ++jm) {
      if (jm > warp) continue;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t bq[4];
        ldsm_x4(bq, Bt + (16 * jm + nk_row) * kPitch + 16 * kt + nk_col);
        mma(s[0], cf[kt], bq[0], bq[1]);
        mma(s[1], cf[kt], bq[2], bq[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // every exponential taken, without a branch (cs falls along the
        // chunk, so cs_i - cs_j <= 0 wherever j <= i; above the diagonal
        // the min only keeps expf finite), then masked
        const int j = 16 * jm + 8 * u + 2 * t;
        const float cj0 = cs[j], cj1 = cs[j + 1];
        const float m00 = s[u][0] * expf(fminf(cs0 - cj0, 0.f));
        const float m01 = s[u][1] * expf(fminf(cs0 - cj1, 0.f));
        const float m10 = s[u][2] * expf(fminf(cs1 - cj0, 0.f));
        const float m11 = s[u][3] * expf(fminf(cs1 - cj1, 0.f));
        mf[jm][2 * u] = pack2(j <= i0 ? m00 : 0.f, j + 1 <= i0 ? m01 : 0.f);
        mf[jm][2 * u + 1] = pack2(j <= i0 + 8 ? m10 : 0.f, j + 1 <= i0 + 8 ? m11 : 0.f);
      }
    }
    // y_inter = bf16(exp(cs_i) (C state)), the state entering the chunk
    // read from its bf16 copy; parked as bf16 pairs in the warp's own rows
    // of C (read by this warp only, and already in cf), where y is made
    const bf16* st_in = sSt + cur * kTile;
    const float e0 = ecs[i0], e1 = ecs[i0 + 8];
    bf16* yrow = Ct + i0 * kPitch + 2 * t;
    {
      float acc[8][4];
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
        for (int pq = 0; pq < 4; ++pq) {
          uint32_t bq[4];
          ldsm_x4_t(bq, st_in + (16 * kt + kn_row) * kPitch + 16 * pq + kn_col);
          mma(acc[2 * pq], cf[kt], bq[0], bq[1]);
          mma(acc[2 * pq + 1], cf[kt], bq[2], bq[3]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        st_shared4(yrow + 8 * pt, pack2(acc[pt][0] * e0, acc[pt][1] * e0));
        st_shared4(yrow + 8 * kPitch + 8 * pt, pack2(acc[pt][2] * e1, acc[pt][3] * e1));
      }
    }
    // y_intra = M X over the k-steps on and below the diagonal; then the
    // warp's rows n of the state, state exp(cs_Q) + Bd_hi^T X + Bd_lo^T X
    // with Bd = B exp(cs_Q - cs) in fp32 split into a bf16 high and low
    // part (A = Bd^T from ldmatrix.trans of B's rows, scaled in registers)
    float yi[8][4];
    const float decay = ecs[kMaxDim - 1];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      yi[pt][0] = yi[pt][1] = yi[pt][2] = yi[pt][3] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) st[pt][c] *= decay;
    }
#pragma unroll
    for (int jm = 0; jm < 4; ++jm) {
      if (jm > warp) continue;
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        uint32_t bq[4];
        ldsm_x4_t(bq, X + (16 * jm + kn_row) * kPitch + 16 * pq + kn_col);
        mma(yi[2 * pq], mf[jm], bq[0], bq[1]);
        mma(yi[2 * pq + 1], mf[jm], bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int jk = 0; jk < 4; ++jk) {
      uint32_t bt[4], ah[4], al[4];
      ldsm_x4_t(bt, Bt + (16 * jk + nk_row) * kPitch + r0 + nk_col);
      // bt[m]: rows n = r0 + g (+8 for m odd), positions j = 16 jk + 2t, +1 (+8 for m >= 2)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = 16 * jk + 2 * t + 8 * (m / 2);
        const float d0 = __fmul_rn(lo_f32(bt[m]), dend[j]);
        const float d1 = __fmul_rn(hi_f32(bt[m]), dend[j + 1]);
        ah[m] = pack2(d0, d1);
        al[m] = pack2(d0 - lo_f32(ah[m]), d1 - hi_f32(ah[m]));  // exact in fp32
      }
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        uint32_t bq[4];
        ldsm_x4_t(bq, X + (16 * jk + kn_row) * kPitch + 16 * pq + kn_col);
        mma(st[2 * pq], ah, bq[0], bq[1]);
        mma(st[2 * pq + 1], ah, bq[2], bq[3]);
        mma(st[2 * pq], al, bq[0], bq[1]);
        mma(st[2 * pq + 1], al, bq[2], bq[3]);
      }
    }
    // the state's bf16 copy for the next chunk's C state
    bf16* st_next = sSt + nxt * kTile;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      bf16* row = st_next + i0 * kPitch + 8 * pt + 2 * t;
      st_shared4(row, pack2(st[pt][0], st[pt][1]));
      st_shared4(row + 8 * kPitch, pack2(st[pt][2], st[pt][3]));
    }
    // y = bf16(bf16(y_intra) + y_inter) in place of y_inter, then 16-byte
    // stores of the real rows and columns
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        bf16* p = yrow + 8 * hf * kPitch + 8 * pt;
        const uint32_t yx = *reinterpret_cast<const uint32_t*>(p);
        st_shared4(p, pack2(bf_round(yi[pt][2 * hf]) + lo_f32(yx),
                            bf_round(yi[pt][2 * hf + 1]) + hi_f32(yx)));
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (lane >> 3) + 4 * k, i = r0 + r, v = 8 * (lane & 7);
      if (i < Q) {
        store8<kVec>(yb + (int64_t)(c0 + i) * y_row, v, P,
                     *reinterpret_cast<const uint4*>(Ct + i * kPitch + v));
      }
    }

    if (more) finish(nxt);
    __syncthreads();
  }

  // the final state in the decode layout (B, H, P, N)
  float* so = state_out + ((int64_t)b * H + h) * P * N;
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = r0 + g + 8 * (c / 2), p = 8 * pt + 2 * t + c % 2;
      if (n < N && p < P) so[(int64_t)p * N + n] = st[pt][c];
    }
  }
}

template <bool kVec>
cudaError_t launch_mma(const void* x, int64_t xsb, int64_t xss, int64_t xsh,
                       const float* dt, int64_t dsb, int64_t dss, int64_t dsh,
                       const float* a_log, const void* bm, int64_t bsb, int64_t bss,
                       const void* cm, int64_t csb, int64_t css, void* y,
                       float* state, int B, int S, int H, int P, int N, int Q,
                       cudaStream_t st) {
  static bool granted = false;
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_mma_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmemBytes);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(ssd_mma_kernel<kVec>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return e;
    granted = true;
  }
  ssd_mma_kernel<kVec><<<dim3(H, B), kMmaThreads, kMmaSmemBytes, st>>>(
      (const bf16*)x, xsb, xss, xsh, dt, dsb, dss, dsh, a_log, (const bf16*)bm, bsb, bss,
      (const bf16*)cm, csb, css, (bf16*)y, state, S, H, P, N, Q);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // 16-byte staging loads and y stores where every row of x, B, C and y
  // starts on a 16-byte boundary; scalar ones otherwise
  const bool vec = P % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(bm) &&
                   aligned16(cm) && aligned16(y) && (xsb | xss | xsh | bsb | bss | csb | css) % 8 == 0;
  return (int)(vec ? launch_mma<true> : launch_mma<false>)(
      x, xsb, xss, xsh, dtf, dsb, dss, dsh, al, bm, bsb, bss, cm, csb, css, y,
      (float*)state, B, S, H, P, N, Q, st);
}

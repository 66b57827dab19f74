// Causal flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas TPU kernel behind src/repro/kernels/ops.py::attention.
//
// Computes out = softmax(q k^T / sqrt(D)) v over the natural layouts
// q (B, S, H, D) and k, v (B, S, KH, D), with the running max, the
// denominator and the output accumulator in fp32 (as the TPU kernel keeps
// them), an optional causal mask, and out (B, S, H, D) in q's dtype.
// Query head h reads kv head h / (H / KH) straight from k and v by
// strides: no repeated heads, no transposed or padded copies.  The ragged
// tail (S not a multiple of the tile) is masked here, in the kernel.
//
// Bound: at the serving shapes (S = 128, D = 256) the bytes of q, k, v
// and out over 3.35 TB/s (~1.4 us) exceed the causal flops, about
// 2*B*H*S^2*D, over 989 TFLOP/s (~0.3 us); at long S the tensor cores
// bound it.  Either way the kernel has to keep its intermediates (logits,
// probabilities, accumulator) out of device memory and feed the tensor
// cores from shared memory and registers.
//
// Design (bf16): the TPU kernel's sequential kv grid axis and its VMEM
// scratch become a loop over 64-row kv tiles inside one block.  One block
// of 2 warps per (32-row query tile, query head, batch row), so that the
// serving shape (B 4, S 128, H 8) gives 128 blocks for the 132 SMs; each
// warp owns 16 query rows.  Per kv tile the block stages K and V in
// shared memory with 16-byte cp.async copies, all in flight at once (a
// loop of plain loads waits out one memory latency per iteration); each
// warp computes its 16 x 64 logits
// with mma.sync m16n8k16 (bf16 in, fp32 accumulate) from ldmatrix
// fragments, runs the online softmax on them in registers (each thread
// holds two rows, reduced over its quad), rounds P to bf16 straight into
// the A operand of the next product, and accumulates P V (V fragments by
// ldmatrix.trans) into an fp32 accumulator that stays in registers
// (16 x D per warp: D/2 floats a thread).  Shared-memory rows are padded
// by 16 bytes so each 8-row ldmatrix phase hits 32 distinct banks.  The kv
// loop stops at the diagonal.  Q, K and V tiles need (32 + 2 * 64) *
// (D + 8) * 2 bytes (~83 KB at D = 256, two blocks per SM), above the
// 48 KB default, so the launch raises the kernel's limit first.
// Double buffering (TMA) and wgmma are later work.
//
// Design (fp32, for the parity checks against the CPU): one warp per
// query row, FMA dot products reduced by shuffles, the online softmax one
// key at a time.  Simple and exact enough; not a fast path.
//
// flash_attention_launch returns cudaGetLastError() after the launch, so
// a launch refused for shared memory reaches the Python wrapper, which
// raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kWarps = 2;      // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// d += a * b for one 16x8x16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 fp32.  Fragment layout (PTX ISA, mma.m16n8k16): with g = lane/4
// and t = lane%4, a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}; pairs pack low index first.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l receives row l/4, columns 2(l%4) and
// 2(l%4)+1 of each (with .trans: column l/4, rows 2(l%4) and 2(l%4)+1) —
// the fragment layout of mma.m16n8k16 above.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// Starts the copy of rows [s0, s0 + n) of a (S, row_stride) bf16 matrix
// into shared memory with pitch ld, 16 bytes per cp.async, all in flight
// at once; rows at or past S are zero-filled (source size 0).  Complete
// with wait_copies() and a barrier.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int64_t row_stride, int s0, int n,
                                          int S, int d) {
  const int chunks = d / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool in = s0 + r < S;
    const bf16* from = in ? src + (int64_t)(s0 + r) * row_stride + c : src;
    const uint32_t to = (uint32_t)__cvta_generic_to_shared(dst + r * ld + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (kBQ + 2 * kBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                  int H, int KH, float scale, int causal) {
  constexpr int LD = D + 8;  // padded row pitch: rows 4 banks apart
  constexpr int NT = D / 8;  // n8 tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * LD;
  bf16* sV = sK + kBK * LD;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: this lane's matrix, row
  const int r0 = warp * 16;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;  // this thread's query rows
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KH * D;
  const bf16* qb = q + ((int64_t)b * S * H + h) * D;
  const bf16* kb = k + ((int64_t)b * S * KH + kh) * D;
  const bf16* vb = v + ((int64_t)b * S * KH + kh) * D;

  load_tile(sQ, LD, qb, q_stride, q0, kBQ, S, D);  // lands with the first K/V tile

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows a, b
  float l[2] = {0.f, 0.f};              // this thread's share of the denominators

  const int kv_end = causal ? min(S, q0 + kBQ) : S;  // stop at the diagonal
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile(sK, LD, kb, kv_stride, k0, kBK, S, D);
    load_tile(sV, LD, vb, kv_stride, k0, kBK, S, D);
    wait_copies();
    __syncthreads();

    // logits s = Q K^T for rows [r0, r0 + 16) x the tile's 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];  // Q rows r0.., columns kk..: matrices (+0,+0) (+8,+0) (+0,+8) (+8,+8)
      ldsm_x4(a, sQ + (r0 + (mi % 2) * 8 + mr) * LD + kk + (mi / 2) * 8);
#pragma unroll
      for (int j = 0; j < kBK / 8; j += 2) {
        uint32_t kf[4];  // b0, b1 of key tiles j and j + 1
        ldsm_x4(kf, sK + (j * 8 + (mi / 2) * 8 + mr) * LD + kk + (mi % 2) * 8);
        mma_16816(s[j], a, kf[0], kf[1]);
        mma_16816(s[j + 1], a, kf[2], kf[3]);
      }
    }

    // scale, mask (causal, ragged tail) and the online softmax, in fp32
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool ok = col < S && (!causal || col <= row);
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 64 logits span one quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const float p = m[r] == -INFINITY ? 0.f : expf(s[j][e] - m[r]);
        s[j][e] = p;
        psum[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: the logits' accumulator layout is the A layout of P
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vf[4];  // b0, b1 of value columns n*8.. and (n+1)*8..
        ldsm_x4_trans(vf, sV + (kk * 16 + (mi % 2) * 8 + mr) * LD + n * 8 + (mi / 2) * 8);
        mma_16816(acc[n], pa, vf[0], vf[1]);
        mma_16816(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // out = acc / l; rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 1.f : l[r];  // fully masked row: the TPU kernel's guard
  }
  bf16* ob = o + ((int64_t)b * S * H + h) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (row_a < S) {
      *reinterpret_cast<uint32_t*>(ob + row_a * q_stride + n * 8) =
          pack(acc[n][0] / l[0], acc[n][1] / l[0]);
    }
    if (row_b < S) {
      *reinterpret_cast<uint32_t*>(ob + row_b * q_stride + n * 8) =
          pack(acc[n][2] / l[1], acc[n][3] / l[1]);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KH, float scale, int causal,
                        cudaStream_t st) {
  constexpr size_t bytes = bf16_smem_bytes<D>();
  static bool granted = false;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    granted = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_bf16_kernel<D><<<grid, kThreads, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H, KH, scale, causal);
  return cudaGetLastError();
}

constexpr int kRowsPerBlockF32 = 4;  // one warp per query row
constexpr int kPerLane = kMaxD / 32;

__global__ void __launch_bounds__(32 * kRowsPerBlockF32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KH, int d, float scale, int causal) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qi = blockIdx.x * kRowsPerBlockF32 + warp;
  if (qi >= S) return;  // no block-wide barrier below
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const float* qr = q + (((int64_t)b * S + qi) * H + h) * d;
  float qv[kPerLane], acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = lane + 32 * j;
    qv[j] = e < d ? qr[e] : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int end = causal ? qi + 1 : S;
  for (int t = 0; t < end; ++t) {
    const int64_t row = (((int64_t)b * S + t) * KH + kh) * d;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      if (e < d) dot = fmaf(qv[j], k[row + e], dot);
    }
    const float s = warp_sum(dot) * scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new), p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      if (e < d) acc[j] = acc[j] * alpha + p * v[row + e];
    }
    m = m_new;
  }
  l = l == 0.f ? 1.f : l;
  float* orow = o + (((int64_t)b * S + qi) * H + h) * d;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = lane + 32 * j;
    if (e < d) orow[e] = acc[j] / l;
  }
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, S, KH, D); all contiguous, one dtype
// (0 = float32, 1 = bfloat16).  H % KH == 0; D <= 256 in fp32, D in
// {64, 80, 128, 256} in bf16 with 16-byte aligned pointers.  Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KH, int d, int causal,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || d <= 0 || d > kMaxD ||
      B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const float scale = 1.f / sqrtf((float)d);
  if (dtype == 1) {
    switch (d) {
      case 64: return (int)launch_bf16<64>(q, k, v, o, B, S, H, KH, scale, causal, st);
      case 80: return (int)launch_bf16<80>(q, k, v, o, B, S, H, KH, scale, causal, st);
      case 128: return (int)launch_bf16<128>(q, k, v, o, B, S, H, KH, scale, causal, st);
      case 256: return (int)launch_bf16<256>(q, k, v, o, B, S, H, KH, scale, causal, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kRowsPerBlockF32 - 1) / kRowsPerBlockF32, H, B);
  flash_f32_kernel<<<grid, 32 * kRowsPerBlockF32, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, KH, d,
      scale, causal);
  return (int)cudaGetLastError();
}

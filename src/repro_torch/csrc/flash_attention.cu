// Flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas TPU kernel behind src/repro/kernels/ops.py::attention.
//
// Computes out = softmax(scale q k^T) v, scale 1 / sqrt(D) unless the
// caller gives another (Zamba2's shared attention: (D / 2)^-1/2), over the natural layouts
// q (B, S, H, D) and k, v (B, S, KH, D), optionally with the logits
// capped (Gemma-2's attn_logit_softcap c: c tanh(logit / c) after the
// scale and before the mask, as the reference layers apply it), with the
// running max, the
// denominator and the output accumulator in fp32 (as the TPU kernel keeps
// them), an optional causal mask, and out (B, S, H, D) in q's dtype.
// Query head h reads kv head h / (H / KH) straight from k and v by
// strides: no repeated heads, no transposed or padded copies.  The ragged
// tail (S not a multiple of the tile) is masked here, in the kernel.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the serving shapes
// the bytes of q, k, v and out set it, 1.41 us at gemma-2b's (B 4, S 128,
// H 8 over KH 1, D 256) and 3.13 us at zamba2-2.7b's (4, 128, 32/32, 80);
// at S = 4096 the causal products set it, 69.5 us at (1, 4096, 8/1, 256)
// and 86.9 us at (1, 4096, 32/32, 80).  Either way the logits, the
// probabilities and the accumulator stay on chip.
//
// Design (bf16).  One block per (q-tile, group of query heads sharing a
// kv head, batch row): NCW consumer warpgroups of 4 warps, each owning 64
// query rows, and a producer warp (a warpgroup where registers move, see
// below) of which one thread issues the copies.  Each part answers one
// cost of the first version (mma.sync over one K/V buffer, 2-warp blocks,
// one block per query head):
// - Tensor cores through wgmma.  S = Q K^T is wgmma m64n64k16 with Q and
//   K read from shared memory through descriptors (both K-major); O += P V
//   takes P as the register A operand (the S accumulator rounded to bf16
//   in registers: its layout is the A layout) and V as an MN-major B.  At
//   D = 80 that is 5 k16 steps and n80.
// - A ring of 2 K/V stages, filled by TMA while the consumers run the
//   products (3 stages measured no faster, PERF.md).  K and V have a
//   "full" and an "empty" mbarrier each per stage: the producer waits on
//   "empty" and starts the copy on "full";
//   the consumers wait on "full" and release K as soon as its Q K^T is
//   done and V when its P V is, so the next K streams in under P V.
//   The tensor maps are 4-D over (D, heads, S, B): the S bound is per
//   batch row, so TMA's zero fill, not the next row's data, covers the
//   ragged tail, and the kv head is a box coordinate.
// - One K/V read per kv head and q-tile.  The query heads of a group are
//   packed into M: block row r is position p0 + r / pack of head
//   h0 + r % pack (the Q box is (D chunk, pack heads, positions), which
//   lands rows in exactly that order), so every head of the group reads
//   the same stage.  pack is the largest power of two dividing H / KH, at
//   most 64 (gemma-2b: 8, a block of 128 rows covers 16 positions); each
//   row's causal limit is its own position.  Unpacked heads measured no
//   faster at any shape (their repeated K/V reads come from L2).
// - With one or two consumer warpgroups, the next tile's Q K^T is issued
//   before this tile's softmax and runs on the tensor cores under it (a
//   second logits accumulator, 32 registers); its P V then waits for both.
//   At D = 64 and 80 a block may hold three consumer warpgroups (192
//   rows) instead: they hide each other's softmax, and at ~100 registers
//   a thread 13 warps fit an SM where a second accumulator would not.
// - 2^x on the special-function unit (ex2.approx, 2 ulp; -inf gives 0)
//   with scale * log2(e) folded into one FMA per logit.
// - The softcap is a template flag (kCap), so the uncapped instances are
//   the code they were without it.  A capped instance first forms each
//   scaled logit, caps it in registers with the accurate tanhf (no
//   fast-math approximation), and keeps the running max and the exp2's
//   FMA in those capped units (its scale_log2 is log2(e) alone).
// - The output goes back through shared memory (the warpgroup's own Q
//   rows, in the same swizzled layout) and leaves as TMA stores, which
//   drop the rows past S.
// - Swizzle: a row of 64 bf16 is one 128-byte swizzle atom, so D = 64,
//   128 and 256 are 1, 2 and 4 column chunks of 64 under SWIZZLE_128B.
//   D = 80's 160-byte rows match no 128-byte atom; it stays on TMA with
//   SWIZZLE_32B: 5 chunks of 16 columns, one k16 step each, and n80 in
//   P V steps over them by the descriptor's leading byte offset.  D =
//   224 (Zamba2-7B's 448-byte rows) is laid out the same way: 14 chunks
//   of 16 columns, n224 in P V.
// - Causal blocks launch the heaviest q-tiles first (blockIdx.y reversed),
//   so the long diagonal tail does not end the grid.
// - Registers: at D = 256 a warpgroup's 64 x 256 fp32 accumulator is 128
//   registers a thread, and a consumer needs ~190 in all.  A block of 3
//   warpgroups starts at 168 a thread (a quarter of the register file
//   over its 3 warps on each SM sub-partition), so with two consumer
//   warpgroups the producer warpgroup drops to 24 (setmaxnreg) and the
//   consumers rise to 240: 128 x 24 + 256 x 240 = 384 x 168.  (A lone
//   producer warp cannot give back enough: 9 warps start at 168 too.)
//   D = 224 (112 accumulator registers) does the same.
//   Elsewhere the producer is one warp: a whole warpgroup would hold its
//   registers for nothing and keep a second block off the SM.
// The query rows a block (64, 128 or 192) are an argument: the wrapper
// picks them from the grid (kernels/flash_attention.py::tile_config, as
// measured on the card, PERF.md).  The host encodes 4 tensor maps per
// launch (pointers change per call).
//
// Design (fp32, for the parity checks against the CPU): one warp per
// query row, FMA dot products reduced by shuffles, the online softmax one
// key at a time.  Simple and exact enough; not a fast path.
//
// flash_attention_launch returns a cudaError_t: cudaErrorInvalidValue for
// arguments the kernel does not take (or a tensor map the driver refuses),
// else cudaGetLastError() after the launch, so a refused launch reaches
// the Python wrapper, which raises.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 256;
constexpr int kBK = 64;          // keys per K/V stage
constexpr int kStages = 2;       // depth of the K/V ring
constexpr int kWG = 128;         // threads of a warpgroup; 64 query rows each
constexpr int kMaxSmem = 232448; // a block's shared memory on an H100
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 in one cvt.rn.bf16x2, lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- shared-memory layout of one head width ------------------------------
// A tile of R rows x D columns is NC column chunks of CH columns; chunk c
// holds R rows of CH * 2 bytes (one swizzle row each), 1024-byte aligned.
template <int D>
struct Tile {
  static constexpr int CH = D % 64 == 0 ? 64 : 16;
  static constexpr int NC = D / CH;
  static constexpr int ROW = CH * 2;     // bytes of a row in a chunk
  static constexpr int SBO = 8 * ROW;    // bytes between 8-row groups
  static constexpr uint64_t SWZ = CH == 64 ? 1 : 3;  // descriptor: 128B, 32B
  static constexpr int MASK = CH == 64 ? 7 : 1;      // 16-byte units XORed
  static constexpr CUtensorMapSwizzle TMA_SWZ =
      CH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
};

// The byte offset (from a 1024-aligned base) that TMA's swizzle gives the
// unswizzled offset off: Swizzle<3,4,3> (128B) or Swizzle<1,4,3> (32B).
template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & Tile<D>::MASK) << 4);
}

// wgmma matrix descriptor: start address, leading and stride byte offsets
// (16-byte units), layout type (1: 128B swizzle, 3: 32B swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swz << 62);
}

// ---- wgmma ---------------------------------------------------------------
// Accumulator layout (m64nN, fp32): warp w of the warpgroup holds rows
// 16w.. 16w+15; with g = lane / 4 and t = lane % 4, d[4j + e] is row
// 16w + g + 8 (e / 2), column 8j + 2t + (e % 2).  The register A operand
// of m64k16 is the mma.m16n8k16 A fragment of the same rows: a = {A[g][2t..],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}, pairs packed low first, so
// the accumulator of columns 16k.. 16k+15 is the A operand of k step k.

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers across the asynchronous product: nothing reads or writes
// them between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32) += A B, A (64 x 16) bf16 in registers, B (16 x N) bf16
// MN-major in shared memory (V: N contiguous), named by a descriptor.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

// d (64 x 64, fp32) = or += A B^T, A (64 x 16) and B (64 x 16) K-major in
// shared memory, named by descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31},"
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31},"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39},"
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<224>(float (&d)[112], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "
      "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111},"
      "{%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "
      "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- mbarrier, TMA -------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// One box of a 4-D tensor map into shared memory; completes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// One box from shared memory to a 4-D tensor map; elements out of bounds
// are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap& map, uint32_t src, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Block geometry shared by the host and the kernel.
template <int D>
__host__ __device__ constexpr int q_bytes(int ncw) { return ncw * 64 * D * 2; }
template <int D>
__host__ __device__ constexpr int kv_bytes() { return kBK * D * 2; }
template <int D>
__host__ __device__ constexpr int smem_bytes(int ncw) {
  // + the barriers, + slack to align the base to 1024 bytes
  return q_bytes<D>(ncw) + 2 * kStages * kv_bytes<D>() + 8 * (1 + 4 * kStages) + 1024;
}

// Only the D = 224 and 256 two-warpgroup blocks move registers (see the
// note); the others keep a lone producer warp, so more blocks fit on an SM.
__host__ __device__ constexpr bool rebalance(int d, int ncw) { return d >= 224 && ncw == 2; }
__host__ __device__ constexpr int block_threads(int d, int ncw) {
  return ncw * kWG + (rebalance(d, ncw) ? kWG : 32);
}

// grid: x = batch row * (H / pack) + head group, y = q-tile, heaviest first.
// kCap: logits capped at cap (cap_scale = the softmax scale over cap).
template <int D, int NCW, bool kCap>
__global__ void __launch_bounds__(block_threads(D, NCW), 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                  int S, int G, int pack_log2, int head_groups, float scale_log2,
                  int causal, float cap, float cap_scale) {
  using T = Tile<D>;
  constexpr int QB = q_bytes<D>(NCW), KVB = kv_bytes<D>();
  constexpr int QREG = NCW * 64 * T::ROW;  // a Q chunk: all the block's rows
  constexpr int KREG = kBK * T::ROW;       // a K or V chunk of one stage
  constexpr bool kRebalance = rebalance(D, NCW);
  // three warpgroups hide each other's latency; their registers leave no
  // room for a second logits accumulator
  constexpr bool kOverlap = NCW < 3;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t sq = base, sk = base + QB, sv = sk + kStages * KVB;
  const uint32_t bars = sv + kStages * KVB;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  const int b = blockIdx.x / head_groups;
  const int h0 = (blockIdx.x % head_groups) << pack_log2;
  const int kh = h0 / G;
  const int positions = (NCW * 64) >> pack_log2;  // per block
  const int p0 = (gridDim.y - 1 - blockIdx.y) * positions;
  const int kv_end = causal ? min(S, p0 + positions) : S;
  const int n_kv = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), NCW * kWG);
      mbar_init(v_empty(s), NCW * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= NCW * 4) {
    // ---- producer: Q once, then K/V tiles into the ring ----
    if constexpr (kRebalance) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == NCW * 4 && lane == 0) {
      mbar_expect(q_full, QB);
#pragma unroll
      for (int c = 0; c < T::NC; ++c) tma_load(sq + c * QREG, tq, q_full, c * T::CH, h0, p0, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        const int free = ((t / kStages) & 1) ^ 1;  // the first round passes
        mbar_wait(k_empty(s), free);
        mbar_expect(k_full(s), KVB);
#pragma unroll
        for (int c = 0; c < T::NC; ++c)
          tma_load(sk + s * KVB + c * KREG, tk, k_full(s), c * T::CH, kh, t * kBK, b);
        mbar_wait(v_empty(s), free);
        mbar_expect(v_full(s), KVB);
#pragma unroll
        for (int c = 0; c < T::NC; ++c)
          tma_load(sv + s * KVB + c * KREG, tv, v_full(s), c * T::CH, kh, t * kBK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns block rows [64 wg, 64 wg + 64) ----
    if constexpr (kRebalance) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t4 = lane % 4;
    const int row_a = wg * 64 + w * 16 + g, row_b = row_a + 8;  // block rows
    const int pos_a = p0 + (row_a >> pack_log2), pos_b = p0 + (row_b >> pack_log2);
    const uint32_t sq_wg = sq + wg * 64 * T::ROW;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of rows a, b (raw or capped logits)
    float l[2] = {0.f, 0.f};              // this thread's share of the denominators

    // S = Q K^T of stage s into sc (64 rows x 64 keys), issued, not waited
    auto issue_qk = [&](float (&sc)[32], int s) {
      const uint32_t ks = sk + s * KVB;
      wg_fence();
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / T::CH, off = (kk * 16 % T::CH) * 2;
        wgmma_ss_n64(sc, desc(sq_wg + c * QREG + off, 16, T::SBO, T::SWZ),
                     desc(ks + c * KREG + off, 16, T::SBO, T::SWZ), kk > 0);
      }
      wg_commit();
    };
    float sc[32], sn[kOverlap ? 32 : 1];  // this tile's logits, the next tile's in flight
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kOverlap ? 32 : 1); ++i) sn[i] = 0.f;
    mbar_wait(q_full, 0);
    if constexpr (kOverlap) {
      mbar_wait(k_full(0), 0);
      issue_qk(sc, 0);
      wg_wait();
      fence_regs(sc);
      mbar_arrive(k_empty(0));
    }
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % kStages, phase = (t / kStages) & 1;
      const int k0 = t * kBK;
      const uint32_t vs = sv + s * KVB;
      if constexpr (kOverlap) {
        // the next tile's Q K^T runs on the tensor cores during this softmax
        if (t + 1 < n_kv) {
          mbar_wait(k_full((t + 1) % kStages), ((t + 1) / kStages) & 1);
          issue_qk(sn, (t + 1) % kStages);
        }
      } else {
        mbar_wait(k_full(s), phase);
        issue_qk(sc, s);
        wg_wait();
        fence_regs(sc);
        mbar_arrive(k_empty(s));
      }

      if constexpr (kCap) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = cap * tanhf(sc[i] * cap_scale);
      }
      // mask (ragged tail, causal) and the online softmax, in fp32
      if (k0 + kBK > S || (causal && k0 + kBK - 1 > p0)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + 2 * t4 + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            if (col >= S || (causal && col > pos)) sc[4 * j + e] = -INFINITY;
          }
        }
      }
      // each row's 16 values here reduce in 4 independent chains (sc[4j + e]
      // is row e / 2), then across its quad
      float part[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i / 4][i % 4] = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float& p = part[(i / 2) % 2][(i / 4) % 2 * 2 + i % 2];
        p = fmaxf(p, sc[i]);
      }
      float mx[2], alpha[2], neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row's 64 logits span one quad
        mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = m_new == -INFINITY ? 1.f : exp2_fast((m[r] - m_new) * scale_log2);
        neg[r] = m_new == -INFINITY ? 0.f : -m_new * scale_log2;
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i / 4][i % 4] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2_fast(fmaf(sc[i], scale_log2, neg[r]));  // 0 where masked
        part[r][(i / 4) % 2 * 2 + i % 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      uint32_t pa[4][4];  // P in bf16, the A operand of each k16 step
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      }

      // O += P V: V rows k16 steps of 16 keys; its column chunks lie KREG apart
      mbar_wait(v_full(s), phase);
      wg_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(o, pa[kk], desc(vs + kk * 16 * T::ROW, KREG, T::SBO, T::SWZ));
      wg_commit();
      wg_wait();  // this P V and the next Q K^T
      fence_regs(o);
      mbar_arrive(v_empty(s));  // this thread is done with V of stage s
      if constexpr (kOverlap) {
        fence_regs(sn);
        if (t + 1 < n_kv) mbar_arrive(k_empty((t + 1) % kStages));  // and K of the next
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = sn[i];
      }
    }

    // out = o / l, staged in this warpgroup's own Q rows (same swizzled
    // layout), then one TMA store per column chunk
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);  // fully masked row: the TPU kernel's guard
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kWG) : "memory");  // Q reads done
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t4, c = col / T::CH, off = (col % T::CH) * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? row_b : row_a;
        const uint32_t at = c * QREG + swizzle<D>(row * T::ROW + off);
        *reinterpret_cast<uint32_t*>(smem + at) =
            pack(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kWG) : "memory");
    if (threadIdx.x % kWG == 0) {
#pragma unroll
      for (int c = 0; c < T::NC; ++c)
        tma_store(to, sq_wg + c * QREG, c * T::CH, h0, p0 + ((wg * 64) >> pack_log2), b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---- host ----------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API: fetched through the runtime, so
// the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-D map over a (B, S, heads, D) bf16 tensor, dims innermost first;
// the box is (one column chunk, box_heads, box_rows positions, 1).
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int box_heads,
              int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Tile<D>::CH, (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<D>::TMA_SWZ,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NCW, bool kCap>
cudaError_t launch_bf16_tiled(const void* q, const void* k, const void* v, void* o, int B,
                              int S, int H, int KH, float scale, int causal, float cap,
                              cudaStream_t st) {
  constexpr int bytes = smem_bytes<D>(NCW);
  static_assert(bytes <= kMaxSmem, "Q and the K/V ring overflow shared memory");
  // pack: the largest power of two dividing the group H / KH, at most 64
  const int G = H / KH;
  int pack_log2 = 0;
  while (pack_log2 < 6 && G % (2 << pack_log2) == 0) ++pack_log2;
  const int pack = 1 << pack_log2, positions = (NCW * 64) / pack;
  const int64_t tiles = (S + positions - 1) / positions, groups = (int64_t)B * (H / pack);
  if (tiles > 65535 || groups > 0x7fffffff) return cudaErrorInvalidValue;
  static bool granted = false;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<D, NCW, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    granted = true;
  }
  CUtensorMap tq, tk, tv, to;
  if (!make_map<D>(&tq, q, B, S, H, pack, NCW * 64 / pack) ||
      !make_map<D>(&tk, k, B, S, KH, 1, kBK) || !make_map<D>(&tv, v, B, S, KH, 1, kBK) ||
      !make_map<D>(&to, o, B, S, H, pack, 64 / pack)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)groups, (unsigned)tiles);
  // capped: the logits are scaled before the cap, so exp2 takes log2(e) alone
  flash_bf16_kernel<D, NCW, kCap><<<grid, block_threads(D, NCW), bytes, st>>>(
      tq, tk, tv, to, S, G, pack_log2, H / pack, kCap ? kLog2e : scale * kLog2e, causal,
      cap, kCap ? scale / cap : 0.f);
  return cudaGetLastError();
}

template <int D, int NCW>
cudaError_t launch_bf16_capped(const void* q, const void* k, const void* v, void* o, int B,
                               int S, int H, int KH, float scale, int causal, float cap,
                               cudaStream_t st) {
  if (cap > 0.f)
    return launch_bf16_tiled<D, NCW, true>(q, k, v, o, B, S, H, KH, scale, causal, cap, st);
  return launch_bf16_tiled<D, NCW, false>(q, k, v, o, B, S, H, KH, scale, causal, cap, st);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, int KH, float scale, int causal, float cap, int q_rows,
                        cudaStream_t st) {
  if (q_rows == 64)
    return launch_bf16_capped<D, 1>(q, k, v, o, B, S, H, KH, scale, causal, cap, st);
  if (q_rows == 128)
    return launch_bf16_capped<D, 2>(q, k, v, o, B, S, H, KH, scale, causal, cap, st);
  if constexpr (D <= 80) {  // three warpgroups fit the register file only here
    if (q_rows == 192)
      return launch_bf16_capped<D, 3>(q, k, v, o, B, S, H, KH, scale, causal, cap, st);
  }
  return cudaErrorInvalidValue;
}

constexpr int kRowsPerBlockF32 = 4;  // one warp per query row
constexpr int kPerLane = kMaxD / 32;

template <bool kCap>
__global__ void __launch_bounds__(32 * kRowsPerBlockF32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KH, int d, float scale, int causal, float cap) {
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
    float s = warp_sum(dot) * scale;
    if constexpr (kCap) s = cap * tanhf(s / cap);
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
// {64, 80, 128, 224, 256} in bf16 with 16-byte aligned pointers.  bf16
// only: q_rows, the query rows a block (64 or 128; 192 at D 64 and 80).
// softcap: 0 for none, else the cap c > 0.  scale: the logits' scale, 0
// for 1 / sqrt(D).  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KH, int d, int causal,
                                      int dtype, int q_rows, float softcap, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || d <= 0 || d > kMaxD ||
      B > 65535 || H > 65535 || !(softcap >= 0.f) || !(scale >= 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (scale == 0.f) scale = 1.f / sqrtf((float)d);
  if (dtype == 1) {
    switch (d) {
      case 64:
        return (int)launch_bf16<64>(q, k, v, o, B, S, H, KH, scale, causal, softcap, q_rows,
                                      st);
      case 80:
        return (int)launch_bf16<80>(q, k, v, o, B, S, H, KH, scale, causal, softcap, q_rows,
                                      st);
      case 128:
        return (int)launch_bf16<128>(q, k, v, o, B, S, H, KH, scale, causal, softcap, q_rows,
                                      st);
      case 224:
        return (int)launch_bf16<224>(q, k, v, o, B, S, H, KH, scale, causal, softcap, q_rows,
                                      st);
      case 256:
        return (int)launch_bf16<256>(q, k, v, o, B, S, H, KH, scale, causal, softcap, q_rows,
                                      st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kRowsPerBlockF32 - 1) / kRowsPerBlockF32, H, B);
  if (softcap > 0.f) {
    flash_f32_kernel<true><<<grid, 32 * kRowsPerBlockF32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, KH, d,
        scale, causal, softcap);
  } else {
    flash_f32_kernel<false><<<grid, 32 * kRowsPerBlockF32, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, KH, d,
        scale, causal, 0.f);
  }
  return (int)cudaGetLastError();
}

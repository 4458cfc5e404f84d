// Flash attention forward and its FlashAttention-2 backward for Hopper
// (sm_90a), bound to Python through plain C entry points (ctypes; see
// deeplearning4j_tpu_torch/_build.py and
// deeplearning4j_tpu_torch/parallel/kernels.py).
//
// Three entries, each replacing one TPU kernel of
// deeplearning4j_tpu/parallel/kernels.py:
//
//   dl4j_flash_fwd     <- _attn_kernel (launched by _flash_forward):
//                         out = softmax(q k^T / sqrt(D)) v, causal or not,
//                         and lse = m + log(l) of the scaled f32 scores;
//   dl4j_flash_bwd_dkv <- _dkv_kernel (launched by _bwd_block): dK, dV with
//                         the K/V tile resident and Q/dO streaming;
//   dl4j_flash_bwd_dq  <- _dq_kernel (launched by _bwd_block): dQ with the
//                         Q tile resident and K/V streaming.
//
// Both backward kernels recompute P = exp(S * scale - lse) tile by tile
// from the row stats they are given (lse and delta = rowsum(dO * O)), so
// a caller may pass global stats (ring attention does).
//
// Layout.  q, k, v, dO, out and the gradients are read and written as
// contiguous [B, S, H, D] with the row stride H * D: no transpose copy
// into [B*H, S, D].  lse and delta are [B*H, S] float32, row b*H + h.
// Any S is taken: the last tile of a sequence is predicated (rows past S
// load as zero and are masked), so no tile size has to divide S.
// Masked scores are -1e30 and their probabilities are set to 0, as on the
// TPU; the normaliser is clamped at 1e-30.  dK and dQ carry the 1/sqrt(D)
// factor, dV does not.
//
// Each entry has three routes, chosen from the dtype, D and the pointers'
// alignment (never by a switch): the tensor cores for bfloat16 with D a
// multiple of 8 (up to 256 for the forward, 128 for the backward) and
// every tensor it reads or writes 16-byte aligned, which covers every
// real head width (16, 32, 40, 64, 80, 96, 128; 256 forward); else the
// FMA pipes for D <= 128 and the D-chunked FMA route for 128 < D <= 512
// (kMaxD), in every dtype.  The f32 train path keeps the FMA routes for
// their <= 1e-6 agreement with the plain version (TF32 would not give
// it).  float16 takes the FMA routes at every D: the wgmma kernels hold
// bf16-specific conversions and are not instantiated for it.
//
// 1. Forward on the tensor cores (flash_fwd_mma_kernel).  At the training
//    shape (B 2, S 1024, H 12, D 64, causal) the forward does ~256 flops
//    per byte it must move, near the card's ridge: its bound is 3.8 us of
//    bytes against 3.3 us of bf16 tensor-core work, while the f32 FMA
//    pipes need 48 us for the products alone.  So the products must run
//    on the tensor cores and the loads must overlap them.  Design: the
//    FlashAttention-2 order of work on Hopper's warpgroup products
//    (wgmma.mma_async, bf16 in, f32 accumulate; not mma.sync).  One
//    warpgroup (4 warps) owns a 64-row query tile, each warp 16 rows of
//    the m64 accumulators.  S = Q K^T is wgmma m64n64k16 with Q and K
//    read from shared memory by descriptors; the 1/sqrt(D) scale (times
//    log2 e) is applied to the f32 score fragments inside the exponent,
//    p = 2^(s * scale * log2 e - m), one FFMA and one MUFU op an element
//    (q is not rounded a second time); the online softmax runs on the
//    fragments with the row max and sum as short trees and then over the
//    4 lanes that share a row; P is rounded to bf16 in registers and is
//    the register A operand of O += P V (wgmma m64nNk16, N = D padded),
//    with V read from shared memory MN-major (transposed by the
//    instruction); the output accumulator stays in registers.  Q, K and
//    V tiles of 64 rows stay bf16 in shared memory in the 128-byte
//    swizzled layout wgmma reads without bank conflicts, D zero-padded
//    to 64, 128, 192 or 256 columns (O is then 128 f32 a thread at
//    D 256, beside the 32 of S); K and V are copied by 16-byte cp.async into a
//    two-stage ring (tile j + 1 loads while tile j is computed; one
//    barrier a tile, and a proxy fence so wgmma sees cp.async's writes).
//    Causal: fully masked tiles are skipped, the mask is applied only on
//    the diagonal tile (and on a ragged last tile), and query tiles are
//    issued longest first (the tile index is the grid's slow axis,
//    reversed).  Tried on the H100 and left out, none faster at the
//    training shape: the same order on mma.sync with ldmatrix (faster
//    only at D 16-80, which the zero padding costs), wgmma on unswizzled
//    shared memory, the next tile's Q K^T issued during the softmax, two
//    m-tiles a warp, 8 warps a block, 128 keys a stage, a deeper ring,
//    and a persistent grid taking tiles from a queue.
// 2. Backward on the tensor cores (flash_bwd_dkv_mma_kernel,
//    flash_bwd_dq_mma_kernel).  The pair does 7 products of 2 S^2 D a
//    head (4 for dK/dV, 3 for dQ) against 5 tensors of bytes, so it is
//    bound by operations even more than the forward: 11 us of bf16
//    tensor-core work at the training shape, ~170 us on the f32 FMA pipes
//    the first design used.  Every backward product has the shape of a
//    forward product, so the design reuses the forward's tiles,
//    descriptors and ring.  dK/dV: one warpgroup owns a 64-row key tile
//    with K and V resident; Q, dO and their lse / delta rows stream
//    through the two-stage cp.async ring.  Per query tile, one wgmma group
//    computes S^T = K Q^T and dP^T = V dO^T (m64n64, both operands K-major
//    from shared memory); the lanes form P^T = 2^(s scale log2 e - lse
//    log2 e) and dS^T = P^T (dP^T - delta) on the f32 fragments (lse and
//    delta vary along the columns, the queries) and round both to bf16 A
//    fragments; a second group computes dV += P^T dO and dK += dS^T Q with
//    dO and Q read MN-major from the same staged tiles.  dQ: one warpgroup
//    owns a 64-row query tile with Q, dO resident and each lane's lse and
//    delta in registers; K and V stream; S = Q K^T and dP = dO V^T in one
//    group, dS = P (dP - delta) in registers, dQ += dS K with K read
//    MN-major.  Two kernels, one launch each, no atomics, deterministic.
//    Causal: dK/dV starts at the diagonal query tile and issues the
//    lowest key tiles (the longest) first; dQ stops at the diagonal and
//    issues the highest query tiles first; the mask only on the diagonal
//    and a ragged last tile.  Not yet done: overlapping one tile's P / dS
//    arithmetic with the next tile's products, TMA, warp specialisation,
//    and FA2/FA3's dQ fused into the dK/dV pass through f32 atomics.
// 3. FMA (flash_fwd_kernel, flash_bwd_dkv_kernel, flash_bwd_dq_kernel):
//    one 256-thread block owns one 64-row tile and walks the other axis
//    with its accumulators in registers; thread (ty, tx) of a 16 x 16
//    grid owns rows ty + 16 i and columns tx + 16 j of every 64 x 64
//    score tile, so row reductions are half-warp shuffles over f32 tiles
//    padded to D + 1 floats in shared memory; q is scaled before the
//    forward's product.
// 4. D-chunked FMA (flash_*_chunk_kernel), 128 < D <= 512 where the
//    tensor cores do not take it.  The FMA kernels' accumulators (8
//    columns a thread, and dK + dV together) and their f32 tiles (dK/dV
//    at D 256: 296 960 bytes, over the 232 448 a block may have) stop at
//    D 128, and so does the tensor-core backward (dK and dV of a 64-row
//    tile at D 256 would be 128 + 128 f32 a thread of one warpgroup, the
//    forward's O 256 at D 512).  So the OUTPUT columns are cut into
//    128-column chunks, one block a (tile, chunk): each block streams
//    every chunk of d through the same 128-column f32 tiles to form the
//    full-D scores (and dP), then accumulates only its own chunk of out,
//    dK/dV or dQ, with the FMA kernels' thread layout, registers and
//    shared memory of D 128.  The scores are recomputed once per chunk
//    (2-4x the work at D 256-512) and the tiles re-read: slow and
//    correct.  Every block forms the same scores in the same order, so
//    their softmax statistics agree bit for bit.  The chunk loop of the
//    backward ends on the block's own chunk, whose Q/dO (dK/dV) or K (dQ)
//    tile the accumulation then reads in place.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "launch_once.cuh"

namespace {

constexpr int kTile = 64;              // rows of a query or key tile
constexpr int kSub = 16;               // threads along each tile edge
constexpr int kThreads = kSub * kSub;  // 256
constexpr int kPer = kTile / kSub;     // tile rows (and cols) per thread
constexpr int kMaxD = 512;
constexpr int kChunk = 128;            // head dims a block of the chunk route
constexpr int kMaxMmaFwdD = 256;       // widest head of the wgmma forward
constexpr int kRouteFma = 0, kRouteTensorCores = 1, kRouteChunks = 2;
constexpr int kLdp = kTile + 1;        // padded row of a score tile
constexpr float kNegInf = -1e30f;      // the TPU kernels' NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// Reductions over the 16 lanes that own one row (offsets < 16 stay
// inside the half-warp).
__device__ __forceinline__ float row_max(float v) {
  for (int o = kSub / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = kSub / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// tensor-core building blocks (cp.async, wgmma)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; writes zeros when !pred (src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4-byte global -> shared copy (one f32 row statistic); zeros when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x in one MUFU op (flushes results below 2^-126 to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;

// wgmma (warpgroup matrix multiply) building blocks

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads of wgmma accumulators across the
// asynchronous product (they are written until wgmma_wait0 returns).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a bf16 matrix in shared memory without swizzle, made of
// 8 x 8 core matrices (8 rows of 16 bytes, 128 contiguous bytes): lbo and
// sbo are the byte strides between core matrices along the leading and
// the strided dimension.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);                                      // 128B swizzle
}

// d (64 x 64 f32, 32 a thread) (+)= A B for one k16 step, A and B both
// K-major bf16 in shared memory (descriptors); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N f32, N / 2 a thread) += A B for one k16 step: A from
// registers (per warp, the m16n8k16 A fragment layout), B MN-major bf16
// in shared memory (imm-trans-b = 1).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}"
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Stage rows t0 .. t0 + kTile of head (b, h) of a [B, S, H, D] tensor as
// f32 into dst (row stride ld), times `mul`; rows at or past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int b,
                                          int h, int t0, int S, int H,
                                          int D, float mul) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int t = t0 + r;
    float x = 0.f;
    if (t < S) x = to_f32(src[(((size_t)b * S + t) * H + h) * D + d]) * mul;
    dst[r * ld + d] = x;
  }
}

// Stage columns [d0, d0 + w) of rows t0 .. t0 + kTile of head (b, h) as
// f32 into dst (row stride ld), times `mul`; rows at or past S are zero.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, int ld,
                                           const T* __restrict__ src, int b,
                                           int h, int t0, int S, int H,
                                           int D, int d0, int w, float mul) {
  for (int e = threadIdx.x; e < kTile * w; e += kThreads) {
    const int r = e / w;
    const int d = e - r * w;
    const int t = t0 + r;
    float x = 0.f;
    if (t < S)
      x = to_f32(src[(((size_t)b * S + t) * H + h) * D + d0 + d]) * mul;
    dst[r * ld + d] = x;
  }
}

// Stage rows t0 .. t0 + kTile of row bh of a [B*H, S] f32 statistic.
__device__ __forceinline__ void load_stat(float* dst,
                                          const float* __restrict__ src,
                                          size_t bh, int t0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int t = t0 + r;
    dst[r] = t < S ? src[bh * S + t] : 0.f;
  }
}

__device__ __forceinline__ bool live(int qp, int kp, int S, int causal) {
  return qp < S && kp < S && (!causal || qp >= kp);
}

// Shared memory of each kernel, in floats.
size_t fwd_floats(int D) {
  return 3 * (size_t)kTile * (D + 1) + (size_t)kTile * kLdp;
}
size_t dkv_floats(int D) {
  return 4 * (size_t)kTile * (D + 1) + 2 * (size_t)kTile * kLdp + 2 * kTile;
}
size_t dq_floats(int D) {
  return 4 * (size_t)kTile * (D + 1) + (size_t)kTile * kLdp + 2 * kTile;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(S / kTile), H, B); one block per query tile

template <typename T, int DPER>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int D, float scale,
                 int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                   // [kTile][ld], pre-scaled
  float* k_s = q_s + kTile * ld;       // [kTile][ld]
  float* v_s = k_s + kTile * ld;       // [kTile][ld]
  float* p_s = v_s + kTile * ld;       // [kTile][kLdp]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;

  load_tile(q_s, ld, q, b, h, q0, S, H, D, scale);

  float m[kPer], l[kPer], acc[kPer][DPER];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPER; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (S + kTile - 1) / kTile;
  // causal: key tiles past this query tile's last row are fully masked
  const int n_tiles = causal ? min(n_kv, (int)blockIdx.x + 1) : n_kv;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(k_s, ld, k, b, h, k0, S, H, D, 1.f);
    load_tile(v_s, ld, v, b, h, k0, S, H, D, 1.f);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[kPer], kb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qa[i] = q_s[(ty + kSub * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) kb[j] = k_s[(tx + kSub * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kSub * i;
      const int qp = q0 + r;
      bool ok[kPer];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        ok[j] = live(qp, k0 + tx + kSub * j, S, causal);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * kLdp + tx + kSub * j] = p;
        psum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPER; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float pa[kPer], vb[DPER];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pa[i] = p_s[(ty + kSub * i) * kLdp + kk];
#pragma unroll
      for (int c = 0; c < DPER; ++c) {
        const int d = tx + kSub * c;
        vb[c] = d < D ? v_s[kk * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < DPER; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qp = q0 + ty + kSub * i;
    if (qp >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const size_t row = (((size_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPER; ++c) {
      const int d = tx + kSub * c;
      if (d < D) out[row + d] = from_f32<T>(acc[i][c] / lc);
    }
    if (tx == 0) lse[((size_t)b * H + h) * S + qp] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// forward on the tensor cores (bfloat16, D % 8 == 0): grid (B * H,
// ceil(S / 64)); blockIdx.y counts query tiles from the last one, so the
// longest causal tiles are issued first.  One warpgroup (4 warps, 16 query
// rows each) a block; a stage holds 64 keys; NK = ceil(D / 16).
//
// Tiles sit in shared memory as 8 x 8 core matrices: row r, 16-byte chunk
// c of a [64][16 NK] tile at ((r / 8) * 2 NK + c) * 64 + (r % 8) * 8
// elements, so along a row the core matrices are 128 bytes apart and
// along the rows 256 NK bytes.  Q and K are read K-major (d contiguous),
// V MN-major (keys are the reduction, d contiguous), from the same
// layout.

constexpr int kMmaThreads = 128;       // one warpgroup
constexpr int kStages = 2;             // K/V ring: tile j + 1 loads during j
constexpr float kLn2 = 0.6931471805599453f;

// Element offset of row r, 16-byte chunk c of a [64][64 NA] tile: 128B
// swizzle atoms of 64 columns (8 KB each, 128 bytes a row, the chunks of
// row r XOR-ed with r % 8), the atoms of a row 64 * 64 elements apart.
__host__ __device__ constexpr int sw_off(int r, int c) {
  return (c >> 3) * kTile * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Start of k16 step kk of a K-major tile (Q, K): atom kk / 4, 32 bytes
// a step inside the atom's unswizzled row (the hardware applies the XOR).
__host__ __device__ constexpr int k_off(int kk) {
  return (kk >> 2) * kTile * 64 + (kk & 3) * 16;
}

template <int NA>
size_t fwd_mma_bytes() {               // q, then the K and V rings
  return (size_t)(1 + 2 * kStages) * kTile * 64 * NA * sizeof(bf16);
}

template <int NA>
size_t dkv_mma_bytes() {               // K, V; the Q, dO, lse, delta rings
  return (size_t)(2 + 2 * kStages) * kTile * 64 * NA * sizeof(bf16) +
         (size_t)2 * kStages * kTile * sizeof(float);
}

template <int NA>
size_t dq_mma_bytes() {                // Q, dO; the K and V rings
  return (size_t)(2 + 2 * kStages) * kTile * 64 * NA * sizeof(bf16);
}

// Zero the pad chunks [D / 8, 8 NA) of `n` consecutive tiles from `base`:
// no copy ever writes them, so every product over d reads zeros there.
template <int NA>
__device__ __forceinline__ void zero_pads(bf16* base, int n, int D) {
  constexpr int CH = 8 * NA;
  const int chunks = D / 8;
  const int pads = CH - chunks;
  for (int e = threadIdx.x; e < n * kTile * pads; e += kMmaThreads) {
    const int r = e / pads;                        // row over all tiles
    *reinterpret_cast<uint4*>(base + (r / kTile) * kTile * CH * 8 +
                              sw_off(r % kTile, chunks + e - r * pads)) =
        make_uint4(0, 0, 0, 0);
  }
}

// cp.async rows t0 .. t0 + kTile of one head (`head` points at row 0,
// rows `rs` elements apart) into the swizzled tile dst; rows at or past S
// are zeros, the pad chunks are left alone.
template <int NA>
__device__ __forceinline__ void stage_tile(bf16* dst,
                                           const bf16* __restrict__ head,
                                           size_t rs, int t0, int S,
                                           int D) {
  constexpr int CH = 8 * NA;
  const int chunks = D / 8;
  for (int e = threadIdx.x; e < kTile * CH; e += kMmaThreads) {
    const int r = e / CH;
    const int c = e - r * CH;
    if (c >= chunks) continue;
    const int t = t0 + r;
    const bool ok = t < S;
    cp_async16(dst + sw_off(r, c), head + (size_t)(ok ? t : 0) * rs + c * 8,
               ok);
  }
}

// Rows row0 and row0 + 8 of a 64 x DP f32 accumulator (this lane's
// fragment) as bf16, times mul[i], into one head's rows below S.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2],
                                           bf16* head, size_t rs, int row0,
                                           int S, int D,
                                           const float (&mul)[2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= S) continue;
    bf16* row = head + (size_t)r * rs;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      if (dt * 8 < D)
        *reinterpret_cast<uint32_t*>(row + dt * 8 + 2 * t4) =
            pack_bf16(acc[4 * dt + 2 * i] * mul[i],
                      acc[4 * dt + 2 * i + 1] * mul[i]);
    }
  }
}

template <int NA>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int D,
                     float scale, int causal) {
  constexpr int DP = 64 * NA;          // D zero-padded to whole atoms
  constexpr int NK = DP / 16;          // k16 steps of Q K^T
  constexpr int TILE = kTile * DP;     // elements of a tile
  constexpr int NT = kTile / 8;        // n-tiles of 8 keys a stage
  constexpr int SBO = 8 * 128;         // bytes between 8-row groups
  constexpr int ATOM = kTile * 64 * 2; // bytes between 64-column atoms
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [TILE]
  bf16* k_s = q_s + TILE;                          // [kStages][TILE]
  bf16* v_s = k_s + kStages * TILE;                // [kStages][TILE]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;       // longest first
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                         // fragment row
  const int t4 = lane & 3;                         // fragment column pair
  const int row0 = q0 + warp * 16 + g;             // rows row0, row0 + 8
  const size_t rs = (size_t)H * D;                 // row stride
  const size_t head = (size_t)b * S * rs + (size_t)h * D;
  const float sl2 = scale * kLog2e;                // scores in log2 units

  if (DP > D) zero_pads<NA>(q_s, 1 + 2 * kStages, D);
  auto stage_kv = [&](int j) {
    const int st = j % kStages;
    stage_tile<NA>(k_s + st * TILE, k + head, rs, j * kTile, S, D);
    stage_tile<NA>(v_s + st * TILE, v + head, rs, j * kTile, S, D);
  };

  const int n_kv = (S + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, qt + 1) : n_kv;
  // prologue: q with tile 0, then tiles 1 .. kStages - 2, a group each
  stage_tile<NA>(q_s, q + head, rs, q0, S, D);
  stage_kv(0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (i < n_tiles) stage_kv(i);
    cp_async_commit();
  }

  float o[DP / 2];                     // 64 x DP, 8-column n-tiles of 4
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  // row max in log2 units (of the scaled scores), and this lane's share
  // of the row sum
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();      // tile j has landed
    fence_async_shared();              // ... visible to wgmma
    __syncthreads();                   // ... for every warp; j - 1 is read
    if (j + kStages - 1 < n_tiles) stage_kv(j + kStages - 1);
    cp_async_commit();
    const int st = j % kStages;
    const bf16* ks = k_s + st * TILE;
    const bf16* vs = v_s + st * TILE;

    // S = Q K^T over the stage's 64 keys (raw, f32): s[4 nt + e]
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_ss_n64(s, smem_desc(q_s + k_off(kk), 16, SBO),
                   smem_desc(ks + k_off(kk), 16, SBO), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // mask only the diagonal tile and a ragged last tile
    const int k0 = j * kTile;
    if ((causal && j == qt) || k0 + kTile > S) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qp = row0 + (e >> 1) * 8;
          if (kp >= S || (causal && kp > qp)) s[4 * nt + e] = kNegInf;
        }
    }

    // online softmax on the fragments, p overwriting s.  The scale is
    // applied in f32 inside the exponent: p = 2^(s * scale * log2 e - m).
    // Every row has a live key in tile 0 (key 0), so m is finite from
    // then on and a masked score's p underflows to exactly 0.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // row max and sum as trees over the n-tiles (short chains)
      float mxs[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mxs[nt] = fmaxf(s[4 * nt + 2 * i], s[4 * nt + 2 * i + 1]);
#pragma unroll
      for (int w2 = NT / 2; w2 > 0; w2 >>= 1)
#pragma unroll
        for (int nt = 0; nt < w2; ++nt) mxs[nt] = fmaxf(mxs[nt], mxs[nt + w2]);
      float mx = mxs[0];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * sl2);
      const float alpha = fast_exp2(m[i] - m_new);
      float pss[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float p0 = fast_exp2(fmaf(s[4 * nt + 2 * i], sl2, -m_new));
        const float p1 = fast_exp2(fmaf(s[4 * nt + 2 * i + 1], sl2, -m_new));
        s[4 * nt + 2 * i] = p0;
        s[4 * nt + 2 * i + 1] = p1;
        pss[nt] = p0 + p1;
      }
#pragma unroll
      for (int w2 = NT / 2; w2 > 0; w2 >>= 1)
#pragma unroll
        for (int nt = 0; nt < w2; ++nt) pss[nt] += pss[nt + w2];
      l[i] = l[i] * alpha + pss[0];
      m[i] = m_new;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        o[4 * dt + 2 * i] *= alpha;
        o[4 * dt + 2 * i + 1] *= alpha;
      }
    }

    // O += P V: P from registers as bf16 A fragments (16 keys a step), V
    // MN-major from shared memory
    uint32_t a[NT / 2][4];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wgmma_rs<DP>(o, a[kk], smem_desc(vs + 16 * kk * 64, ATOM, SBO));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }
  cp_async_wait<0>();                  // no copy outlives the block

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float lc = fmaxf(li, 1e-30f);
    inv[i] = 1.f / lc;
    const int qp = row0 + 8 * i;
    // lse = m + log(l) of the scaled scores, m back in natural units
    if (qp < S && t4 == 0)
      lse[((size_t)b * H + h) * S + qp] = m[i] * kLn2 + logf(lc);
  }
  store_rows<DP>(o, out + head, rs, row0, S, D, inv);
}

// ---------------------------------------------------------------------------
// backward dK, dV: grid (ceil(S / kTile), H, B); one block per key tile

template <typename T, int DPER>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int D, float scale,
                     int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;                   // [kTile][ld], resident
  float* v_s = k_s + kTile * ld;       // [kTile][ld], resident
  float* q_s = v_s + kTile * ld;       // [kTile][ld]
  float* g_s = q_s + kTile * ld;       // [kTile][ld]
  float* p_s = g_s + kTile * ld;       // P^T  [kTile keys][kLdp]
  float* ds_s = p_s + kTile * kLdp;    // dS^T [kTile keys][kLdp]
  float* lse_s = ds_s + kTile * kLdp;  // [kTile]
  float* dl_s = lse_s + kTile;         // [kTile]

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;

  load_tile(k_s, ld, k, b, h, k0, S, H, D, 1.f);
  load_tile(v_s, ld, v, b, h, k0, S, H, D, 1.f);

  float dk_acc[kPer][DPER], dv_acc[kPer][DPER];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < DPER; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (S + kTile - 1) / kTile;
  // causal: query tiles before this key tile are fully masked
  const int first = causal ? (int)blockIdx.x : 0;
  for (int it = first; it < n_q; ++it) {
    const int q0 = it * kTile;
    __syncthreads();
    load_tile(q_s, ld, q, b, h, q0, S, H, D, 1.f);
    load_tile(g_s, ld, g, b, h, q0, S, H, D, 1.f);
    load_stat(lse_s, lse, bh, q0, S);
    load_stat(dl_s, delta, bh, q0, S);
    __syncthreads();

    // S^T and dP^T: thread owns key rows ty + 16 i, query cols tx + 16 j
    float st[kPer][kPer], dpt[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float ka[kPer], va[kPer], qb[kPer], gb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        ka[i] = k_s[(ty + kSub * i) * ld + d];
        va[i] = v_s[(ty + kSub * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        qb[j] = q_s[(tx + kSub * j) * ld + d];
        gb[j] = g_s[(tx + kSub * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], gb[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kr = ty + kSub * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qc = tx + kSub * j;
        const float p = live(q0 + qc, k0 + kr, S, causal)
                            ? expf(st[i][j] * scale - lse_s[qc])
                            : 0.f;
        p_s[kr * kLdp + qc] = p;
        ds_s[kr * kLdp + qc] = p * (dpt[i][j] - dl_s[qc]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over this query tile
    for (int qq = 0; qq < kTile; ++qq) {
      float pa[kPer], sa[kPer], gb[DPER], qb[DPER];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pa[i] = p_s[(ty + kSub * i) * kLdp + qq];
        sa[i] = ds_s[(ty + kSub * i) * kLdp + qq];
      }
#pragma unroll
      for (int c = 0; c < DPER; ++c) {
        const int d = tx + kSub * c;
        gb[c] = d < D ? g_s[qq * ld + d] : 0.f;
        qb[c] = d < D ? q_s[qq * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < DPER; ++c) {
          dv_acc[i][c] = fmaf(pa[i], gb[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sa[i], qb[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kp = k0 + ty + kSub * i;
    if (kp >= S) continue;
    const size_t row = (((size_t)b * S + kp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPER; ++c) {
      const int d = tx + kSub * c;
      if (d < D) {
        dk[row + d] = from_f32<T>(dk_acc[i][c] * scale);
        dv[row + d] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward dQ: grid (ceil(S / kTile), H, B); one block per query tile

template <typename T, int DPER>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                   // [kTile][ld], resident
  float* g_s = q_s + kTile * ld;       // [kTile][ld], resident
  float* k_s = g_s + kTile * ld;       // [kTile][ld]
  float* v_s = k_s + kTile * ld;       // [kTile][ld]
  float* ds_s = v_s + kTile * ld;      // dS [kTile queries][kLdp]
  float* lse_s = ds_s + kTile * kLdp;  // [kTile]
  float* dl_s = lse_s + kTile;         // [kTile]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;

  load_tile(q_s, ld, q, b, h, q0, S, H, D, 1.f);
  load_tile(g_s, ld, g, b, h, q0, S, H, D, 1.f);
  load_stat(lse_s, lse, bh, q0, S);
  load_stat(dl_s, delta, bh, q0, S);

  float dq_acc[kPer][DPER];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < DPER; ++c) dq_acc[i][c] = 0.f;

  const int n_kv = (S + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, (int)blockIdx.x + 1) : n_kv;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();
    load_tile(k_s, ld, k, b, h, k0, S, H, D, 1.f);
    load_tile(v_s, ld, v, b, h, k0, S, H, D, 1.f);
    __syncthreads();

    // S and dP: thread owns query rows ty + 16 i, key cols tx + 16 j
    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[kPer], ga[kPer], kb[kPer], vb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qa[i] = q_s[(ty + kSub * i) * ld + d];
        ga[i] = g_s[(ty + kSub * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        kb[j] = k_s[(tx + kSub * j) * ld + d];
        vb[j] = v_s[(tx + kSub * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qr = ty + kSub * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kc = tx + kSub * j;
        const float p = live(q0 + qr, k0 + kc, S, causal)
                            ? expf(s[i][j] * scale - lse_s[qr])
                            : 0.f;
        ds_s[qr * kLdp + kc] = p * (dp[i][j] - dl_s[qr]);
      }
    }
    __syncthreads();

    // dQ += dS K over this key tile
    for (int kk = 0; kk < kTile; ++kk) {
      float sa[kPer], kb[DPER];
#pragma unroll
      for (int i = 0; i < kPer; ++i) sa[i] = ds_s[(ty + kSub * i) * kLdp + kk];
#pragma unroll
      for (int c = 0; c < DPER; ++c) {
        const int d = tx + kSub * c;
        kb[c] = d < D ? k_s[kk * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < DPER; ++c) dq_acc[i][c] = fmaf(sa[i], kb[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qp = q0 + ty + kSub * i;
    if (qp >= S) continue;
    const size_t row = (((size_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPER; ++c) {
      const int d = tx + kSub * c;
      if (d < D) dq[row + d] = from_f32<T>(dq_acc[i][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// D-chunked FMA route (128 < D <= 512): grid (tiles * n_chunks, H, B),
// block (tile, chunk) = blockIdx.x / n_chunks, % n_chunks; output columns
// [chunk * kChunk, + kChunk).  Shared memory is that of the FMA kernels at
// D = kChunk.

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int D,
                       float scale, int causal, int n_chunks) {
  extern __shared__ float smem[];
  constexpr int ld = kChunk + 1;
  constexpr int DPER = kChunk / kSub;
  float* q_s = smem;                   // [kTile][ld], pre-scaled
  float* k_s = q_s + kTile * ld;       // [kTile][ld]
  float* v_s = k_s + kTile * ld;       // [kTile][ld], the block's chunk
  float* p_s = v_s + kTile * ld;       // [kTile][kLdp]

  const int qt = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - qt * n_chunks;
  const int q0 = qt * kTile;
  const int c0 = chunk * kChunk;
  const int w = min(kChunk, D - c0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;

  float m[kPer], l[kPer], acc[kPer][DPER];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPER; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (S + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, qt + 1) : n_kv;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kTile;
    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    for (int cc = 0; cc < n_chunks; ++cc) {
      const int d0 = cc * kChunk;
      const int dw = min(kChunk, D - d0);
      __syncthreads();  // the previous readers of q_s, k_s (and p_s, v_s)
      load_chunk(q_s, ld, q, b, h, q0, S, H, D, d0, dw, scale);
      load_chunk(k_s, ld, k, b, h, k0, S, H, D, d0, dw, 1.f);
      __syncthreads();
      for (int d = 0; d < dw; ++d) {
        float qa[kPer], kb[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) qa[i] = q_s[(ty + kSub * i) * ld + d];
#pragma unroll
        for (int j = 0; j < kPer; ++j) kb[j] = k_s[(tx + kSub * j) * ld + d];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }
    load_chunk(v_s, ld, v, b, h, k0, S, H, D, c0, w, 1.f);

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kSub * i;
      const int qp = q0 + r;
      bool ok[kPer];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        ok[j] = live(qp, k0 + tx + kSub * j, S, causal);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * kLdp + tx + kSub * j] = p;
        psum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPER; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float pa[kPer], vb[DPER];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pa[i] = p_s[(ty + kSub * i) * kLdp + kk];
#pragma unroll
      for (int c = 0; c < DPER; ++c) {
        const int d = tx + kSub * c;
        vb[c] = d < w ? v_s[kk * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < DPER; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qp = q0 + ty + kSub * i;
    if (qp >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const size_t row = (((size_t)b * S + qp) * H + h) * D + c0;
#pragma unroll
    for (int c = 0; c < DPER; ++c) {
      const int d = tx + kSub * c;
      if (d < w) out[row + d] = from_f32<T>(acc[i][c] / lc);
    }
    if (tx == 0 && chunk == 0)
      lse[((size_t)b * H + h) * S + qp] = m[i] + logf(lc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int S,
                           int H, int D, float scale, int causal,
                           int n_chunks) {
  extern __shared__ float smem[];
  constexpr int ld = kChunk + 1;
  constexpr int DPER = kChunk / kSub;
  float* k_s = smem;                   // [kTile][ld]
  float* v_s = k_s + kTile * ld;       // [kTile][ld]
  float* q_s = v_s + kTile * ld;       // [kTile][ld]
  float* g_s = q_s + kTile * ld;       // [kTile][ld]
  float* p_s = g_s + kTile * ld;       // P^T  [kTile keys][kLdp]
  float* ds_s = p_s + kTile * kLdp;    // dS^T [kTile keys][kLdp]
  float* lse_s = ds_s + kTile * kLdp;  // [kTile]
  float* dl_s = lse_s + kTile;         // [kTile]

  const int kt = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - kt * n_chunks;
  const int k0 = kt * kTile;
  const int c0 = chunk * kChunk;
  const int w = min(kChunk, D - c0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;

  float dk_acc[kPer][DPER], dv_acc[kPer][DPER];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < DPER; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (S + kTile - 1) / kTile;
  const int first = causal ? kt : 0;
  for (int it = first; it < n_q; ++it) {
    const int q0 = it * kTile;
    float st[kPer][kPer], dpt[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) st[i][j] = dpt[i][j] = 0.f;
    // every chunk of d, the block's own last: its Q and dO stay staged
    for (int step = 0; step < n_chunks; ++step) {
      const int cc = (chunk + 1 + step) % n_chunks;
      const int d0 = cc * kChunk;
      const int dw = min(kChunk, D - d0);
      __syncthreads();
      if (step == 0) {
        load_stat(lse_s, lse, bh, q0, S);
        load_stat(dl_s, delta, bh, q0, S);
      }
      load_chunk(k_s, ld, k, b, h, k0, S, H, D, d0, dw, 1.f);
      load_chunk(v_s, ld, v, b, h, k0, S, H, D, d0, dw, 1.f);
      load_chunk(q_s, ld, q, b, h, q0, S, H, D, d0, dw, 1.f);
      load_chunk(g_s, ld, g, b, h, q0, S, H, D, d0, dw, 1.f);
      __syncthreads();
      for (int d = 0; d < dw; ++d) {
        float ka[kPer], va[kPer], qb[kPer], gb[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          ka[i] = k_s[(ty + kSub * i) * ld + d];
          va[i] = v_s[(ty + kSub * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          qb[j] = q_s[(tx + kSub * j) * ld + d];
          gb[j] = g_s[(tx + kSub * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
            dpt[i][j] = fmaf(va[i], gb[j], dpt[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kr = ty + kSub * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qc = tx + kSub * j;
        const float p = live(q0 + qc, k0 + kr, S, causal)
                            ? expf(st[i][j] * scale - lse_s[qc])
                            : 0.f;
        p_s[kr * kLdp + qc] = p;
        ds_s[kr * kLdp + qc] = p * (dpt[i][j] - dl_s[qc]);
      }
    }
    __syncthreads();

    for (int qq = 0; qq < kTile; ++qq) {
      float pa[kPer], sa[kPer], gb[DPER], qb[DPER];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pa[i] = p_s[(ty + kSub * i) * kLdp + qq];
        sa[i] = ds_s[(ty + kSub * i) * kLdp + qq];
      }
#pragma unroll
      for (int c = 0; c < DPER; ++c) {
        const int d = tx + kSub * c;
        gb[c] = d < w ? g_s[qq * ld + d] : 0.f;
        qb[c] = d < w ? q_s[qq * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < DPER; ++c) {
          dv_acc[i][c] = fmaf(pa[i], gb[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sa[i], qb[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kp = k0 + ty + kSub * i;
    if (kp >= S) continue;
    const size_t row = (((size_t)b * S + kp) * H + h) * D + c0;
#pragma unroll
    for (int c = 0; c < DPER; ++c) {
      const int d = tx + kSub * c;
      if (d < w) {
        dk[row + d] = from_f32<T>(dk_acc[i][c] * scale);
        dv[row + d] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, int S, int H, int D,
                          float scale, int causal, int n_chunks) {
  extern __shared__ float smem[];
  constexpr int ld = kChunk + 1;
  constexpr int DPER = kChunk / kSub;
  float* q_s = smem;                   // [kTile][ld]
  float* g_s = q_s + kTile * ld;       // [kTile][ld]
  float* k_s = g_s + kTile * ld;       // [kTile][ld]
  float* v_s = k_s + kTile * ld;       // [kTile][ld]
  float* ds_s = v_s + kTile * ld;      // dS [kTile queries][kLdp]
  float* lse_s = ds_s + kTile * kLdp;  // [kTile]
  float* dl_s = lse_s + kTile;         // [kTile]

  const int qt = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - qt * n_chunks;
  const int q0 = qt * kTile;
  const int c0 = chunk * kChunk;
  const int w = min(kChunk, D - c0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;

  load_stat(lse_s, lse, bh, q0, S);
  load_stat(dl_s, delta, bh, q0, S);

  float dq_acc[kPer][DPER];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < DPER; ++c) dq_acc[i][c] = 0.f;

  const int n_kv = (S + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, qt + 1) : n_kv;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kTile;
    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
    // every chunk of d, the block's own last: its K stays staged
    for (int step = 0; step < n_chunks; ++step) {
      const int cc = (chunk + 1 + step) % n_chunks;
      const int d0 = cc * kChunk;
      const int dw = min(kChunk, D - d0);
      __syncthreads();
      load_chunk(q_s, ld, q, b, h, q0, S, H, D, d0, dw, 1.f);
      load_chunk(g_s, ld, g, b, h, q0, S, H, D, d0, dw, 1.f);
      load_chunk(k_s, ld, k, b, h, k0, S, H, D, d0, dw, 1.f);
      load_chunk(v_s, ld, v, b, h, k0, S, H, D, d0, dw, 1.f);
      __syncthreads();
      for (int d = 0; d < dw; ++d) {
        float qa[kPer], ga[kPer], kb[kPer], vb[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          qa[i] = q_s[(ty + kSub * i) * ld + d];
          ga[i] = g_s[(ty + kSub * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          kb[j] = k_s[(tx + kSub * j) * ld + d];
          vb[j] = v_s[(tx + kSub * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
            dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qr = ty + kSub * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kc = tx + kSub * j;
        const float p = live(q0 + qr, k0 + kc, S, causal)
                            ? expf(s[i][j] * scale - lse_s[qr])
                            : 0.f;
        ds_s[qr * kLdp + kc] = p * (dp[i][j] - dl_s[qr]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float sa[kPer], kb[DPER];
#pragma unroll
      for (int i = 0; i < kPer; ++i) sa[i] = ds_s[(ty + kSub * i) * kLdp + kk];
#pragma unroll
      for (int c = 0; c < DPER; ++c) {
        const int d = tx + kSub * c;
        kb[c] = d < w ? k_s[kk * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < DPER; ++c) dq_acc[i][c] = fmaf(sa[i], kb[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qp = q0 + ty + kSub * i;
    if (qp >= S) continue;
    const size_t row = (((size_t)b * S + qp) * H + h) * D + c0;
#pragma unroll
    for (int c = 0; c < DPER; ++c) {
      const int d = tx + kSub * c;
      if (d < w) dq[row + d] = from_f32<T>(dq_acc[i][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward on the tensor cores (bfloat16, D % 8 == 0): one warpgroup a
// 64-row tile, the tiles in the forward's swizzled layout, the other
// axis streamed through a two-stage cp.async ring.  Per streamed tile,
// two wgmma groups: the two m64n64 score-shaped products from shared
// memory, then (after P and dS are formed on the f32 fragments and
// rounded to bf16 A fragments in registers) the accumulating products
// with the streamed or resident tile read MN-major.  P = 2^(s * scale *
// log2 e - lse * log2 e); masked entries get P = 0, so dS = 0 there.

// dK, dV: grid (B * H, ceil(S / 64)); blockIdx.y is the key tile, so the
// longest causal tiles (the lowest index) are issued first.  In the
// fragments the rows are keys and the columns queries: lse and delta
// vary along the columns.
template <int NA>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int S, int H, int D, float scale, int causal) {
  constexpr int DP = 64 * NA;
  constexpr int NK = DP / 16;          // k16 steps over d
  constexpr int TILE = kTile * DP;
  constexpr int NT = kTile / 8;        // n-tiles of 8 queries
  constexpr int SBO = 8 * 128;
  constexpr int ATOM = kTile * 64 * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // [TILE], resident
  bf16* v_s = k_s + TILE;                          // [TILE], resident
  bf16* q_s = v_s + TILE;                          // [kStages][TILE]
  bf16* g_s = q_s + kStages * TILE;                // [kStages][TILE]
  float* lse_s = reinterpret_cast<float*>(g_s + kStages * TILE);
  float* dl_s = lse_s + kStages * kTile;           // [kStages][kTile] each

  const size_t bh = blockIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kt = blockIdx.y;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row0 = k0 + warp * 16 + (lane >> 2);   // keys row0, row0 + 8
  const size_t rs = (size_t)H * D;
  const size_t head = (size_t)b * S * rs + (size_t)h * D;
  const float sl2 = scale * kLog2e;

  if (DP > D) zero_pads<NA>(k_s, 2 + 2 * kStages, D);
  // query tile i (Q, dO and their lse, delta) into stage i % kStages;
  // one 4-byte copy a thread: lse by threads 0-63, delta by 64-127
  static_assert(kMmaThreads == 2 * kTile, "one stat copy a thread");
  auto stage_q = [&](int i) {
    const int st = i % kStages;
    stage_tile<NA>(q_s + st * TILE, q + head, rs, i * kTile, S, D);
    stage_tile<NA>(g_s + st * TILE, g + head, rs, i * kTile, S, D);
    const int r = threadIdx.x & (kTile - 1);
    const int t = i * kTile + r;
    const bool ok = t < S;
    const float* src = threadIdx.x < kTile ? lse : delta;
    float* dst = threadIdx.x < kTile ? lse_s : dl_s;
    cp_async4(dst + st * kTile + r, src + bh * S + (ok ? t : 0), ok);
  };

  const int n_q = (S + kTile - 1) / kTile;
  const int first = causal ? kt : 0;   // earlier query tiles are masked
  stage_tile<NA>(k_s, k + head, rs, k0, S, D);
  stage_tile<NA>(v_s, v + head, rs, k0, S, D);
  stage_q(first);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (first + i < n_q) stage_q(first + i);
    cp_async_commit();
  }

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = first; it < n_q; ++it) {
    cp_async_wait<kStages - 2>();      // tile it has landed
    fence_async_shared();
    __syncthreads();                   // ... for every warp; it - 1 is read
    if (it + kStages - 1 < n_q) stage_q(it + kStages - 1);
    cp_async_commit();
    const int st = it % kStages;
    const bf16* qs = q_s + st * TILE;
    const bf16* gs = g_s + st * TILE;
    const float* ls = lse_s + st * kTile;
    const float* ds = dl_s + st * kTile;

    // S^T = K Q^T and dP^T = V dO^T over d (raw f32)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_ss_n64(s, smem_desc(k_s + k_off(kk), 16, SBO),
                   smem_desc(qs + k_off(kk), 16, SBO), kk > 0);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_ss_n64(dp, smem_desc(v_s + k_off(kk), 16, SBO),
                   smem_desc(gs + k_off(kk), 16, SBO), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T = P^T (dP^T - delta) as bf16 A fragments, 16 queries
    // a k16 step; the mask only on the diagonal and a ragged last tile
    const int q0 = it * kTile;
    const bool edge = (causal && it == kt) || q0 + kTile > S;
    uint32_t pa[NT / 2][4], sa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * t4;                 // columns c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
      float p[4], x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse_c = (e & 1) ? l2.y : l2.x;
        p[e] = fast_exp2(fmaf(s[4 * nt + e], sl2, -lse_c * kLog2e));
        if (edge) {
          const int qp = q0 + c + (e & 1);
          const int kp = row0 + 8 * (e >> 1);
          if (qp >= S || (causal && kp > qp)) p[e] = 0.f;
        }
        x[e] = p[e] * (dp[4 * nt + e] - ((e & 1) ? d2.y : d2.x));
      }
      const int kk = nt >> 1;
      const int hi = 2 * (nt & 1);                   // a2, a3 for odd nt
      pa[kk][hi] = pack_bf16(p[0], p[1]);
      pa[kk][hi + 1] = pack_bf16(p[2], p[3]);
      sa[kk][hi] = pack_bf16(x[0], x[1]);
      sa[kk][hi + 1] = pack_bf16(x[2], x[3]);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries, dO and Q
    // read MN-major
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wgmma_rs<DP>(dva, pa[kk], smem_desc(gs + 16 * kk * 64, ATOM, SBO));
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wgmma_rs<DP>(dka, sa[kk], smem_desc(qs + 16 * kk * 64, ATOM, SBO));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait<0>();                  // no copy outlives the block

  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  store_rows<DP>(dka, dk + head, rs, row0, S, D, sc);
  store_rows<DP>(dva, dv + head, rs, row0, S, D, one);
}

// dQ: grid (B * H, ceil(S / 64)); blockIdx.y counts query tiles from the
// last one (longest causal tiles first).  Rows are queries, so each lane
// keeps the lse and delta of its two rows in registers.
template <int NA>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int S, int H, int D,
                        float scale, int causal) {
  constexpr int DP = 64 * NA;
  constexpr int NK = DP / 16;
  constexpr int TILE = kTile * DP;
  constexpr int NT = kTile / 8;        // n-tiles of 8 keys
  constexpr int SBO = 8 * 128;
  constexpr int ATOM = kTile * 64 * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [TILE], resident
  bf16* g_s = q_s + TILE;                          // [TILE], resident
  bf16* k_s = g_s + TILE;                          // [kStages][TILE]
  bf16* v_s = k_s + kStages * TILE;                // [kStages][TILE]

  const size_t bh = blockIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;       // longest first
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);   // queries row0, row0 + 8
  const size_t rs = (size_t)H * D;
  const size_t head = (size_t)b * S * rs + (size_t)h * D;
  const float sl2 = scale * kLog2e;

  if (DP > D) zero_pads<NA>(q_s, 2 + 2 * kStages, D);
  auto stage_kv = [&](int j) {
    const int st = j % kStages;
    stage_tile<NA>(k_s + st * TILE, k + head, rs, j * kTile, S, D);
    stage_tile<NA>(v_s + st * TILE, v + head, rs, j * kTile, S, D);
  };

  const int n_kv = (S + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, qt + 1) : n_kv;
  stage_tile<NA>(q_s, q + head, rs, q0, S, D);
  stage_tile<NA>(g_s, g + head, rs, q0, S, D);
  stage_kv(0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (i < n_tiles) stage_kv(i);
    cp_async_commit();
  }

  float lse2[2], dl[2];                // lse in log2 units, and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lse2[i] = r < S ? lse[bh * S + r] * kLog2e : 0.f;
    dl[i] = r < S ? delta[bh * S + r] : 0.f;
  }
  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();
    if (j + kStages - 1 < n_tiles) stage_kv(j + kStages - 1);
    cp_async_commit();
    const int st = j % kStages;
    const bf16* ks = k_s + st * TILE;
    const bf16* vs = v_s + st * TILE;

    // S = Q K^T and dP = dO V^T over d (raw f32)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_ss_n64(s, smem_desc(q_s + k_off(kk), 16, SBO),
                   smem_desc(ks + k_off(kk), 16, SBO), kk > 0);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_ss_n64(dp, smem_desc(g_s + k_off(kk), 16, SBO),
                   smem_desc(vs + k_off(kk), 16, SBO), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - delta) as bf16 A fragments, 16 keys a k16 step
    const int k0 = j * kTile;
    const bool edge = (causal && j == qt) || k0 + kTile > S;
    uint32_t sa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = fast_exp2(fmaf(s[4 * nt + e], sl2, -lse2[i]));
        if (edge) {
          const int kp = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qp = row0 + 8 * i;
          if (kp >= S || (causal && kp > qp)) p = 0.f;
        }
        x[e] = p * (dp[4 * nt + e] - dl[i]);
      }
      const int hi = 2 * (nt & 1);
      sa[nt >> 1][hi] = pack_bf16(x[0], x[1]);
      sa[nt >> 1][hi + 1] = pack_bf16(x[2], x[3]);
    }

    // dQ += dS K over the tile's keys, K read MN-major
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wgmma_rs<DP>(dqa, sa[kk], smem_desc(ks + 16 * kk * 64, ATOM, SBO));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dqa);
  }
  cp_async_wait<0>();

  const float sc[2] = {scale, scale};
  store_rows<DP>(dqa, dq + head, rs, row0, S, D, sc);
}

// ---------------------------------------------------------------------------
// launches

// The kernel's shared-memory limit for `smem` bytes, set on the first
// (eager) call of each kernel and size (launch_once.cuh), so a launch
// under CUDA-graph capture makes no runtime call but the launch.
cudaError_t prepare(const void* kernel, size_t smem) {
  int max_optin = 0;
  cudaError_t err = dl4j::device_attribute_once(
      cudaDevAttrMaxSharedMemoryPerBlockOptin, &max_optin);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_optin) return cudaErrorInvalidConfiguration;
  return dl4j::set_attribute_once(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int B, int S, int H, int D) {
  return B < 1 || S < 1 || H < 1 || D < 1 || D > kMaxD || H > 65535 ||
         B > 65535;
}

template <typename T, int DPER>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int S, int H, int D, int causal,
                cudaStream_t stream) {
  const size_t smem = fwd_floats(D) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DPER>;
  cudaError_t err = prepare((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, H, D, 1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

template <int NA>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int S, int H, int D, int causal,
                    cudaStream_t stream) {
  const size_t smem = fwd_mma_bytes<NA>();
  auto kernel = flash_fwd_mma_kernel<NA>;
  cudaError_t err = prepare((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_q = (S + kTile - 1) / kTile;
  if (n_q > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, n_q);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, H, D, 1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

template <int NA>
cudaError_t dkv_mma(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int S, int H, int D,
                    int causal, cudaStream_t stream) {
  const size_t smem = dkv_mma_bytes<NA>();
  auto kernel = flash_bwd_dkv_mma_kernel<NA>;
  cudaError_t err = prepare((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_k = (S + kTile - 1) / kTile;
  if (n_k > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, n_k);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, D,
      1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

template <int NA>
cudaError_t dq_mma(const void* q, const void* k, const void* v,
                   const void* g, const void* lse, const void* delta,
                   void* dqp, int B, int S, int H, int D, int causal,
                   cudaStream_t stream) {
  const size_t smem = dq_mma_bytes<NA>();
  auto kernel = flash_bwd_dq_mma_kernel<NA>;
  cudaError_t err = prepare((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_q = (S + kTile - 1) / kTile;
  if (n_q > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, n_q);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dqp), S, H, D, 1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

// The route of an entry (kind 0 forward, 1 dK/dV, 2 dQ): the tensor cores
// for bfloat16, D a multiple of 8 up to 256 (forward) or 128 (backward),
// every bf16 tensor (inputs and outputs) on a 16-byte boundary (cp.async
// copies 16 bytes), a null pointer counting as aligned; else the FMA
// pipes up to D = kChunk and the D-chunked FMA route above it.
int route_of(int kind, int D, int dtype,
             std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  const int mma_max = kind == 0 ? kMaxMmaFwdD : kChunk;
  if (dtype == 1 && D % 8 == 0 && D <= mma_max && (bits & 15) == 0)
    return kRouteTensorCores;
  return D > kChunk ? kRouteChunks : kRouteFma;
}

// Launches of the D-chunked route: the FMA kernels' shared memory at D =
// kChunk, one block a (tile, chunk).
template <typename Kernel>
cudaError_t chunk_grid(Kernel kernel, size_t smem, int B, int S, int H,
                       int D, dim3* grid, int* n_chunks) {
  cudaError_t err = prepare((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  *n_chunks = (D + kChunk - 1) / kChunk;
  *grid = dim3(((S + kTile - 1) / kTile) * *n_chunks, H, B);
  return cudaSuccess;
}

template <typename T>
cudaError_t fwd_chunks(const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int S, int H, int D,
                       int causal, cudaStream_t stream) {
  const size_t smem = fwd_floats(kChunk) * sizeof(float);
  auto kernel = flash_fwd_chunk_kernel<T>;
  dim3 grid;
  int n_chunks = 0;
  cudaError_t err = chunk_grid(kernel, smem, B, S, H, D, &grid, &n_chunks);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, H, D, 1.0f / sqrtf((float)D), causal,
      n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_chunks(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int D,
                       int causal, cudaStream_t stream) {
  const size_t smem = dkv_floats(kChunk) * sizeof(float);
  auto kernel = flash_bwd_dkv_chunk_kernel<T>;
  dim3 grid;
  int n_chunks = 0;
  cudaError_t err = chunk_grid(kernel, smem, B, S, H, D, &grid, &n_chunks);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, D,
      1.0f / sqrtf((float)D), causal, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_chunks(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dqp, int B, int S, int H, int D, int causal,
                      cudaStream_t stream) {
  const size_t smem = dq_floats(kChunk) * sizeof(float);
  auto kernel = flash_bwd_dq_chunk_kernel<T>;
  dim3 grid;
  int n_chunks = 0;
  cudaError_t err = chunk_grid(kernel, smem, B, S, H, D, &grid, &n_chunks);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqp), S, H, D, 1.0f / sqrtf((float)D), causal,
      n_chunks);
  return cudaGetLastError();
}

template <typename T, int DPER>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dk, void* dv,
                int B, int S, int H, int D, int causal,
                cudaStream_t stream) {
  const size_t smem = dkv_floats(D) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, DPER>;
  cudaError_t err = prepare((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, D,
      1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

template <typename T, int DPER>
cudaError_t dq(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dqp, int B, int S,
               int H, int D, int causal, cudaStream_t stream) {
  const size_t smem = dq_floats(D) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, DPER>;
  cudaError_t err = prepare((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqp), S, H, D, 1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

// Head dims up to 64 keep 4 accumulator columns per thread, up to 128
// keep 8.
#define DL4J_DISPATCH(FN, ...)                                              \
  do {                                                                      \
    if (dtype == 0)                                                         \
      return (int)(D <= 4 * kSub ? FN<float, 4>(__VA_ARGS__)                \
                                 : FN<float, 8>(__VA_ARGS__));              \
    if (dtype == 1)                                                         \
      return (int)(D <= 4 * kSub ? FN<__nv_bfloat16, 4>(__VA_ARGS__)        \
                                 : FN<__nv_bfloat16, 8>(__VA_ARGS__));      \
    if (dtype == 2)                                                         \
      return (int)(D <= 4 * kSub ? FN<__half, 4>(__VA_ARGS__)               \
                                 : FN<__half, 8>(__VA_ARGS__));             \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

// The tensor-core kernels pad D to whole 64-column atoms: the backward
// to one or two, the forward to up to four.
#define DL4J_DISPATCH_MMA(FN, ...)                                          \
  return (int)(D <= 64 ? FN<1>(__VA_ARGS__) : FN<2>(__VA_ARGS__))

#define DL4J_DISPATCH_MMA_FWD(FN, ...)                                      \
  return (int)(D <= 64 ? FN<1>(__VA_ARGS__)                                 \
               : D <= 128 ? FN<2>(__VA_ARGS__)                              \
               : D <= 192 ? FN<3>(__VA_ARGS__) : FN<4>(__VA_ARGS__))

#define DL4J_DISPATCH_CHUNKS(FN, ...)                                       \
  do {                                                                      \
    if (dtype == 0) return (int)FN<float>(__VA_ARGS__);                     \
    if (dtype == 1) return (int)FN<__nv_bfloat16>(__VA_ARGS__);             \
    if (dtype == 2) return (int)FN<__half>(__VA_ARGS__);                    \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes: kind 0 = forward,
// 1 = dK/dV, 2 = dQ, on route 0 (FMA), 1 (tensor cores) or 2 (D-chunked
// FMA, whose blocks hold kChunk columns of d whatever D is).
size_t dl4j_flash_smem_bytes(int kind, int D, int route) {
  if (route == kRouteTensorCores) {
    const bool two = D > 64;
    if (kind == 0)
      return D <= 64    ? fwd_mma_bytes<1>()
             : D <= 128 ? fwd_mma_bytes<2>()
             : D <= 192 ? fwd_mma_bytes<3>() : fwd_mma_bytes<4>();
    if (kind == 1) return two ? dkv_mma_bytes<2>() : dkv_mma_bytes<1>();
    return two ? dq_mma_bytes<2>() : dq_mma_bytes<1>();
  }
  const int d = route == kRouteChunks ? kChunk : D;
  const size_t f = kind == 0 ? fwd_floats(d)
                             : kind == 1 ? dkv_floats(d) : dq_floats(d);
  return f * sizeof(float);
}

// Every entry takes contiguous [B, S, H, D] tensors in one dtype
// (0 = float32, 1 = bfloat16, 2 = float16) and [B*H, S] float32 row stats on the
// current device, launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.  Each picks its route from its
// inputs (route_of): bfloat16 with D % 8 == 0 (up to 256 forward, 128
// backward) and 16-byte aligned tensors on the tensor cores; otherwise
// the FMA pipes up to D = 128 and the D-chunked FMA route above it.

// out [B, S, H, D] and lse [B*H, S] of flash attention over q, k, v.
int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int H, int D, int causal,
                   int dtype, void* stream) {
  if (bad_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = route_of(0, D, dtype, {q, k, v, out});
  if (route == kRouteTensorCores)
    DL4J_DISPATCH_MMA_FWD(fwd_mma, q, k, v, out, lse, B, S, H, D, causal, s);
  if (route == kRouteChunks)
    DL4J_DISPATCH_CHUNKS(fwd_chunks, q, k, v, out, lse, B, S, H, D, causal,
                         s);
  DL4J_DISPATCH(fwd, q, k, v, out, lse, B, S, H, D, causal, s);
}

// The route entry `kind` (0 forward, 1 dK/dV, 2 dQ) takes for these
// tensors (0 FMA, 1 tensor cores, 2 D-chunked FMA): q, k, v and then out
// (dl4j_flash_fwd), g, dk, dv (dl4j_flash_bwd_dkv) or g, dq
// (dl4j_flash_bwd_dq), the unused trailing pointers NULL.
int dl4j_flash_route(int kind, const void* q, const void* k, const void* v,
                     const void* p3, const void* p4, const void* p5, int D,
                     int dtype) {
  return route_of(kind, D, dtype, {q, k, v, p3, p4, p5});
}

// dk, dv of flash attention given dO = g and the row stats lse, delta.
int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int D,
                       int causal, int dtype, void* stream) {
  if (bad_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = route_of(1, D, dtype, {q, k, v, g, dk, dv});
  if (route == kRouteTensorCores)
    DL4J_DISPATCH_MMA(dkv_mma, q, k, v, g, lse, delta, dk, dv, B, S, H, D,
                      causal, s);
  if (route == kRouteChunks)
    DL4J_DISPATCH_CHUNKS(dkv_chunks, q, k, v, g, lse, delta, dk, dv, B, S,
                         H, D, causal, s);
  DL4J_DISPATCH(dkv, q, k, v, g, lse, delta, dk, dv, B, S, H, D, causal, s);
}

// dq of flash attention given dO = g and the row stats lse, delta.
int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dqp, int B, int S, int H, int D, int causal,
                      int dtype, void* stream) {
  if (bad_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = route_of(2, D, dtype, {q, k, v, g, dqp});
  if (route == kRouteTensorCores)
    DL4J_DISPATCH_MMA(dq_mma, q, k, v, g, lse, delta, dqp, B, S, H, D,
                      causal, s);
  if (route == kRouteChunks)
    DL4J_DISPATCH_CHUNKS(dq_chunks, q, k, v, g, lse, delta, dqp, B, S, H, D,
                         causal, s);
  DL4J_DISPATCH(dq, q, k, v, g, lse, delta, dqp, B, S, H, D, causal, s);
}

const char* dl4j_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

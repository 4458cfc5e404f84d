// Paged attention for Hopper (sm_90a), bound to Python through a plain C
// entry point (ctypes; see deeplearning4j_tpu_torch/_build.py and
// deeplearning4j_tpu_torch/parallel/paged_kernel.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/parallel/paged_kernel.py
// ::_paged_attn_kernel (launched by paged_flash_attention).  Same
// function: for every lane b and head h, one online softmax over the
// lane's LIVE pages of a [P, ps, H, K] K/V pool, walked through the block
// table row table[b, :].  Query column c sits at position pos[b] + c and
// sees keys t <= pos[b] + c; pages past the frontier
// pos[b] + max(n_feed[b], 1) - 1 are neither read nor computed, so the
// work scales with live pages, not with the table width.  Padding columns
// (c >= n_feed[b]) attend only through the frontier page, exactly as on
// the TPU; callers never read them.  Out-of-range table ids read the null
// page 0; the mask value is -FLT_MAX / 2 and the normaliser is clamped at
// 1e-30, as in the TPU kernel.
//
// Bound.  At the served shape (B 8, H 12, K 64, page 16, up to 64 live
// pages a lane) decode (C = 1) does 2 flops per K/V element it reads and
// a 16-column chunk 32: both are bound by the bytes of the live pages
// (2.3 us at 3.35 TB/s), far below the card's ~295 flops/byte ridge.
// What stood between the first design and that bound: one block per
// (lane, head) gave 96 blocks for 132 SMs and walked the longest lane
// serially; scalar loads with no overlap; one lane per key dot product;
// shared memory that grew with C (C >= 127 at K 64 was refused).
//
// Design.
// - Flash-decoding split.  A block takes one (head, lane, query-column
//   tile, page range of at most pages_per_split logical pages); a block
//   whose range starts past its lane's frontier exits at once.  The plan
//   (pages_per_split, n_splits) comes from the Python wrapper
//   (paged_kernel.paged_split_plan), so that the CPU tests check it; it
//   gives well over 132 blocks at the served shape.  With one split the
//   block writes `out` itself; otherwise it writes its partial (m, l and
//   the unnormalised acc[C, K], f32) to a scratch the wrapper allocates,
//   and paged_attention_merge_kernel rescales the partials into `out`.
//   One wrapper call ("launch") is the split kernel plus, with more than
//   one split, the merge kernel.
// - Loads.  The block copies the page ids of its range to shared memory,
//   then stages 64 keys (fewer for wide f32 rows) of K and V at a time
//   in their own dtype by cp.async (16 bytes where the row allows it,
//   else 8 or 4; a bfloat16 row of odd K is copied element by element)
//   into a two-stage ring: tile i + 1 loads while tile i is computed.
//   Rows past the range are zero-filled, and K is zero-padded in shared
//   memory to the width the products read.  Shared memory no longer
//   depends on C: the feed width is tiled, so every C is taken.
// - Products.  bfloat16 with C > 1 (chunked prefill, the speculative
//   verify): tensor cores, mma.sync.m16n8k16 with 16 query columns x 8
//   keys x 16 of depth for the scores and P V the same way (P rounded to
//   bf16 in registers, V through ldmatrix.trans).  A block takes 16
//   columns (a wider feed is tiled in 16-column blocks) and each of its
//   4 warps 16 keys of a 64-key tile.  C = 1 and all of float32: vectorised
//   warp-cooperative dot products on the FMA pipes, G lanes per key row
//   (8 for K 64 bfloat16, one 16-byte chunk each) with a shuffle
//   reduction, the lanes spread over K for P V; float32 with C > 1 takes
//   4 columns a block.  Every warp keeps its own online softmax; the
//   warps' partials are merged in shared memory at the end of the block.
// - K up to 512 (kMaxK); a larger head dim is refused with its own
//   return code, kErrHeadDim.  The tensor-core route keeps K <= 256
//   (kMaxMmaK): its 16 x K f32 accumulators are K / 2 registers a lane,
//   256 at K 512.  bfloat16 chunks (C > 1) of a wider head take the
//   FMA route with 4 columns a block, as float32 does; a lane then holds
//   2 (bfloat16) or 4 (float32) 16-byte chunks of a row.
// - float16 takes the FMA route at every C and K, as float32 does (1 or
//   4 columns a block), with bfloat16's 16-byte chunks of 8 elements;
//   scores, softmax and accumulators are f32 as in the other dtypes.  The
//   tensor-core route is not instantiated for it.

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "launch_once.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kThreads = 128;   // 4 warps a block
constexpr int kWarps = 4;
constexpr int kMaxK = 512;
constexpr int kMaxMmaK = 256;   // widest head of the tensor-core route
constexpr int kErrHeadDim = -1;  // the entry's code for K > kMaxK
constexpr int kMmaCols = 16;    // query columns of an mma block
constexpr int kMmaKeys = 64;    // keys a stage holds on the mma route

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* pos;
  const int* n_feed;
  void* out;
  float* part_ml;    // [n_splits, B, C, H, 2] (m, l)
  float* part_acc;   // [n_splits, B, C, H, K]
  int B, C, H, K, P, ps, MP;
  int pps, n_splits, c_tiles, cols;
  int copy;          // bytes per async copy: 16, 8, 4; 0 = element copy
  int key_tile;      // keys per stage
  float scale, neg;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half(x);
}

// Two packed 16-bit values (the low one first) as floats.
__device__ __forceinline__ float2 pair_f32(uint32_t raw, bf16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}
__device__ __forceinline__ float2 pair_f32(uint32_t raw, f16) {
  return __half22float2(*reinterpret_cast<const __half2*>(&raw));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Global -> shared copies of 16, 8 or 4 bytes; zeros when !ok.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n,
                                         bool ok) {
  const uint32_t d = smem_addr(dst);
  const int sz = ok ? n : 0;
  if (n == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(sz)
                 : "memory");
  else if (n == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(sz)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(sz)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What one block works on, and whether it has anything to do.
struct Work {
  int b, h, ct, split;
  int p0;          // pos[b]
  int pg0, pg1;    // logical pages [pg0, pg1) of this block
  int key0, key1;  // keys [key0, key1) = [pg0 * ps, pg1 * ps)
};

__device__ __forceinline__ bool block_work(const Args& a, Work& w) {
  int idx = blockIdx.x;
  w.split = idx % a.n_splits;
  idx /= a.n_splits;
  w.ct = idx % a.c_tiles;
  idx /= a.c_tiles;
  w.h = idx % a.H;
  w.b = idx / a.H;
  w.p0 = a.pos[w.b];
  const int wmax = w.p0 + max(a.n_feed[w.b], 1) - 1;  // the lane's frontier
  const int n_lp = min(wmax / a.ps + 1, a.MP);
  w.pg0 = w.split * a.pps;
  if (w.pg0 >= n_lp) return false;   // the range starts past the frontier
  w.pg1 = min(w.pg0 + a.pps, n_lp);
  w.key0 = w.pg0 * a.ps;
  w.key1 = w.pg1 * a.ps;
  return true;
}

// Page ids of the block's range into shared memory (out-of-range ids read
// the null page).
__device__ __forceinline__ void load_page_ids(const Args& a, const Work& w,
                                              int* pid) {
  for (int i = threadIdx.x; i < w.pg1 - w.pg0; i += kThreads) {
    int page = a.table[(size_t)w.b * a.MP + w.pg0 + i];
    if (page < 0 || page >= a.P) page = 0;
    pid[i] = page;
  }
}

// Stage keys t0 .. t0 + rows of head h into ks / vs (row stride ld
// elements, columns [0, K)); rows at or past key1 are zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(const Args& a, const Work& w,
                                           const int* pid, T* ks, T* vs,
                                           int ld, int t0, int rows) {
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const size_t rs = (size_t)a.H * a.K;   // between rows of a page
  if (a.copy > 0) {
    const int per = a.copy / (int)sizeof(T);
    const int n_row = a.K / per;
    for (int e = threadIdx.x; e < rows * n_row; e += kThreads) {
      const int r = e / n_row;
      const int c = e - r * n_row;
      const int t = t0 + r;
      const bool ok = t < w.key1;
      size_t off = 0;
      if (ok) {
        const int lp = t / a.ps;
        off = ((size_t)pid[lp - w.pg0] * a.ps + (t - lp * a.ps)) * rs +
              (size_t)w.h * a.K + (size_t)c * per;
      }
      cp_async(ks + r * ld + c * per, kp + off, a.copy, ok);
      cp_async(vs + r * ld + c * per, vp + off, a.copy, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * a.K; e += kThreads) {
      const int r = e / a.K;
      const int d = e - r * a.K;
      const int t = t0 + r;
      T kx = from_f32<T>(0.f), vx = from_f32<T>(0.f);
      if (t < w.key1) {
        const int lp = t / a.ps;
        const size_t off =
            ((size_t)pid[lp - w.pg0] * a.ps + (t - lp * a.ps)) * rs +
            (size_t)w.h * a.K + d;
        kx = kp[off];
        vx = vp[off];
      }
      ks[r * ld + d] = kx;
      vs[r * ld + d] = vx;
    }
  }
}

// Zero columns [K, ld) of `rows` rows of each buffer (never copied to).
template <typename T>
__device__ __forceinline__ void zero_pads(T* buf, int rows, int ld, int K) {
  if (ld == K) return;
  for (int e = threadIdx.x; e < rows * (ld - K); e += kThreads) {
    const int r = e / (ld - K);
    buf[r * ld + K + (e - r * (ld - K))] = from_f32<T>(0.f);
  }
}

// Merge the warps' partial softmaxes of one block (m_s, l_s [kWarps][cols],
// acc_s [kWarps][cols][lda]) and write them: the normalised output with
// one split, else the partial (M, L, O) of this split.
template <typename T>
__device__ __forceinline__ void block_merge(const Args& a, const Work& w,
                                            const float* m_s,
                                            const float* l_s,
                                            const float* acc_s, int cols,
                                            int lda) {
  for (int e = threadIdx.x; e < cols * a.K; e += kThreads) {
    const int cc = e / a.K;
    const int d = e - cc * a.K;
    const int c = w.ct * cols + cc;
    if (c >= a.C) continue;
    float mx = a.neg;
    for (int i = 0; i < kWarps; ++i) mx = fmaxf(mx, m_s[i * cols + cc]);
    float l = 0.f, o = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      const float f = expf(m_s[i * cols + cc] - mx);
      l = fmaf(l_s[i * cols + cc], f, l);
      o = fmaf(acc_s[((size_t)i * cols + cc) * lda + d], f, o);
    }
    const size_t row = ((size_t)w.b * a.C + c) * a.H + w.h;
    if (a.n_splits == 1) {
      static_cast<T*>(a.out)[row * a.K + d] = from_f32<T>(o / fmaxf(l, 1e-30f));
    } else {
      const size_t prow =
          ((size_t)w.split * a.B * a.C * a.H) + row;   // [split, b, c, h]
      a.part_acc[prow * a.K + d] = o;
      if (d == 0) {
        a.part_ml[prow * 2] = mx;
        a.part_ml[prow * 2 + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// FMA route: C = 1, and float32.  G lanes share a key row (one 16-byte
// chunk of VEC elements each, CPL chunks a lane), so a warp scores 32 / G
// keys at a time; CF query columns a block.

template <typename T, int G, int CPL, int CF>
__global__ void __launch_bounds__(kThreads)
paged_attention_vec_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int R = 32 / G;             // key rows a warp scores at once
  constexpr int NV = CPL * VEC;         // elements a lane holds of a row
  constexpr int LDV = G * CPL * VEC;    // shared-memory row (>= K)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Work w;
  if (!block_work(a, w)) return;
  const int kt = a.key_tile;
  T* ks = reinterpret_cast<T*>(smem_raw);          // [2][kt][LDV]
  T* vs = ks + 2 * kt * LDV;                       // [2][kt][LDV]
  const size_t stage_bytes = (size_t)4 * kt * LDV * sizeof(T);
  const size_t merge_bytes =
      (size_t)kWarps * CF * (LDV + 2) * sizeof(float);
  int* pid = reinterpret_cast<int*>(
      smem_raw + (stage_bytes > merge_bytes ? stage_bytes : merge_bytes));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;             // the row of the pass
  const int gl = lane - grp * G;        // the lane within the row

  zero_pads(ks, 4 * kt, LDV, a.K);      // k and v, both stages
  load_page_ids(a, w, pid);

  // this lane's slice of each column's q, scaled in f32 (the TPU order)
  float qr[CF][NV];
  const T* qp = static_cast<const T*>(a.q);
#pragma unroll
  for (int cc = 0; cc < CF; ++cc) {
    const int c = w.ct * CF + cc;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = (gl + j * G) * VEC + e;
        qr[cc][j * VEC + e] =
            c < a.C && d < a.K
                ? to_f32(qp[(((size_t)w.b * a.C + c) * a.H + w.h) * a.K + d]) *
                      a.scale
                : 0.f;
      }
  }
  float m[CF], l[CF], acc[CF][NV];
#pragma unroll
  for (int cc = 0; cc < CF; ++cc) {
    m[cc] = a.neg;
    l[cc] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[cc][i] = 0.f;
  }
  __syncthreads();                      // page ids and pads are in place

  const int n_tiles = (w.key1 - w.key0 + kt - 1) / kt;
  stage_tile(a, w, pid, ks, vs, LDV, w.key0, kt);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      stage_tile(a, w, pid, ks + (st ^ 1) * kt * LDV, vs + (st ^ 1) * kt * LDV,
                 LDV, w.key0 + (it + 1) * kt, kt);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = ks + st * kt * LDV;
    const T* vb = vs + st * kt * LDV;
    const int t0 = w.key0 + it * kt;
    for (int p = 0; p < kt; p += kWarps * R) {
      const int r = p + warp * R + grp;
      const int t = t0 + r;
      float kv[NV], vv[NV];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int off = r * LDV + (gl + j * G) * VEC;
        if constexpr (sizeof(T) == 2) {
          const uint4 kraw = *reinterpret_cast<const uint4*>(kb + off);
          const uint4 vraw = *reinterpret_cast<const uint4*>(vb + off);
          const uint32_t* k2 = reinterpret_cast<const uint32_t*>(&kraw);
          const uint32_t* v2 = reinterpret_cast<const uint32_t*>(&vraw);
#pragma unroll
          for (int e = 0; e < VEC / 2; ++e) {
            const float2 kf = pair_f32(k2[e], T());
            const float2 vf = pair_f32(v2[e], T());
            kv[j * VEC + 2 * e] = kf.x;
            kv[j * VEC + 2 * e + 1] = kf.y;
            vv[j * VEC + 2 * e] = vf.x;
            vv[j * VEC + 2 * e + 1] = vf.y;
          }
        } else {
          const float4 kf = *reinterpret_cast<const float4*>(kb + off);
          const float4 vf = *reinterpret_cast<const float4*>(vb + off);
          kv[j * VEC] = kf.x;
          kv[j * VEC + 1] = kf.y;
          kv[j * VEC + 2] = kf.z;
          kv[j * VEC + 3] = kf.w;
          vv[j * VEC] = vf.x;
          vv[j * VEC + 1] = vf.y;
          vv[j * VEC + 2] = vf.z;
          vv[j * VEC + 3] = vf.w;
        }
      }
#pragma unroll
      for (int cc = 0; cc < CF; ++cc) {
        const int c = w.ct * CF + cc;
        if (c >= a.C) break;            // uniform over the block
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) dot = fmaf(qr[cc][i], kv[i], dot);
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const bool live = t < w.key1 && t <= w.p0 + c;
        const float s = live ? dot : a.neg;
        float mx = s;
#pragma unroll
        for (int o = G; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[cc], mx);
        const float alpha = expf(m[cc] - m_new);
        const float pv = live ? expf(s - m_new) : 0.f;
        float ps = pv;
#pragma unroll
        for (int o = G; o < 32; o <<= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l[cc] = l[cc] * alpha + ps;
        m[cc] = m_new;
#pragma unroll
        for (int i = 0; i < NV; ++i)
          acc[cc][i] = fmaf(pv, vv[i], acc[cc][i] * alpha);
      }
    }
    __syncthreads();                    // stage st is free again
  }

  // sum acc over the warp's rows (m is uniform over the warp), then merge
  // the warps in shared memory (aliasing the staging ring)
  float* m_s = reinterpret_cast<float*>(smem_raw);
  float* l_s = m_s + kWarps * CF;
  float* acc_s = l_s + kWarps * CF;     // [kWarps][CF][LDV]
#pragma unroll
  for (int cc = 0; cc < CF; ++cc) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        acc[cc][i] += __shfl_xor_sync(0xffffffffu, acc[cc][i], o);
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc_s[((size_t)warp * CF + cc) * LDV + (gl + j * G) * VEC + e] =
              acc[cc][j * VEC + e];
    }
    if (lane == 0) {
      m_s[warp * CF + cc] = m[cc];
      l_s[warp * CF + cc] = l[cc];
    }
  }
  __syncthreads();
  block_merge<T>(a, w, m_s, l_s, acc_s, CF, LDV);
}

// ---------------------------------------------------------------------------
// tensor-core route: bfloat16, C > 1.  16 query columns a block; each warp
// scores 16 keys of a 64-key stage.  NK = ceil(K / 16) rounded up to a
// compiled width.

template <int NK>
__host__ __device__ constexpr int mma_ld() { return 16 * NK + 8; }

template <int NK>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_kernel(const Args a) {
  constexpr int KP = 16 * NK;
  constexpr int LD = mma_ld<NK>();      // +16 bytes a row: no conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Work w;
  if (!block_work(a, w)) return;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [16][LD]
  bf16* ks = q_s + kMmaCols * LD;                  // [2][64][LD]
  bf16* vs = ks + 2 * kMmaKeys * LD;               // [2][64][LD]
  int* pid = reinterpret_cast<int*>(vs + 2 * kMmaKeys * LD);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // q tile: columns ct * 16 + r, zeros past C and past K
  const bf16* qp = static_cast<const bf16*>(a.q);
  for (int e = threadIdx.x; e < kMmaCols * KP; e += kThreads) {
    const int r = e / KP;
    const int d = e - r * KP;
    const int c = w.ct * kMmaCols + r;
    q_s[r * LD + d] =
        c < a.C && d < a.K
            ? qp[(((size_t)w.b * a.C + c) * a.H + w.h) * a.K + d]
            : __float2bfloat16(0.f);
  }
  zero_pads(ks, 4 * kMmaKeys, LD, a.K);   // columns [K, LD) of k and v
  load_page_ids(a, w, pid);
  __syncthreads();

  float o[2 * NK][4];
#pragma unroll
  for (int i = 0; i < 2 * NK; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {a.neg, a.neg};
  float l[2] = {0.f, 0.f};
  const int col0 = w.ct * kMmaCols + g;   // this lane's columns col0, +8

  const int n_tiles = (w.key1 - w.key0 + kMmaKeys - 1) / kMmaKeys;
  stage_tile(a, w, pid, ks, vs, LD, w.key0, kMmaKeys);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      stage_tile(a, w, pid, ks + (st ^ 1) * kMmaKeys * LD,
                 vs + (st ^ 1) * kMmaKeys * LD, LD,
                 w.key0 + (it + 1) * kMmaKeys, kMmaKeys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kb = ks + st * kMmaKeys * LD + warp * 16 * LD;
    const bf16* vb = vs + st * kMmaKeys * LD + warp * 16 * LD;
    const int t0 = w.key0 + it * kMmaKeys + warp * 16;

    // S = Q K^T: 16 columns x this warp's 16 keys (2 n-tiles)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t qa[4], kf[4];
      ldmatrix_x4(qa, q_s + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(kf, kb + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qa, kf[0], kf[1]);
      mma_bf16(s[1], qa, kf[2], kf[3]);
    }

    // scale in f32, mask t <= pos + c and the range's end; online softmax
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = col0 + 8 * i;
      bool live[2][2];
      float mx = a.neg;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + nt * 8 + 2 * t4 + e;
          live[nt][e] = t < w.key1 && t <= w.p0 + c;
          const float x = live[nt][e] ? s[nt][2 * i + e] * a.scale : a.neg;
          s[nt][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = live[nt][e] ? expf(s[nt][2 * i + e] - m_new) : 0.f;
          s[nt][2 * i + e] = p;
          ps += p;
        }
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int dt = 0; dt < 2 * NK; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V over the warp's 16 keys
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dp = 0; dp < NK; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
    }
    __syncthreads();                    // stage st is free again
  }

  // the warps' partials into shared memory (aliasing q and the ring)
  float* m_s = reinterpret_cast<float*>(smem_raw);
  float* l_s = m_s + kWarps * kMmaCols;
  float* acc_s = l_s + kWarps * kMmaCols;   // [kWarps][16][KP]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = g + 8 * i;
#pragma unroll
    for (int dt = 0; dt < 2 * NK; ++dt) {
      float* dst = acc_s + ((size_t)warp * kMmaCols + r) * KP + dt * 8 + 2 * t4;
      dst[0] = o[dt][2 * i];
      dst[1] = o[dt][2 * i + 1];
    }
    if (t4 == 0) {
      m_s[warp * kMmaCols + r] = m[i];
      l_s[warp * kMmaCols + r] = li;
    }
  }
  __syncthreads();
  block_merge<bf16>(a, w, m_s, l_s, acc_s, kMmaCols, KP);
}

// ---------------------------------------------------------------------------
// merge of the splits: one thread per output element (b, c, h, d); reads
// only the splits its lane's live pages reached.

template <typename T>
__global__ void __launch_bounds__(256)
paged_attention_merge_kernel(const Args a) {
  const size_t total = (size_t)a.B * a.C * a.H * a.K;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const size_t row = e / a.K;           // ((b * C + c) * H + h)
  const int d = (int)(e - row * a.K);
  const int b = (int)(row / ((size_t)a.C * a.H));
  const int wmax = a.pos[b] + max(a.n_feed[b], 1) - 1;
  const int n_lp = min(wmax / a.ps + 1, a.MP);
  const int used = (n_lp + a.pps - 1) / a.pps;
  const size_t plane = (size_t)a.B * a.C * a.H;
  float mx = a.neg;
  for (int s = 0; s < used; ++s)
    mx = fmaxf(mx, a.part_ml[(s * plane + row) * 2]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < used; ++s) {
    const size_t pr = s * plane + row;
    const float f = expf(a.part_ml[pr * 2] - mx);
    l = fmaf(a.part_ml[pr * 2 + 1], f, l);
    o = fmaf(a.part_acc[pr * a.K + d], f, o);
  }
  static_cast<T*>(a.out)[e] = from_f32<T>(o / fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// launches

// The column tilings the kernels take: 1 or 4 columns a block on the FMA
// route (float32 and float16, bfloat16 at C = 1, and bfloat16 chunks at
// K > 256), 16 on the tensor-core route (bfloat16, C > 1, K <= 256).  The
// wrapper's split plan picks one.
bool valid_cols(int C, int K, int dtype, int cols) {
  if (dtype != 1 || C == 1) return cols == 1 || (dtype != 1 && cols == 4);
  if (K > kMaxMmaK) return cols == 4;
  return cols == kMmaCols;
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Lanes a key row on the FMA route, chunks a lane, keys a stage.
void vec_shape(int K, int es, int& G, int& CPL, int& key_tile) {
  const int vec = 16 / es;
  const int nch = (K + vec - 1) / vec;
  G = nch <= 32 ? next_pow2(nch < 4 ? 4 : nch) : 32;
  CPL = nch <= 32 ? 1 : nch <= 64 ? 2 : 4;
  const int ldv = G * CPL * vec;
  const int rows = 32 / G;
  key_tile = 64;
  while (key_tile > kWarps * rows &&
         (size_t)4 * key_tile * ldv * es > (size_t)96 * 1024)
    key_tile >>= 1;
}

int mma_nk(int K) {
  const int nk = (K + 15) / 16;
  if (nk <= 6) return nk;
  return nk <= 8 ? 8 : 16;
}

size_t vec_smem(int K, int es, int CF, int pps) {
  int G, CPL, kt;
  vec_shape(K, es, G, CPL, kt);
  const size_t ldv = (size_t)G * CPL * (16 / es);
  const size_t stage = (size_t)4 * kt * ldv * es;
  const size_t merge = (size_t)kWarps * CF * (ldv + 2) * sizeof(float);
  return (stage > merge ? stage : merge) + (size_t)pps * sizeof(int);
}

size_t mma_smem(int K, int cols, int pps) {
  const size_t ld = (size_t)16 * mma_nk(K) + 8;
  return (cols + 4 * kMmaKeys) * ld * sizeof(bf16) +
         (size_t)pps * sizeof(int);
}

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

template <typename Kernel>
cudaError_t run(Kernel kernel, const Args& a, size_t smem,
                cudaStream_t stream) {
  cudaError_t err = prepare((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)a.n_splits * a.c_tiles * a.H * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Instantiated shapes: one chunk a lane below G = 32 (K <= 128 float32,
// K <= 256 16-bit), where bfloat16 takes one column a block and float32
// and float16 one or four; at G = 32 two chunks a lane (float32 K <= 256,
// 16-bit K <= 512) or four (float32 K <= 512), with one or four columns
// a block.
template <typename T, int G>
cudaError_t vec_cpl(const Args& a, int CPL, size_t smem, cudaStream_t s) {
  if constexpr (G == 32) {
    if constexpr (sizeof(T) == 4) {
      if (CPL == 4)
        return a.cols == 1
                   ? run(paged_attention_vec_kernel<T, G, 4, 1>, a, smem, s)
                   : run(paged_attention_vec_kernel<T, G, 4, 4>, a, smem, s);
    }
    if (CPL == 2)
      return a.cols == 1
                 ? run(paged_attention_vec_kernel<T, G, 2, 1>, a, smem, s)
                 : run(paged_attention_vec_kernel<T, G, 2, 4>, a, smem, s);
  }
  if constexpr (std::is_same<T, bf16>::value) {
    return run(paged_attention_vec_kernel<T, G, 1, 1>, a, smem, s);
  } else {
    return a.cols == 1
               ? run(paged_attention_vec_kernel<T, G, 1, 1>, a, smem, s)
               : run(paged_attention_vec_kernel<T, G, 1, 4>, a, smem, s);
  }
}

template <typename T>
cudaError_t vec_launch(const Args& a, cudaStream_t s) {
  int G, CPL, kt;
  vec_shape(a.K, sizeof(T), G, CPL, kt);
  const size_t smem = vec_smem(a.K, sizeof(T), a.cols, a.pps);
  switch (G) {
    case 4: return vec_cpl<T, 4>(a, CPL, smem, s);
    case 8: return vec_cpl<T, 8>(a, CPL, smem, s);
    case 16: return vec_cpl<T, 16>(a, CPL, smem, s);
    default: return vec_cpl<T, 32>(a, CPL, smem, s);
  }
}

cudaError_t mma_launch(const Args& a, cudaStream_t s) {
  const size_t smem = mma_smem(a.K, kMmaCols, a.pps);
  switch (mma_nk(a.K)) {
    case 1: return run(paged_attention_mma_kernel<1>, a, smem, s);
    case 2: return run(paged_attention_mma_kernel<2>, a, smem, s);
    case 3: return run(paged_attention_mma_kernel<3>, a, smem, s);
    case 4: return run(paged_attention_mma_kernel<4>, a, smem, s);
    case 5: return run(paged_attention_mma_kernel<5>, a, smem, s);
    case 6: return run(paged_attention_mma_kernel<6>, a, smem, s);
    case 8: return run(paged_attention_mma_kernel<8>, a, smem, s);
    default: return run(paged_attention_mma_kernel<16>, a, smem, s);
  }
}

template <typename T>
cudaError_t merge_launch(const Args& a, cudaStream_t s) {
  const size_t total = (size_t)a.B * a.C * a.H * a.K;
  const size_t blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffULL) return cudaErrorInvalidValue;
  paged_attention_merge_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(a);
  return cudaGetLastError();
}

// Bytes of each async copy for rows of `row_bytes` at these pools.
int copy_bytes(const void* k, const void* v, int row_bytes) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  for (int n = 16; n >= 4; n >>= 1)
    if (row_bytes % n == 0 && (bits % n) == 0) return n;
  return 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the split kernel, in bytes, for
// `cols` query columns a block.
size_t dl4j_paged_attention_smem_bytes(int cols, int K, int dtype, int pps) {
  if (cols == kMmaCols) return mma_smem(K, cols, pps);
  return vec_smem(K, dtype == 0 ? 4 : 2, cols, pps);
}

// q [B, C, H, K] and the pools [P, ps, H, K] in one dtype (0 = float32,
// 1 = bfloat16, 2 = float16), table [B, MP], pos [B], n_feed [B] int32, out like q;
// all contiguous on the current device.  The split plan: pages_per_split
// logical pages and `cols` query columns a block, n_splits = ceil(MP /
// pages_per_split); with n_splits > 1, part_ml [n_splits, B, C, H, 2] and
// part_acc [n_splits, B, C, H, K] float32 scratch.  `cols` picks the
// kernel (valid_cols).  Launches the split kernel and, with n_splits > 1,
// the merge kernel on `stream`; does not synchronise; returns
// kErrHeadDim (-1) for K > 512, cudaErrorInvalidValue for other bad
// arguments or an inconsistent plan, else the first CUDA error.
int dl4j_paged_attention(const void* q, const void* k_pages,
                         const void* v_pages, const void* table,
                         const void* pos, const void* n_feed, void* out,
                         void* part_ml, void* part_acc, int B, int C, int H,
                         int K, int P, int ps, int MP, int pages_per_split,
                         int n_splits, int cols, int dtype, void* stream) {
  if (K > kMaxK) return kErrHeadDim;
  if (B < 1 || C < 1 || H < 1 || K < 1 || P < 1 || ps < 1 ||
      MP < 1 || pages_per_split < 1 || dtype < 0 || dtype > 2 ||
      !valid_cols(C, K, dtype, cols) ||
      n_splits != (MP + pages_per_split - 1) / pages_per_split ||
      (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = dtype == 0 ? 4 : 2;
  Args a;
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.table = static_cast<const int*>(table);
  a.pos = static_cast<const int*>(pos);
  a.n_feed = static_cast<const int*>(n_feed);
  a.out = out;
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B;
  a.C = C;
  a.H = H;
  a.K = K;
  a.P = P;
  a.ps = ps;
  a.MP = MP;
  a.pps = pages_per_split;
  a.n_splits = n_splits;
  a.cols = cols;
  a.c_tiles = (C + a.cols - 1) / a.cols;
  a.copy = copy_bytes(k_pages, v_pages, K * es);
  a.scale = 1.0f / sqrtf((float)K);
  a.neg = -FLT_MAX * 0.5f;  // mask_value(float32)
  cudaError_t err;
  if (cols == kMmaCols) {
    a.key_tile = kMmaKeys;
    err = mma_launch(a, s);
  } else {
    int G, CPL, kt;
    vec_shape(K, es, G, CPL, kt);
    a.key_tile = kt;
    err = dtype == 1   ? vec_launch<bf16>(a, s)
          : dtype == 2 ? vec_launch<f16>(a, s)
                       : vec_launch<float>(a, s);
  }
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  return (int)(dtype == 1   ? merge_launch<bf16>(a, s)
               : dtype == 2 ? merge_launch<f16>(a, s)
                            : merge_launch<float>(a, s));
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

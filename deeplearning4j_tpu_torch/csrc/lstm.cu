// Fused peephole-LSTM forward scan for Hopper (sm_90a), bound to Python
// through a plain C entry point (ctypes; see deeplearning4j_tpu_torch/
// _build.py and deeplearning4j_tpu_torch/nn/layers/lstm_kernel.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/nn/layers/lstm_kernel.py
// ::_lstm_kernel (launched by _forward / fused_lstm_scan).  Same function:
// the whole time loop of one LSTM layer in one call.  For t = 0..T-1,
// with h_{-1} = c_{-1} = 0 and everything in f32:
//
//   z   = xz_t + h_{t-1} . RW                 gate order [i, f, o, g]
//   i   = sigmoid(z_i + c_{t-1} * pi)         f = sigmoid(z_f + c_{t-1} * pf)
//   g   = tanh(z_g)                           c_t = f * c_{t-1} + i * g
//   o   = sigmoid(z_o + c_t * po)             h_t = o * tanh(c_t)
//
// hs[t] = h_t in xz's dtype; with residuals also cs[t] = c_t and
// zs[t] = z (before the peephole terms), both f32, for the backward.
//
// Bound.  The call must move xz, RW and hs (plus cs and zs with
// residuals) once and do 2*T*B*H*4H flops; at the char-LSTM shape (T 64,
// B 32, H 256) both take under 10 us on an H100.  What sets the time is
// the chain of T dependent steps: each needs every unit's h_{t-1}, so
// the cost of one step (its product, its gate arithmetic and the
// exchange of h between the SMs that share the units) is paid T times.
//
// Two routes, chosen from (dtype, B, H) by make_plan (mirrored in Python
// by lstm_kernel.lstm_route_rule); no switch picks one.  float16 takes
// bf16's plan (both are 2-byte elements) and its code with the f16 forms
// swapped in: m16n8k16 .f16 products with h split into f16 hi + lo, the
// fast exponential, f16 stores of hs; c and the residuals stay f32.
//
// 1. Cluster route (bf16 and f16 H <= 512, f32 H <= 384 on an H100:
//    wherever a CTA's slice of RW, the h double buffer and the k-split
//    partials fit its shared memory).  The batch is cut into tiles of 16
//    rows (one m16 tile); each tile is one thread-block cluster of N CTAs
//    (a power of two, at most 16, with cudaFuncAttributeNonPortable-
//    ClusterSizeAllowed above 8), so the grid is N * tiles CTAs, clusters are
//    independent, and there is no grid barrier and no co-residency
//    requirement: any B runs.  CTA r owns u = roundup(ceil(H / 16), 8)
//    hidden units [r u, r u + u) and all four gate columns of them, and
//    keeps that [H, 4u] slice of RW in shared memory, in the input dtype,
//    for all T steps (transposed, rows padded against bank conflicts).
//    Each step:
//    - the product [16, H] . [H, 4u] runs on the tensor cores with
//      mma.sync: bf16 as m16n8k16 with h (f32 in the reference) split
//      into bf16 hi + lo, two products into separate accumulators, so h
//      keeps ~16 bits; f32 as 3xTF32 m16n8k8 (hi.hi + hi.lo + lo.hi),
//      which holds the f32 tolerance.  A warp owns one 8-unit block
//      (its four gate n-tiles, so one lane ends up holding i, f, o and g
//      of the same (row, unit) pairs) and a share of the k range; the
//      k-split partials are summed through shared memory;
//    - the gate arithmetic runs on the accumulator fragments; c stays in
//      the registers of the lane that owns the pair for all T steps.
//      bf16 takes the fast exponential for its gates (error ~1e-6
//      relative, far inside its output's rounding), f32 the accurate
//      expf / tanhf its 1e-5 tolerance needs (the accurate gates are a
//      large share of a bf16 step: they run on 2 of the CTA's 8 warps);
//    - h_t goes to the CTA's own slot of a double buffer [2][16][H] f32,
//      then every thread pushes 16-byte pieces of the CTA's slice into
//      the same slot of each peer through distributed shared memory
//      (cluster.map_shared_rank), and the cluster meets at one
//      barrier.cluster arrive.release / wait.acquire: h never goes to
//      L2, and the slot read at step t + 1 is never written at step t;
//    - hs, cs and zs are stored between the arrive and the wait without
//      waiting, a lane's two adjacent units as one 8-byte (4-byte for
//      bf16 hs) store where H is even, and xz of step t + 1 is loaded
//      into registers there too, so its latency hides under the barrier
//      and the next product.  (xz is prefetched into registers rather
//      than by cp.async: a bf16 gate segment of odd H is only 2-byte
//      aligned, and cp.async moves 4, 8 or 16 bytes.)
// 2. Wide route (the rest, H <= 1024): the hidden units are split over
//    all SMs, u = ceil(H / SMs) a block, each block keeping its [4u, H]
//    f32 slice of RW and the c of its rows in shared memory; h is
//    exchanged through a double-buffered f32 scratch [2, B, H] in device
//    memory (read with ld.global.cg) and the blocks meet at
//    cooperative_groups' grid barrier between steps (a cooperative
//    launch).  c of every batch row of a launch is kept in shared
//    memory, so a batch whose c does not fit is cut into the fewest
//    equal slices no larger than what fits at 16 staging rows, one
//    cooperative launch a slice (B 3040 at H 1024: 3 of 1014): any B
//    runs.
//    Dot products on the FMA pipes, `group` lanes a (row, unit) pair.

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "launch_once.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kThreads = 256;   // wide route
constexpr int kMaxRows = 32;    // wide route: batch rows of h staged per pass
constexpr int kSliceRows = 16;  // wide route: staging rows of a batch slice
constexpr int kTileRows = 16;   // cluster route: batch rows a cluster
constexpr int kMaxCluster = 16;
constexpr int kMaxWarps = 8;    // cluster route: warps a CTA, at most
constexpr int kRouteCluster = 0;
constexpr int kRouteWide = 1;

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The gate nonlinearities of the cluster route: accurate in f32, the
// fast exponential in bf16 (see the route's notes).
template <typename T>
__device__ __forceinline__ float gate_sigmoid(float x) {
  if constexpr (sizeof(T) == 2) return __fdividef(1.f, 1.f + __expf(-x));
  return sigmoid(x);
}

template <typename T>
__device__ __forceinline__ float gate_tanh(float x) {
  if constexpr (sizeof(T) == 2) return 2.f * gate_sigmoid<T>(2.f * x) - 1.f;
  return tanhf(x);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(f16* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct Plan {
  int route;         // kRouteCluster or kRouteWide
  int cluster;       // CTAs a cluster (cluster route)
  int units;         // hidden units a block
  int blocks;        // grid of one launch
  int threads;       // threads a block
  size_t smem;       // dynamic shared memory a block, bytes
  int batch_tile;    // batch rows a cluster / a launch (wide: the slice)
  int launches;      // launches a call (wide: batch slices)
  int rows;          // wide: batch rows staged per pass
  int group;         // wide: lanes a (row, unit) pair
  int k_parts;       // cluster: warps that share one unit block's k range
  int active;        // cluster: clusters the card holds at once
};

// ---------------------------------------------------------------------------
// cluster route

// Geometry of the cluster route for [H] in dtype es (bytes an element).
struct ClusterShape {
  int u, n, tasks, k_parts, warps;
  int hs;   // h row stride, floats
  int rs;   // RW slice row stride, elements
  size_t smem;
};

ClusterShape cluster_shape(int H, int es) {
  ClusterShape c;
  c.u = round_up((H + kMaxCluster - 1) / kMaxCluster, 8);
  const int live = (H + c.u - 1) / c.u;
  c.n = 1;
  while (c.n < live) c.n <<= 1;
  c.tasks = c.u / 8;
  const int kt = (H + 15) / 16;
  c.k_parts = c.tasks <= kMaxWarps ? kMaxWarps / c.tasks : 1;
  if (c.k_parts > kt) c.k_parts = kt;
  c.warps = c.tasks * c.k_parts;
  const bool half = es == 2;
  // bank-conflict-free fragment reads: the h rows 8 (bf16, float2 reads)
  // or 4 (f32) words past a multiple of 32; the RW rows 4 words past one
  c.hs = round_up(H, 32) + (half ? 8 : 4);
  c.rs = half ? round_up(H, 64) + 8 : round_up(H, 32) + 4;
  c.smem = (size_t)2 * kTileRows * c.hs * sizeof(float) +
           (size_t)(c.k_parts - 1) * c.tasks * 512 * sizeof(float) +
           (size_t)4 * c.u * c.rs * es;
  return c;
}

// m16n8k16 with f32 accumulators on 16-bit operands of type T (bf16 or
// f16: the same shapes and fragment layouts)
template <typename T>
__device__ __forceinline__ void mma_16(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x ~ hi + lo, each a pair of T (bf16 or f16) packed as the mma operand
// wants them
__device__ __forceinline__ void split_pair(float2 x, uint32_t& hi,
                                           uint32_t& lo, bf16) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x.x, x.y);
  const float2 back = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(x.x - back.x, x.y - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

__device__ __forceinline__ void split_pair(float2 x, uint32_t& hi,
                                           uint32_t& lo, f16) {
  const __half2 h2 = __floats2half2_rn(x.x, x.y);
  const float2 back = __half22float2(h2);
  const __half2 l2 = __floats2half2_rn(x.x - back.x, x.y - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// z[gate][e] (+)= h rows [0, 16) . RW columns of unit block ub, over the
// k16 steps [kt0, kt1): e = 0, 1 row g, units 2 tq, 2 tq + 1; e = 2, 3
// the same units of row g + 8.  RW in T = bf16 or f16.
template <typename T>
__device__ __forceinline__ void product(float (&z)[4][4], const float* h,
                                        const T* rw, int u, int ub,
                                        int hs, int rs, int kt0, int kt1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  float lo[4][4];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[gt][e] = lo[gt][e] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * 16 + 2 * tq;
    const float* h0 = h + g * hs + k0;
    const float* h1 = h0 + 8 * hs;
    uint32_t ahi[4], alo[4];
    split_pair(*reinterpret_cast<const float2*>(h0), ahi[0], alo[0], T());
    split_pair(*reinterpret_cast<const float2*>(h1), ahi[1], alo[1], T());
    split_pair(*reinterpret_cast<const float2*>(h0 + 8), ahi[2], alo[2], T());
    split_pair(*reinterpret_cast<const float2*>(h1 + 8), ahi[3], alo[3], T());
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
      const T* w = rw + (size_t)(gt * u + ub * 8 + g) * rs + k0;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(w);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(w + 8);
      mma_16<T>(z[gt], ahi, b0, b1);
      mma_16<T>(lo[gt], alo, b0, b1);
    }
  }
#pragma unroll
  for (int gt = 0; gt < 4; ++gt)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[gt][e] += lo[gt][e];
}

__device__ __forceinline__ void product(float (&z)[4][4], const float* h,
                                        const float* rw, int u, int ub,
                                        int hs, int rs, int kt0, int kt1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  float small[4][4];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[gt][e] = small[gt][e] = 0.f;
  for (int k8 = 2 * kt0; k8 < 2 * kt1; ++k8) {
    const int k0 = k8 * 8 + tq;
    const float x[4] = {h[g * hs + k0], h[(g + 8) * hs + k0],
                        h[g * hs + k0 + 4], h[(g + 8) * hs + k0 + 4]};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ahi[i] = tf32(x[i]);
      alo[i] = tf32(x[i] - __uint_as_float(ahi[i]));
    }
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
      const float* w = rw + (size_t)(gt * u + ub * 8 + g) * rs + k0;
      const float w0 = w[0], w1 = w[4];
      const uint32_t bh0 = tf32(w0), bh1 = tf32(w1);
      const uint32_t bl0 = tf32(w0 - __uint_as_float(bh0));
      const uint32_t bl1 = tf32(w1 - __uint_as_float(bh1));
      mma_tf32(z[gt], ahi, bh0, bh1);
      mma_tf32(small[gt], ahi, bl0, bl1);
      mma_tf32(small[gt], alo, bh0, bh1);
    }
  }
#pragma unroll
  for (int gt = 0; gt < 4; ++gt)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[gt][e] += small[gt][e];
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
lstm_cluster_kernel(const T* __restrict__ xz, const T* __restrict__ rw,
                    const T* __restrict__ pi, const T* __restrict__ pf,
                    const T* __restrict__ po, T* __restrict__ hs,
                    float* __restrict__ cs, float* __restrict__ zs, int T_,
                    int B, int H, int u, int k_parts, int hstride,
                    int rstride, long long xz_st, long long xz_sb,
                    long long hs_st, long long hs_sb) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / n;
  const int tasks = u / 8;
  const int j0 = rank * u;
  float* h_s = reinterpret_cast<float*>(smem_raw);    // [2][16][hstride]
  float* red = h_s + 2 * kTileRows * hstride;   // [k_parts-1][tasks][16][32]
  T* rw_s = reinterpret_cast<T*>(red + (size_t)(k_parts - 1) * tasks * 512);

  // this CTA's RW columns, transposed: rw_s[(gate*u + jj) * rstride + k] =
  // RW[k, gate*H + j0 + jj], zero past H in either index; kLoads loads a
  // thread in flight at a time (one at a time, the load took ~20 us)
  constexpr int kLoads = 8;
  const int cols = 4 * u;
  const int n_rw = cols * rstride;
  for (int e0 = threadIdx.x; e0 < n_rw; e0 += kLoads * blockDim.x) {
    T v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = e0 + i * blockDim.x;
      const int k = e / cols;
      const int col = e - k * cols;
      const int gate = col / u;
      const int jj = col - gate * u;
      v[i] = (e < n_rw && k < H && j0 + jj < H)
                 ? rw[(size_t)k * 4 * H + (size_t)gate * H + j0 + jj]
                 : from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = e0 + i * blockDim.x;
      const int k = e / cols;
      if (e < n_rw) rw_s[(size_t)(e - k * cols) * rstride + k] = v[i];
    }
  }
  for (int e = threadIdx.x; e < 2 * kTileRows * hstride; e += blockDim.x)
    h_s[e] = 0.f;
  cluster_arrive();   // every CTA of the cluster runs and is zeroed
  cluster_wait();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int ub = warp % tasks;          // this warp's 8-unit block
  const int kp = warp / tasks;          // and its share of the k range
  const int kt = (H + 15) / 16;
  const int kt0 = kp * kt / k_parts, kt1 = (kp + 1) * kt / k_parts;
  // this lane's (row, unit) pairs in the accumulator fragments: e = 0, 1
  // row g, e = 2, 3 row g + 8; units jj, jj + 1.  After the k-split sum
  // they belong to the warp with kp == 0, which holds their c and does
  // their gates (spreading the pairs over the k-split warps ran slower).
  const bool owner = kp == 0;
  const int jj = ub * 8 + 2 * tq;
  int brow[2], jcol[2];
  bool live_b[2], live_j[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    brow[i] = tile * kTileRows + g + 8 * i;
    live_b[i] = brow[i] < B;
    jcol[i] = j0 + jj + i;
    live_j[i] = jcol[i] < H;
  }
  // units jj, jj + 1 are stored as one pair where both are live and the
  // addresses allow it (even H and hs strides; else one at a time)
  const bool pairs = live_j[1] && H % 2 == 0 && hs_st % 2 == 0 &&
                     hs_sb % 2 == 0;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  float ppi[2], ppf[2], ppo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ppi[i] = live_j[i] ? to_f32(pi[jcol[i]]) : 0.f;
    ppf[i] = live_j[i] ? to_f32(pf[jcol[i]]) : 0.f;
    ppo[i] = live_j[i] ? to_f32(po[jcol[i]]) : 0.f;
  }
  float x[4][4];   // xz of this step, [gate][e]
  auto load_xz = [&](int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, k = e & 1;
      const bool ok = owner && live_b[i] && live_j[k];
      const T* src = xz + (long long)t * xz_st + (long long)brow[i] * xz_sb +
                     jcol[k];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt)
        x[gt][e] = ok ? to_f32(src[(size_t)gt * H]) : 0.f;
    }
  };
  load_xz(0);

  // the CTA's slice of h in 16-byte pieces: units [j0, j0 + span)
  const int span = max(0, min(u, round_up(H, 8) - j0));
  for (int t = 0; t < T_; ++t) {
    const float* h_in = h_s + (t & 1) * kTileRows * hstride;   // h_{t-1}
    float* h_out = h_s + ((t + 1) & 1) * kTileRows * hstride;  // h_t
    float z[4][4];
    product(z, h_in, rw_s, u, ub, hstride, rstride, kt0, kt1);
    if (k_parts > 1) {
      if (!owner) {
        float* r = red + ((size_t)(kp - 1) * tasks + ub) * 512 + lane;
#pragma unroll
        for (int gt = 0; gt < 4; ++gt)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[(gt * 4 + e) * 32] = z[gt][e];
      }
      __syncthreads();
      if (owner) {
        for (int p = 1; p < k_parts; ++p) {
          const float* r = red + ((size_t)(p - 1) * tasks + ub) * 512 + lane;
#pragma unroll
          for (int gt = 0; gt < 4; ++gt)
#pragma unroll
            for (int e = 0; e < 4; ++e) z[gt][e] += r[(gt * 4 + e) * 32];
        }
      }
    }
    float hv[4];
    if (owner) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = e & 1;
        const float zi = x[0][e] + z[0][e];
        const float zf = x[1][e] + z[1][e];
        const float zo = x[2][e] + z[2][e];
        const float zg = x[3][e] + z[3][e];
        x[0][e] = zi;             // keep z for the residual store
        x[1][e] = zf;
        x[2][e] = zo;
        x[3][e] = zg;
        const float ig = gate_sigmoid<T>(zi + c[e] * ppi[k]);
        const float fg = gate_sigmoid<T>(zf + c[e] * ppf[k]);
        const float gg = gate_tanh<T>(zg);
        c[e] = fg * c[e] + ig * gg;
        const float og = gate_sigmoid<T>(zo + c[e] * ppo[k]);
        hv[e] = og * gate_tanh<T>(c[e]);
      }
      if (live_j[0]) {
        *reinterpret_cast<float2*>(h_out + g * hstride + j0 + jj) =
            make_float2(hv[0], hv[1]);
        *reinterpret_cast<float2*>(h_out + (g + 8) * hstride + j0 + jj) =
            make_float2(hv[2], hv[3]);
      }
    }
    const bool more = t + 1 < T_;
    if (more) {
      __syncthreads();                  // the CTA's h_t slice is in place
      const int quads = span / 4;
      for (int e = threadIdx.x; e < (n - 1) * kTileRows * quads;
           e += blockDim.x) {
        const int p = e / (kTileRows * quads);
        const int rem = e - p * kTileRows * quads;
        const int r = rem / quads;
        const int q4 = rem - r * quads;
        const int peer = p < rank ? p : p + 1;
        float* src = h_out + r * hstride + j0 + 4 * q4;
        float* dst = cluster.map_shared_rank(src, peer);
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<float4*>(src);
      }
      cluster_arrive();
    }
    if (owner) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!live_b[i]) continue;
        const int b = brow[i];
        const size_t row = (size_t)t * B + b;
        T* hp = hs + (long long)t * hs_st + (long long)b * hs_sb + jcol[0];
        float* zp = zs == nullptr ? nullptr : zs + row * 4 * H + jcol[0];
        float* cp = cs == nullptr ? nullptr : cs + row * H + jcol[0];
        const int e = 2 * i;
        if (pairs) {
          store_pair(hp, hv[e], hv[e + 1]);
          if (zp != nullptr) {
#pragma unroll
            for (int gt = 0; gt < 4; ++gt)
              store_pair(zp + (size_t)gt * H, x[gt][e], x[gt][e + 1]);
            store_pair(cp, c[e], c[e + 1]);
          }
          continue;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (!live_j[k]) continue;
          hp[k] = from_f32<T>(hv[e + k]);
          if (zp != nullptr) {
#pragma unroll
            for (int gt = 0; gt < 4; ++gt) zp[(size_t)gt * H + k] = x[gt][e + k];
            cp[k] = c[e + k];
          }
        }
      }
      if (more) load_xz(t + 1);
    }
    if (more) cluster_wait();           // every peer's h_t has landed
  }
}

// ---------------------------------------------------------------------------
// wide route

// Shared memory, in floats: RW slice [4u][H] | h rows [rows][H + 4] |
// c [B][u]
size_t wide_floats(int B, int H, int u, int rows) {
  return (size_t)4 * u * H + (size_t)rows * (H + 4) + (size_t)B * u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_wide_kernel(const T* __restrict__ xz, const T* __restrict__ rw,
                 const T* __restrict__ pi, const T* __restrict__ pf,
                 const T* __restrict__ po, T* __restrict__ hs,
                 float* __restrict__ cs, float* __restrict__ zs,
                 float* hbuf, int T_, int B, int ldb, int H, int u,
                 int rows, int group, long long xz_st, long long xz_sb,
                 long long hs_st, long long hs_sb) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * u;
  const int ub = min(u, H - j0);  // units of this block
  const int hp = H + 4;           // padded h row
  float* rw_s = smem;                              // [4u][H]
  float* h_s = rw_s + (size_t)4 * u * H;           // [rows][hp]
  float* c_s = h_s + (size_t)rows * hp;            // [B][u]

  // this block's RW columns, transposed so that a group's lanes read
  // consecutive k: rw_s[(gate*u + jj)*H + k] = RW[k, gate*H + j0 + jj]
  const size_t n_rw = (size_t)4 * u * H;
  for (size_t e = threadIdx.x; e < n_rw; e += blockDim.x) {
    const int col = (int)(e / H);
    const int k = (int)(e - (size_t)col * H);
    const int gate = col / u;
    const int jj = col - gate * u;
    rw_s[e] = jj < ub ? to_f32(rw[(size_t)k * 4 * H + (size_t)gate * H + j0 +
                                  jj])
                      : 0.f;
  }
  for (int e = threadIdx.x; e < B * u; e += blockDim.x) c_s[e] = 0.f;
  __syncthreads();

  const int lane_g = threadIdx.x % group;
  const int slot = threadIdx.x / group;
  const int slots = blockDim.x / group;
  for (int t = 0; t < T_; ++t) {
    const float* h_in = hbuf + (size_t)((t + 1) & 1) * B * H;  // h_{t-1}
    float* h_out = hbuf + (size_t)(t & 1) * B * H;
    for (int b0 = 0; b0 < B; b0 += rows) {
      const int nb = min(rows, B - b0);
      for (int e = threadIdx.x; e < nb * H; e += blockDim.x) {
        const int r = e / H;
        const int k = e - r * H;
        h_s[r * hp + k] =
            t == 0 ? 0.f : __ldcg(h_in + (size_t)(b0 + r) * H + k);
      }
      __syncthreads();
      const int pairs = nb * ub;
      for (int q0 = 0; q0 < pairs; q0 += slots) {
        const int q = q0 + slot;
        const bool live = q < pairs;
        const int r = live ? q / ub : 0;
        const int jj = live ? q - r * ub : 0;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        if (live) {
          const float* hr = h_s + r * hp;
          const float* w0 = rw_s + (size_t)jj * H;
          const float* w1 = w0 + (size_t)u * H;
          const float* w2 = w1 + (size_t)u * H;
          const float* w3 = w2 + (size_t)u * H;
          for (int k = lane_g; k < H; k += group) {
            const float hv = hr[k];
            a0 = fmaf(hv, w0[k], a0);
            a1 = fmaf(hv, w1[k], a1);
            a2 = fmaf(hv, w2[k], a2);
            a3 = fmaf(hv, w3[k], a3);
          }
        }
        for (int o = group >> 1; o > 0; o >>= 1) {
          a0 += __shfl_xor_sync(0xffffffffu, a0, o);
          a1 += __shfl_xor_sync(0xffffffffu, a1, o);
          a2 += __shfl_xor_sync(0xffffffffu, a2, o);
          a3 += __shfl_xor_sync(0xffffffffu, a3, o);
        }
        if (live && lane_g == 0) {
          const int b = b0 + r;
          const int j = j0 + jj;
          const T* x = xz + (long long)t * xz_st + (long long)b * xz_sb;
          const float zi = to_f32(x[j]) + a0;
          const float zf = to_f32(x[H + j]) + a1;
          const float zo = to_f32(x[2 * H + j]) + a2;
          const float zg = to_f32(x[3 * H + j]) + a3;
          const float c_prev = c_s[b * u + jj];
          const float ig = sigmoid(zi + c_prev * to_f32(pi[j]));
          const float fg = sigmoid(zf + c_prev * to_f32(pf[j]));
          const float gg = tanhf(zg);
          const float c = fg * c_prev + ig * gg;
          const float og = sigmoid(zo + c * to_f32(po[j]));
          const float h = og * tanhf(c);
          c_s[b * u + jj] = c;
          h_out[(size_t)b * H + j] = h;
          hs[(long long)t * hs_st + (long long)b * hs_sb + j] = from_f32<T>(h);
          if (zs != nullptr) {
            const size_t row = (size_t)t * ldb + b;
            float* zr = zs + row * 4 * H;
            zr[j] = zi;
            zr[H + j] = zf;
            zr[2 * H + j] = zo;
            zr[3 * H + j] = zg;
            cs[row * H + j] = c;
          }
        }
      }
      __syncthreads();  // h_s is refilled by the next pass
    }
    if (t + 1 < T_) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// plans and launches

int wide_group(int rows, int u) {
  int group = 32;
  while (group > 1 && kThreads / group < rows * u) group >>= 1;
  return group;
}

// Staging rows for a slice of `b` rows: min(b, 32), halved until the
// block's shared memory fits (0 when even one row does not).
int wide_rows(int b, int H, int u, size_t optin) {
  int rows = b < kMaxRows ? b : kMaxRows;
  while (wide_floats(b, H, u, rows) * sizeof(float) > optin && rows > 1)
    rows = (rows + 1) / 2;
  return wide_floats(b, H, u, rows) * sizeof(float) > optin ? 0 : rows;
}

// The device limits, the kernels' attributes and the wide route's
// occupancy are set or read on the first (eager) call of each shape and
// remembered (launch_once.cuh): a launch under CUDA-graph capture makes
// no runtime call but the launch.
cudaError_t device_limits(int* sms, int* optin) {
  cudaError_t err =
      dl4j::device_attribute_once(cudaDevAttrMultiProcessorCount, sms);
  if (err != cudaSuccess) return err;
  return dl4j::device_attribute_once(cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                     optin);
}

// Shared-memory and cluster-size attributes of the cluster kernel, and
// the launch configuration of plan p.
template <typename T>
cudaError_t cluster_config(const Plan& p, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  const void* kernel = (const void*)lstm_cluster_kernel<T>;
  cudaError_t err = dl4j::set_attribute_once(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  if (p.cluster > 8) {
    err = dl4j::set_attribute_once(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(p.blocks);
  cfg->blockDim = dim3(p.threads);
  cfg->dynamicSmemBytes = p.smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Clusters of plan p the card holds at once (0: the launch would fail).
template <typename T>
cudaError_t active_clusters(const Plan& p, int* active) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T>(p, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(active, (void*)lstm_cluster_kernel<T>,
                                        &cfg);
}

cudaError_t make_plan(int B, int H, int es, Plan* p) {
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return err;
  const ClusterShape c = cluster_shape(H, es);
  if (c.smem <= (size_t)optin && c.tasks <= kMaxWarps) {
    p->route = kRouteCluster;
    p->cluster = c.n;
    p->units = c.u;
    p->batch_tile = kTileRows;
    const long long tiles = (B + kTileRows - 1) / kTileRows;
    if (tiles * c.n > 0x7fffffffLL) return cudaErrorInvalidValue;
    p->blocks = (int)(tiles * c.n);
    p->threads = c.warps * 32;
    p->smem = c.smem;
    p->launches = 1;
    p->k_parts = c.k_parts;
    return cudaSuccess;
  }
  int coop = 0;
  err = dl4j::device_attribute_once(cudaDevAttrCooperativeLaunch, &coop);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  p->route = kRouteWide;
  p->units = (H + sms - 1) / sms;
  p->blocks = (H + p->units - 1) / p->units;
  p->threads = kThreads;
  int bs = B;
  p->rows = wide_rows(bs, H, p->units, optin);
  p->launches = 1;
  if (p->rows == 0) {             // c of every row does not fit: slice
    const long long room = (long long)optin / (long long)sizeof(float) -
                           (long long)4 * p->units * H -
                           (long long)kSliceRows * (H + 4);
    const long long bmax = room / p->units;
    if (bmax < kSliceRows) return cudaErrorInvalidConfiguration;
    p->launches = (int)((B + bmax - 1) / bmax);
    bs = (B + p->launches - 1) / p->launches;
    p->rows = wide_rows(bs, H, p->units, optin);
    if (p->rows == 0) return cudaErrorInvalidConfiguration;
  }
  p->batch_tile = bs;
  p->group = wide_group(p->rows, p->units);
  p->smem = wide_floats(bs, H, p->units, p->rows) * sizeof(float);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_cluster(const Plan& p, const void* xz, const void* rw,
                           const void* pi, const void* pf, const void* po,
                           void* hs, void* cs, void* zs, int T_, int B,
                           int H, long long xz_st, long long xz_sb,
                           long long hs_st, long long hs_sb,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T>(p, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  const ClusterShape c = cluster_shape(H, sizeof(T));
  err = cudaLaunchKernelEx(
      &cfg, lstm_cluster_kernel<T>, static_cast<const T*>(xz),
      static_cast<const T*>(rw), static_cast<const T*>(pi),
      static_cast<const T*>(pf), static_cast<const T*>(po),
      static_cast<T*>(hs), static_cast<float*>(cs), static_cast<float*>(zs),
      T_, B, H, c.u, c.k_parts, c.hs, c.rs, xz_st, xz_sb, hs_st, hs_sb);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const Plan& p, const void* xz, const void* rw,
                        const void* pi, const void* pf, const void* po,
                        void* hs, void* cs, void* zs, void* hbuf, int T_,
                        int B, int H, long long xz_st, long long xz_sb,
                        long long hs_st, long long hs_sb,
                        cudaStream_t stream) {
  auto kernel = lstm_wide_kernel<T>;
  cudaError_t err = dl4j::set_attribute_once(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return err;
  int sms = 0, optin = 0, per_sm = 0;
  err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return err;
  err = dl4j::max_active_blocks_once(&per_sm, (const void*)kernel, kThreads,
                                     p.smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < p.blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  for (int b0 = 0; b0 < B; b0 += p.batch_tile) {
    const T* a_xz = static_cast<const T*>(xz) + b0 * xz_sb;
    const T* a_rw = static_cast<const T*>(rw);
    const T* a_pi = static_cast<const T*>(pi);
    const T* a_pf = static_cast<const T*>(pf);
    const T* a_po = static_cast<const T*>(po);
    T* a_hs = static_cast<T*>(hs) + b0 * hs_sb;
    float* a_cs = cs ? static_cast<float*>(cs) + (size_t)b0 * H : nullptr;
    float* a_zs = zs ? static_cast<float*>(zs) + (size_t)b0 * 4 * H : nullptr;
    float* a_hbuf = static_cast<float*>(hbuf);
    int a_t = T_, a_b = min(p.batch_tile, B - b0), a_ldb = B, a_h = H,
        a_u = p.units, a_rows = p.rows, a_group = p.group;
    void* args[] = {&a_xz,  &a_rw,   &a_pi,    &a_pf,  &a_po,  &a_hs,
                    &a_cs,  &a_zs,   &a_hbuf,  &a_t,   &a_b,   &a_ldb,
                    &a_h,   &a_u,    &a_rows,  &a_group, &xz_st, &xz_sb,
                    &hs_st, &hs_sb};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.blocks),
                                      dim3(kThreads), args, p.smem, stream);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* xz, const void* rw, const void* pi,
                   const void* pf, const void* po, void* hs, void* cs,
                   void* zs, void* hbuf, int T_, int B, int H,
                   long long xz_st, long long xz_sb, long long hs_st,
                   long long hs_sb, cudaStream_t stream) {
  Plan p = {};
  cudaError_t err = make_plan(B, H, sizeof(T), &p);
  if (err != cudaSuccess) return err;
  if (p.route == kRouteCluster)
    return launch_cluster<T>(p, xz, rw, pi, pf, po, hs, cs, zs, T_, B, H,
                             xz_st, xz_sb, hs_st, hs_sb, stream);
  if (hbuf == nullptr) return cudaErrorInvalidValue;
  return launch_wide<T>(p, xz, rw, pi, pf, po, hs, cs, zs, hbuf, T_, B, H,
                        xz_st, xz_sb, hs_st, hs_sb, stream);
}

}  // namespace

extern "C" {

// The launch plan of a [B, H] problem in `dtype` (0 = float32, 1 =
// bfloat16, 2 = float16) on the current device: out = {route (0 cluster, 1 wide),
// cluster size, hidden units a block, blocks a launch, threads a block,
// shared-memory bytes a block, batch rows a cluster (cluster) or a launch
// (wide), launches a call, staging rows (wide), lanes a pair (wide),
// k-parts (cluster), clusters the card holds at once (cluster)}.
// Returns the CUDA error of the device queries, or
// cudaErrorInvalidConfiguration when no route fits.
int dl4j_lstm_plan(int B, int H, int dtype, long long* out) {
  if (B < 1 || H < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  Plan p = {};
  cudaError_t err = make_plan(B, H, dtype == 0 ? 4 : 2, &p);
  if (err == cudaSuccess && p.route == kRouteCluster) {
    err = dtype == 1   ? active_clusters<bf16>(p, &p.active)
          : dtype == 2 ? active_clusters<f16>(p, &p.active)
                       : active_clusters<float>(p, &p.active);
    if (err == cudaSuccess && p.active < 1)
      err = cudaErrorInvalidConfiguration;
  }
  const long long v[12] = {p.route,   p.cluster,    p.units,    p.blocks,
                           p.threads, (long long)p.smem, p.batch_tile,
                           p.launches, p.rows,      p.group,    p.k_parts,
                           p.active};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return (int)err;
}

// xz [T, B, 4H] (element (t, b, c) at t*xz_st + b*xz_sb + c), RW [H, 4H]
// contiguous, pi/pf/po [H], all in one dtype (0 = float32, 1 = bfloat16,
// 2 = float16);
// hs [T, B, H] in that dtype at t*hs_st + b*hs_sb + j; cs [T, B, H] and
// zs [T, B, 4H] contiguous float32, both null for the inference forward;
// hbuf [2, batch rows a launch, H] float32 scratch of the wide route
// (null on the cluster route).  Launches on `stream` the route
// dl4j_lstm_plan names; no synchronisation; returns the first launch
// error, else cudaGetLastError().
int dl4j_lstm_forward(const void* xz, const void* rw, const void* pi,
                      const void* pf, const void* po, void* hs, void* cs,
                      void* zs, void* hbuf, int T, int B, int H,
                      long long xz_st, long long xz_sb, long long hs_st,
                      long long hs_sb, int dtype, void* stream) {
  if (T < 1 || B < 1 || H < 1 || (cs == nullptr) != (zs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(xz, rw, pi, pf, po, hs, cs, zs, hbuf, T, B, H,
                              xz_st, xz_sb, hs_st, hs_sb, s);
  if (dtype == 1)
    return (int)launch<bf16>(xz, rw, pi, pf, po, hs, cs, zs, hbuf, T, B, H,
                             xz_st, xz_sb, hs_st, hs_sb, s);
  if (dtype == 2)
    return (int)launch<f16>(xz, rw, pi, pf, po, hs, cs, zs, hbuf, T, B, H,
                            xz_st, xz_sb, hs_st, hs_sb, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl4j_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

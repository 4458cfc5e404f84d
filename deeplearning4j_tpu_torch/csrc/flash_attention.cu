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
//
// Numerics.  Inputs (float32 or bfloat16) are converted to f32 when a
// tile is staged in shared memory; every product and sum is f32; outputs
// and gradients are stored in the input dtype.  Masked scores are -1e30
// and their probabilities are set to 0, as on the TPU; the normaliser is
// clamped at 1e-30.  dK and dQ carry the 1/sqrt(D) factor, dV does not.
//
// Design for the card.  The TPU kernels run a sequential grid axis with
// f32 accumulators in VMEM scratch.  Here one thread block owns one
// 64-row tile (a query tile for fwd and dq, a key tile for dkv) and walks
// the other axis in a loop, with its accumulators in registers.  256
// threads form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j of every 64 x 64 score tile (i, j < 4), so a row's 16
// owners are 16 consecutive lanes of one warp and row reductions are
// half-warp shuffles.  Tiles live in shared memory as f32 with rows padded
// to D + 1 floats, so the 16 lanes reading 16 different rows at one column
// hit 16 different banks.  Fully masked causal tiles are skipped by the
// loop bounds (the TPU's dynamic bounds and pl.when guards).
//
// Bound.  At the training shape (S = 1024, D = 64) every kernel does
// O(S) flops per byte it must move, far above the card's ridge: all three
// are bound by operations.  This first version computes on the f32 FMA
// pipes (67 TFLOP/s) rather than the tensor cores (989 TFLOP/s in bf16),
// which caps it at a few percent of the bf16 bound; the tensor-core path
// (wgmma with TMA-fed tiles, warp-specialised) is a later change.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;              // rows of a query or key tile
constexpr int kSub = 16;               // threads along each tile edge
constexpr int kThreads = kSub * kSub;  // 256
constexpr int kPer = kTile / kSub;     // tile rows (and cols) per thread
constexpr int kMaxD = 128;
constexpr int kLdp = kTile + 1;        // padded row of a score tile
constexpr float kNegInf = -1e30f;      // the TPU kernels' NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
// launches

cudaError_t prepare(const void* kernel, size_t smem) {
  int dev = 0;
  int max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes: kind 0 = forward,
// 1 = dK/dV, 2 = dQ.
size_t dl4j_flash_smem_bytes(int kind, int D) {
  const size_t f = kind == 0 ? fwd_floats(D)
                             : kind == 1 ? dkv_floats(D) : dq_floats(D);
  return f * sizeof(float);
}

// Every entry takes contiguous [B, S, H, D] tensors in one dtype
// (0 = float32, 1 = bfloat16) and [B*H, S] float32 row stats on the
// current device, launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.

// out [B, S, H, D] and lse [B*H, S] of flash attention over q, k, v.
int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int H, int D, int causal,
                   int dtype, void* stream) {
  if (bad_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DL4J_DISPATCH(fwd, q, k, v, out, lse, B, S, H, D, causal, s);
}

// dk, dv of flash attention given dO = g and the row stats lse, delta.
int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int D,
                       int causal, int dtype, void* stream) {
  if (bad_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DL4J_DISPATCH(dkv, q, k, v, g, lse, delta, dk, dv, B, S, H, D, causal, s);
}

// dq of flash attention given dO = g and the row stats lse, delta.
int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dqp, int B, int S, int H, int D, int causal,
                      int dtype, void* stream) {
  if (bad_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DL4J_DISPATCH(dq, q, k, v, g, lse, delta, dqp, B, S, H, D, causal, s);
}

const char* dl4j_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused peephole-LSTM forward scan for Hopper (sm_90a), bound to Python
// through a plain C entry point (ctypes; see deeplearning4j_tpu_torch/
// _build.py and deeplearning4j_tpu_torch/nn/layers/lstm_kernel.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/nn/layers/lstm_kernel.py
// ::_lstm_kernel (launched by _forward / fused_lstm_scan).  Same function:
// the whole time loop of one LSTM layer in one launch.  For t = 0..T-1,
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
// Design for the card.  The TPU kernel kept RW [H, 4H] whole in VMEM and
// ran the time axis as its sequential grid.  RW does not fit one SM's
// shared memory at H = 256 (1 MiB in f32), so here the HIDDEN UNITS are
// split over the blocks: block k owns units [k*u, k*u + u) and all four
// gate columns of them (j, H+j, 2H+j, 3H+j).  It loads its [4u, H] slice
// of RW into shared memory once, as f32, and keeps it for all T steps;
// i/f/o/g, the peephole terms and c are then local to the block, and c
// never leaves shared memory.  Only h is exchanged between blocks,
// through a double-buffered f32 scratch [2, B, H] in device memory
// (slot t & 1 holds h_t), read with ld.global.cg so no stale L1 line is
// seen.  Step t needs every block's h_{t-1}: the launch is cooperative
// (all blocks co-resident, the host checks the occupancy) and the blocks
// meet at cooperative_groups' grid barrier between steps.  The carry is
// f32 throughout; hs is only an output.
//
// Per step a block stages up to `rows` batch rows of h_{t-1} in shared
// memory and computes its rows x u (batch row, unit) pairs, each by a
// group of `group` consecutive lanes that split the H-long dot products
// and reduce with shuffles.
//
// Bound: T dependent steps.  The whole launch must move xz, RW and hs
// (plus cs and zs with residuals) once and do 2*T*B*H*4H flops; at the
// char-LSTM shape (T 64, B 32, H 256) both take under 10 us on an H100,
// while every step pays a grid barrier, the L2 round trip of h and the
// block's serial dot products: the chain of T steps, not bytes or flops,
// sets the time (about 13 us a step, PERF.md section 6).  What a later
// change does about it: a thread-block cluster exchanging h through
// distributed shared memory (no trip to L2, a cluster barrier instead of
// a grid barrier), and tensor-core products.
//
// Largest H: the shared memory a block needs is
// 4 * (4u*H + rows*(H+4) + B*u) bytes with u = ceil(H / SMs), and the
// host halves `rows` until it fits the 227 KB a block may have.  On 132
// SMs, H = 1024 (u = 8, RW slice 128 KiB) fits up to B = 1112 at 16 rows
// and up to B = 3039 at one row; H = 256 (u = 2) up to B = 27 902.
// The Python wrapper refuses H > 1024.

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;   // batch rows of h staged per pass

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Plan {
  int units;    // hidden units per block (u)
  int blocks;   // ceil(H / u)
  int rows;     // batch rows per staging pass
  int group;    // lanes per (row, unit) pair
  size_t smem;  // dynamic shared memory per block, bytes
};

// Shared memory, in floats: RW slice [4u][H] | h rows [rows][H + 4] |
// c [B][u]
size_t smem_floats(int B, int H, int u, int rows) {
  return (size_t)4 * u * H + (size_t)rows * (H + 4) + (size_t)B * u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_forward_kernel(const T* __restrict__ xz, const T* __restrict__ rw,
                    const T* __restrict__ pi, const T* __restrict__ pf,
                    const T* __restrict__ po, T* __restrict__ hs,
                    float* __restrict__ cs, float* __restrict__ zs,
                    float* hbuf, int T_, int B, int H, int u, int rows,
                    int group, long long xz_st, long long xz_sb,
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
            const size_t row = (size_t)t * B + b;
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

cudaError_t make_plan(int B, int H, Plan* p) {
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  p->units = (H + sms - 1) / sms;
  p->blocks = (H + p->units - 1) / p->units;
  p->rows = B < kMaxRows ? B : kMaxRows;
  p->smem = smem_floats(B, H, p->units, p->rows) * sizeof(float);
  while (p->smem > (size_t)optin && p->rows > 1) {
    p->rows = (p->rows + 1) / 2;
    p->smem = smem_floats(B, H, p->units, p->rows) * sizeof(float);
  }
  const int pairs = p->rows * p->units;
  p->group = 32;
  while (p->group > 1 && kThreads / p->group < pairs) p->group >>= 1;
  if (p->smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* xz, const void* rw, const void* pi,
                   const void* pf, const void* po, void* hs, void* cs,
                   void* zs, void* hbuf, int T_, int B, int H,
                   long long xz_st, long long xz_sb, long long hs_st,
                   long long hs_sb, cudaStream_t stream) {
  Plan p;
  cudaError_t err = make_plan(B, H, &p);
  if (err != cudaSuccess) return err;
  auto kernel = lstm_forward_kernel<T>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, p.smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < p.blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  const T* a_xz = static_cast<const T*>(xz);
  const T* a_rw = static_cast<const T*>(rw);
  const T* a_pi = static_cast<const T*>(pi);
  const T* a_pf = static_cast<const T*>(pf);
  const T* a_po = static_cast<const T*>(po);
  T* a_hs = static_cast<T*>(hs);
  float* a_cs = static_cast<float*>(cs);
  float* a_zs = static_cast<float*>(zs);
  float* a_hbuf = static_cast<float*>(hbuf);
  int a_t = T_, a_b = B, a_h = H, a_u = p.units, a_rows = p.rows,
      a_group = p.group;
  void* args[] = {&a_xz,   &a_rw,   &a_pi,    &a_pf,   &a_po,   &a_hs,
                  &a_cs,   &a_zs,   &a_hbuf,  &a_t,    &a_b,    &a_h,
                  &a_u,    &a_rows, &a_group, &xz_st,  &xz_sb,  &hs_st,
                  &hs_sb};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.blocks),
                                    dim3(kThreads), args, p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for a [B, H] problem on the current device:
// out = {units per block, blocks, rows per pass, lanes per pair,
// shared-memory bytes}.  Returns the CUDA error of the device queries, or
// cudaErrorInvalidConfiguration when the shared memory does not fit.
int dl4j_lstm_plan(int B, int H, long long* out) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  p.units = p.blocks = p.rows = p.group = 0;
  p.smem = 0;
  const cudaError_t err = make_plan(B, H, &p);
  out[0] = p.units;
  out[1] = p.blocks;
  out[2] = p.rows;
  out[3] = p.group;
  out[4] = (long long)p.smem;
  return (int)err;
}

// xz [T, B, 4H] (element (t, b, c) at t*xz_st + b*xz_sb + c), RW [H, 4H]
// contiguous, pi/pf/po [H], all in one dtype (0 = float32, 1 = bfloat16);
// hs [T, B, H] in that dtype at t*hs_st + b*hs_sb + j; cs [T, B, H] and
// zs [T, B, 4H] contiguous float32, both null for the inference forward;
// hbuf [2, B, H] float32 scratch.  One cooperative launch on `stream`; no
// synchronisation; returns the launch's error, else cudaGetLastError().
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
    return (int)launch<__nv_bfloat16>(xz, rw, pi, pf, po, hs, cs, zs, hbuf,
                                      T, B, H, xz_st, xz_sb, hs_st, hs_sb, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl4j_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// K1: instance norm + affine + activation over an NHWC tensor, forward and
// backward, for Hopper (sm_90a).
//
// Forward: replaces the Pallas TPU kernel sggan_tpu/ops/pallas_in.py
// (instance_norm_pallas: _pallas_forward, body _in_kernel).  Same math:
// per (sample, channel), f32 sum and sum of squares over the H*W plane,
// var = max(E[x^2] - mean^2, 0), y = (x - mean) / sqrt(var + eps),
// y = y * gamma + beta, then none / relu / leaky_relu(alpha), stored in the
// input dtype (f32 or bf16, round to nearest even).
//
// Bound: memory.  It does ~8 flops per element against 2 reads and 1
// write of the activation, which are the floor: the statistics need the
// whole plane before the first output can be written, and at the serving
// shapes (8-16 MiB per sample) a plane does not stay in one SM's shared
// memory.
//
// Why two launches: the Pallas kernel carries the sums across a
// sequential grid in VMEM scratch (phase 0, then phase 1 over the same
// blocks).  Hopper blocks run in no order, so the sums cross a kernel
// boundary instead:
//   1. in_stats: grid (spatial split, 32-channel tile, sample); each block
//      writes f32 partial (sum, sum of squares) for its rows and channels
//      to a scratch (N, n_split, 2, C) that the wrapper allocates;
//   2. in_apply: the same grid; each block first combines the n_split
//      partials of its channels (fixed order, so the result is
//      deterministic), then normalizes its rows.
// The spatial split is chosen by the wrapper so that batch 1 still puts
// several blocks on each of the 132 SMs.  When the caller passes mean and
// rstd buffers, in_apply's split-0 blocks also write the (N, C) f32 moments
// the backward needs.
//
// Backward: replaces the custom VJP of the JAX package's fused instance
// norm, sggan_tpu/ops/norm.py::_in_fused_bwd (the TPU kernel's own VJP,
// pallas_in.py _bwd, is autodiff of the same math).  Per (sample, channel),
// with xhat = (x - mean) * rstd recomputed from the saved x and moments:
//   the act gate on pre = xhat * gamma + beta: relu passes dy where
//   pre > 0, leaky_relu passes dy where pre >= 0 and alpha * dy elsewhere;
//   S1 = sum(dy_g), S2 = sum(dy_g * xhat) over the H*W plane, in f32;
//   dx = rstd * gamma * (dy_g - S1 / S - xhat * S2 / S), in x's dtype;
//   dgamma = sum over samples of S2, dbeta = sum over samples of S1.
// Bound: memory, like the forward.  The floor is 2 reads of (x, dy) and 1
// write of dx: dx needs the whole plane's S1 and S2 first.  The same two
// launches: in_bwd_stats writes f32 partial (S1, S2) per split to the
// (N, n_split, 2, C) scratch; in_bwd_apply combines them in a fixed order
// and writes dx, recomputing xhat and the gated dy rather than storing
// them.  dgamma and dbeta are the scratch summed over samples and splits
// by the wrapper.
//
// Layout: x is read as (N, S = H*W, C), C fastest.  The 32 lanes of a
// warp take 32 neighbouring channels of one row, so each warp access is
// one contiguous run of the row; the block's 8 warps take 8 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // channels per block
constexpr int kRows = 8;    // rows per block step, one warp each
constexpr int kThreads = kLanes * kRows;

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_stats(const T* __restrict__ x, float* __restrict__ part, int s, int c,
         int rows_per_split) {
  const int split = blockIdx.x, n = blockIdx.z;
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int ch = blockIdx.y * kLanes + lane;
  const int r_end = min((split + 1) * rows_per_split, s);
  float s1 = 0.f, s2 = 0.f;
  if (ch < c) {
    const T* xp = x + (size_t)n * s * c + ch;
    for (int r = split * rows_per_split + row; r < r_end; r += kRows) {
      const float v = to_f32(xp[(size_t)r * c]);
      s1 += v;
      s2 += v * v;
    }
  }
  __shared__ float sh1[kRows][kLanes], sh2[kRows][kLanes];
  sh1[row][lane] = s1;
  sh2[row][lane] = s2;
  __syncthreads();
  if (row == 0 && ch < c) {
    for (int i = 1; i < kRows; ++i) {
      s1 += sh1[i][lane];
      s2 += sh2[i][lane];
    }
    float* pp = part + ((size_t)n * gridDim.x + split) * 2 * c;
    pp[ch] = s1;
    pp[c + ch] = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_apply(const T* __restrict__ x, const float* __restrict__ part,
         const float* __restrict__ gamma, const float* __restrict__ beta,
         T* __restrict__ y, float* __restrict__ mean_out,
         float* __restrict__ rstd_out, int s, int c, int rows_per_split,
         int act, float eps, float alpha) {
  const int split = blockIdx.x, n = blockIdx.z, n_split = gridDim.x;
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int ch = blockIdx.y * kLanes + lane;

  // combine the partials of this block's channels: warp w sums splits
  // w, w + 8, ...; then warp 0 sums the 8 warps in order
  __shared__ float sh1[kRows][kLanes], sh2[kRows][kLanes];
  float s1 = 0.f, s2 = 0.f;
  if (ch < c) {
    const float* pp = part + (size_t)n * n_split * 2 * c;
    for (int i = row; i < n_split; i += kRows) {
      s1 += pp[(size_t)i * 2 * c + ch];
      s2 += pp[(size_t)i * 2 * c + c + ch];
    }
  }
  sh1[row][lane] = s1;
  sh2[row][lane] = s2;
  __syncthreads();
  __shared__ float sh_mean[kLanes], sh_rstd[kLanes];
  if (row == 0) {
    for (int i = 1; i < kRows; ++i) {
      s1 += sh1[i][lane];
      s2 += sh2[i][lane];
    }
    const float mean = s1 / (float)s;
    const float var = fmaxf(s2 / (float)s - mean * mean, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
    sh_mean[lane] = mean;
    sh_rstd[lane] = rstd;
    if (mean_out != nullptr && split == 0 && ch < c) {
      mean_out[(size_t)n * c + ch] = mean;
      rstd_out[(size_t)n * c + ch] = rstd;
    }
  }
  __syncthreads();
  if (ch >= c) return;

  const float mean = sh_mean[lane], rstd = sh_rstd[lane];
  const float g = gamma[ch], b = beta[ch];
  const size_t base = (size_t)n * s * c + ch;
  const int r_end = min((split + 1) * rows_per_split, s);
  for (int r = split * rows_per_split + row; r < r_end; r += kRows) {
    const size_t i = base + (size_t)r * c;
    float v = (to_f32(x[i]) - mean) * rstd;
    v = v * g + b;
    if (act == kRelu) {
      v = fmaxf(v, 0.f);
    } else if (act == kLeakyRelu) {
      v = v >= 0.f ? v : alpha * v;
    }
    store(y + i, v);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           void* part, void* mean, void* rstd, int n, int s, int c,
           int rows_per_split, int n_split, int act, float eps, float alpha,
           cudaStream_t stream) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  in_stats<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), s, c,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_apply<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(part),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), s, c, rows_per_split, act, eps, alpha);
  return (int)cudaGetLastError();
}

// dy gated by the activation, recomputed from the normalized input.  pre
// is rounded after the product and after the sum, not fused into one fma,
// so that the gate decides as the plain version's two rounded ops do even
// for a pre-activation within an ulp of 0: one element gated otherwise
// moves its whole plane's dx through the sums.
__device__ __forceinline__ float gate(float g, float xhat, float gamma,
                                      float beta, int act, float alpha) {
  if (act == kNone) return g;
  const float pre = __fadd_rn(__fmul_rn(xhat, gamma), beta);
  if (act == kRelu) return pre > 0.f ? g : 0.f;
  return pre >= 0.f ? g : alpha * g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_stats(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             float* __restrict__ part, int s, int c, int rows_per_split,
             int act, float alpha) {
  const int split = blockIdx.x, n = blockIdx.z;
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int ch = blockIdx.y * kLanes + lane;
  const int r_end = min((split + 1) * rows_per_split, s);
  float s1 = 0.f, s2 = 0.f;
  if (ch < c) {
    const float m = mean[(size_t)n * c + ch], r = rstd[(size_t)n * c + ch];
    const float g = gamma[ch], b = beta[ch];
    const size_t base = (size_t)n * s * c + ch;
    for (int i = split * rows_per_split + row; i < r_end; i += kRows) {
      const size_t k = base + (size_t)i * c;
      const float xhat = (to_f32(x[k]) - m) * r;
      const float d = gate(to_f32(dy[k]), xhat, g, b, act, alpha);
      s1 += d;
      s2 += d * xhat;
    }
  }
  __shared__ float sh1[kRows][kLanes], sh2[kRows][kLanes];
  sh1[row][lane] = s1;
  sh2[row][lane] = s2;
  __syncthreads();
  if (row == 0 && ch < c) {
    for (int i = 1; i < kRows; ++i) {
      s1 += sh1[i][lane];
      s2 += sh2[i][lane];
    }
    float* pp = part + ((size_t)n * gridDim.x + split) * 2 * c;
    pp[ch] = s1;
    pp[c + ch] = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ part, T* __restrict__ dx, int s, int c,
             int rows_per_split, int act, float alpha) {
  const int split = blockIdx.x, n = blockIdx.z, n_split = gridDim.x;
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int ch = blockIdx.y * kLanes + lane;

  // combine the partials in the forward's fixed order
  __shared__ float sh1[kRows][kLanes], sh2[kRows][kLanes];
  float s1 = 0.f, s2 = 0.f;
  if (ch < c) {
    const float* pp = part + (size_t)n * n_split * 2 * c;
    for (int i = row; i < n_split; i += kRows) {
      s1 += pp[(size_t)i * 2 * c + ch];
      s2 += pp[(size_t)i * 2 * c + c + ch];
    }
  }
  sh1[row][lane] = s1;
  sh2[row][lane] = s2;
  __syncthreads();
  __shared__ float sh_mdy[kLanes], sh_mdyx[kLanes];
  if (row == 0) {
    for (int i = 1; i < kRows; ++i) {
      s1 += sh1[i][lane];
      s2 += sh2[i][lane];
    }
    sh_mdy[lane] = s1 / (float)s;
    sh_mdyx[lane] = s2 / (float)s;
  }
  __syncthreads();
  if (ch >= c) return;

  const float m_dy = sh_mdy[lane], m_dyx = sh_mdyx[lane];
  const float m = mean[(size_t)n * c + ch], r = rstd[(size_t)n * c + ch];
  const float g = gamma[ch], b = beta[ch];
  const float scale = r * g;
  const size_t base = (size_t)n * s * c + ch;
  const int r_end = min((split + 1) * rows_per_split, s);
  for (int i = split * rows_per_split + row; i < r_end; i += kRows) {
    const size_t k = base + (size_t)i * c;
    const float xhat = (to_f32(x[k]) - m) * r;
    const float d = gate(to_f32(dy[k]), xhat, g, b, act, alpha);
    store(dx + k, scale * (d - m_dy - xhat * m_dyx));
  }
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* gamma,
               const void* beta, const void* mean, const void* rstd,
               void* part, void* dx, int n, int s, int c, int rows_per_split,
               int n_split, int act, float alpha, cudaStream_t stream) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  in_bwd_stats<T><<<grid, kThreads, 0, stream>>>(
      xt, dyt, g, b, m, r, static_cast<float*>(part), s, c, rows_per_split,
      act, alpha);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_bwd_apply<T><<<grid, kThreads, 0, stream>>>(
      xt, dyt, g, b, m, r, static_cast<const float*>(part),
      static_cast<T*>(dx), s, c, rows_per_split, act, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (n, s, c) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// gamma, beta: (c,) f32; part: (n, n_split, 2, c) f32 scratch with
// n_split * rows_per_split >= s; mean, rstd: (n, c) f32 outputs, or both
// null.  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launches.
extern "C" int sggan_instance_norm_fwd(const void* x, const void* gamma,
                                       const void* beta, void* y, void* part,
                                       void* mean, void* rstd, int n, int s,
                                       int c, int rows_per_split,
                                       int n_split, int is_bf16, int act,
                                       float eps, float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, gamma, beta, y, part, mean, rstd, n, s,
                                 c, rows_per_split, n_split, act, eps, alpha,
                                 st);
  return launch<float>(x, gamma, beta, y, part, mean, rstd, n, s, c,
                       rows_per_split, n_split, act, eps, alpha, st);
}

// x, dy, dx: (n, s, c) contiguous, all f32 or all bf16; gamma, beta: (c,)
// f32; mean, rstd: (n, c) f32 from the forward; part: (n, n_split, 2, c)
// f32, written with the per-split (sum dy_g, sum dy_g * xhat).  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int sggan_instance_norm_bwd(const void* x, const void* dy,
                                       const void* gamma, const void* beta,
                                       const void* mean, const void* rstd,
                                       void* part, void* dx, int n, int s,
                                       int c, int rows_per_split, int n_split,
                                       int is_bf16, int act, float alpha,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(x, dy, gamma, beta, mean, rstd, part, dx,
                                     n, s, c, rows_per_split, n_split, act,
                                     alpha, st);
  return launch_bwd<float>(x, dy, gamma, beta, mean, rstd, part, dx, n, s, c,
                           rows_per_split, n_split, act, alpha, st);
}

// K1 forward: instance norm + affine + activation over an NHWC tensor,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sggan_tpu/ops/pallas_in.py
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
// several blocks on each of the 132 SMs.
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
         T* __restrict__ y, int s, int c, int rows_per_split, int act,
         float eps, float alpha) {
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
    sh_mean[lane] = mean;
    sh_rstd[lane] = 1.f / sqrtf(var + eps);
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
           void* part, int n, int s, int c, int rows_per_split, int n_split,
           int act, float eps, float alpha, cudaStream_t stream) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  in_stats<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), s, c,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_apply<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(part),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(y), s, c, rows_per_split, act, eps, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (n, s, c) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// gamma, beta: (c,) f32; part: (n, n_split, 2, c) f32 scratch with
// n_split * rows_per_split >= s.  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError() after the launches.
extern "C" int sggan_instance_norm_fwd(const void* x, const void* gamma,
                                       const void* beta, void* y, void* part,
                                       int n, int s, int c,
                                       int rows_per_split, int n_split,
                                       int is_bf16, int act, float eps,
                                       float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, gamma, beta, y, part, n, s, c,
                                 rows_per_split, n_split, act, eps, alpha, st);
  return launch<float>(x, gamma, beta, y, part, n, s, c, rows_per_split,
                       n_split, act, eps, alpha, st);
}

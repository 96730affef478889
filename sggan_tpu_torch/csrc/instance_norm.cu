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
// Backward: replaces the custom VJP of the JAX package's fused instance
// norm, sggan_tpu/ops/norm.py::_in_fused_bwd (the TPU kernel's own VJP,
// pallas_in.py _bwd, is autodiff of the same math).  Per (sample, channel),
// with xhat = (x - mean) * rstd recomputed from the saved x and moments:
//   the act gate on pre = xhat * gamma + beta: relu passes dy where
//   pre > 0, leaky_relu passes dy where pre >= 0 and alpha * dy elsewhere;
//   S1 = sum(dy_g), S2 = sum(dy_g * xhat) over the H*W plane, in f32;
//   dx = rstd * gamma * (dy_g - S1 / S - xhat * S2 / S), in x's dtype;
//   dgamma = sum over samples of S2, dbeta = sum over samples of S1.
//
// Bound: memory.  A few flops per element against the bytes of x (and dy);
// the sums need the whole plane before the first output, so a kernel that
// cannot hold a plane reads it twice.
//
// A block owns 32 neighbouring channels (a channel tile) of one sample's
// rows; its 256 threads each move a packet of 16 bytes (8 bf16 or 4 f32
// channels of one row), so a row of the tile is 4 (bf16) or 8 (f32)
// threads and a thread step covers 64 or 32 rows.  Three routes, chosen
// by the wrapper from shape, dtype and alignment before the launch
// (ops/cuda_in.py::plan):
//   cluster (one launch): a cluster of k CTAs (k <= 8, or 16 with the
//     non-portable attribute) owns one (sample, channel tile) slab and
//     brings it into shared memory once with 16-byte cp.async copies; each
//     CTA sums its rows, the partials are combined across the cluster
//     through distributed shared memory in rank order, and the outputs
//     are formed from shared memory with 16-byte stores.  Traffic: forward
//     x + y, backward x + dy + dx, the bound itself.
//   stream (two launches): for planes no cluster holds.  A stats launch
//     writes f32 partial sums per (sample, spatial split, channel) to a
//     scratch; an apply launch combines them in a fixed order and writes
//     the output, reading x (and dy) again.  16-byte packets, four in
//     flight per thread.
//   scalar (two launches): the stream kernels with one element per thread
//     (a warp's 32 lanes on 32 channels of one row), for C that is no
//     multiple of a packet or a pointer that is not 16-byte aligned.
// Every sum is taken in a fixed order (warp butterfly, warps in order,
// splits or cluster ranks in order), so two calls give the same bits.
//
// The spatial path (sggan_tpu/parallel/spatial.py::instance_norm_sp, a
// plane split across ranks) reaches the two-pass routes' kernels through
// entries of their own, one a pass, so that the caller can sum the
// moments across ranks between them: pass 1 (in_stats, then in_combine)
// gives the local block's per-(sample, channel) sums; pass 2 (in_apply,
// fed the global sums as a single partial) divides by the plane's global
// count.  The backward alike: in_bwd_stats and in_combine give the local
// (S1, S2) and this rank's dgamma, dbeta from them; in_bwd_apply, fed
// the global sums, gives dx.  Its relu passes half of dy where the
// pre-activation is exactly 0 (kReluTie), as JAX's maximum does there.
//
// dgamma and dbeta: each (sample, channel tile)'s first block writes the
// plane's (S1, S2) to a scratch (N, 2, C) and counts itself on an integer
// counter; the last to arrive (__threadfence, atomicAdd) sums the scratch
// over the samples in order, writes dgamma and dbeta, and resets the
// counter to 0.  No float atomics and no library reduction.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;  // channels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // packets in flight per thread, stream routes

// kReluTie: relu whose gate passes half of dy where the pre-activation is
// exactly 0, the subgradient JAX gives jnp.maximum(y, 0) at a tie; the
// spatial path's act (sggan_tpu/parallel/spatial.py:186), never the
// one-card path's.
enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2, kReluTie = 3 };
enum Route { kScalar = 0, kStream = 1, kCluster = 2 };

// ---- packets: VEC channels of one row, raw (16 bytes, or one element) and
// as floats ---------------------------------------------------------------

template <typename T, int VEC>
struct Packet {
  using type = uint4;
};
template <typename T>
struct Packet<T, 1> {
  using type = T;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Packet<T, VEC>::type ldp(const T* p) {
  return *reinterpret_cast<const typename Packet<T, VEC>::type*>(p);
}

__device__ __forceinline__ void unpack(float v, float (&f)[1]) { f[0] = v; }
__device__ __forceinline__ void unpack(__nv_bfloat16 v, float (&f)[1]) {
  f[0] = __bfloat162float(v);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void ld(const T* p, float (&f)[VEC]) {
  unpack(ldp<T, VEC>(p), f);
}

__device__ __forceinline__ void st(float* p, const float (&f)[1]) { *p = f[0]; }
__device__ __forceinline__ void st(__nv_bfloat16* p, const float (&f)[1]) {
  *p = __float2bfloat16_rn(f[0]);
}
__device__ __forceinline__ void st(float* p, const float (&f)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      __float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
      __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void st(__nv_bfloat16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
      pack2(f[6], f[7]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// ---- the math -----------------------------------------------------------

__device__ __forceinline__ float act_fwd(float v, int act, float alpha) {
  if (act == kRelu || act == kReluTie) return fmaxf(v, 0.f);
  if (act == kLeakyRelu) return v >= 0.f ? v : alpha * v;
  return v;
}

// var = max(E[x^2] - mean^2, 0), with mean^2 rounded before the
// subtraction, not fused into one fma: where the plane's variance is
// far below mean^2 (a 1x1 plane has none) the fma leaves the rounding
// error of mean^2, up to half an ulp (5e-7 at |mean| 3), beside eps 1e-3
// in rstd, where the plain version's two rounded ops leave 0.
__device__ __forceinline__ float moments_var(float msq, float mean) {
  return fmaxf(__fsub_rn(msq, __fmul_rn(mean, mean)), 0.f);
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
  if (act == kReluTie) return pre > 0.f ? g : (pre == 0.f ? 0.5f * g : 0.f);
  return pre >= 0.f ? g : alpha * g;
}

// Where a thread sits in its block: packet v (channels v * VEC ...) of the
// tile, first row r0, rows advancing by RSTEP.
template <int VEC>
struct Lane {
  static constexpr int V = kLanes / VEC;        // packets per tile row
  static constexpr int RSTEP = kThreads / V;    // rows per thread step
  int v, r0, ch0;
  bool live;
  __device__ Lane(int c) {
    v = threadIdx.x % V;
    r0 = threadIdx.x / V;
    ch0 = blockIdx.y * kLanes + v * VEC;
    live = ch0 < c;  // c % VEC == 0: a packet is wholly in or out
  }
};

// The block's sums of (a, b) per tile channel, into out[0 / 1][channel]:
// a butterfly over the lanes that share a packet position, then the warps
// in order.  Ends with the block synchronised.
template <int VEC>
__device__ __forceinline__ void block_sum(float (&a)[VEC], float (&b)[VEC],
                                          float (&ws)[2][kWarps][kLanes],
                                          float (&out)[2][kLanes]) {
  constexpr int V = kLanes / VEC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = V; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
      b[j] += __shfl_xor_sync(0xffffffffu, b[j], off);
    }
  }
  if (lane < V) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      ws[0][warp][lane * VEC + j] = a[j];
      ws[1][warp][lane * VEC + j] = b[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < kLanes) {
    float s = 0.f, t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += ws[0][w][threadIdx.x];
      t += ws[1][w][threadIdx.x];
    }
    out[0][threadIdx.x] = s;
    out[1][threadIdx.x] = t;
  }
  __syncthreads();
}

// Sum the n_split partials (n, n_split, 2, c) of this block's tile in a
// fixed order: warp w takes splits w, w + 8, ...; then the warps in order.
// out[0 / 1][tile channel].  Ends with the block synchronised.
__device__ __forceinline__ void combine_parts(const float* part, int c,
                                              int n_split,
                                              float (&ws)[2][kWarps][kLanes],
                                              float (&out)[2][kLanes]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = blockIdx.y * kLanes + lane;
  float s1 = 0.f, s2 = 0.f;
  if (ch < c) {
    const float* pp = part + (size_t)blockIdx.z * n_split * 2 * c;
    for (int i = warp; i < n_split; i += kWarps) {
      s1 += pp[(size_t)i * 2 * c + ch];
      s2 += pp[(size_t)i * 2 * c + c + ch];
    }
  }
  ws[0][warp][lane] = s1;
  ws[1][warp][lane] = s2;
  __syncthreads();
  if (threadIdx.x < kLanes) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += ws[0][w][threadIdx.x];
      b += ws[1][w][threadIdx.x];
    }
    out[0][threadIdx.x] = a;
    out[1][threadIdx.x] = b;
  }
  __syncthreads();
}

// Called by every block with blockIdx.x == 0 after its threads < kLanes
// wrote this (sample, tile)'s (S1, S2) to sums (n, 2, c).  The last such
// block of the grid sums them over the samples in order into dgamma and
// dbeta and resets the counter.
__device__ __forceinline__ void finish_dgamma(const float* sums,
                                              float* dgamma, float* dbeta,
                                              unsigned* counter, int c) {
  __shared__ bool last;
  __threadfence();  // this block's sums are visible before it counts
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned blocks = gridDim.y * gridDim.z;
    last = atomicAdd(counter, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n = gridDim.z;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < n; ++i) {
      s1 += __ldcg(sums + (size_t)i * 2 * c + ch);
      s2 += __ldcg(sums + (size_t)i * 2 * c + c + ch);
    }
    dbeta[ch] = s1;
    dgamma[ch] = s2;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// ---- stream and scalar routes: grid (n_split, tiles, n) -----------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
in_stats(const T* __restrict__ x, float* __restrict__ part, int s, int c,
         int rows_per_split) {
  using L = Lane<VEC>;
  const L ln(c);
  const int split = blockIdx.x, n = blockIdx.z;
  const int r_end = min((split + 1) * rows_per_split, s);
  float s1[VEC] = {}, s2[VEC] = {};
  if (ln.live) {
    const T* xp = x + (size_t)n * s * c + ln.ch0;
    for (int r = split * rows_per_split + ln.r0; r < r_end;
         r += kUnroll * L::RSTEP) {
      typename Packet<T, VEC>::type raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * L::RSTEP < r_end)
          raw[u] = ldp<T, VEC>(xp + (size_t)(r + u * L::RSTEP) * c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * L::RSTEP < r_end) {
          float f[VEC];
          unpack(raw[u], f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            s1[j] += f[j];
            s2[j] += f[j] * f[j];
          }
        }
    }
  }
  __shared__ float ws[2][kWarps][kLanes], tot[2][kLanes];
  block_sum<VEC>(s1, s2, ws, tot);
  const int ch = blockIdx.y * kLanes + threadIdx.x;
  if (threadIdx.x < kLanes && ch < c) {
    float* pp = part + ((size_t)n * gridDim.x + split) * 2 * c;
    pp[ch] = tot[0][threadIdx.x];
    pp[c + ch] = tot[1][threadIdx.x];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
in_apply(const T* __restrict__ x, const float* __restrict__ part,
         const float* __restrict__ gamma, const float* __restrict__ beta,
         T* __restrict__ y, float* __restrict__ mean_out,
         float* __restrict__ rstd_out, int s, int c, int rows_per_split,
         int act, float eps, float alpha, int n_part, float count) {
  using L = Lane<VEC>;
  const int split = blockIdx.x, n = blockIdx.z;
  __shared__ float ws[2][kWarps][kLanes], tot[2][kLanes];
  combine_parts(part, c, n_part, ws, tot);
  __shared__ float sh_mean[kLanes], sh_rstd[kLanes];
  if (threadIdx.x < kLanes) {
    const float mean = tot[0][threadIdx.x] / count;
    const float var = moments_var(tot[1][threadIdx.x] / count, mean);
    const float rstd = 1.f / sqrtf(var + eps);
    sh_mean[threadIdx.x] = mean;
    sh_rstd[threadIdx.x] = rstd;
    const int ch = blockIdx.y * kLanes + threadIdx.x;
    if (split == 0 && ch < c) {
      mean_out[(size_t)n * c + ch] = mean;
      rstd_out[(size_t)n * c + ch] = rstd;
    }
  }
  __syncthreads();
  const L ln(c);
  if (!ln.live) return;
  float m[VEC], r[VEC], g[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = sh_mean[ln.v * VEC + j];
    r[j] = sh_rstd[ln.v * VEC + j];
    g[j] = gamma[ln.ch0 + j];
    b[j] = beta[ln.ch0 + j];
  }
  const size_t base = (size_t)n * s * c + ln.ch0;
  const int r_end = min((split + 1) * rows_per_split, s);
  for (int row = split * rows_per_split + ln.r0; row < r_end;
       row += kUnroll * L::RSTEP) {
    typename Packet<T, VEC>::type raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (row + u * L::RSTEP < r_end)
        raw[u] = ldp<T, VEC>(x + base + (size_t)(row + u * L::RSTEP) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (row + u * L::RSTEP < r_end) {
        float f[VEC];
        unpack(raw[u], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float v = (f[j] - m[j]) * r[j];
          v = v * g[j] + b[j];
          f[j] = act_fwd(v, act, alpha);
        }
        st(y + base + (size_t)(row + u * L::RSTEP) * c, f);
      }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
in_bwd_stats(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             float* __restrict__ part, int s, int c, int rows_per_split,
             int act, float alpha) {
  using L = Lane<VEC>;
  const L ln(c);
  const int split = blockIdx.x, n = blockIdx.z;
  const int r_end = min((split + 1) * rows_per_split, s);
  float s1[VEC] = {}, s2[VEC] = {};
  if (ln.live) {
    float m[VEC], r[VEC], g[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = mean[(size_t)n * c + ln.ch0 + j];
      r[j] = rstd[(size_t)n * c + ln.ch0 + j];
      g[j] = gamma[ln.ch0 + j];
      b[j] = beta[ln.ch0 + j];
    }
    const size_t base = (size_t)n * s * c + ln.ch0;
    for (int row = split * rows_per_split + ln.r0; row < r_end;
         row += kUnroll * L::RSTEP) {
      typename Packet<T, VEC>::type rx[kUnroll], rd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + u * L::RSTEP < r_end) {
          const size_t k = base + (size_t)(row + u * L::RSTEP) * c;
          rx[u] = ldp<T, VEC>(x + k);
          rd[u] = ldp<T, VEC>(dy + k);
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + u * L::RSTEP < r_end) {
          float fx[VEC], fd[VEC];
          unpack(rx[u], fx);
          unpack(rd[u], fd);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float xhat = (fx[j] - m[j]) * r[j];
            const float d = gate(fd[j], xhat, g[j], b[j], act, alpha);
            s1[j] += d;
            s2[j] += d * xhat;
          }
        }
    }
  }
  __shared__ float ws[2][kWarps][kLanes], tot[2][kLanes];
  block_sum<VEC>(s1, s2, ws, tot);
  const int ch = blockIdx.y * kLanes + threadIdx.x;
  if (threadIdx.x < kLanes && ch < c) {
    float* pp = part + ((size_t)n * gridDim.x + split) * 2 * c;
    pp[ch] = tot[0][threadIdx.x];
    pp[c + ch] = tot[1][threadIdx.x];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
in_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ part, T* __restrict__ dx,
             float* __restrict__ sums, float* __restrict__ dgamma,
             float* __restrict__ dbeta, unsigned* __restrict__ counter, int s,
             int c, int rows_per_split, int act, float alpha, int n_part,
             float count) {
  using L = Lane<VEC>;
  const int split = blockIdx.x, n = blockIdx.z;
  __shared__ float ws[2][kWarps][kLanes], tot[2][kLanes];
  combine_parts(part, c, n_part, ws, tot);
  // sums null: the spatial path's second pass, fed the sums of every
  // shard, writes dx alone (its dgamma and dbeta came from the first)
  if (split == 0 && sums != nullptr) {
    const int ch = blockIdx.y * kLanes + threadIdx.x;
    if (threadIdx.x < kLanes && ch < c) {
      sums[(size_t)n * 2 * c + ch] = tot[0][threadIdx.x];
      sums[(size_t)n * 2 * c + c + ch] = tot[1][threadIdx.x];
    }
  }
  const L ln(c);
  if (ln.live) {
    float m[VEC], r[VEC], g[VEC], b[VEC], mdy[VEC], mdyx[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = mean[(size_t)n * c + ln.ch0 + j];
      r[j] = rstd[(size_t)n * c + ln.ch0 + j];
      g[j] = gamma[ln.ch0 + j];
      b[j] = beta[ln.ch0 + j];
      mdy[j] = tot[0][ln.v * VEC + j] / count;
      mdyx[j] = tot[1][ln.v * VEC + j] / count;
    }
    const size_t base = (size_t)n * s * c + ln.ch0;
    const int r_end = min((split + 1) * rows_per_split, s);
    for (int row = split * rows_per_split + ln.r0; row < r_end;
         row += kUnroll * L::RSTEP) {
      typename Packet<T, VEC>::type rx[kUnroll], rd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + u * L::RSTEP < r_end) {
          const size_t k = base + (size_t)(row + u * L::RSTEP) * c;
          rx[u] = ldp<T, VEC>(x + k);
          rd[u] = ldp<T, VEC>(dy + k);
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + u * L::RSTEP < r_end) {
          float fx[VEC], fd[VEC];
          unpack(rx[u], fx);
          unpack(rd[u], fd);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float xhat = (fx[j] - m[j]) * r[j];
            const float d = gate(fd[j], xhat, g[j], b[j], act, alpha);
            fx[j] = r[j] * g[j] * (d - mdy[j] - xhat * mdyx[j]);
          }
          st(dx + base + (size_t)(row + u * L::RSTEP) * c, fx);
        }
    }
  }
  if (split == 0 && sums != nullptr)
    finish_dgamma(sums, dgamma, dbeta, counter, c);
}

// The spatial path's end of a first pass: the n_split partials (n, n_split,
// 2, c) of each (sample, channel) summed in combine_parts' fixed order into
// sums (n, 2, c); with dgamma non-null (the backward's), the last block
// also sums them over the samples into dgamma and dbeta (finish_dgamma).
// Grid (1, tiles, n).
__global__ void __launch_bounds__(kThreads)
in_combine(const float* __restrict__ part, float* __restrict__ sums,
           float* __restrict__ dgamma, float* __restrict__ dbeta,
           unsigned* __restrict__ counter, int c, int n_split) {
  __shared__ float ws[2][kWarps][kLanes], tot[2][kLanes];
  combine_parts(part, c, n_split, ws, tot);
  const int ch = blockIdx.y * kLanes + threadIdx.x;
  if (threadIdx.x < kLanes && ch < c) {
    sums[(size_t)blockIdx.z * 2 * c + ch] = tot[0][threadIdx.x];
    sums[(size_t)blockIdx.z * 2 * c + c + ch] = tot[1][threadIdx.x];
  }
  if (dgamma != nullptr) finish_dgamma(sums, dgamma, dbeta, counter, c);
}

// ---- cluster route: grid (k, tiles, n), cluster (k, 1, 1) ---------------
//
// CTA `rank` of the cluster holds rows [rank * rows, (rank + 1) * rows) of
// the (sample, tile) slab in dynamic shared memory, packet by packet; each
// thread reads back only the packets it copied itself, so the copies need
// no block barrier, only the thread's own cp.async wait.

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_fwd_cluster(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ y,
               float* __restrict__ mean_out, float* __restrict__ rstd_out,
               int s, int c, int rows, int act, float eps, float alpha) {
  constexpr int VEC = 16 / sizeof(T);
  using L = Lane<VEC>;
  extern __shared__ uint4 slab[];  // rows x L::V packets
  __shared__ float ws[2][kWarps][kLanes], tot[2][kLanes];
  __shared__ float sh_mean[kLanes], sh_rstd[kLanes];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), k = (int)cluster.num_blocks();
  const int n = blockIdx.z;
  const L ln(c);
  const int r_begin = rank * rows, nr = min(rows, s - r_begin);
  const size_t base = ((size_t)n * s + r_begin) * c + ln.ch0;

  if (ln.live)
    for (int r = ln.r0; r < nr; r += L::RSTEP)
      cp_async16(&slab[r * L::V + ln.v], x + base + (size_t)r * c);
  cp_async_wait_all();
  float s1[VEC] = {}, s2[VEC] = {};
  if (ln.live)
    for (int r = ln.r0; r < nr; r += L::RSTEP) {
      float f[VEC];
      ld(reinterpret_cast<const T*>(&slab[r * L::V + ln.v]), f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1[j] += f[j];
        s2[j] += f[j] * f[j];
      }
    }
  block_sum<VEC>(s1, s2, ws, tot);

  cluster.sync();  // every CTA's partials are in its shared memory
  if (threadIdx.x < kLanes) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < k; ++q) {  // rank order: the same bits in every CTA
      const float* p = cluster.map_shared_rank(&tot[0][0], q);
      a += p[threadIdx.x];
      b += p[kLanes + threadIdx.x];
    }
    const float mean = a / (float)s;
    const float var = moments_var(b / (float)s, mean);
    const float rstd = 1.f / sqrtf(var + eps);
    sh_mean[threadIdx.x] = mean;
    sh_rstd[threadIdx.x] = rstd;
    const int ch = blockIdx.y * kLanes + threadIdx.x;
    if (rank == 0 && ch < c) {
      mean_out[(size_t)n * c + ch] = mean;
      rstd_out[(size_t)n * c + ch] = rstd;
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partials
  if (!ln.live) return;
  float m[VEC], r[VEC], g[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = sh_mean[ln.v * VEC + j];
    r[j] = sh_rstd[ln.v * VEC + j];
    g[j] = gamma[ln.ch0 + j];
    b[j] = beta[ln.ch0 + j];
  }
  for (int row = ln.r0; row < nr; row += L::RSTEP) {
    float f[VEC];
    ld(reinterpret_cast<const T*>(&slab[row * L::V + ln.v]), f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = (f[j] - m[j]) * r[j];
      v = v * g[j] + b[j];
      f[j] = act_fwd(v, act, alpha);
    }
    st(y + base + (size_t)row * c, f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_cluster(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ gamma,
               const float* __restrict__ beta,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               T* __restrict__ dx, float* __restrict__ sums,
               float* __restrict__ dgamma, float* __restrict__ dbeta,
               unsigned* __restrict__ counter, int s, int c, int rows,
               int act, float alpha) {
  constexpr int VEC = 16 / sizeof(T);
  using L = Lane<VEC>;
  extern __shared__ uint4 slab[];  // x, then dy: rows x L::V packets each
  __shared__ float ws[2][kWarps][kLanes], tot[2][kLanes];
  __shared__ float sh_mdy[kLanes], sh_mdyx[kLanes];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), k = (int)cluster.num_blocks();
  const int n = blockIdx.z;
  const L ln(c);
  const int r_begin = rank * rows, nr = min(rows, s - r_begin);
  const size_t base = ((size_t)n * s + r_begin) * c + ln.ch0;
  uint4* const sx = slab;
  uint4* const sd = slab + (size_t)rows * L::V;

  if (ln.live)
    for (int r = ln.r0; r < nr; r += L::RSTEP) {
      cp_async16(&sx[r * L::V + ln.v], x + base + (size_t)r * c);
      cp_async16(&sd[r * L::V + ln.v], dy + base + (size_t)r * c);
    }
  float m[VEC], rs[VEC], g[VEC], b[VEC];
  if (ln.live) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = mean[(size_t)n * c + ln.ch0 + j];
      rs[j] = rstd[(size_t)n * c + ln.ch0 + j];
      g[j] = gamma[ln.ch0 + j];
      b[j] = beta[ln.ch0 + j];
    }
  }
  cp_async_wait_all();
  float s1[VEC] = {}, s2[VEC] = {};
  if (ln.live)
    for (int r = ln.r0; r < nr; r += L::RSTEP) {
      float fx[VEC], fd[VEC];
      ld(reinterpret_cast<const T*>(&sx[r * L::V + ln.v]), fx);
      ld(reinterpret_cast<const T*>(&sd[r * L::V + ln.v]), fd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (fx[j] - m[j]) * rs[j];
        const float d = gate(fd[j], xhat, g[j], b[j], act, alpha);
        s1[j] += d;
        s2[j] += d * xhat;
      }
    }
  block_sum<VEC>(s1, s2, ws, tot);

  cluster.sync();
  if (threadIdx.x < kLanes) {
    float a = 0.f, bb = 0.f;
    for (int q = 0; q < k; ++q) {
      const float* p = cluster.map_shared_rank(&tot[0][0], q);
      a += p[threadIdx.x];
      bb += p[kLanes + threadIdx.x];
    }
    sh_mdy[threadIdx.x] = a / (float)s;
    sh_mdyx[threadIdx.x] = bb / (float)s;
    const int ch = blockIdx.y * kLanes + threadIdx.x;
    if (rank == 0 && ch < c) {
      sums[(size_t)n * 2 * c + ch] = a;
      sums[(size_t)n * 2 * c + c + ch] = bb;
    }
  }
  cluster.sync();
  if (ln.live) {
    float mdy[VEC], mdyx[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mdy[j] = sh_mdy[ln.v * VEC + j];
      mdyx[j] = sh_mdyx[ln.v * VEC + j];
    }
    for (int row = ln.r0; row < nr; row += L::RSTEP) {
      float fx[VEC], fd[VEC];
      ld(reinterpret_cast<const T*>(&sx[row * L::V + ln.v]), fx);
      ld(reinterpret_cast<const T*>(&sd[row * L::V + ln.v]), fd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (fx[j] - m[j]) * rs[j];
        const float d = gate(fd[j], xhat, g[j], b[j], act, alpha);
        fx[j] = rs[j] * g[j] * (d - mdy[j] - xhat * mdyx[j]);
      }
      st(dx + base + (size_t)row * c, fx);
    }
  }
  if (rank == 0) finish_dgamma(sums, dgamma, dbeta, counter, c);
}

// ---- launches -----------------------------------------------------------

template <typename T>
size_t cluster_smem(int rows, int tensors) {
  return (size_t)rows * kLanes * sizeof(T) * tensors;
}

// A launch of grid (k, tiles, n) in clusters of (k, 1, 1); `attr` holds
// the cluster attribute the returned config points to.
cudaLaunchConfig_t cluster_config(int k, int tiles, int n, size_t smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, tiles, n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kern, typename... Args>
int launch_cluster(Kern kern, int k, int tiles, int n, size_t smem,
                   cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(k, tiles, n, smem, st, &attr);
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename T, int VEC>
int fwd_two_pass(const T* x, const float* gamma, const float* beta, T* y,
                 float* mean, float* rstd, float* part, int n, int s, int c,
                 int rows, int n_split, int act, float eps, float alpha,
                 cudaStream_t st) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  in_stats<T, VEC><<<grid, kThreads, 0, st>>>(x, part, s, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_apply<T, VEC><<<grid, kThreads, 0, st>>>(x, part, gamma, beta, y, mean,
                                              rstd, s, c, rows, act, eps,
                                              alpha, n_split, (float)s);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* xv, const void* gv, const void* bv, void* yv, float* ws,
        int n, int s, int c, int route, int k, int rows, int n_split, int act,
        float eps, float alpha, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const float* g = static_cast<const float*>(gv);
  const float* b = static_cast<const float*>(bv);
  T* y = static_cast<T*>(yv);
  float* mean = ws;
  float* rstd = ws + (size_t)n * c;
  float* part = ws + (size_t)2 * n * c;
  if (route == kCluster)
    return launch_cluster(in_fwd_cluster<T>, k, (c + kLanes - 1) / kLanes, n,
                          cluster_smem<T>(rows, 1), st, x, g, b, y, mean,
                          rstd, s, c, rows, act, eps, alpha);
  if (route == kStream)
    return fwd_two_pass<T, VEC>(x, g, b, y, mean, rstd, part, n, s, c, rows,
                                n_split, act, eps, alpha, st);
  return fwd_two_pass<T, 1>(x, g, b, y, mean, rstd, part, n, s, c, rows,
                            n_split, act, eps, alpha, st);
}

template <typename T, int VEC>
int bwd_two_pass(const T* x, const T* dy, const float* g, const float* b,
                 const float* mean, const float* rstd, T* dx, float* sums,
                 float* dgamma, float* dbeta, float* part, unsigned* counter,
                 int n, int s, int c, int rows, int n_split, int act,
                 float alpha, cudaStream_t st) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  in_bwd_stats<T, VEC><<<grid, kThreads, 0, st>>>(x, dy, g, b, mean, rstd,
                                                  part, s, c, rows, act,
                                                  alpha);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_bwd_apply<T, VEC><<<grid, kThreads, 0, st>>>(
      x, dy, g, b, mean, rstd, part, dx, sums, dgamma, dbeta, counter, s, c,
      rows, act, alpha, n_split, (float)s);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* xv, const void* dyv, const void* gv, const void* bv,
        const void* mv, const void* rv, void* dxv, float* ws,
        unsigned* counter, int n, int s, int c, int route, int k, int rows,
        int n_split, int act, float alpha, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  const float* g = static_cast<const float*>(gv);
  const float* b = static_cast<const float*>(bv);
  const float* mean = static_cast<const float*>(mv);
  const float* rstd = static_cast<const float*>(rv);
  T* dx = static_cast<T*>(dxv);
  float* dgamma = ws;
  float* dbeta = ws + c;
  float* sums = ws + 2 * (size_t)c;
  float* part = sums + (size_t)2 * n * c;
  if (route == kCluster)
    return launch_cluster(in_bwd_cluster<T>, k, (c + kLanes - 1) / kLanes, n,
                          cluster_smem<T>(rows, 2), st, x, dy, g, b, mean,
                          rstd, dx, sums, dgamma, dbeta, counter, s, c, rows,
                          act, alpha);
  if (route == kStream)
    return bwd_two_pass<T, VEC>(x, dy, g, b, mean, rstd, dx, sums, dgamma,
                                dbeta, part, counter, n, s, c, rows, n_split,
                                act, alpha, st);
  return bwd_two_pass<T, 1>(x, dy, g, b, mean, rstd, dx, sums, dgamma, dbeta,
                            part, counter, n, s, c, rows, n_split, act, alpha,
                            st);
}

template <typename Kern>
int allow_large_clusters(Kern kern) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  int optin = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename Kern>
int max_clusters(Kern kern, int k, size_t smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(k, 1, 1, smem, 0, &attr);
  int count = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&count, kern, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// ---- the spatial path: K1's two passes with the moments summed across
// ranks between them (sggan_tpu/parallel/spatial.py::instance_norm_sp).
// Pass 1 sums the local block to (n, 2, c); the caller all-reduces those
// sums over the ranks that hold one plane; pass 2 normalizes from the
// global sums and `count`, the global H * W.  Stream (VEC packets) or
// scalar route only: the cluster route holds a whole plane and has no
// point between its passes for the sum across ranks.

template <typename T, int VEC>
int sp_stats(const T* x, float* part, float* sums, int n, int s, int c,
             int rows, int n_split, cudaStream_t st) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  in_stats<T, VEC><<<grid, kThreads, 0, st>>>(x, part, s, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_combine<<<dim3(1, grid.y, n), kThreads, 0, st>>>(part, sums, nullptr,
                                                      nullptr, nullptr, c,
                                                      n_split);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int sp_apply(const T* x, const float* sums, const float* g, const float* b,
             T* y, float* mean, float* rstd, int n, int s, int c, int rows,
             int n_split, int act, float eps, float alpha, float count,
             cudaStream_t st) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  in_apply<T, VEC><<<grid, kThreads, 0, st>>>(x, sums, g, b, y, mean, rstd,
                                              s, c, rows, act, eps, alpha, 1,
                                              count);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int sp_bwd_stats(const T* x, const T* dy, const float* g, const float* b,
                 const float* mean, const float* rstd, float* part,
                 float* sums, float* dgamma, float* dbeta, unsigned* counter,
                 int n, int s, int c, int rows, int n_split, int act,
                 float alpha, cudaStream_t st) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  in_bwd_stats<T, VEC><<<grid, kThreads, 0, st>>>(x, dy, g, b, mean, rstd,
                                                  part, s, c, rows, act,
                                                  alpha);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_combine<<<dim3(1, grid.y, n), kThreads, 0, st>>>(part, sums, dgamma,
                                                      dbeta, counter, c,
                                                      n_split);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int sp_bwd_apply(const T* x, const T* dy, const float* g, const float* b,
                 const float* mean, const float* rstd, const float* sums,
                 T* dx, int n, int s, int c, int rows, int n_split, int act,
                 float alpha, float count, cudaStream_t st) {
  const dim3 grid(n_split, (c + kLanes - 1) / kLanes, n);
  in_bwd_apply<T, VEC><<<grid, kThreads, 0, st>>>(
      x, dy, g, b, mean, rstd, sums, dx, nullptr, nullptr, nullptr, nullptr,
      s, c, rows, act, alpha, 1, count);
  return (int)cudaGetLastError();
}

}  // namespace

// Once per device, before the first launch: lets the cluster kernels take
// the opt-in shared memory and clusters of 16.  Returns a CUDA error code.
extern "C" int sggan_instance_norm_init() {
  int err = allow_large_clusters(in_fwd_cluster<float>);
  if (!err) err = allow_large_clusters(in_fwd_cluster<__nv_bfloat16>);
  if (!err) err = allow_large_clusters(in_bwd_cluster<float>);
  if (!err) err = allow_large_clusters(in_bwd_cluster<__nv_bfloat16>);
  return err;
}

// How many clusters of the cluster route fit on the card at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error code.
extern "C" int sggan_instance_norm_max_clusters(int backward, int is_bf16,
                                                int k, int rows) {
  if (backward)
    return is_bf16 ? max_clusters(in_bwd_cluster<__nv_bfloat16>, k,
                                  cluster_smem<__nv_bfloat16>(rows, 2))
                   : max_clusters(in_bwd_cluster<float>, k,
                                  cluster_smem<float>(rows, 2));
  return is_bf16 ? max_clusters(in_fwd_cluster<__nv_bfloat16>, k,
                                cluster_smem<__nv_bfloat16>(rows, 1))
                 : max_clusters(in_fwd_cluster<float>, k,
                                cluster_smem<float>(rows, 1));
}

// x, y: (n, s, c) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// gamma, beta: (c,) f32; ws: f32 workspace [mean (n, c) | rstd (n, c) |
// part (n, n_split, 2, c)], the moments written on every route.  route:
// 0 scalar, 1 stream (c % packet == 0, 16-byte aligned x and y), 2
// cluster (the same, and a cluster of k CTAs of `rows` rows holds the
// plane).  rows: rows per split (two-pass routes) or per CTA (cluster).
// Launches on `stream` and does not synchronise; returns the launch's
// CUDA error code.
extern "C" int sggan_instance_norm_fwd(const void* x, const void* gamma,
                                       const void* beta, void* y, float* ws,
                                       int n, int s, int c, int route, int k,
                                       int rows, int n_split, int is_bf16,
                                       int act, float eps, float alpha,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fwd<__nv_bfloat16>(x, gamma, beta, y, ws, n, s, c, route, k, rows,
                              n_split, act, eps, alpha, st);
  return fwd<float>(x, gamma, beta, y, ws, n, s, c, route, k, rows, n_split,
                    act, eps, alpha, st);
}

// x, dy, dx: (n, s, c) contiguous, all f32 or all bf16; gamma, beta: (c,)
// f32; mean, rstd: (n, c) f32 from the forward; ws: f32 workspace [dgamma
// (c) | dbeta (c) | sums (n, 2, c) | part (n, n_split, 2, c)]; counter: one
// unsigned, 0 between calls (the kernel resets it), private to the stream.
// Routes and rows as the forward's.  Launches on `stream` and does not
// synchronise; returns the launch's CUDA error code.
extern "C" int sggan_instance_norm_bwd(const void* x, const void* dy,
                                       const void* gamma, const void* beta,
                                       const void* mean, const void* rstd,
                                       void* dx, float* ws, unsigned* counter,
                                       int n, int s, int c, int route, int k,
                                       int rows, int n_split, int is_bf16,
                                       int act, float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bwd<__nv_bfloat16>(x, dy, gamma, beta, mean, rstd, dx, ws, counter,
                              n, s, c, route, k, rows, n_split, act, alpha,
                              st);
  return bwd<float>(x, dy, gamma, beta, mean, rstd, dx, ws, counter, n, s, c,
                    route, k, rows, n_split, act, alpha, st);
}

// The spatial path's entries.  x, dy, y, dx: the local block (n, s, c),
// f32 (is_bf16 = 0) or bf16; gamma, beta: (c,) f32; mean, rstd: (n, c)
// f32; sums: (n, 2, c) f32, rows of c floats [S1 | S2] per sample; part:
// f32 scratch (n, n_split, 2, c); count: the plane's global H * W.  route
// 1 (stream: c % packet == 0, 16-byte aligned tensors) or 0 (scalar), rows
// per split as the one-card entries'.  Each launches on `stream` without
// synchronising and returns the launch's CUDA error code.

// Pass 1 forward: the local block's (sum x, sum x^2) into sums.
extern "C" int sggan_instance_norm_sp_stats(const void* x, float* part,
                                            float* sums, int n, int s, int c,
                                            int route, int rows, int n_split,
                                            int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != kStream && route != kScalar) return (int)cudaErrorInvalidValue;
  return is_bf16
             ? (route == kStream
                    ? sp_stats<__nv_bfloat16, 8>(
                          static_cast<const __nv_bfloat16*>(x), part, sums, n,
                          s, c, rows, n_split, st)
                    : sp_stats<__nv_bfloat16, 1>(
                          static_cast<const __nv_bfloat16*>(x), part, sums, n,
                          s, c, rows, n_split, st))
             : (route == kStream
                    ? sp_stats<float, 4>(static_cast<const float*>(x), part,
                                         sums, n, s, c, rows, n_split, st)
                    : sp_stats<float, 1>(static_cast<const float*>(x), part,
                                         sums, n, s, c, rows, n_split, st));
}

// Pass 2 forward: y, mean and rstd from the global sums and count.
extern "C" int sggan_instance_norm_sp_apply(
    const void* x, const float* sums, const float* gamma, const float* beta,
    void* y, float* mean, float* rstd, int n, int s, int c, int route,
    int rows, int n_split, int is_bf16, int act, float eps, float alpha,
    float count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != kStream && route != kScalar) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    return route == kStream
               ? sp_apply<__nv_bfloat16, 8>(xb, sums, gamma, beta, yb, mean,
                                            rstd, n, s, c, rows, n_split, act,
                                            eps, alpha, count, st)
               : sp_apply<__nv_bfloat16, 1>(xb, sums, gamma, beta, yb, mean,
                                            rstd, n, s, c, rows, n_split, act,
                                            eps, alpha, count, st);
  }
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  return route == kStream
             ? sp_apply<float, 4>(xf, sums, gamma, beta, yf, mean, rstd, n, s,
                                  c, rows, n_split, act, eps, alpha, count, st)
             : sp_apply<float, 1>(xf, sums, gamma, beta, yf, mean, rstd, n, s,
                                  c, rows, n_split, act, eps, alpha, count,
                                  st);
}

// Pass 1 backward: the local block's gated (S1, S2) into sums, and dgamma,
// dbeta (c,) their sums over the samples: this shard's own, before any sum
// across ranks.  counter: as sggan_instance_norm_bwd's.
extern "C" int sggan_instance_norm_sp_bwd_stats(
    const void* x, const void* dy, const float* gamma, const float* beta,
    const float* mean, const float* rstd, float* part, float* sums,
    float* dgamma, float* dbeta, unsigned* counter, int n, int s, int c,
    int route, int rows, int n_split, int is_bf16, int act, float alpha,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != kStream && route != kScalar) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* db = static_cast<const __nv_bfloat16*>(dy);
    return route == kStream
               ? sp_bwd_stats<__nv_bfloat16, 8>(
                     xb, db, gamma, beta, mean, rstd, part, sums, dgamma,
                     dbeta, counter, n, s, c, rows, n_split, act, alpha, st)
               : sp_bwd_stats<__nv_bfloat16, 1>(
                     xb, db, gamma, beta, mean, rstd, part, sums, dgamma,
                     dbeta, counter, n, s, c, rows, n_split, act, alpha, st);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dy);
  return route == kStream
             ? sp_bwd_stats<float, 4>(xf, df, gamma, beta, mean, rstd, part,
                                      sums, dgamma, dbeta, counter, n, s, c,
                                      rows, n_split, act, alpha, st)
             : sp_bwd_stats<float, 1>(xf, df, gamma, beta, mean, rstd, part,
                                      sums, dgamma, dbeta, counter, n, s, c,
                                      rows, n_split, act, alpha, st);
}

// Pass 2 backward: dx from the global (S1, S2) sums and count.
extern "C" int sggan_instance_norm_sp_bwd_apply(
    const void* x, const void* dy, const float* gamma, const float* beta,
    const float* mean, const float* rstd, const float* sums, void* dx, int n,
    int s, int c, int route, int rows, int n_split, int is_bf16, int act,
    float alpha, float count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != kStream && route != kScalar) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* db = static_cast<const __nv_bfloat16*>(dy);
    auto* ob = static_cast<__nv_bfloat16*>(dx);
    return route == kStream
               ? sp_bwd_apply<__nv_bfloat16, 8>(xb, db, gamma, beta, mean,
                                                rstd, sums, ob, n, s, c, rows,
                                                n_split, act, alpha, count, st)
               : sp_bwd_apply<__nv_bfloat16, 1>(xb, db, gamma, beta, mean,
                                                rstd, sums, ob, n, s, c, rows,
                                                n_split, act, alpha, count,
                                                st);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dy);
  auto* of = static_cast<float*>(dx);
  return route == kStream
             ? sp_bwd_apply<float, 4>(xf, df, gamma, beta, mean, rstd, sums,
                                      of, n, s, c, rows, n_split, act, alpha,
                                      count, st)
             : sp_bwd_apply<float, 1>(xf, df, gamma, beta, mean, rstd, sums,
                                      of, n, s, c, rows, n_split, act, alpha,
                                      count, st);
}

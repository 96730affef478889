// K2: reflect-pad(1) -> 3x3 stride-1 conv -> instance norm -> activation over
// an NHWC tensor, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sggan_tpu/ops/pallas_conv_in.py (conv3_in:
// _pallas_forward, body _kernel).  Same math: the conv accumulates in f32
// and is rounded once to the compute dtype (y16, f32 or bf16); per (sample,
// channel) the f32 sum and sum of squares of the ROUNDED y16 over the H*W
// plane give mean, var = max(E[y^2] - mean^2, 0), rsig = 1 / sqrt(var + eps);
// y = act((y16 - mean) * rsig * gamma + beta), stored in the compute dtype.
// y, y16, mean and rsig are outputs: the backward needs no recompute.
//
// Bound.  At the resblock shape (16, 64, 128, 256 -> 256) in bf16 the work is
// 154.6 GFLOP against 201 MB moved once (x, y16, y): the tensor cores bound
// it, 0.156 ms at 989 TFLOP/s.  At the wide shape (16, 256, 512, 64 -> 64) the
// same 154.6 GFLOP stand against 805 MB: device memory bounds it, 0.240 ms at
// 3.35 TB/s.  In f32 the products run as plain FMAs (full f32, no TF32) and
// the 67 TFLOP/s of the CUDA cores bound both shapes, 2.31 ms.
//
// Design.  The Pallas kernel runs one program per sample, walks row tiles in
// order and carries the sums in VMEM scratch; sixteen programs would fill 16
// of 132 SMs, and Hopper blocks run in no order.  Here:
//   1. k2_conv_tc / k2_conv_scalar: grid (Cout tile x spatial tile, sample).
//      A block loads the (rows + 2) x (cols + 2) halo of its pixel tile for a
//      chunk of input channels into shared memory, the reflect indices
//      (-1 -> 1, H -> H - 2) computed in the load, so no padded copy of x
//      exists; the nine taps are nine shifted views of that halo.  It writes
//      its tile of y16 and its f32 partial (sum, sum of squares) per channel
//      to a scratch (N, tiles, 2, Cout).  No atomics: every partial has one
//      writer, so the result repeats bit for bit.
//   2. k2_moments: combines a channel's partials in a fixed order into the
//      (N, Cout) f32 mean and rsig.
//   3. k2_normalize: re-reads y16 (from L2 where it still is), normalizes,
//      applies gamma, beta and the activation, writes y.  The launch
//      boundary stands where the Pallas kernel has phase A / phase B: the
//      whole plane's moments are needed before the first normalized value.
// The pre-activation is rounded after the product and after the sum (no fma),
// exactly as instance_norm.cu's backward gate recomputes it from y16, mean
// and rsig, so forward and backward decide relu alike within an ulp of 0.
//
// Two routes for the conv, both hand-written here:
//   tensor cores (bf16, Cin and Cout multiples of 16): an implicit GEMM of
//     256 pixels (16 x 16) by 64 output channels a block, K = 9 taps x Cin in
//     chunks of 16 channels.  The chunks arrive by cp.async in a two-stage
//     ring, so the next chunk's loads run under this chunk's products.
//     Fragments come from shared memory by ldmatrix (the weights
//     transposed on the way) and feed mma.sync m16n8k16 with f32
//     accumulators; a warp owns two pixel rows by 64 channels.  The pixel
//     stride of the halo (24 bf16) and the row stride of the weights (72)
//     put the eight rows of every 8x8 ldmatrix tile in distinct banks, for
//     each of the nine shifted tap views.  (A first version went through
//     nvcuda::wmma: its fragment loads compiled to generic loads and
//     register transposes, and the pass took 0.90 ms where this takes
//     0.44 ms at the resblock shape, on an H100 at 700 W.)
//   scalar (f32, and bf16 at any other channel count): 128 pixels (8 x 16)
//     by 64 channels a block, chunks of 8 input channels, a thread owns
//     4 pixels by 8 channels of f32 FMAs.
// What a later redesign would change for the card: wgmma, which reads both
// operands from shared memory once per 64-row tile, with TMA-fed tiles, and
// the normalize pass fused into the next conv's load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_pipeline.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 16;      // pixel columns of a block's tile, both routes
constexpr int kBN = 64;      // output channels of a block's tile
constexpr int kHaloW = kTW + 2;

// tensor-core route
constexpr int kTcTH = 16;                       // pixel rows of a tile
constexpr int kTcKC = 16;   // input channels per chunk: one mma's depth
constexpr int kTcStages = 2;                    // chunks in flight
constexpr int kTcLDA = kTcKC + 8;               // halo pixel stride, bf16
constexpr int kTcLDB = kBN + 8;                 // weight row stride, bf16
constexpr int kTcLDC = kBN + 4;                 // accumulator row stride, f32
constexpr int kTcHalo = (kTcTH + 2) * kHaloW;   // 324 pixels
constexpr int kTcStageElems = kTcHalo * kTcLDA + 9 * kTcKC * kTcLDB;
constexpr int kTcBytesOps = kTcStages * kTcStageElems * 2;
constexpr int kTcBytesC = kTcTH * kTW * kTcLDC * 4;
constexpr int kTcSmem = kTcBytesOps > kTcBytesC ? kTcBytesOps : kTcBytesC;

// scalar route
constexpr int kScTH = 8;
constexpr int kScKC = 8;
constexpr int kScHalo = (kScTH + 2) * kHaloW;   // 180 pixels

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void cast(float v, float* o) { *o = v; }
__device__ __forceinline__ void cast(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* o, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(a, b);
}

// index of the reflect-padded coordinate i in [-1, n], clamped for the
// rows and columns of a ragged tile that lie past the plane (their results
// are never stored)
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// Shared by both routes.  `acc` holds the block's f32 conv results in shared
// memory, pixel p = row * kTW + col at acc[p * ld + channel].  Rounds each to
// T, stores the valid ones to y16, and writes the block's partial sums of the
// rounded values to `part`.  Lane l takes channels 2l and 2l + 1, warp w the
// pixels w, w + 8, ...; the 8 warps' sums are combined in order.
template <typename T>
__device__ __forceinline__ void tile_epilogue(
    const float* acc, int ld, int tile_h, T* __restrict__ y16,
    float* __restrict__ part, float (*red)[2][kBN], int n, int h, int w,
    int cout, int h0, int w0, int co0, int sp, int n_sp) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = 2 * lane, co = co0 + ch;
  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
  for (int p = warp; p < tile_h * kTW; p += kWarps) {
    const int oh = h0 + p / kTW, ow = w0 + p % kTW;
    if (oh >= h || ow >= w) continue;
    if (co >= cout) continue;
    T* out = y16 + (((size_t)n * h + oh) * w + ow) * cout + co;
    T ra, rb;
    cast(acc[p * ld + ch], &ra);
    const float fa = to_f32(ra);
    s1a += fa;
    s2a += fa * fa;
    if (co + 1 < cout) {
      cast(acc[p * ld + ch + 1], &rb);
      const float fb = to_f32(rb);
      s1b += fb;
      s2b += fb * fb;
    }
    if (cout % 2 == 0) {  // then co + 1 < cout, and the pair is aligned
      store2(out, ra, rb);
    } else {
      out[0] = ra;
      if (co + 1 < cout) out[1] = rb;
    }
  }
  red[warp][0][ch] = s1a;
  red[warp][1][ch] = s2a;
  red[warp][0][ch + 1] = s1b;
  red[warp][1][ch + 1] = s2b;
  __syncthreads();
  if (threadIdx.x < 2 * kBN) {
    const int which = threadIdx.x / kBN, c = threadIdx.x % kBN;
    if (co0 + c < cout) {
      float s = red[0][which][c];
      for (int i = 1; i < kWarps; ++i) s += red[i][which][c];
      part[(((size_t)n * n_sp + sp) * 2 + which) * cout + co0 + c] = s;
    }
  }
}

// ---------------------------------------------------------------------
// tensor-core route: bf16, cin % 16 == 0, cout % 16 == 0
// ---------------------------------------------------------------------

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// c += a (16 x 16, row-major fragments) * b (16 x 8), f32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
k2_conv_tc(const bf16* __restrict__ x, const bf16* __restrict__ wk,
           bf16* __restrict__ y16, float* __restrict__ part, int h, int w,
           int cin, int cout, int tiles_w, int n_ct) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kWarps][2][kBN];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  float* sc = reinterpret_cast<float*>(smem);

  const int ct = blockIdx.x % n_ct, sp = blockIdx.x / n_ct, n = blockIdx.y;
  const int n_sp = gridDim.x / n_ct;
  const int h0 = (sp / tiles_w) * kTcTH, w0 = (sp % tiles_w) * kTW;
  const int co0 = ct * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this lane's row and 8-column half in every ldmatrix.x4
  const int lrow = lane % 16, lcol = (lane / 16) * 8;

  // acc[i][t]: pixel row 2 * warp + i of the tile, channels 8 t .. 8 t + 7
  float acc[2][kBN / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < kBN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  const bf16* xn = x + (size_t)n * h * w * cin;
  const int n_chunks = cin / kTcKC;
  // chunk c of the input channels into stage c % kTcStages, as one
  // cp.async group
  auto load_chunk = [&](int c) {
    if (c < n_chunks) {
      const int c0 = c * kTcKC;
      bf16* a_st = sa + (c % kTcStages) * kTcStageElems;
      bf16* b_st = a_st + kTcHalo * kTcLDA;
      for (int i = threadIdx.x; i < kTcHalo * (kTcKC / 8); i += kThreads) {
        const int pix = i / (kTcKC / 8), v = i % (kTcKC / 8);
        const int ih = reflect(h0 - 1 + pix / kHaloW, h);
        const int iw = reflect(w0 - 1 + pix % kHaloW, w);
        __pipeline_memcpy_async(a_st + pix * kTcLDA + v * 8,
                                xn + ((size_t)ih * w + iw) * cin + c0 + v * 8,
                                16);
      }
      for (int j = threadIdx.x; j < 9 * kTcKC * (kBN / 8); j += kThreads) {
        const int v = j % (kBN / 8), k = (j / (kBN / 8)) % kTcKC;
        const int tap = j / ((kBN / 8) * kTcKC);
        const int co = co0 + v * 8;
        bf16* dst = b_st + (tap * kTcKC + k) * kTcLDB + v * 8;
        if (co < cout)
          __pipeline_memcpy_async(
              dst, wk + ((size_t)tap * cin + c0 + k) * cout + co, 16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __pipeline_commit();  // an empty group past the end keeps the count
  };
  for (int c = 0; c < kTcStages - 1; ++c) load_chunk(c);
  for (int c = 0; c < n_chunks; ++c) {
    __pipeline_wait_prior(kTcStages - 2);  // chunk c has landed
    __syncthreads();  // for every thread; and chunk c - 1 is consumed
    load_chunk(c + kTcStages - 1);
    const bf16* a_st = sa + (c % kTcStages) * kTcStageElems;
    const bf16* b_st = a_st + kTcHalo * kTcLDA;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], a_st + ((2 * warp + i + dy) * kHaloW + dx + lrow)
                                     * kTcLDA + lcol);
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        unsigned b[4];
        ldmatrix_x4_trans(b,
                          b_st + (tap * kTcKC + lrow) * kTcLDB + j * 16 + lcol);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[i][2 * j], a[i], b[0], b[1]);
          mma_16816(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the accumulator tile takes the operands' place
  // an accumulator holds rows lane / 4 and lane / 4 + 8 of its 16 pixels,
  // channels 2 (lane % 4) and the next
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < kBN / 8; ++t) {
      float* o = sc + ((2 * warp + i) * kTW + lane / 4) * kTcLDC + t * 8
                 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][t][0], acc[i][t][1]);
      *reinterpret_cast<float2*>(o + 8 * kTcLDC) =
          make_float2(acc[i][t][2], acc[i][t][3]);
    }
  __syncthreads();
  tile_epilogue<bf16>(sc, kTcLDC, kTcTH, y16, part, red, n, h, w, cout, h0,
                      w0, co0, sp, n_sp);
}

// ---------------------------------------------------------------------
// scalar route: f32 FMAs on f32 or bf16 inputs, any channel counts
// ---------------------------------------------------------------------
struct ScOperands {
  float in[kScHalo][kScKC];
  float wt[9][kScKC][kBN];
};
union ScSmem {
  ScOperands op;
  float acc[kScTH * kTW][kBN];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
k2_conv_scalar(const T* __restrict__ x, const T* __restrict__ wk,
               T* __restrict__ y16, float* __restrict__ part, int h, int w,
               int cin, int cout, int tiles_w, int n_ct) {
  __shared__ __align__(16) ScSmem sm;
  __shared__ float red[kWarps][2][kBN];

  const int ct = blockIdx.x % n_ct, sp = blockIdx.x / n_ct, n = blockIdx.y;
  const int n_sp = gridDim.x / n_ct;
  const int h0 = (sp / tiles_w) * kScTH, w0 = (sp % tiles_w) * kTW;
  const int co0 = ct * kBN;
  // a thread owns pixels (row, col0 .. col0 + 3) and channels cg .. cg + 7
  const int cg = (threadIdx.x % 8) * 8, pg = threadIdx.x / 8;
  const int row = pg / 4, col0 = (pg % 4) * 4;

  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[p][c] = 0.f;

  const T* xn = x + (size_t)n * h * w * cin;
  for (int c0 = 0; c0 < cin; c0 += kScKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kScHalo * kScKC; i += kThreads) {
      const int pix = i / kScKC, k = i % kScKC;
      float v = 0.f;
      if (c0 + k < cin) {
        const int ih = reflect(h0 - 1 + pix / kHaloW, h);
        const int iw = reflect(w0 - 1 + pix % kHaloW, w);
        v = to_f32(xn[((size_t)ih * w + iw) * cin + c0 + k]);
      }
      sm.op.in[pix][k] = v;
    }
    for (int i = threadIdx.x; i < 9 * kScKC * kBN; i += kThreads) {
      const int c = i % kBN, k = (i / kBN) % kScKC, tap = i / (kBN * kScKC);
      float v = 0.f;
      if (c0 + k < cin && co0 + c < cout)
        v = to_f32(wk[((size_t)tap * cin + c0 + k) * cout + co0 + c]);
      sm.op.wt[tap][k][c] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int base = (row + tap / 3) * kHaloW + col0 + tap % 3;
#pragma unroll
      for (int k = 0; k < kScKC; ++k) {
        const float4 wa = *reinterpret_cast<const float4*>(&sm.op.wt[tap][k][cg]);
        const float4 wb =
            *reinterpret_cast<const float4*>(&sm.op.wt[tap][k][cg + 4]);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float xv = sm.op.in[base + p][k];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[p][c] = fmaf(xv, wv[c], acc[p][c]);
        }
      }
    }
  }
  __syncthreads();  // the accumulator tile takes the operands' place
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      sm.acc[row * kTW + col0 + p][cg + c] = acc[p][c];
  __syncthreads();
  tile_epilogue<T>(&sm.acc[0][0], kBN, kScTH, y16, part, red, n, h, w, cout,
                   h0, w0, co0, sp, n_sp);
}

// ---------------------------------------------------------------------
// moments: (N, n_sp, 2, C) partials -> (N, C) mean and rsig
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
k2_moments(const float* __restrict__ part, float* __restrict__ mean,
           float* __restrict__ rsig, int n_sp, int c, int s, float eps) {
  const int n = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + lane;
  // warp w sums tiles w, w + 8, ...; then warp 0 sums the 8 warps in order
  __shared__ float sh1[kWarps][32], sh2[kWarps][32];
  float s1 = 0.f, s2 = 0.f;
  if (ch < c) {
    const float* pp = part + (size_t)n * n_sp * 2 * c;
    for (int i = warp; i < n_sp; i += kWarps) {
      s1 += pp[(size_t)i * 2 * c + ch];
      s2 += pp[(size_t)i * 2 * c + c + ch];
    }
  }
  sh1[warp][lane] = s1;
  sh2[warp][lane] = s2;
  __syncthreads();
  if (warp == 0 && ch < c) {
    for (int i = 1; i < kWarps; ++i) {
      s1 += sh1[i][lane];
      s2 += sh2[i][lane];
    }
    const float m = s1 / (float)s;
    const float var = fmaxf(s2 / (float)s - m * m, 0.f);
    mean[(size_t)n * c + ch] = m;
    rsig[(size_t)n * c + ch] = 1.f / sqrtf(var + eps);
  }
}

// ---------------------------------------------------------------------
// normalize: y = act((y16 - mean) * rsig * gamma + beta)
// ---------------------------------------------------------------------
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<bf16, 1> { using type = bf16; };
template <> struct Vec<bf16, 8> { using type = uint4; };

__device__ __forceinline__ float activate(float xhat, float g, float b,
                                          int act, float alpha) {
  // rounded after the product and after the sum, as the backward's gate
  const float pre = __fadd_rn(__fmul_rn(xhat, g), b);
  if (act == kRelu) return fmaxf(pre, 0.f);
  if (act == kLeakyRelu) return pre >= 0.f ? pre : alpha * pre;
  return pre;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
k2_normalize(const T* __restrict__ y16, const float* __restrict__ mean,
             const float* __restrict__ rsig, const float* __restrict__ gamma,
             const float* __restrict__ beta, T* __restrict__ y, int s, int c,
             int rows_per_split, int act, float alpha) {
  using VT = typename Vec<T, V>::type;
  const int n = blockIdx.y;
  const int cv = c / V;                    // channel vectors per pixel
  const int per = min(cv, kThreads);       // of them, per block pass
  const int step = kThreads / per;         // pixels per block pass
  const int lv = threadIdx.x % per, lr = threadIdx.x / per;
  const int r_begin = blockIdx.x * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, s);
  if (lr >= step) return;
  for (int v0 = 0; v0 < cv; v0 += per) {
    const int ch = (v0 + lv) * V;
    if (ch >= c) continue;
    float m[V], r[V], g[V], b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      m[i] = mean[(size_t)n * c + ch + i];
      r[i] = rsig[(size_t)n * c + ch + i];
      g[i] = gamma[ch + i];
      b[i] = beta[ch + i];
    }
    for (int p = r_begin + lr; p < r_end; p += step) {
      const size_t off = ((size_t)n * s + p) * c + ch;
      VT in = *reinterpret_cast<const VT*>(y16 + off);
      VT out;
      const T* iv = reinterpret_cast<const T*>(&in);
      T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < V; ++i)
        cast(activate((to_f32(iv[i]) - m[i]) * r[i], g[i], b[i], act, alpha),
             ov + i);
      *reinterpret_cast<VT*>(y + off) = out;
    }
  }
}

template <typename T, int V>
void launch_normalize(const void* y16, const float* mean, const float* rsig,
                      const float* gamma, const float* beta, void* y, int n,
                      int s, int c, int rows_per_split, int n_split, int act,
                      float alpha, cudaStream_t st) {
  k2_normalize<T, V><<<dim3(n_split, n), kThreads, 0, st>>>(
      static_cast<const T*>(y16), mean, rsig, gamma, beta, static_cast<T*>(y),
      s, c, rows_per_split, act, alpha);
}

}  // namespace

// x: (n, h, w, cin) contiguous; wk: (3, 3, cin, cout) contiguous in x's
// dtype; y16, y: (n, h, w, cout); all f32 (is_bf16 = 0) or bf16 (1).  gamma,
// beta: (cout,) f32.  mean, rsig: (n, cout) f32 outputs.  part: scratch
// (n, tiles, 2, cout) f32 with tiles = ceil(h / tile_h) * ceil(w / 16), where
// tile_h is 16 on the tensor-core route (use_tc = 1: bf16, cin and cout
// multiples of 16) and 8 on the scalar route.  n_split * rows_per_split >=
// h * w.  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments the chosen route does not take.
extern "C" int sggan_conv3_in_fwd(const void* x, const void* wk,
                                  const void* gamma, const void* beta,
                                  void* y, void* y16, void* mean, void* rsig,
                                  void* part, int n, int h, int w, int cin,
                                  int cout, int is_bf16, int use_tc,
                                  int rows_per_split, int n_split, int act,
                                  float eps, float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h < 2 || w < 2 || n < 1 || n > 65535 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  if (use_tc && (!is_bf16 || cin % 16 || cout % 16))
    return (int)cudaErrorInvalidValue;
  const int tile_h = use_tc ? kTcTH : kScTH;
  const int tiles_w = (w + kTW - 1) / kTW;
  const int n_sp = ((h + tile_h - 1) / tile_h) * tiles_w;
  const int n_ct = (cout + kBN - 1) / kBN;
  const dim3 grid(n_sp * n_ct, n);
  float* pt = static_cast<float*>(part);
  if (use_tc) {
    cudaError_t err = cudaFuncSetAttribute(
        k2_conv_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    k2_conv_tc<<<grid, kThreads, kTcSmem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
        static_cast<bf16*>(y16), pt, h, w, cin, cout, tiles_w, n_ct);
  } else if (is_bf16) {
    k2_conv_scalar<bf16><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
        static_cast<bf16*>(y16), pt, h, w, cin, cout, tiles_w, n_ct);
  } else {
    k2_conv_scalar<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wk),
        static_cast<float*>(y16), pt, h, w, cin, cout, tiles_w, n_ct);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rsig);
  k2_moments<<<dim3((cout + 31) / 32, n), kThreads, 0, st>>>(
      pt, mp, rp, n_sp, cout, h * w, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const int s = h * w;
  if (is_bf16 && cout % 8 == 0)
    launch_normalize<bf16, 8>(y16, mp, rp, gp, bp, y, n, s, cout,
                              rows_per_split, n_split, act, alpha, st);
  else if (is_bf16)
    launch_normalize<bf16, 1>(y16, mp, rp, gp, bp, y, n, s, cout,
                              rows_per_split, n_split, act, alpha, st);
  else if (cout % 4 == 0)
    launch_normalize<float, 4>(y16, mp, rp, gp, bp, y, n, s, cout,
                               rows_per_split, n_split, act, alpha, st);
  else
    launch_normalize<float, 1>(y16, mp, rp, gp, bp, y, n, s, cout,
                               rows_per_split, n_split, act, alpha, st);
  return (int)cudaGetLastError();
}

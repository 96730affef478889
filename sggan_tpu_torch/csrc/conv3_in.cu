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
//   1. k2_conv_wgmma / k2_conv_scalar: grid (Cout tile x spatial tile,
//      sample).  A block loads the halo of its pixel tile for a chunk of
//      input channels into shared memory, the reflect indices (-1 -> 1, H ->
//      H - 2) computed in the load, so no padded copy of x exists; the nine
//      taps are nine shifted views of that halo.  It writes its tile of y16
//      and its f32 partial (sum, sum of squares) per channel to a scratch
//      (N, tiles, 2, Cout).  No atomics: every partial has one writer, so
//      the result repeats bit for bit.
//   2. k2_moments: combines a channel's partials in a fixed order into the
//      (N, Cout) f32 mean and rsig.
//   3. k2_normalize: re-reads y16 (from L2 where it still is), normalizes,
//      applies gamma, beta and the activation, writes y.  The launch
//      boundary stands where the Pallas kernel has phase A / phase B: the
//      whole plane's moments are needed before the first normalized value.
// The pre-activation is rounded after the product and after the sum (no fma),
// exactly as instance_norm.cu's backward gate recomputes it from y16, mean
// and rsig, so forward and backward decide relu alike within an ulp of 0.
// ops/cuda_conv_in.py's conv_plan picks the route and the tile, and the
// entry refuses a plan that is not its route's own.
//
// Two routes for the conv, both hand-written here:
//   wgmma (bf16, Cin and Cout multiples of 16): an implicit GEMM on Hopper's
//     warpgroup MMA.  A block is two warpgroups; each owns R rows of 64
//     consecutive output pixels (a wgmma's 64 rows must be core matrices at
//     one stride, which one row of pixels gives) by BN output channels.
//     Each chunk of 16 input channels is 9 R wgmma.mma_async m64nBNk16 a
//     warpgroup, both operands read from shared memory by descriptor,
//     without swizzle: A is a tap's view of the halo, stored as two planes
//     of 8 channels so that a tap is an offset of the start address; B the
//     tap's weights, which the wrapper packs K-major.  The chunks arrive by
//     cp.async, the reflect resolved once a block in the copies' source
//     offsets, in a ring of STAGES, STAGES - 2 ahead; a chunk's copies are
//     issued after the wgmmas of the chunk before them, and a warpgroup
//     keeps one chunk of wgmmas in flight across the barrier.
//     What bounds it: every block reads each chunk of weights from L2 again,
//     and over every tile and width timed while it was tuned the pass moved
//     ~2 TB/s from L2 by cp.async.  So the tile holds as many pixels as the
//     accumulators allow: 8 rows x 64 pixels by 64 channels, 128 f32 a
//     thread, which reads 77 bytes from L2 per pixel and chunk of 64 output
//     channels where the first port's 16 x 16 by 64 tile read 113 (and
//     mma.sync's warps each re-read their weights from shared memory).
//     N = 128 with 4 rows needs less shared-memory bandwidth per product
//     but more from L2, and was slower, as was a 3-stage ring; one tile is
//     built (kWgBN, kWgR, kWgStages).  A in registers by ldmatrix measured
//     the same as by descriptor at one row a warpgroup, and its fragments
//     leave no registers for more rows.
//     On an NVIDIA H100 80GB HBM3 at 700 W (perf_conv_in, profiler device
//     time): the pass takes 0.322 ms (480 TF/s) at the resblock shape,
//     where the first port's mma.sync pass took 0.432-0.443 ms and cuDNN's
//     conv alone takes 0.199 ms; 0.529 ms at the wide shape (4 chunks a
//     block, so each block's first loads and its epilogue, unhidden with
//     one block an SM, are most of it), against 0.547-0.550 and cuDNN's
//     0.324.
//   scalar (f32, and bf16 at any other channel count): 128 pixels (8 x 16)
//     by 64 channels a block, chunks of 8 input channels, a thread owns
//     4 pixels by 8 channels of f32 FMAs.
// What a later redesign would change for the card: TMA with the weight
// stage multicast to a cluster (the bytes from L2 that bound the pass), a
// persistent grid whose epilogue overlaps the next tile's loads, the moments
// taken in the epilogue, and the normalize pass fused into the next conv's
// load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;      // output channels of one epilogue pass

// wgmma route: a block is two warpgroups, each R output rows of kWgTW
// pixels by BN output channels; chunks of 16 input channels
constexpr int kWgTW = 64;                        // pixels: one wgmma's M
constexpr int kWgKC = 16;                        // one wgmma's K
constexpr int kWgHaloW = kWgTW + 2;

// The halo is two planes of 8 channels, 16 bytes a pixel; each 8 pixels of
// a row are one core matrix of the A descriptor
template <int BN, int R>
struct WgTile {
  static constexpr int kRows = 2 * R;                 // output rows a tile
  static constexpr int kHalo = (kRows + 2) * kWgHaloW;  // pixels
  static constexpr int kHaloElems = kHalo * kWgKC;
  static constexpr int kPlaneBytes = kHalo * 16;
  static constexpr int kStage = kHaloElems + 9 * BN * kWgKC;  // bf16
  static constexpr int kLDC = BN + 8;  // accumulator row stride, f32
  static constexpr int kBytesC = kRows * kWgTW * kLDC * 4;
  static constexpr int smem(int stages) {
    return stages * kStage * 2 > kBytesC ? stages * kStage * 2 : kBytesC;
  }
};
// The one wgmma kernel built, as conv_plan (ops/cuda_conv_in.py) names it:
// R = 4 rows a warpgroup (a tile of 8 x 64 pixels) by 64 channels, 4 stages
constexpr int kWgBN = 64, kWgR = 4, kWgStages = 4;
using WgPlan = WgTile<kWgBN, kWgR>;

// scalar route
constexpr int kScTH = 8;
constexpr int kScTW = 16;
constexpr int kScHaloW = kScTW + 2;
constexpr int kScKC = 8;
constexpr int kScHalo = (kScTH + 2) * kScHaloW;   // 180 pixels

enum Route { kScalar = 0, kWgmma = 1 };
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

// Shared by every route.  `acc` holds kBN channels of the block's f32 conv
// results in shared memory, pixel p = row * TW + col at acc[p * ld +
// channel].  Rounds each to T, stores the valid ones to y16, and writes the
// block's partial sums of the rounded values to `part`.  Lane l takes
// channels 2l and 2l + 1, warp w the pixels w, w + 8, ...; the 8 warps'
// sums are combined in order.
template <typename T, int TW>
__device__ __forceinline__ void tile_epilogue(
    const float* acc, int ld, int tile_h, T* __restrict__ y16,
    float* __restrict__ part, float (*red)[2][kBN], int n, int h, int w,
    int cout, int h0, int w0, int co0, int sp, int n_sp) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = 2 * lane, co = co0 + ch;
  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
  for (int p = warp; p < tile_h * TW; p += kWarps) {
    const int oh = h0 + p / TW, ow = w0 + p % TW;
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
// wgmma route: bf16, cin % 16 == 0, cout % 16 == 0
// ---------------------------------------------------------------------

// d (64 x N, f32, this thread's N / 2) += a (64 x 16) * b (16 x N), both
// bf16 in shared memory, K-major, given by their descriptors
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// this thread's writes to shared memory (cp.async and plain stores), made
// visible to the async proxy that wgmma reads its shared operands through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins an accumulator at this point of the program, so the compiler does
// not read it before the wgmmas that write it have retired
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Descriptor of a K-major bf16 operand in shared memory without swizzle
// (shared addresses stay under 2^18, so an offset added to the descriptor
// stays in its 14-bit start address field):
// core matrices of 8 rows by 16 bytes (8 channels of K) stored as 128
// contiguous bytes; the core matrix of the next 8 channels of K `lbo` bytes
// on, that of the next 8 rows `sbo` bytes on.  B: rows are output
// channels, lbo 128, sbo 256.  A from the halo planes: rows are pixels,
// lbo one plane, sbo 128.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t smem_addr, int lbo,
                                                int sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4)
         | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// An implicit GEMM: M = the block's 2R x 64 output pixels (R rows a
// warpgroup), N = BN output channels, K = 9 taps x Cin in chunks of 16
// input channels, each chunk 9 R wgmma m64nBNk16 a warpgroup, the R rows of
// a tap on one B descriptor.  Both operands come from shared memory by
// descriptor: B, the chunk's 9 x BN x 16 weights, K-major; A, the nine taps
// as shifted views of one halo.  The chunks arrive by cp.async in a ring of
// STAGES, STAGES - 2 ahead: a chunk's loads are issued after the wgmmas of
// the chunk before them, so they run under those, and each warpgroup keeps
// one chunk of wgmmas in flight across the barrier.  A stage is refilled
// only after every warpgroup's wgmmas on it have retired and every thread
// has passed the barrier after that.
template <int BN, int R, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
k2_conv_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ wk,
              bf16* __restrict__ y16, float* __restrict__ part, int h, int w,
              int cin, int cout, int tiles_w, int n_ct) {
  static_assert(STAGES >= 3, "a stage in flight, one read, one retiring");
  static_assert(BN == 64, "m64n64k16 is the one wgmma shape bound here");
  using Tile = WgTile<BN, R>;
  constexpr int kAhead = STAGES - 2;
  constexpr int kHaloLoads = (Tile::kHalo * 2 + kThreads - 1) / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kWarps][2][kBN];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  float* sc = reinterpret_cast<float*>(smem);
  const uint32_t sa_addr = (uint32_t)__cvta_generic_to_shared(sa);

  const int ct = blockIdx.x % n_ct, sp = blockIdx.x / n_ct, n = blockIdx.y;
  const int n_sp = gridDim.x / n_ct;
  const int h0 = (sp / tiles_w) * Tile::kRows, w0 = (sp % tiles_w) * kWgTW;
  const int co0 = ct * BN;
  // warpgroup g computes output rows h0 + R g .. h0 + R g + R - 1; its
  // warp q pixels 16 q .. 16 q + 15 of each
  const int g = threadIdx.x / 128, q = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  float acc[R][BN / 2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;

  // this thread's halo copies, 16 bytes each: item i = threadIdx.x + k
  // kThreads is 8 channels (v = i % 2) of halo pixel i / 2, stored in
  // plane v; its source offset at channel 0, the reflect resolved once
  const bf16* xn = x + (size_t)n * h * w * cin;
  int a_src[kHaloLoads];
#pragma unroll
  for (int k = 0; k < kHaloLoads; ++k) {
    const int i = threadIdx.x + k * kThreads, pix = i / 2;
    const int ih = reflect(h0 - 1 + pix / kWgHaloW, h);
    const int iw = reflect(w0 - 1 + pix % kWgHaloW, w);
    a_src[k] = (ih * w + iw) * cin + (i % 2) * 8;
  }
  // the weight rows past cout are zero in every stage, once
  for (int j = threadIdx.x; co0 + BN > cout && j < STAGES * 9 * BN * 2;
       j += kThreads) {
    const int o = (j / 2) % BN;
    if (co0 + o >= cout) {
      const int stage = j / (9 * BN * 2), tap = (j / (2 * BN)) % 9;
      *reinterpret_cast<uint4*>(sa + stage * Tile::kStage + Tile::kHaloElems
                                + tap * BN * kWgKC + (o / 8) * 128
                                + (j % 2) * 64 + (o % 8) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the accumulators are touched by nothing but the wgmmas until the
  // last of them has retired: a register write between two would make
  // ptxas serialize them
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) pin(acc[r][i]);

  const int n_chunks = cin / kWgKC;
  // chunk c into stage c % STAGES, as one cp.async group: the halo's 16
  // channels, and the weights packed (cin / 16, 9, cout, 16) by the
  // wrapper, laid out as the descriptor reads them
  auto load_chunk = [&](int c) {
    if (c < n_chunks) {
      bf16* a_st = sa + (c % STAGES) * Tile::kStage;
      bf16* b_st = a_st + Tile::kHaloElems;
#pragma unroll
      for (int k = 0; k < kHaloLoads; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < Tile::kHalo * 2)
          __pipeline_memcpy_async(
              a_st + (i % 2) * Tile::kHalo * 8 + (i / 2) * 8,
              xn + a_src[k] + c * kWgKC, 16);
      }
      const bf16* wc = wk + (size_t)c * 9 * cout * kWgKC;
      for (int j = threadIdx.x; j < 9 * BN * 2; j += kThreads) {
        const int v = j % 2, o = (j / 2) % BN, tap = j / (2 * BN);
        if (co0 + o < cout)
          __pipeline_memcpy_async(
              b_st + tap * BN * kWgKC + (o / 8) * 128 + v * 64 + (o % 8) * 8,
              wc + ((size_t)tap * cout + co0 + o) * kWgKC + v * 8, 16);
      }
    }
    __pipeline_commit();  // an empty group past the end keeps the count
  };

  for (int c = 0; c < kAhead; ++c) load_chunk(c);
  for (int c = 0; c < n_chunks; ++c) {
    __pipeline_wait_prior(kAhead - 1);  // chunk c has landed
    fence_proxy_async();
    // every thread's copies of chunk c are in; every warpgroup has retired
    // chunk c - 2, whose stage the loads below refill
    __syncthreads();
    // descriptors of this stage's halo at this warpgroup's first row, and
    // of its weights; a tap or row further on adds its offset in 16-byte
    // units to the start address field
    const uint32_t a_addr = sa_addr + (c % STAGES) * Tile::kStage * 2;
    const uint64_t ad = kmajor_desc(a_addr + R * g * kWgHaloW * 16,
                                    Tile::kPlaneBytes, 128);
    const uint64_t bd = kmajor_desc(a_addr + Tile::kHaloElems * 2, 128, 256);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int r = 0; r < R; ++r)
        wgmma_n64(acc[r], ad + (r + tap / 3) * kWgHaloW + tap % 3,
                  bd + tap * BN * kWgKC * 2 / 16);
    wgmma_commit();
    load_chunk(c + kAhead);
    wgmma_wait<1>();  // chunk c - 1 has retired
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) pin(acc[r][i]);
  __pipeline_wait_prior(0);
  __syncthreads();  // the accumulator tile takes the operands' place
  // a thread holds rows lane / 4 and lane / 4 + 8 of its warp's 16 pixels,
  // channels 8 t + 2 (lane % 4) and the next, as mma.sync does
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      float* o = sc + ((R * g + r) * kWgTW + 16 * q + lane / 4) * Tile::kLDC
                 + t * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(o) =
          make_float2(acc[r][4 * t], acc[r][4 * t + 1]);
      *reinterpret_cast<float2*>(o + 8 * Tile::kLDC) =
          make_float2(acc[r][4 * t + 2], acc[r][4 * t + 3]);
    }
  __syncthreads();
  for (int c0 = 0; c0 < BN; c0 += kBN) {
    tile_epilogue<bf16, kWgTW>(sc + c0, Tile::kLDC, Tile::kRows, y16, part,
                               red, n, h, w, cout, h0, w0, co0 + c0, sp,
                               n_sp);
    __syncthreads();  // red is reused by the next channel group
  }
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
  float acc[kScTH * kScTW][kBN];
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
  const int h0 = (sp / tiles_w) * kScTH, w0 = (sp % tiles_w) * kScTW;
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
        const int ih = reflect(h0 - 1 + pix / kScHaloW, h);
        const int iw = reflect(w0 - 1 + pix % kScHaloW, w);
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
      const int base = (row + tap / 3) * kScHaloW + col0 + tap % 3;
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
      sm.acc[row * kScTW + col0 + p][cg + c] = acc[p][c];
  __syncthreads();
  tile_epilogue<T, kScTW>(&sm.acc[0][0], kBN, kScTH, y16, part, red, n, h, w,
                          cout, h0, w0, co0, sp, n_sp);
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

// x: (n, h, w, cin) contiguous; y16, y: (n, h, w, cout); all f32 (is_bf16 =
// 0) or bf16 (1).  gamma, beta: (cout,) f32.  mean, rsig: (n, cout) f32
// outputs.  The launch plan comes from the caller (ops/cuda_conv_in.py,
// conv_plan), and the entry refuses one that is not the route's own:
//   route 0, scalar: any dtype and channel counts; tile 8 x 16 pixels by 64
//     channels, no dynamic shared memory; wk (3, 3, cin, cout) in x's dtype.
//   route 1, wgmma: bf16, cin and cout multiples of 16; tile 8 x 64 pixels
//     by 64 channels, 4 chunks in the ring, WgPlan::smem(4) dynamic shared
//     bytes; wk packed (cin / 16, 3, 3, cout, 16).
// n_sp = ceil(h / tile_h) * ceil(w / tile_w) spatial tiles a sample, and
// part is scratch (n, n_sp, 2, cout) f32.  n_split * rows_per_split >= h *
// w.  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments the route does not take.
extern "C" int sggan_conv3_in_fwd(const void* x, const void* wk,
                                  const void* gamma, const void* beta,
                                  void* y, void* y16, void* mean, void* rsig,
                                  void* part, int n, int h, int w, int cin,
                                  int cout, int is_bf16, int route,
                                  int tile_h, int tile_w, int bn, int stages,
                                  int smem, int n_sp, int rows_per_split,
                                  int n_split, int act, float eps,
                                  float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h < 2 || w < 2 || n < 1 || n > 65535 || cin < 1 || cout < 1
      || (route != kScalar && route != kWgmma))
    return (int)cudaErrorInvalidValue;
  if (route == kWgmma && (!is_bf16 || cin % 16 || cout % 16))
    return (int)cudaErrorInvalidValue;
  const bool own_tile =
      route == kScalar
          ? tile_h == kScTH && tile_w == kScTW && bn == kBN && smem == 0
          : tile_h == 2 * kWgR && tile_w == kWgTW && bn == kWgBN
                && stages == kWgStages && smem == WgPlan::smem(kWgStages);
  const int tiles_w = (w + tile_w - 1) / tile_w;
  if (!own_tile || n_sp != ((h + tile_h - 1) / tile_h) * tiles_w)
    return (int)cudaErrorInvalidValue;
  const int n_ct = (cout + bn - 1) / bn;
  const dim3 grid(n_sp * n_ct, n);
  float* pt = static_cast<float*>(part);
  cudaError_t err = cudaSuccess;
  if (route == kWgmma) {
    auto kernel = k2_conv_wgmma<kWgBN, kWgR, kWgStages>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, st>>>(
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
  err = cudaGetLastError();
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

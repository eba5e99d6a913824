// Stride-1 ResNet bottleneck blocks with BatchNorm folded into the weights:
//
//   h1  = relu(x . w1 + b1)                      1x1 reduce, Cin -> Cm
//   h2  = relu(conv3x3_d(h1) . w2 + b2)          3x3 at dilation d, zero-padded h1
//   out = relu(h2 . w3 + b3 + res)               1x1 expand, Cm -> Cout
//   res = x, or x . wd + bd (1x1 projection)
//
// on NHWC activations (x (B, H, W, Cin), pixels in rows of Cin channels).
// Replaces two TPU kernels:
//   * yomitoku_tpu/ops/pallas/bottleneck.py: fused_bottleneck (one block per
//     pallas_call, a row strip plus a d-row halo in VMEM), and
//   * yomitoku_tpu/ops/pallas/stage.py: fused_identity_stage (N identity
//     blocks per pallas_call, the strip's activations VMEM-resident across
//     the blocks).
//
// What bounds it on the H100 (batch 1; a block's bytes: x read, out
// written; its operations: 2 M (Cin Cm + 9 Cm^2 + Cm Cout [+ Cin Cout])):
//
//   shape                        M = H W   3x3 K   bound of the block
//   DBNet layer1_0 / layer1      118,400     576   bytes (0.023 / 0.018 ms)
//   DBNet layer2 (3 blocks)       29,600   1,152   ops   (0.017 ms a block)
//   DBNet layer3 (5 blocks)        7,400   2,304   ops   (0.017 ms a block)
//   DBNet layer4_0 / layer4        7,400   4,608   ops   (0.090 / 0.067)
//   PResNet stage0(_0)            25,600     576   bytes (0.005-0.008)
//   PResNet stage1 / 2 / 3    6,400 / 1,600 / 400   1,152-4,608   ~0.004
//
// DBNet's layer1 is bound by device memory, layer2-4 by the tensor cores,
// and PResNet's late stages by nothing but latency: their grids are small.
// The TPU kernels kept h1, h2 and, for a stage, the activations between
// blocks on chip.  An SM cannot: a DBNet layer1 activation is 400 x 296 x
// 256 x 2 B = 60.6 MB per image, more than the 50 MB L2, and a row strip
// with its halo is more than the 227 KB of shared memory at any useful
// height.  So a block is three launches of one implicit-GEMM kernel, h1 and
// h2 (each a quarter of x) making one round trip through device memory,
// which L2 partly absorbs; at DBNet layer1 those round trips put a
// three-launch design's floor near 0.041 ms.
//
// One kernel computes C = relu(sum over taps of A_tap . W_tap [+ A2 . W2]
// + bias [+ bias2] [+ res]); a 1x1 is one tap, the 3x3 nine taps whose A
// rows are the output pixels shifted by ((t-1) d, (u-1) d).  The projection
// shortcut is a second K segment over x and wd, so x . wd + bd stays an
// unrounded f32 sum, as in the Pallas kernel.  Biases are f32; h1, h2 and
// the output are rounded to the storage type after the f32 epilogue, where
// the Pallas kernels round them.
//
// bf16: TMA + wgmma, the shape of gemm.cu (hopper.cuh's parts):
//   * A by TMA with the tap shift in the coordinates: each activation is a
//     4-D tiled tensor map (C, W, H, B), 128-byte swizzled; an output unit
//     is a patch of bw x bh pixels (bw bh <= 128 or 64 rows), and tap
//     (t, u) loads the same box at (x + (u-1) d, y + (t-1) d).  TMA
//     zero-fills coordinates off the tensor, negative ones included: that
//     is the 3x3's zero padding of h1 (not of x, whose 1x1 image relu(b1)
//     is not zero), with no predicate code.  One box row is 64 channels
//     (128 bytes), the K-major swizzled A tile that wgmma reads.  A tiled
//     map, not an im2col-mode one: the patch is a plain box, every tap is
//     one more coordinate offset, and the same map serves the epilogue's
//     geometry.  A 1x1 reads its pixels as one line (C, M, 1, 1), so its
//     units have no padding; the 3x3's patch is chosen per shape in Python
//     (ops/_common.py conv_patch) for the fewest units, e.g. 8 x 16 at
//     400 x 296 (none padded), 25 x 5 at 100 x 74 (3.6% of the rows
//     computed lie off the page);
//   * B (the folded weights, (taps, K, N) row-major, the JAX layout) by a
//     3-D map (N, K, taps): MN-major, wgmma's transpose bit, 64-column
//     atoms; past K it loads zeros, so any K % 8 works;
//   * one producer thread walks each unit's K steps (taps x 64-channel
//     tiles, then the projection's tiles) into an mbarrier ring; two
//     consumer warpgroups take whole units in turns (named barriers), so
//     one's epilogue runs under the other's products, and issue wgmma
//     m64nNk16 from shared memory; N = 64 (Cm = 64: DBNet layer1, PResNet
//     stage0) has its own instantiation, as 128-wide units would waste half
//     of each;
//   * the epilogue works in place in the warpgroup's output tile: the
//     residual lands there by TMA (the patch's box, through the same 4-D
//     geometry), requested one unit ahead so it arrives under the
//     products; f32 bias (+ bias2), the residual, relu and one rounding
//     overwrite it element by element; one TMA store per 64 channels
//     writes it back and clips the patch's overhang past the page and N.
//     A whole residual tile in flight per warpgroup is what the 1x1
//     expands, which move the most bytes, need to stream;
//   * routes (chosen in Python, ops/_common.py conv_route): "wgmma"
//     128-pixel units where they fill three quarters of the card;
//     "wgmma_small" 64-pixel units where they would not; "wgmma_split"
//     64-pixel units with the K steps split over as many blocks as fit one
//     wave (at most 8) into an f32 workspace, then a combine pass (summing
//     the splits in a fixed order: a run repeats bit for bit) that applies
//     the epilogue, for grids that stay under one wave even so (PResNet
//     stage2-3 at batch 1).  Each C entry takes a plan per convolution
//     (route, patch, splits) and returns YT_ERR_ROUTE for one not built for
//     its arguments; nothing falls back.
// f32: a 64x64x16 shared-memory tile with 4x4 FMA micro-tiles per thread
// (full f32, for the parity checks).
// A stage (yt_identity_stage) runs its N blocks from one C call into two
// ping-pong activation buffers, h1 and h2 in one scratch.
// What bounds it now (PERF.md section 6): a 128 x 128 unit reads 64 FLOP
// per byte from L2, so the large-K convolutions with one unit per SM
// (DBNet layer3) run at ~380 TFLOP/s; the 3x3 at K = 64 (DBNet layer1)
// reads its patch nine times, once per tap.  Not yet: the 3x3's A as three
// x-shifted boxes 2d rows taller per K tile (the taps of one column share
// one box: 2-2.6x less A traffic), the weights multicast to a 2-CTA
// cluster, keeping h1 on chip (a unit that recomputes its h1 halo), and a
// persistent multi-block stage kernel.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct ConvArgs {
  const void* a1;  // segment 1: activation rows (one per pixel), k1 channels
  long long lda1;  // pixel stride of a1 (elements)
  int k1, taps;    // taps: 1 (1x1) or 9 (3x3, tap 3t + u)
  const void* w1;  // (taps * k1, n) row-major: row tap * k1 + k
  const void* a2;  // segment 2 (or null): read at the output pixel
  long long lda2;
  int k2;
  const void* w2;       // (k2, n) row-major
  const float* bias;    // (n,)
  const float* bias2;   // (n,) or null
  const void* res;      // (m, n) with row stride ldr, or null
  long long ldr;
  void* c;              // (m, n) with row stride ldc
  long long ldc;
  int m, n;             // m = B * H * W output pixels
  int h, w, d;          // page geometry and dilation of the taps
};

// How one convolution runs (ops/_common.py conv_plan): route (0 "fma", 1
// "wgmma", 2 "wgmma_small", 3 "wgmma_split"), the patch of an output unit
// (bw x bh pixels) and the K splits.
struct Plan {
  int route, bw, bh, splits;
};

// ----------------------------------------------------------------- f32 path

// One K step s of the implicit GEMM: which operand, which tap, which K
// offset.  Steps walk segment 1 tap by tap, then segment 2.
struct Step {
  const void* a;
  long long lda;
  const void* w;  // the first W row of this tap (row k0 + kr is at w + ...)
  int k, k0, dy, dx;
};

template <int BK>
__device__ __forceinline__ Step step_at(const ConvArgs& p, int s, int esize) {
  const int nk1 = (p.k1 + BK - 1) / BK;
  Step st;
  if (s < p.taps * nk1) {
    const int tap = s / nk1;
    st.a = p.a1;
    st.lda = p.lda1;
    st.k = p.k1;
    st.k0 = (s % nk1) * BK;
    st.w = static_cast<const char*>(p.w1) + (long long)tap * p.k1 * p.n * esize;
    st.dy = p.taps == 9 ? (tap / 3 - 1) * p.d : 0;
    st.dx = p.taps == 9 ? (tap % 3 - 1) * p.d : 0;
  } else {
    st.a = p.a2;
    st.lda = p.lda2;
    st.k = p.k2;
    st.k0 = (s - p.taps * nk1) * BK;
    st.w = p.w2;
    st.dy = st.dx = 0;
  }
  return st;
}

__host__ __device__ __forceinline__ int num_steps(const ConvArgs& p, int bk) {
  return p.taps * ((p.k1 + bk - 1) / bk) + (p.a2 ? (p.k2 + bk - 1) / bk : 0);
}

// A pixel's coordinates, computed once per row a thread loads.
struct Pixel {
  long long idx;  // pixel index in the (B, H, W) page batch
  int y, x;
  bool ok;        // idx < m
};

__device__ __forceinline__ Pixel pixel_of(const ConvArgs& p, int pm) {
  Pixel px;
  px.ok = pm < p.m;
  const int hw = p.h * p.w;
  const int rem = pm % hw;
  px.idx = pm;
  px.y = rem / p.w;
  px.x = rem % p.w;
  return px;
}

// The row of A for pixel px at this step's tap, or null where the tapped
// pixel lies off the page (or px is past m): the tap reads zeros there.
template <typename T>
__device__ __forceinline__ const T* a_row(const ConvArgs& p, const Step& st,
                                          const Pixel& px) {
  const int y = px.y + st.dy, x = px.x + st.dx;
  if (!px.ok || y < 0 || y >= p.h || x < 0 || x >= p.w) return nullptr;
  return static_cast<const T*>(st.a) + (px.idx + (long long)st.dy * p.w + st.dx) * st.lda;
}

__device__ __forceinline__ float bias_at(const ConvArgs& p, int col) {
  return p.bias[col] + (p.bias2 ? p.bias2[col] : 0.f);
}

constexpr int HF_M = 64, HF_N = 64, HF_K = 16;

__global__ void __launch_bounds__(256) conv_f32_kernel(ConvArgs p) {
  __shared__ float As[HF_K][HF_M + 4];
  __shared__ float Bs[HF_K][HF_N + 4];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * HF_M, n0 = blockIdx.y * HF_N;
  // A element (row ty + 16 j, column tx) of each step is this thread's
  Pixel px[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) px[j] = pixel_of(p, m0 + ty + 16 * j);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = num_steps(p, HF_K);
  for (int s = 0; s < nk; ++s) {
    const Step st = step_at<HF_K>(p, s, 4);
    const int gk = st.k0 + tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* row = a_row<float>(p, st, px[j]);
      As[tx][ty + 16 * j] = row != nullptr && gk < st.k ? row[gk] : 0.f;
    }
    const float* W = static_cast<const float*>(st.w);
    for (int idx = tid; idx < HF_N * HF_K; idx += 256) {
      const int n = idx % HF_N, c = idx / HF_N;
      const int gn = n0 + n, k = st.k0 + c;
      Bs[c][n] = gn < p.n && k < st.k ? W[(long long)k * p.n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HF_K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float* res = static_cast<const float*>(p.res);
  float* C = static_cast<float*>(p.c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= p.n) continue;
      float v = acc[i][j] + bias_at(p, gn);
      if (res) v += res[(long long)gm * p.ldr + gn];
      C[(long long)gm * p.ldc + gn] = fmaxf(v, 0.f);
    }
  }
}

// ---------------------------------------------------------------- bf16 path
// Needs k1, k2, n % 8 == 0, pixel strides % 8 == 0, 16-byte aligned
// activations and weights, 8-byte aligned biases (tma_ok).

constexpr int BK = 64;          // k per stage: one 128-byte swizzle span of bf16
constexpr int ATOM = BK * 128;  // one weight atom: 64 k rows of 64 n; one 64-channel block of a tile
constexpr int MAX_DEVICES = 64;

// A unit shape: BM output pixels (a patch) by BN channels; a ring of
// STAGES; a producer warpgroup and two consumer warpgroups, each with an
// output tile of its own (BN / 64 blocks of [BM rows][64 channels], the
// TMA box layout), where the residual lands and the result is stored from.
template <int BM_, int BN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int MT = BM / 64;  // m64 sub-tiles of a unit
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + BN * BK * 2;
  static constexpr int C0 = STAGES * STAGE;  // the output tiles
  static constexpr int OUT = BM * BN * 2;
  static constexpr int ALLOC = C0 + 2 * OUT + 1024;  // + alignment slack
  static constexpr int THREADS = 3 * 128;
};
using Wide = Tile<128, 128, 5>;   // "wgmma"                      (160 KB ring)
using Wide64 = Tile<128, 64, 8>;  // "wgmma", N <= 64             (192 KB)
using Small = Tile<64, 128, 8>;   // "wgmma_small", "wgmma_split" (192 KB)
using Small64 = Tile<64, 64, 8>;  // the same, N <= 64            (128 KB)

struct WgArgs {
  const float* bias;   // (n,)
  const float* bias2;  // (n,) or null
  int res;             // whether a residual is added (read through its map)
  float* ws;           // split partials (splits, m, n), or null: the epilogue runs here
  int m, n;
  int pw, ph;          // the maps' page width and height (a 1x1: m and 1)
  int taps, d;
  int bw, bh;          // the patch of a unit
  int npx, npy;        // patches across and down a page
  int nk1, seg1;       // 64-channel tiles of segment 1 per tap; its steps
  int steps;           // all K steps: seg1 + segment 2's tiles
  int ntn, splits, sps;  // n tiles, K splits, steps per split
  int units;             // pages x patches x splits x n tiles
};

struct Unit {
  int b, x0, y0, n0, split, s0, s1;
};

// Units walk n tiles fastest, then splits, then patches: the blocks in
// flight share the patch's A tiles.
__device__ __forceinline__ Unit unit_at(const WgArgs& p, int u, int bn) {
  Unit t;
  t.n0 = u % p.ntn * bn;
  u /= p.ntn;
  t.split = u % p.splits;
  u /= p.splits;
  t.x0 = u % p.npx * p.bw;
  u /= p.npx;
  t.y0 = u % p.npy * p.bh;
  t.b = u / p.npy;
  t.s0 = t.split * p.sps;
  t.s1 = min(p.steps, t.s0 + p.sps);
  return t;
}

// The pixel of row r of a unit's tile, or -1 where the row lies past the
// patch's box or off the page.
__device__ __forceinline__ long long pixel_at(const WgArgs& p, const Unit& t, int r) {
  const int yl = r / p.bw, xl = r - yl * p.bw;
  const int x = t.x0 + xl, y = t.y0 + yl;
  if (yl >= p.bh || x >= p.pw || y >= p.ph) return -1;
  return ((long long)t.b * p.ph + y) * p.pw + x;
}

// Shared-memory stage: A [BM rows][64 k] (the patch's pixels, row yl bw +
// xl), then BN / 64 weight atoms [64 k rows][64 n]; each row 128 bytes,
// 128-byte swizzled, every tile on a 1024-byte boundary (the swizzle
// period), as TMA and wgmma both swizzle by address.
template <class T>
__device__ __forceinline__ void produce(const CUtensorMap* ta1, const CUtensorMap* tw1,
                                        const CUtensorMap* ta2, const CUtensorMap* tw2,
                                        const WgArgs& p, unsigned char* sm, uint64_t* full,
                                        uint64_t* empty) {
  tma_prefetch_map(ta1);
  tma_prefetch_map(tw1);
  if (p.steps > p.seg1) {
    tma_prefetch_map(ta2);
    tma_prefetch_map(tw2);
  }
  const uint32_t bytes = (p.bw * p.bh + T::BN) * 128;
  int it = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_at(p, u, T::BN);
    for (int st = t.s0; st < t.s1; ++st, ++it) {
      const int s = it % T::STAGES, use = it / T::STAGES;
      if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
      unsigned char* a = sm + s * T::STAGE;
      unsigned char* b = a + T::A_BYTES;
      mbar_expect_tx(full + s, bytes);
      if (st < p.seg1) {
        const int tap = st / p.nk1, k0 = (st - tap * p.nk1) * BK;
        const int dy = p.taps == 9 ? (tap / 3 - 1) * p.d : 0;
        const int dx = p.taps == 9 ? (tap % 3 - 1) * p.d : 0;
        tma_load_4d(a, ta1, full + s, k0, t.x0 + dx, t.y0 + dy, t.b);
#pragma unroll
        for (int j = 0; j < T::BN / 64; ++j)
          tma_load_3d(b + j * ATOM, tw1, full + s, t.n0 + 64 * j, k0, tap);
      } else {
        const int k0 = (st - p.seg1) * BK;
        tma_load_4d(a, ta2, full + s, k0, t.x0, t.y0, t.b);
#pragma unroll
        for (int j = 0; j < T::BN / 64; ++j)
          tma_load_3d(b + j * ATOM, tw2, full + s, t.n0 + 64 * j, k0, 0);
      }
    }
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float* d, uint64_t a, uint64_t b, int acc) {
  if constexpr (BN == 128) wgmma_ss_n128<1>(d, a, b, acc);
  else wgmma_ss_n64<1>(d, a, b, acc);
}

// The residual of a unit into its output tile: one box of 64 channels
// over the patch per 64-channel block, completion on rbar.
template <class T>
__device__ __forceinline__ void load_res(const CUtensorMap* tr, const WgArgs& p, const Unit& t,
                                         unsigned char* out, uint64_t* rbar) {
  mbar_expect_tx(rbar, (T::BN / 64) * p.bw * p.bh * 128);
#pragma unroll
  for (int j = 0; j < T::BN / 64; ++j)
    tma_load_4d(out + j * T::BM * 128, tr, rbar, t.n0 + 64 * j, t.x0, t.y0, t.b);
}

// w: this consumer warpgroup, 0 or 1 (warp-uniform).
template <class T>
__device__ __forceinline__ void consume(const CUtensorMap* to, const CUtensorMap* tr,
                                        const WgArgs& p, unsigned char* sm, uint64_t* full,
                                        uint64_t* empty, uint64_t* rbar, int w) {
  constexpr int NA = T::BN / 2;  // accumulator floats per m64 sub-tile
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  // Taking turns (named barriers 1 and 2, warpgroup 0 first): a warpgroup
  // issues a unit's products on its turn and passes the turn on before its
  // epilogue, so the tensor cores work through the other's products.
  const int nu = (p.units - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's units
  auto my_turn = [&]() { named_bar_sync(1 + w, 256); };
  auto pass_turn = [&]() { named_bar_arrive(2 - w, 256); };
  if (w == 1) pass_turn();
  unsigned char* out = sm + T::C0 + w * T::OUT;
  rbar += w;
  const bool res = p.res && !p.ws;
  if (res && leader && w < nu) {  // the first unit's residual, in flight from the start
    tma_prefetch_map(tr);
    load_res<T>(tr, p, unit_at(p, blockIdx.x + w * gridDim.x, T::BN), out, rbar);
  }
  int nres = 0;  // residual tiles this warpgroup has waited for
  int it = 0;    // ring position of the unit's first step
  float acc[T::MT][NA];
  for (int i = 0; i < nu; ++i) {
    const Unit t = unit_at(p, blockIdx.x + i * gridDim.x, T::BN);
    const int ns = t.s1 - t.s0;
    if (i % 2 != w) {  // the other warpgroup's unit
      it += ns;
      continue;
    }
    my_turn();
    for (int k = 0; k < ns; ++k, ++it) {
      const int s = it % T::STAGES;
      mbar_wait(full + s, (it / T::STAGES) & 1);
      const unsigned char* a = sm + s * T::STAGE;
      const unsigned char* b = a + T::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // MN-major W: 16 k rows down; the next 64-column atom ATOM bytes on
        const uint64_t db = wgmma_desc(b + kk * 16 * 128, ATOM, 1024, 1);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
          wgmma_step<T::BN>(acc[mt], wgmma_desc(a + mt * 64 * 128 + kk * 32, 16, 1024, 1), db,
                            k > 0 || kk > 0);
      }
      wgmma_commit();
      if (k > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % T::STAGES);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int e = 0; e < NA; ++e) fence_operand(acc[mt][e]);
    if (lane == 0) mbar_arrive(empty + (it - 1) % T::STAGES);
    if (i + 1 < nu) pass_turn();

    // lane (g, q) of warp holds rows 16 warp + g (+ 8) of each m64
    // sub-tile, columns 8 j + 2 q (+ 1)
    if (p.ws) {
      // A split's partial sums, unrounded, at the patch's pixels.
      float* part = p.ws + (long long)t.split * p.m * p.n;
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long px = pixel_at(p, t, mt * 64 + warp * 16 + g + 8 * h);
          if (px < 0) continue;
#pragma unroll
          for (int j = 0; j < T::BN / 8; ++j) {
            const int col = t.n0 + 8 * j + 2 * q;
            if (col < p.n)
              *reinterpret_cast<float2*>(part + px * p.n + col) =
                  make_float2(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
          }
        }
      continue;
    }

    // Epilogue in place in the output tile (128-byte rows, 16-byte chunks
    // swizzled by row % 8, as TMA lays them: conflict-free): bias in f32
    // on the accumulators, the residual that landed there, relu, one
    // rounding to bf16 over it; then one TMA store per 64-channel block,
    // which clips the patch's overhang past the page and N.  Each thread
    // reads and writes only its own elements, so no barrier splits it.
    if (res) mbar_wait(rbar, nres++ & 1);
    const int rows = p.bw * p.bh;
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      const int col = t.n0 + 8 * j + 2 * q;
      float2 bv = make_float2(0.f, 0.f);
      if (col < p.n) {
        bv = __ldg(reinterpret_cast<const float2*>(p.bias + col));
        if (p.bias2) {
          const float2 b2 = __ldg(reinterpret_cast<const float2*>(p.bias2 + col));
          bv.x += b2.x;
          bv.y += b2.y;
        }
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        if (mt * 64 >= rows) continue;  // warpgroup-uniform
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 64 + warp * 16 + g + 8 * h;  // r % 8 == g
          auto* pair = reinterpret_cast<__nv_bfloat162*>(out + (j / 8) * T::BM * 128 + r * 128 +
                                                         (((j % 8) ^ g) << 4) + q * 4);
          float v0 = acc[mt][4 * j + 2 * h] + bv.x, v1 = acc[mt][4 * j + 2 * h + 1] + bv.y;
          if (res) {
            const float2 rv = __bfloat1622float2(*pair);
            v0 += rv.x;
            v1 += rv.y;
          }
          *pair = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
    fence_proxy_async();
    named_bar_sync(3 + w, 128);  // this warpgroup's tile is written
    if (leader) {
#pragma unroll
      for (int j = 0; j < T::BN / 64; ++j)
        if (t.n0 + 64 * j < p.n) tma_store_4d(to, out + j * T::BM * 128, t.n0 + 64 * j, t.x0, t.y0, t.b);
      bulk_commit();
      bulk_wait_read<0>();  // the tile is free again: the next residual may land
      if (res && i + 2 < nu)
        load_res<T>(tr, p, unit_at(p, blockIdx.x + (i + 2) * gridDim.x, T::BN), out, rbar);
    }
  }
}

// Warpgroup 0 is the producer (one thread issues every TMA load), warpgroups
// 1 and 2 the consumers.  The roles part once and never meet again, so
// setmaxnreg can hand the producer's registers to the consumers.  Maps:
// ta1 / tw1 segment 1's activation and weights, ta2 / tw2 segment 2's, to
// the output, tr the residual.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap ta1,
                      const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap ta2,
                      const __grid_constant__ CUtensorMap tw2,
                      const __grid_constant__ CUtensorMap to,
                      const __grid_constant__ CUtensorMap tr, const WgArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * T::STAGES + 2];
  uint64_t *full = bars, *empty = bars + T::STAGES, *rbar = bars + 2 * T::STAGES;
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init(rbar, 1);
    mbar_init(rbar + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // broadcast from lane 0: the compiler then knows the role is warp-uniform
  // and keeps the wgmmas of the consumer branch asynchronous
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    warpgroup_reg_dealloc<40>();
    if (threadIdx.x == 0) produce<T>(&ta1, &tw1, &ta2, &tw2, p, sm, full, empty);
  } else {
    warpgroup_reg_alloc<232>();
    consume<T>(&to, &tr, p, sm, full, empty, rbar, wg - 1);
  }
}

struct CombineArgs {
  const float* ws;  // (splits, m, n) partial sums
  int splits, m, n;
  const float* bias;   // (n,)
  const float* bias2;  // (n,) or null
  const bf16* res;     // (m, n) with row stride ldr, or null
  long long ldr;
  bf16* c;
  long long ldc;
};

// The split route's epilogue: the splits summed in order (no atomics: a
// run repeats bit for bit), bias, residual, relu, one rounding; 8
// channels a thread, 16-byte loads and stores.
__global__ void __launch_bounds__(256) conv_combine_kernel(CombineArgs p) {
  const int nv = p.n / 8;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)p.m * nv) return;
  const long long px = i / nv;
  const int col = (int)(i - px * nv) * 8;
  const long long plane = (long long)p.m * p.n;
  const float* src = p.ws + px * p.n + col;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < p.splits; ++s) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(src + s * plane));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(src + s * plane + 4));
    const float part[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += part[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] += p.bias[col + e] + (p.bias2 ? p.bias2[col + e] : 0.f);
  if (p.res) {
    float r[8];
    unpack8(*reinterpret_cast<const uint4*>(p.res + px * p.ldr + col), r);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += r[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
  *reinterpret_cast<uint4*>(p.c + px * p.ldc + col) = pack8(v);
}

// A 4-D map (C, W, H, B) of an activation of k channels with pixel stride
// ld; boxes of 64 channels x the bw x bh patch.
int map_pixels(CUtensorMap* map, const void* base, int k, long long ld, int pw, int ph, int pb,
               int bw, int bh) {
  const cuuint64_t row = (cuuint64_t)ld * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)k, (cuuint64_t)pw, (cuuint64_t)ph, (cuuint64_t)pb};
  const cuuint64_t strides[3] = {row, row * pw, row * pw * ph};
  const cuuint32_t box[4] = {BK, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return make_map_bf16(map, 4, base, dims, strides, box);
}

// A 3-D map (N, K, taps) of (taps, k, n) row-major weights; boxes of one
// 64 k x 64 n atom of one tap.
int map_weights(CUtensorMap* map, const void* base, int n, int k, int taps) {
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)k, (cuuint64_t)taps};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 2, (cuuint64_t)n * k * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  return make_map_bf16(map, 3, base, dims, strides, box);
}

template <class T>
int launch_wgmma(const ConvArgs& g, const Plan& pl, float* ws, cudaStream_t s) {
  // a 1x1 reads its pixels as one line: no patch overhangs a page edge
  const bool line = g.taps == 1;
  const int pw = line ? g.m : g.w, ph = line ? 1 : g.h, pb = line ? 1 : g.m / (g.h * g.w);
  if (pl.bw < 1 || pl.bh < 1 || pl.bw * pl.bh > T::BM) return YT_ERR_ROUTE;
  CUtensorMap ta1, tw1, ta2, tw2, to, tr;
  int rc = map_pixels(&ta1, g.a1, g.k1, g.lda1, pw, ph, pb, pl.bw, pl.bh);
  if (!rc) rc = map_weights(&tw1, g.w1, g.n, g.k1, g.taps);
  if (!rc && g.a2) rc = map_pixels(&ta2, g.a2, g.k2, g.lda2, pw, ph, pb, pl.bw, pl.bh);
  if (!rc && g.a2) rc = map_weights(&tw2, g.w2, g.n, g.k2, 1);
  if (!rc) rc = map_pixels(&to, g.c, g.n, g.ldc, pw, ph, pb, pl.bw, pl.bh);
  if (!rc && g.res) rc = map_pixels(&tr, g.res, g.n, g.ldr, pw, ph, pb, pl.bw, pl.bh);
  if (rc) return rc;
  if (!g.a2) {  // never read
    ta2 = ta1;
    tw2 = tw1;
  }
  if (!g.res) tr = to;  // never read
  WgArgs p{};
  p.bias = g.bias;
  p.bias2 = g.bias2;
  p.res = g.res != nullptr;
  p.m = g.m;
  p.n = g.n;
  p.pw = pw;
  p.ph = ph;
  p.taps = g.taps;
  p.d = g.d;
  p.bw = pl.bw;
  p.bh = pl.bh;
  p.npx = (pw + pl.bw - 1) / pl.bw;
  p.npy = (ph + pl.bh - 1) / pl.bh;
  p.nk1 = (g.k1 + BK - 1) / BK;
  p.seg1 = g.taps * p.nk1;
  p.steps = p.seg1 + (g.a2 ? (g.k2 + BK - 1) / BK : 0);
  p.ntn = (g.n + T::BN - 1) / T::BN;
  // at most pl.splits splits of whole K steps, none of them empty
  p.sps = (p.steps + pl.splits - 1) / pl.splits;
  p.splits = (p.steps + p.sps - 1) / p.sps;
  p.ws = p.splits > 1 ? ws : nullptr;
  const long long units = (long long)pb * p.npy * p.npx * p.splits * p.ntn;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.units = (int)units;

  auto kern = conv_wgmma_kernel<T>;
  // per device, once: the shared-memory attribute, SMs, blocks per SM
  static int per_sm[MAX_DEVICES] = {}, sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!per_sm[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::ALLOC);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kern, T::THREADS, T::ALLOC);
    if (e != cudaSuccess) return (int)e;
    if (per_sm[dev] < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  const int slots = sms[dev] * per_sm[dev];
  kern<<<p.units < slots ? p.units : slots, T::THREADS, T::ALLOC, s>>>(ta1, tw1, ta2, tw2, to, tr,
                                                                      p);
  e = cudaGetLastError();
  if (e != cudaSuccess || !p.ws) return (int)e;
  CombineArgs c{ws,    p.splits, g.m, g.n, g.bias, g.bias2, static_cast<const bf16*>(g.res),
                g.ldr, static_cast<bf16*>(g.c), g.ldc};
  const long long threads = (long long)g.m * (g.n / 8);
  conv_combine_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(c);
  return (int)cudaGetLastError();
}

bool tma_ok(const ConvArgs& g) {
  auto aligned = [](const void* ptr, int to) { return reinterpret_cast<uintptr_t>(ptr) % to == 0; };
  return aligned(g.a1, 16) && aligned(g.w1, 16) && aligned(g.c, 16) && aligned(g.bias, 8) &&
         (!g.a2 || (aligned(g.a2, 16) && aligned(g.w2, 16) && g.k2 % 8 == 0 && g.lda2 % 8 == 0)) &&
         (!g.bias2 || aligned(g.bias2, 8)) && (!g.res || (aligned(g.res, 16) && g.ldr % 8 == 0)) &&
         g.k1 % 8 == 0 && g.n % 8 == 0 && g.lda1 % 8 == 0 && g.ldc % 8 == 0;
}

// One convolution by its plan; ws: room for the split route's partials.
int run_conv(int dtype, const ConvArgs& g, const Plan& pl, float* ws, cudaStream_t s) {
  if (dtype == YT_F32) {
    if (pl.route != 0) return YT_ERR_ROUTE;
    dim3 grid((g.m + HF_M - 1) / HF_M, (g.n + HF_N - 1) / HF_N);
    conv_f32_kernel<<<grid, 256, 0, s>>>(g);
    return (int)cudaGetLastError();
  }
  if (!tma_ok(g)) return YT_ERR_ROUTE;
  const bool n64 = g.n <= 64;
  switch (pl.route) {
    case 1:
      if (pl.splits != 1) return YT_ERR_ROUTE;
      return n64 ? launch_wgmma<Wide64>(g, pl, nullptr, s) : launch_wgmma<Wide>(g, pl, nullptr, s);
    case 2:
      if (pl.splits != 1) return YT_ERR_ROUTE;
      return n64 ? launch_wgmma<Small64>(g, pl, nullptr, s) : launch_wgmma<Small>(g, pl, nullptr, s);
    case 3:
      if (pl.splits < 2 || !ws) return YT_ERR_ROUTE;
      return n64 ? launch_wgmma<Small64>(g, pl, ws, s) : launch_wgmma<Small>(g, pl, ws, s);
  }
  return YT_ERR_ROUTE;
}

// One block, three launches: h1 = 1x1 reduce, h2 = the 3x3, out = 1x1
// expand + shortcut, by plans[0..2].  h1 and h2 are (B * H * W, cm) scratch.
int bottleneck(int dtype, const void* x, int b, int h, int w, int cin, int cm,
               int cout, int d, const void* w1, const float* b1, const void* w2,
               const float* b2, const void* w3, const float* b3, const void* wd,
               const float* bd, void* h1, void* h2, void* out, const Plan* plans, float* ws,
               cudaStream_t s) {
  const int m = b * h * w;
  ConvArgs reduce{x, cin, cin, 1, w1, nullptr, 0, 0, nullptr, b1, nullptr,
                  nullptr, 0, h1, cm, m, cm, h, w, d};
  int e = run_conv(dtype, reduce, plans[0], ws, s);
  if (e) return e;
  ConvArgs conv3{h1, cm, cm, 9, w2, nullptr, 0, 0, nullptr, b2, nullptr,
                 nullptr, 0, h2, cm, m, cm, h, w, d};
  e = run_conv(dtype, conv3, plans[1], ws, s);
  if (e) return e;
  ConvArgs expand{h2, cm, cm, 1, w3, wd ? x : nullptr, cin, wd ? cin : 0, wd,
                  b3, bd, wd ? nullptr : x, cin, out, cout, m, cout, h, w, d};
  return run_conv(dtype, expand, plans[2], ws, s);
}

bool bad_dims(int dtype, int b, int h, int w, int cin, int cm, int cout, int d) {
  if (dtype != YT_BF16 && dtype != YT_F32) return true;
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cm <= 0 || cout <= 0 || d <= 0) return true;
  if ((long long)b * h * w > 0x7fffffffLL) return true;
  return dtype == YT_BF16 && (cin % 8 || cm % 8 || cout % 8);
}

}  // namespace

// One convolution on NHWC a1 (b, h, w, k1) -> out (b, h, w, n), all
// contiguous: relu(sum over taps of a1 . w1 (+ a2 . w2) + b1 (+ b2) (+ res)),
// w1 (taps, k1, n), a2 (b, h, w, k2) read at the output pixel with w2 (k2,
// n), res (b, h, w, n); plan = {route, bw, bh, splits} (see Plan); ws:
// (splits, b h w, n) f32 for the split route.
extern "C" int yt_conv(int dtype, const int* plan, const void* a1, int taps, const void* w1,
                       const float* b1, const void* a2, int k2, const void* w2, const float* b2,
                       const void* res, void* out, int b, int h, int w, int k1, int n, int d,
                       void* ws, void* stream) {
  if (bad_dims(dtype, b, h, w, k1, n, n, d) || (taps != 1 && taps != 9) || (a2 && (!w2 || k2 <= 0)))
    return (int)cudaErrorInvalidValue;
  const int m = b * h * w;
  ConvArgs g{a1, k1, k1, taps, w1, a2, k2, a2 ? k2 : 0, w2, b1, b2, res, n, out, n, m, n, h, w, d};
  const Plan pl{plan[0], plan[1], plan[2], plan[3]};
  return run_conv(dtype, g, pl, static_cast<float*>(ws), static_cast<cudaStream_t>(stream));
}

// One stride-1 bottleneck block on NHWC x (b, h, w, cin) -> out (b, h, w,
// cout); wd / bd null for the identity shortcut (then cin == cout); plan:
// three {route, bw, bh, splits}, reduce, 3x3, expand.
extern "C" int yt_bottleneck(int dtype, const void* x, int b, int h, int w,
                             int cin, int cm, int cout, int d, const void* w1,
                             const float* b1, const void* w2, const float* b2,
                             const void* w3, const float* b3, const void* wd,
                             const float* bd, void* h1, void* h2, void* out,
                             const int* plan, void* ws, void* stream) {
  if (bad_dims(dtype, b, h, w, cin, cm, cout, d) || (!wd && cin != cout) ||
      (wd && !bd))
    return (int)cudaErrorInvalidValue;
  const Plan plans[3] = {{plan[0], plan[1], plan[2], plan[3]},
                         {plan[4], plan[5], plan[6], plan[7]},
                         {plan[8], plan[9], plan[10], plan[11]}};
  return bottleneck(dtype, x, b, h, w, cin, cm, cout, d, w1, b1, w2, b2, w3,
                    b3, wd, bd, h1, h2, out, plans, static_cast<float*>(ws),
                    static_cast<cudaStream_t>(stream));
}

// nblocks identity blocks (c -> cm -> c) in a row; block j's weights are
// slice j of w1s (nblocks, c, cm), w2s (nblocks, 9, cm, cm), w3s (nblocks,
// cm, c) and of the biases.  The blocks alternate between out and tmp (the
// last one writes out; tmp may be null for one block); h1 and h2 are
// scratch of (b * h * w, cm) each, reused by every block, as is ws; plan:
// three {route, bw, bh, splits}, one per convolution of a block.
extern "C" int yt_identity_stage(int dtype, const void* x, int b, int h, int w,
                                 int c, int cm, int nblocks, int d,
                                 const void* w1s, const float* b1s,
                                 const void* w2s, const float* b2s,
                                 const void* w3s, const float* b3s, void* h1,
                                 void* h2, void* tmp, void* out, const int* plan, void* ws,
                                 void* stream) {
  if (bad_dims(dtype, b, h, w, c, cm, c, d) || nblocks <= 0 || (nblocks > 1 && !tmp))
    return (int)cudaErrorInvalidValue;
  const Plan plans[3] = {{plan[0], plan[1], plan[2], plan[3]},
                         {plan[4], plan[5], plan[6], plan[7]},
                         {plan[8], plan[9], plan[10], plan[11]}};
  const long long es = dtype == YT_BF16 ? 2 : 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* src = x;
  for (int j = 0; j < nblocks; ++j) {
    void* dst = (nblocks - 1 - j) % 2 == 0 ? out : tmp;
    const char* w1 = static_cast<const char*>(w1s) + j * (long long)c * cm * es;
    const char* w2 = static_cast<const char*>(w2s) + j * 9LL * cm * cm * es;
    const char* w3 = static_cast<const char*>(w3s) + j * (long long)cm * c * es;
    const int e = bottleneck(dtype, src, b, h, w, c, cm, c, d, w1, b1s + (long long)j * cm,
                             w2, b2s + (long long)j * cm, w3, b3s + (long long)j * c,
                             nullptr, nullptr, h1, h2, dst, plans, static_cast<float*>(ws), s);
    if (e) return e;
    src = dst;
  }
  return 0;
}

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
// What bounds it on the H100: at the detectors' shapes a block does 60-290
// FLOPs per byte it must move (x read, out written), below or near the
// card's ~295 FLOP/byte ridge: DBNet's layer1 blocks are bound by device
// memory, layer3-4 by the tensor cores.  The TPU kernels kept h1, h2 and,
// for a stage, the activations between blocks on chip.  An SM cannot: a
// DBNet layer1 activation is 400 x 296 x 256 x 2 B = 60.6 MB per image,
// more than the 50 MB L2, and one row strip with its halo is more than the
// 227 KB of shared memory at any useful strip height.  So the design here
// is a chain of three launches of one implicit-GEMM kernel per block, with
// h1 and h2 (each a quarter of x) making one round trip through device
// memory, which L2 partly absorbs:
//   * one kernel computes C = relu(sum over taps of A_tap . W_tap [+ A2 . W2]
//     + bias [+ bias2] [+ res]); a 1x1 is one tap, the 3x3 is nine taps whose
//     A rows are the output pixels shifted by ((t-1) d, (u-1) d).  A pixel
//     shifted off the page loads zeros (cp.async with source size 0): that is
//     the 3x3's zero padding of h1 (not of x, whose 1x1 image relu(b1) is not
//     zero).  The projection shortcut is a second K segment over x and wd, so
//     x . wd + bd stays an unrounded f32 sum, as in the Pallas kernel;
//   * bf16: 128x128x32 blocks, 8 warps of 64x32, mma.sync m16n8k16 fed by
//     ldmatrix, a 4-stage cp.async ring (the tiles gemm.cu had before its
//     TMA + wgmma redesign), with the gathered A rows; each thread computes
//     its two A rows' pixel coordinates once;
//   * f32: a 64x64x16 shared-memory tile with 4x4 FMA micro-tiles per thread
//     (full f32, for the parity checks);
//   * biases are f32; h1, h2 and the output are rounded to the storage type
//     after the f32 epilogue, where the Pallas kernels round them;
//   * a stage (yt_identity_stage) runs its N blocks from one C call into two
//     ping-pong activation buffers, h1 and h2 in one scratch.
// Not yet: keeping h1 on chip (a block that recomputes its h1 halo), TMA,
// wgmma, and a persistent multi-block stage kernel.
#include <stdint.h>

#include "common.cuh"

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

// ---------------------------------------------------------------- bf16 path
// Needs k1, k2, n % 8 == 0, pixel strides % 8 == 0 and 16-byte aligned
// base pointers (the wrapper checks).

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int AP = BK + 8;  // A row pitch: 80 bytes, conflict-free ldmatrix
constexpr int BP = BN + 8;  // W row pitch (k-major tiles): 272 bytes
constexpr int A_TILE = BM * AP;
constexpr int B_TILE = BK * BP;
constexpr int CONV_SMEM = STAGES * (A_TILE + B_TILE) * 2;  // 74 KB

__global__ void __launch_bounds__(256) conv_bf16_kernel(ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][AP]
  bf16* Bs = As + STAGES * A_TILE;           // [STAGES][BK][BP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 64 x 32 each

  // This thread copies A rows tid / 4 and tid / 4 + 64 (column kc) and W
  // rows tid / 16 and tid / 16 + 16 (columns nc .. nc + 7) of each stage.
  const int kc = (tid % 4) * 8, nc = (tid % 16) * 8;
  const Pixel px[2] = {pixel_of(p, m0 + tid / 4), pixel_of(p, m0 + tid / 4 + 64)};

  auto load_stage = [&](int stage, int s) {
    const Step st = step_at<BK>(p, s, 2);
    bf16* as = As + stage * A_TILE;
    bf16* bs = Bs + stage * B_TILE;
    const bf16* W = static_cast<const bf16*>(st.w);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bf16* row = a_row<bf16>(p, st, px[i]);
      const bool ok = row != nullptr && st.k0 + kc < st.k;
      cp_async16(as + (tid / 4 + 64 * i) * AP + kc,
                 ok ? row + st.k0 + kc : static_cast<const bf16*>(st.a), ok);
      const int kr = tid / 16 + 16 * i;
      const bool okw = st.k0 + kr < st.k && n0 + nc < p.n;
      cp_async16(bs + kr * BP + nc,
                 okw ? W + (long long)(st.k0 + kr) * p.n + n0 + nc : W, okw);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = num_steps(p, BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();  // step t has landed (for this thread) ...
    __syncthreads();              // ... for all threads; step t-1 is consumed
    if (t + STAGES - 1 < nk) load_stage((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_async_commit();  // possibly empty: keeps the group count in step

    const bf16* as = As + (t % STAGES) * A_TILE;
    const bf16* bs = Bs + (t % STAGES) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], as + (wm * 64 + mt * 16 + lane % 16) * AP + kk + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // two n8 tiles per ldmatrix
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * BP + wn * 32 + np * 16 + (lane >> 4) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  cp_async_wait<0>();

  // Epilogue on the accumulators: lane (g, q) holds rows g and g + 8,
  // columns 2q and 2q + 1 of each 16x8 tile.
  const int g = lane / 4, q = lane % 4;
  const bf16* res = static_cast<const bf16*>(p.res);
  bf16* C = static_cast<bf16*>(p.c);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + q * 2;
    if (col >= p.n) continue;
    const float b0 = bias_at(p, col), b1 = bias_at(p, col + 1);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 64 + mt * 16 + g + hh * 8;
        if (row >= p.m) continue;
        float v0 = acc[mt][nt][2 * hh] + b0, v1 = acc[mt][nt][2 * hh + 1] + b1;
        if (res) {
          const float2 rv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + (long long)row * p.ldr + col));
          v0 += rv.x;
          v1 += rv.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(C + (long long)row * p.ldc + col) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path

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

int launch_conv(int dtype, const ConvArgs& p, cudaStream_t s) {
  if (dtype == YT_BF16) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CONV_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.m + BM - 1) / BM, (p.n + BN - 1) / BN);
    conv_bf16_kernel<<<grid, 256, CONV_SMEM, s>>>(p);
  } else {
    dim3 grid((p.m + HF_M - 1) / HF_M, (p.n + HF_N - 1) / HF_N);
    conv_f32_kernel<<<grid, 256, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// One block, three launches: h1 = 1x1 reduce, h2 = the 3x3, out = 1x1
// expand + shortcut.  h1 and h2 are (B * H * W, cm) scratch.
int bottleneck(int dtype, const void* x, int b, int h, int w, int cin, int cm,
               int cout, int d, const void* w1, const float* b1, const void* w2,
               const float* b2, const void* w3, const float* b3, const void* wd,
               const float* bd, void* h1, void* h2, void* out, cudaStream_t s) {
  const int m = b * h * w;
  ConvArgs reduce{x, cin, cin, 1, w1, nullptr, 0, 0, nullptr, b1, nullptr,
                  nullptr, 0, h1, cm, m, cm, h, w, d};
  int e = launch_conv(dtype, reduce, s);
  if (e) return e;
  ConvArgs conv3{h1, cm, cm, 9, w2, nullptr, 0, 0, nullptr, b2, nullptr,
                 nullptr, 0, h2, cm, m, cm, h, w, d};
  e = launch_conv(dtype, conv3, s);
  if (e) return e;
  ConvArgs expand{h2, cm, cm, 1, w3, wd ? x : nullptr, cin, wd ? cin : 0, wd,
                  b3, bd, wd ? nullptr : x, cin, out, cout, m, cout, h, w, d};
  return launch_conv(dtype, expand, s);
}

bool bad_dims(int dtype, int b, int h, int w, int cin, int cm, int cout, int d) {
  if (dtype != YT_BF16 && dtype != YT_F32) return true;
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cm <= 0 || cout <= 0 || d <= 0) return true;
  if ((long long)b * h * w > 0x7fffffffLL) return true;
  return dtype == YT_BF16 && (cin % 8 || cm % 8 || cout % 8);
}

}  // namespace

// One stride-1 bottleneck block on NHWC x (b, h, w, cin) -> out (b, h, w,
// cout); wd / bd null for the identity shortcut (then cin == cout).
extern "C" int yt_bottleneck(int dtype, const void* x, int b, int h, int w,
                             int cin, int cm, int cout, int d, const void* w1,
                             const float* b1, const void* w2, const float* b2,
                             const void* w3, const float* b3, const void* wd,
                             const float* bd, void* h1, void* h2, void* out,
                             void* stream) {
  if (bad_dims(dtype, b, h, w, cin, cm, cout, d) || (!wd && cin != cout) ||
      (wd && !bd))
    return (int)cudaErrorInvalidValue;
  return bottleneck(dtype, x, b, h, w, cin, cm, cout, d, w1, b1, w2, b2, w3,
                    b3, wd, bd, h1, h2, out, static_cast<cudaStream_t>(stream));
}

// nblocks identity blocks (c -> cm -> c) in a row; block j's weights are
// slice j of w1s (nblocks, c, cm), w2s (nblocks, 9, cm, cm), w3s (nblocks,
// cm, c) and of the biases.  The blocks alternate between out and tmp (the
// last one writes out; tmp may be null for one block); h1 and h2 are
// scratch of (b * h * w, cm) each, reused by every block.
extern "C" int yt_identity_stage(int dtype, const void* x, int b, int h, int w,
                                 int c, int cm, int nblocks, int d,
                                 const void* w1s, const float* b1s,
                                 const void* w2s, const float* b2s,
                                 const void* w3s, const float* b3s, void* h1,
                                 void* h2, void* tmp, void* out, void* stream) {
  if (bad_dims(dtype, b, h, w, c, cm, c, d) || nblocks <= 0 || (nblocks > 1 && !tmp))
    return (int)cudaErrorInvalidValue;
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
                             nullptr, nullptr, h1, h2, dst, s);
    if (e) return e;
    src = dst;
  }
  return 0;
}

// Tiled GEMM with an optional LayerNorm on A and a bias / exact-erf GELU /
// residual epilogue:
//
//   C = epilogue(LN?(A) . W + bias)      A (M, K), W (K, N), C (M, N)
//
// Replaces the matrix products inside two TPU kernels:
//   * yomitoku_tpu/ops/pallas/fused_mlp.py: fused_mlp (fc1 -> GELU -> fc2)
//     and fused_mlp_ln (x + fc2(GELU(fc1(LN(x))))), and
//   * yomitoku_tpu/ops/pallas/flash_attention.py: fused_attention_block_ln
//     (the LN -> packed QKV projection and the out-projection + residual).
// ops/mlp.py and ops/attention.py chain these GEMMs with the attention
// kernel of attention.cu.
//
// What bounds it on the H100: at the recognizer's shapes (M = 51,200 rows,
// K = 768 or 3072, N = 768 to 3072, bf16) every product does ~600 FLOPs per
// byte of device memory it must move, above the card's ~295 FLOP/byte ridge:
// the tensor cores bound it, not HBM.  The TPU kernels held a whole 512-row
// tile and the full weight chunk in VMEM and never wrote the (N, 4D) hidden
// activation; an SM's 227 KB of shared memory cannot, so the design here:
//   * bf16: 128x128x32 block tiles, 8 warps of 64x32, mma.sync m16n8k16
//     (f32 accumulators in registers) fed by ldmatrix from padded
//     (conflict-free) shared-memory rows; a 4-stage cp.async ring keeps
//     three tiles in flight from device memory while the tensor cores work
//     on the fourth.  The epilogue runs on the accumulator registers;
//   * f32: a 64x64x16 shared-memory tile with 4x4 FMA micro-tiles per thread
//     (full f32; tensor-core TF32 would lose the 1e-4 parity);
//   * LayerNorm: its own row pass (one warp per row, f32 statistics, variance
//     max(E[x^2] - mean^2, 0) as in the Pallas kernels), writing LN(x) rounded
//     to the storage type, as the Pallas kernels round it before their
//     matmul; the GEMM then reads it like any A.  A separate pass because
//     cp.async copies tiles to shared memory untouched: normalising in the
//     load path needs tiles staged through registers, which kept such a
//     GEMM near 60 TFLOP/s on this card, while the extra pass moves only
//     2 x M x K x 2 bytes (~0.16 GB, ~50 us per call at these shapes);
//   * the hidden activation of the MLP makes one bf16 round trip through HBM
//     (fc1 writes it, fc2 reads it): ~0.6 GB per encoder block at batch 128,
//     a fifth of a millisecond at 3.35 TB/s.
// Not yet: TMA, wgmma, warp specialisation (the route to the card's full
// tensor-core rate, for a later change).
#include <stdint.h>

#include "common.cuh"

namespace {

struct GemmArgs {
  const void* a;
  long long lda;
  const void* w;
  long long ldw;     // W element (k, n) at w[k * ldw + n], or w[n * ldw + k]
  const void* bias;  // (N,) or null
  const void* res;   // (M, N) with row stride ldr, or null
  long long ldr;
  void* c;
  long long ldc;
  int m, n, k;
  int gelu;
};

struct LnArgs {
  const void* x;  // (M, K) with row stride ldx
  long long ldx;
  const void* g;  // (K,) scale and shift
  const void* b;
  void* y;        // (M, K), contiguous
  int m, k;
  float eps;
};

// y = LayerNorm(x) row by row, one warp per row: f32 mean and
// var = max(E[x^2] - mean^2, 0) (the Pallas formula), output rounded to T.
// bf16 rows move as 16-byte vectors (K % 8 == 0 there).
template <typename T>
__global__ void __launch_bounds__(256) layer_norm_kernel(LnArgs p) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= p.m) return;
  const T* x = static_cast<const T*>(p.x) + (long long)row * p.ldx;
  const T* g = static_cast<const T*>(p.g);
  const T* b = static_cast<const T*>(p.b);
  T* y = static_cast<T*>(p.y) + (long long)row * p.k;
  float s = 0.f, ss = 0.f;
  if constexpr (sizeof(T) == 2) {
    for (int k = lane * 8; k < p.k; k += 256) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(x + k), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
  } else {
    for (int k = lane; k < p.k; k += 32) {
      const float v = to_f32(x[k]);
      s += v;
      ss += v * v;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / p.k;
  const float rs = rsqrtf(fmaxf(ss / p.k - mean * mean, 0.f) + p.eps);
  if constexpr (sizeof(T) == 2) {
    for (int k = lane * 8; k < p.k; k += 256) {
      float v[8], gv[8], bv[8];
      unpack8(*reinterpret_cast<const uint4*>(x + k), v);
      unpack8(*reinterpret_cast<const uint4*>(g + k), gv);
      unpack8(*reinterpret_cast<const uint4*>(b + k), bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean) * rs * gv[e] + bv[e];
      *reinterpret_cast<uint4*>(y + k) = pack8(v);
    }
  } else {
    for (int k = lane; k < p.k; k += 32)
      y[k] = from_f32<T>((to_f32(x[k]) - mean) * rs * to_f32(g[k]) + to_f32(b[k]));
  }
}

__device__ __forceinline__ float epilogue(const GemmArgs& p, float v,
                                          float bias, float res) {
  v += bias;
  if (p.gelu) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v + res;
}

// ---------------------------------------------------------------- bf16 path
// Needs K % 8 == 0, N % 8 == 0, every leading dimension % 8 == 0 and
// 16-byte aligned base pointers (the wrapper checks).

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int AP = BK + 8;  // row pitch (elements) of A tiles and of W tiles
                            // stored n-major: 80 bytes, so the 8 rows of an
                            // ldmatrix hit 8 distinct 16-byte bank groups
constexpr int BP = BN + 8;  // row pitch of W tiles stored k-major (272 bytes)
constexpr int A_TILE = BM * AP;
constexpr int B_TILE = BN * AP > BK * BP ? BN * AP : BK * BP;
constexpr int GEMM_SMEM = STAGES * (A_TILE + B_TILE) * 2;  // 80 KB

// NK: W rows are output columns (a torch Linear weight, W[n * ldw + k]);
// otherwise W rows are k (the JAX (in, out) layout, W[k * ldw + n]).
template <bool NK>
__global__ void __launch_bounds__(256) gemm_bf16_kernel(GemmArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][AP]
  bf16* Bs = As + STAGES * A_TILE;           // [STAGES][B_TILE]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 64 x 32 each
  const bf16* A = static_cast<const bf16*>(p.a);
  const bf16* W = static_cast<const bf16*>(p.w);

  // Each thread copies two 16-byte vectors of A and two of W per stage.
  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * A_TILE;
    bf16* bs = Bs + stage * B_TILE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;
      const int r = c / 4, kc = (c % 4) * 8;  // 128 rows x 4 vectors
      const bool ok = m0 + r < p.m && k0 + kc < p.k;
      cp_async16(as + r * AP + kc, ok ? A + (long long)(m0 + r) * p.lda + k0 + kc : A, ok);
      if (NK) {  // 128 n x 4 vectors along k
        const bool okw = n0 + r < p.n && k0 + kc < p.k;
        cp_async16(bs + r * AP + kc,
                   okw ? W + (long long)(n0 + r) * p.ldw + k0 + kc : W, okw);
      } else {  // 32 k x 16 vectors along n
        const int kr = c / 16, nc = (c % 16) * 8;
        const bool okw = k0 + kr < p.k && n0 + nc < p.n;
        cp_async16(bs + kr * BP + nc,
                   okw ? W + (long long)(k0 + kr) * p.ldw + n0 + nc : W, okw);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (p.k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed (for this thread) ...
    __syncthreads();              // ... for all threads; tile t-1 is consumed
    if (t + STAGES - 1 < nk) load_stage((t + STAGES - 1) % STAGES, (t + STAGES - 1) * BK);
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
        if (NK)
          ldmatrix_x4(r, bs + (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * AP +
                             kk + ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * BP + wn * 32 + np * 16 +
                                   (lane >> 4) * 8);
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
  const bf16* bias = static_cast<const bf16*>(p.bias);
  const bf16* res = static_cast<const bf16*>(p.res);
  bf16* C = static_cast<bf16*>(p.c);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + q * 2;
    if (col >= p.n) continue;
    float2 bv = make_float2(0.f, 0.f);
    if (bias) bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + g + h * 8;
        if (row >= p.m) continue;
        float2 rv = make_float2(0.f, 0.f);
        if (res)
          rv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + (long long)row * p.ldr + col));
        *reinterpret_cast<__nv_bfloat162*>(C + (long long)row * p.ldc + col) =
            __floats2bfloat162_rn(epilogue(p, acc[mt][nt][2 * h], bv.x, rv.x),
                                  epilogue(p, acc[mt][nt][2 * h + 1], bv.y, rv.y));
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int HF_M = 64, HF_N = 64, HF_K = 16;

template <bool NK>
__global__ void __launch_bounds__(256) gemm_f32_kernel(GemmArgs p) {
  __shared__ float As[HF_K][HF_M + 4];
  __shared__ float Bs[HF_K][HF_N + 4];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * HF_M, n0 = blockIdx.x * HF_N;
  const float* A = static_cast<const float*>(p.a);
  const float* W = static_cast<const float*>(p.w);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.k; k0 += HF_K) {
    for (int idx = tid; idx < HF_M * HF_K; idx += 256) {
      const int r = idx / HF_K, c = idx % HF_K;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = gm < p.m && gk < p.k ? A[(long long)gm * p.lda + gk] : 0.f;
    }
    for (int idx = tid; idx < HF_N * HF_K; idx += 256) {
      // NK: consecutive threads walk k along a W row; KN: n along a W row
      const int n = NK ? idx / HF_K : idx % HF_N;
      const int c = NK ? idx % HF_K : idx / HF_N;
      const int gn = n0 + n, gk = k0 + c;
      float v = 0.f;
      if (gn < p.n && gk < p.k)
        v = NK ? W[(long long)gn * p.ldw + gk] : W[(long long)gk * p.ldw + gn];
      Bs[c][n] = v;
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

  const float* bias = static_cast<const float*>(p.bias);
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
      C[(long long)gm * p.ldc + gn] =
          epilogue(p, acc[i][j], bias ? bias[gn] : 0.f,
                   res ? res[(long long)gm * p.ldr + gn] : 0.f);
    }
  }
}

template <bool NK>
int launch_bf16(const GemmArgs& p, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_bf16_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  gemm_bf16_kernel<NK><<<grid, 256, GEMM_SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ln_g / ln_b non-null: A is first normalised into ln_out ((M, K),
// contiguous scratch of the storage type), which the GEMM then reads.
extern "C" int yt_gemm(int dtype, const void* a, long long lda, const void* w,
                       long long ldw, int w_nk, const void* bias,
                       const void* res, long long ldr, void* c, long long ldc,
                       int m, int n, int k, const void* ln_g, const void* ln_b,
                       float eps, int gelu, void* ln_out, void* stream) {
  GemmArgs p{a, lda, w, ldw, bias, res, ldr, c, ldc, m, n, k, gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = ln_g != nullptr;
  if (m <= 0 || n <= 0 || k <= 0 || (ln && (!ln_b || !ln_out)))
    return (int)cudaErrorInvalidValue;
  if (dtype == YT_BF16 &&
      (k % 8 || n % 8 || lda % 8 || ldw % 8 || ldc % 8 || (res && ldr % 8)))
    return (int)cudaErrorInvalidValue;
  if (dtype != YT_BF16 && dtype != YT_F32) return (int)cudaErrorInvalidValue;
  if (ln) {
    LnArgs q{a, lda, ln_g, ln_b, ln_out, m, k, eps};
    const int blocks = (m + 7) / 8;
    if (dtype == YT_BF16) layer_norm_kernel<bf16><<<blocks, 256, 0, s>>>(q);
    else layer_norm_kernel<float><<<blocks, 256, 0, s>>>(q);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    p.a = ln_out;
    p.lda = k;
  }
  if (dtype == YT_BF16) return w_nk ? launch_bf16<true>(p, s) : launch_bf16<false>(p, s);
  dim3 grid((n + HF_N - 1) / HF_N, (m + HF_M - 1) / HF_M);
  if (w_nk) gemm_f32_kernel<true><<<grid, 256, 0, s>>>(p);
  else gemm_f32_kernel<false><<<grid, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* yt_error_string(int code) {
  if (code == YT_ERR_ROUTE) return "route not built for these arguments";
  if (code == YT_ERR_TENSOR_MAP) return "TMA tensor map encode failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

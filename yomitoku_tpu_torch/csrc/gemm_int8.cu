// W8A8 pieces: a row-quantize pass (optional LayerNorm prologue) and an
// int8 tensor-core GEMM whose epilogue dequantizes with row and column
// scales:
//
//   quantize:  v = LN?(x) row by row (f32);  per row, or per row and
//              K-chunk: s = max(max|v|, 1e-6) / 127, q = clip(rint(v / s))
//   GEMM:      C = epilogue(sum_c (A_c . W_c)_i32 * s_row[c] * s_col + bias)
//              A (M, K) int8, W (K, N) int8 stored n-major (W[n * ldw + k]),
//              one int32 partial sum per K-chunk, folded into f32 with
//              that chunk's row scale; epilogue: + bias, erf-GELU?, + res?
//
// Replaces the int8 matrix products inside two TPU kernels:
//   * yomitoku_tpu/ops/pallas/fused_mlp.py: fused_mlp_ln_int8 (LN -> quant
//     rows -> int8 fc1 -> GELU -> quant rows per hidden chunk -> int8 fc2,
//     chunk by chunk into an f32 accumulator -> + x), and
//   * yomitoku_tpu/ops/pallas/flash_attention.py: fused_attention_block_ln_int8
//     (LN -> quant rows -> int8 QKV; the f32 attention output -> quant rows
//     -> int8 out-projection -> + x), whose attention runs in attention.cu.
// ops/mlp.py and ops/attention.py chain these kernels.
//
// What bounds it on the H100: at the recognizer's shapes (M = 51,200 rows,
// K = 768 or 3072, N = 768 to 3072) each product does ~1,200 int8 operations
// per byte it must move, above the card's ~590 OP/byte int8 ridge: the
// tensor cores bound it.  The TPU kernels kept the hidden activation, its
// GELU and its quantization in VMEM; an SM cannot hold a 512-row x 1024
// chunk, so here:
//   * the GEMM is the bf16 GEMM of gemm.cu in bytes: 128x128 block tiles
//     of 64 int8 along K, 8 warps of 64x32, mma.sync m16n8k32 s8 (int32
//     accumulators in registers) fed by ldmatrix from padded rows (80-byte
//     pitch: the 8 rows of an ldmatrix hit 8 distinct 16-byte bank groups),
//     a 4-stage cp.async ring.  int8 fragments of m16n8k32 are the bf16
//     fragments of m16n8k16 byte for byte, so the loads are the same;
//   * the per-chunk row scales fold the int32 sums into f32 accumulators at
//     each chunk's end (the Pallas kernel's f32 accumulator across its
//     hidden-chunk grid axis);
//   * the GELU output makes one f32 round trip through device memory (fc1
//     writes it, the quantize pass reads it): 51,200 x 3,072 x 4 B = 629 MB
//     each way per encoder block at batch 128 (~0.19 ms each way at
//     3.35 TB/s), because its quantization needs the max over a 1024-wide
//     chunk of a row, which spans eight of this GEMM's column tiles.
// Quantization follows the Pallas kernels' arithmetic: f32 LN statistics
// with var = max(E[x^2] - mean^2, 0), 1 / sqrt (not the approximate rsqrt),
// no fused multiply-adds where the JAX code rounds each operation, IEEE
// division, round half to even.  Not yet: wgmma, TMA, the hidden chunk kept
// on chip (later changes).
#include <stdint.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------ quantize rows

struct QuantArgs {
  const void* x;  // (M, K) with row stride ldx
  long long ldx;
  const float* g;  // LayerNorm scale and shift (K,), or null: no LN
  const float* b;
  float eps;
  int8_t* q;  // (M, K), contiguous
  float* s;   // (M, K / chunk), contiguous
  int m, k, chunk;
};

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ signed char quant(float v, float s) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// One warp per row: LN statistics in one pass (if LN), then per chunk the
// max of |v| and the codes; v is recomputed from x in each pass (the row
// stays in L1/L2).  Lanes take 4 consecutive elements (K, chunk % 4 == 0).
template <typename T>
__global__ void __launch_bounds__(256) quantize_rows_kernel(QuantArgs p) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= p.m) return;
  const T* x = static_cast<const T*>(p.x) + (long long)row * p.ldx;
  const bool ln = p.g != nullptr;
  float mean = 0.f, rs = 1.f;
  if (ln) {
    float s = 0.f, ss = 0.f;
    for (int k = lane * 4; k < p.k; k += 128) {
      float v[4];
      load4(x + k, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    mean = s / p.k;
    const float var = fmaxf(__fsub_rn(ss / p.k, __fmul_rn(mean, mean)), 0.f);
    rs = 1.f / sqrtf(__fadd_rn(var, p.eps));
  }
  auto values = [&](int k, float* v) {
    load4(x + k, v);
    if (ln) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[e], mean), rs), p.g[k + e]),
                         p.b[k + e]);
    }
  };
  const int nc = p.k / p.chunk;
  for (int c = 0; c < nc; ++c) {
    const int k0 = c * p.chunk, k1 = k0 + p.chunk;
    float amax = 0.f;
    for (int k = k0 + lane * 4; k < k1; k += 128) {
      float v[4];
      values(k, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = warp_max(amax);
    const float sc = __fmul_rn(fmaxf(amax, 1e-6f), 1.f / 127.f);
    if (lane == 0) p.s[(long long)row * nc + c] = sc;
    for (int k = k0 + lane * 4; k < k1; k += 128) {
      float v[4];
      values(k, v);
      char4 o;
      o.x = quant(v[0], sc);
      o.y = quant(v[1], sc);
      o.z = quant(v[2], sc);
      o.w = quant(v[3], sc);
      *reinterpret_cast<char4*>(p.q + (long long)row * p.k + k) = o;
    }
  }
}

// ----------------------------------------------------------------- int8 GEMM

constexpr int QBM = 128, QBN = 128, QBK = 64, QSTAGES = 4;
constexpr int QP = QBK + 16;                   // row pitch in bytes (80)
constexpr int QTILE = QBM * QP;                // bytes of an A or a W tile
constexpr int QSMEM = QSTAGES * 2 * QTILE;     // 80 KB

struct Gemm8Args {
  const int8_t* a;  // (M, K), row stride lda
  long long lda;
  const int8_t* w;  // W element (k, n) at w[n * ldw + k]
  long long ldw;
  const float* sa;  // (M, nchunks) row scales
  const float* sw;  // (N,) column scales
  const float* bias;  // (N,) or null
  const void* res;    // (M, N) of the output type, row stride ldr, or null
  long long ldr;
  void* c;
  long long ldc;
  int m, n, k, kchunk, nchunks, gelu;
};

// c (16x8 s32) += a (16x32 s8, row) . b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TO>
__global__ void __launch_bounds__(256) gemm_int8_kernel(Gemm8Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* As = smem;                    // [QSTAGES][QBM][QP]
  unsigned char* Ws = smem + QSTAGES * QTILE;  // [QSTAGES][QBN][QP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * QBM, n0 = blockIdx.x * QBN;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 64 x 32 each
  const int g = lane / 4, q = lane % 4;

  // Each thread copies two 16-byte vectors of A and two of W per stage:
  // 128 rows x 4 vectors each (K % 16 == 0: no vector straddles K).
  auto load_stage = [&](int stage, int k0) {
    unsigned char* as = As + stage * QTILE;
    unsigned char* ws = Ws + stage * QTILE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;
      const int r = c / 4, kc = (c % 4) * 16;
      const bool ok = m0 + r < p.m && k0 + kc < p.k;
      cp_async16(as + r * QP + kc, ok ? p.a + (long long)(m0 + r) * p.lda + k0 + kc : p.a, ok);
      const bool okw = n0 + r < p.n && k0 + kc < p.k;
      cp_async16(ws + r * QP + kc, okw ? p.w + (long long)(n0 + r) * p.ldw + k0 + kc : p.w, okw);
    }
  };

  int iacc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[i][j][e] = 0;
        facc[i][j][e] = 0.f;
      }

  const int nk = (p.k + QBK - 1) / QBK;
#pragma unroll
  for (int s = 0; s < QSTAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * QBK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<QSTAGES - 2>();  // tile t has landed (for this thread) ...
    __syncthreads();               // ... for all threads; tile t-1 is consumed
    if (t + QSTAGES - 1 < nk) load_stage((t + QSTAGES - 1) % QSTAGES, (t + QSTAGES - 1) * QBK);
    cp_async_commit();  // possibly empty: keeps the group count in step

    const unsigned char* as = As + (t % QSTAGES) * QTILE;
    const unsigned char* ws = Ws + (t % QSTAGES) * QTILE;
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], as + (wm * 64 + mt * 16 + lane % 16) * QP + kk + (lane / 16) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // two n8 tiles per ldmatrix
        unsigned r[4];
        ldmatrix_x4(r, ws + (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * QP + kk +
                           ((lane >> 3) & 1) * 16);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(iacc[mt][nt], af[mt], bfr[nt]);
    }
    if ((t + 1) * QBK % p.kchunk == 0 || t == nk - 1) {
      // Fold the int32 sums of chunk c into f32: (i32 * s_row) * s_col,
      // then added, each rounded as in the Pallas kernels.
      const int c = t * QBK / p.kchunk;
      float sr[4][2], sc[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 64 + mt * 16 + g + h * 8;
          sr[mt][h] = row < p.m ? p.sa[(long long)row * p.nchunks + c] : 0.f;
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + nt * 8 + q * 2 + e;
          sc[nt][e] = col < p.n ? p.sw[col] : 0.f;
        }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = __fmul_rn(__fmul_rn((float)iacc[mt][nt][e], sr[mt][e >> 1]),
                                      sc[nt][e & 1]);
            facc[mt][nt][e] = __fadd_rn(facc[mt][nt][e], d);
            iacc[mt][nt][e] = 0;
          }
    }
  }
  cp_async_wait<0>();

  // Epilogue: lane (g, q) holds rows g and g + 8, columns 2q and 2q + 1 of
  // each 16x8 tile.
  const TO* res = static_cast<const TO*>(p.res);
  TO* C = static_cast<TO*>(p.c);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + q * 2;
    if (col >= p.n) continue;
    const float b0 = p.bias ? p.bias[col] : 0.f, b1 = p.bias ? p.bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + g + h * 8;
        if (row >= p.m) continue;
        float v0 = __fadd_rn(facc[mt][nt][2 * h], b0);
        float v1 = __fadd_rn(facc[mt][nt][2 * h + 1], b1);
        if (p.gelu) {
          v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
          v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
        }
        if (res) {
          const float2 rv = load2(res + (long long)row * p.ldr + col);
          v0 = __fadd_rn(rv.x, v0);
          v1 = __fadd_rn(rv.y, v1);
        }
        store2(C + (long long)row * p.ldc + col, v0, v1);
      }
    }
  }
}

template <typename TO>
int launch_gemm_int8(const Gemm8Args& p, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_int8_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, QSMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.n + QBN - 1) / QBN, (p.m + QBM - 1) / QBM);
  gemm_int8_kernel<TO><<<grid, 256, QSMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) of the storage type dtype, row stride ldx (% 4 == 0, 16-byte
// aligned rows for f32, 8-byte for bf16); g, b (K,) f32 or null (no LN);
// q (M, K) int8 and s (M, K / chunk) f32, contiguous.  K % chunk == 0,
// chunk % 4 == 0.
extern "C" int yt_quantize_rows(int dtype, const void* x, long long ldx,
                                const void* g, const void* b, float eps,
                                void* q, void* s, int m, int k, int chunk,
                                void* stream) {
  if (m <= 0 || k <= 0 || chunk <= 0 || k % chunk || chunk % 4 || ldx % 4 ||
      (g == nullptr) != (b == nullptr))
    return (int)cudaErrorInvalidValue;
  QuantArgs p{x, ldx, static_cast<const float*>(g), static_cast<const float*>(b),
              eps, static_cast<int8_t*>(q), static_cast<float*>(s), m, k, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (m + 7) / 8;
  if (dtype == YT_BF16) quantize_rows_kernel<bf16><<<blocks, 256, 0, st>>>(p);
  else if (dtype == YT_F32) quantize_rows_kernel<float><<<blocks, 256, 0, st>>>(p);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a (M, K) int8 with row stride lda; w: element (k, n) at w[n * ldw + k];
// sa (M, K / kchunk), sw (N,), bias (N,) or null, all f32; res (M, N) of the
// output type out_dtype, row stride ldr, or null; c (M, N), row stride ldc.
// K % 16 == 0, N % 8 == 0, lda and ldw % 16 == 0, ldc and ldr even; kchunk
// divides K and is K or a multiple of 64.
extern "C" int yt_gemm_int8(const void* a, long long lda, const void* w,
                            long long ldw, const void* sa, const void* sw,
                            const void* bias, const void* res, long long ldr,
                            void* c, long long ldc, int out_dtype, int m, int n,
                            int k, int kchunk, int gelu, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || kchunk <= 0 || k % kchunk ||
      (kchunk != k && kchunk % QBK) || k % 16 || n % 8 || lda % 16 || ldw % 16 ||
      ldc % 2 || (res && ldr % 2))
    return (int)cudaErrorInvalidValue;
  Gemm8Args p{static_cast<const int8_t*>(a), lda, static_cast<const int8_t*>(w), ldw,
              static_cast<const float*>(sa), static_cast<const float*>(sw),
              static_cast<const float*>(bias), res, ldr, c, ldc,
              m, n, k, kchunk, k / kchunk, gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == YT_BF16) return launch_gemm_int8<bf16>(p, s);
  if (out_dtype == YT_F32) return launch_gemm_int8<float>(p, s);
  return (int)cudaErrorInvalidValue;
}

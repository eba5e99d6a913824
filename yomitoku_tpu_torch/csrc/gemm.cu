// GEMM with an optional LayerNorm on A and a bias / exact-erf GELU /
// residual epilogue:
//
//   C = epilogue(LN?(A) . W + bias)      A (M, K), W (K, N), C (M, N)
//
// Replaces the matrix products inside four TPU kernels:
//   * yomitoku_tpu/ops/pallas/fused_mlp.py: fused_mlp (fc1 -> GELU -> fc2)
//     and fused_mlp_ln (x + fc2(GELU(fc1(LN(x))))), and
//   * yomitoku_tpu/ops/pallas/flash_attention.py: fused_attention_block_ln
//     (the LN -> packed QKV projection and the out-projection + residual)
//     and fused_attention_block (the same without LN or residual).
// ops/mlp.py and ops/attention.py chain these GEMMs with the attention
// kernel of attention.cu.
//
// What bounds it on the H100: at the recognizer's shapes (M = 51,200 rows,
// K = 768 or 3072, N = 768 to 3072, bf16) every product does ~600 FLOPs per
// byte of device memory it must move, above the card's ~295 FLOP/byte
// ridge: the tensor cores bound it (989 TFLOP/s dense bf16), not HBM.  The
// TPU kernels held a whole 512-row tile and the full weight chunk in VMEM
// and never wrote the (M, 4D) hidden activation.  An SM's 227 KB of shared
// memory cannot: a 128-row block of that activation is 786 KB, so it makes
// one bf16 round trip through HBM between fc1 and fc2 (fc1 writes it, fc2
// reads it: ~0.63 GB per encoder block at batch 128, ~0.19 ms at 3.35
// TB/s).
//
// bf16: Hopper's own parts (hopper.cuh), one persistent block per SM:
//   * one producer thread issues TMA 2-D tile loads of A and W, 64 k wide
//     (128 bytes, so the 128-byte swizzle), into a ring of stages guarded
//     by full / empty mbarriers; TMA's zero fill covers a ragged M, N or K
//     (K % 8 is still required: row strides are 16-byte multiples).  W comes
//     in either layout: a torch Linear weight (N, K) row-major is K-major
//     for wgmma's B; the JAX (K, N) row-major layout is MN-major (the
//     transpose bit), loaded as 64-column atoms;
//   * consumer warpgroups issue wgmma.mma_async m64nNk16 with both operands
//     in shared memory, f32 accumulators in registers; setmaxnreg moves the
//     producer warpgroup's registers to them;
//   * blocks walk the output tiles ("units") N-tile fastest, so the blocks
//     in flight share a few 128-row blocks of A (read about once from HBM)
//     and W (at most 4.7 MB) stays in the 50 MB L2;
//   * the epilogue runs on the accumulators, 64 x 64 at a time: bias (a
//     copy of the unit's slice, fetched by a bulk copy while the products
//     run), exact erff GELU and residual in f32, one rounding to bf16, then
//     through a swizzled staging buffer in shared memory to 16-byte
//     coalesced stores (each warp writes whole 128-byte rows); the residual
//     comes in the same way one sub-tile ahead.  GELU is a template
//     argument: with erff inlined for every accumulator behind a runtime
//     flag, the kernel was ~22k instructions and ran its epilogue out of
//     the instruction cache.  The products alone keep the tensor cores
//     busy; the epilogue is what the schedules below must hide, and the
//     GELU one (erff, ~30 instructions a value) is not hidden at fc1.
// Two schedules (routes, chosen in Python by ops/_common.py gemm_route):
//   "wgmma"       128 x 128 units; two consumer warpgroups take whole units
//                 in turns (named barriers, as attention.cu's warpgroups
//                 do), so one's epilogue runs under the other's products;
//   "wgmma_small" 64 x 128 units, one consumer warpgroup: grids that
//                 128-row units would leave under one wave.
// A cooperative schedule (128 x 256 units, two warpgroups sharing each)
// was measured beside "wgmma" and lost by 5-10% at the ViT's QKV and
// out-projection and came within 4% either way at fc1 and fc2, so it went.
// The C entry obeys the route or returns YT_ERR_ROUTE; nothing falls back.
//
// f32: a 64x64x16 shared-memory tile with 4x4 FMA micro-tiles per thread
// (full f32; tensor-core TF32 would lose the 1e-4 parity).
//
// LayerNorm: its own row pass (one warp per row, f32 statistics, variance
// max(E[x^2] - mean^2, 0) as in the Pallas kernels), writing LN(x) rounded
// to the storage type, as the Pallas kernels round it before their matmul;
// the GEMM then reads it like any A (TMA copies tiles untouched, so
// normalising in the load path would stage every tile through registers;
// the extra pass moves 2 x M x K x 2 bytes, ~0.16 GB, ~50 us at these
// shapes).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- bf16 path

constexpr int BK = 64;  // k per stage: one 128-byte swizzle span of bf16
constexpr int MAX_DEVICES = 64;

struct WgArgs {
  const bf16* bias;  // (N,) or null
  const bf16* res;   // (M, N) with row stride ldr, or null
  long long ldr;
  bf16* c;
  long long ldc;
  int m, n;
  int nk;     // k tiles of BK
  int ntn;    // n tiles of BN
  int units;  // m tiles x n tiles
};

// A schedule: units of BM x BN outputs; NWG consumer warpgroups that take
// whole units in turns; a ring of STAGES.  Each consumer warpgroup also
// owns two output sub-tiles of 64 x 64 (the epilogue's staging buffers)
// and a copy of its unit's bias slice.
constexpr int BN = 128;                // output columns of a unit: one m64n128 wgmma
constexpr int SUB = 64;                // rows and columns of an output sub-tile
constexpr int SUB_BYTES = SUB * 128;   // one sub-tile of bf16, 128-byte rows
template <int BM_, int NWG_, int STAGES_>
struct Sched {
  static constexpr int BM = BM_, NWG = NWG_, STAGES = STAGES_;
  static constexpr int MT = BM / 64;  // m64 sub-tiles of a unit
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + BN * BK * 2;
  static constexpr int C0 = STAGES * STAGE;                  // staging buffers
  static constexpr int BIAS0 = C0 + NWG * 2 * SUB_BYTES;     // bias slices
  static constexpr int ALLOC = BIAS0 + NWG * BN * 2 + 1024;  // + alignment slack
  static constexpr int THREADS = (NWG + 1) * 128;
};
using PingPong = Sched<128, 2, 6>;  // "wgmma"       (192 KB ring)
using Small = Sched<64, 1, 4>;      // "wgmma_small" (96 KB ring)

// Shared-memory stage: A [BM rows][64 k], then W: NK [BN rows][64 k], else
// BN / 64 atoms [64 k rows][64 n]; each row 128 bytes, 128-byte swizzled,
// every tile on a 1024-byte boundary (the swizzle period), as TMA and wgmma
// both swizzle by address.
template <class S, bool NK>
__device__ __forceinline__ void produce(const CUtensorMap* ta, const CUtensorMap* tw,
                                        const WgArgs& p, unsigned char* sm, uint64_t* full,
                                        uint64_t* empty) {
  tma_prefetch_map(ta);
  tma_prefetch_map(tw);
  int it = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int m0 = u / p.ntn * S::BM, n0 = u % p.ntn * BN;
    for (int kt = 0; kt < p.nk; ++kt, ++it) {
      const int s = it % S::STAGES, use = it / S::STAGES;
      if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
      unsigned char* a = sm + s * S::STAGE;
      unsigned char* b = a + S::A_BYTES;
      mbar_expect_tx(full + s, S::STAGE);
      tma_load_2d(a, ta, full + s, kt * BK, m0);
      if constexpr (NK) {
        tma_load_2d(b, tw, full + s, kt * BK, n0);
      } else {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b + j * (BK * 128), tw, full + s, n0 + j * 64, kt * BK);
      }
    }
  }
}

__device__ __forceinline__ float epilogue(float v, float bias, float res, int gelu) {
  v += bias;
  if (gelu) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v + res;
}

template <bool GELU>
__device__ __forceinline__ float epilogue(float v, float bias, float res) {
  return epilogue(v, bias, res, GELU);
}

// w: this consumer warpgroup, 0..NWG-1 (warp-uniform).
template <class S, bool NK, bool GELU>
__device__ __forceinline__ void consume(const WgArgs& p, unsigned char* sm, uint64_t* full,
                                        uint64_t* empty, uint64_t* bbar, int w) {
  constexpr int NA = BN / 2;          // accumulator floats per m64 sub-tile
  constexpr int TN = BN / SUB;        // output sub-tiles across a unit
  constexpr int NSUB = S::MT * TN;    // and in all
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;
  // Taking turns (named barriers 1 and 2, warpgroup 0 first): a warpgroup
  // issues a unit's products on its turn and passes the turn on before its
  // epilogue, so the tensor cores work through the other's products.
  const int nu = (p.units - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's units
  auto my_turn = [&]() {
    if constexpr (S::NWG == 2) named_bar_sync(1 + w, 256);
  };
  auto pass_turn = [&]() {
    if constexpr (S::NWG == 2) named_bar_arrive(2 - w, 256);
  };
  auto wg_sync = [&]() { named_bar_sync(3 + w, 128); };  // this warpgroup alone
  if (w == 1) pass_turn();
  unsigned char* cbuf = sm + S::C0 + w * 2 * SUB_BYTES;
  bf16* bias_s = reinterpret_cast<bf16*>(sm + S::BIAS0) + w * BN;
  bbar += w;
  int sub = 0;  // this warpgroup's output sub-tiles so far: staging buffer sub % 2
  int nb = 0;   // its bias copies so far
  float acc[S::MT][NA];
  for (int i = w; i < nu; i += S::NWG) {
    const int u = blockIdx.x + i * gridDim.x;
    const int m0 = u / p.ntn * S::BM, n0 = u % p.ntn * BN;
    if (p.bias && leader) {  // the unit's bias slice lands while the products run
      const uint32_t bytes = min(BN, p.n - n0) * 2;
      mbar_expect_tx(bbar, bytes);
      bulk_load(bias_s, p.bias + n0, bytes, bbar);
    }
    auto valid = [&](int t) { return m0 + t / TN * 64 < p.m && n0 + t % TN * SUB < p.n; };
    // this thread's chunks: rows crow + 16 c, 16-byte column chunk cchunk
    const int crow = (threadIdx.x % 128) / 8, cchunk = threadIdx.x % 8;
    uint4 rres[SUB / 16];
    auto load_res = [&](int t) {
      const int r0 = m0 + t / TN * 64, col = n0 + t % TN * SUB + cchunk * 8;
#pragma unroll
      for (int c = 0; c < SUB / 16; ++c) {
        const int row = r0 + crow + 16 * c;
        rres[c] = row < p.m && col < p.n
                      ? __ldg(reinterpret_cast<const uint4*>(p.res + row * p.ldr + col))
                      : make_uint4(0, 0, 0, 0);
      }
    };
    if (p.res && valid(0)) load_res(0);  // in flight during the products
    int it = i * p.nk;
    my_turn();
    for (int kt = 0; kt < p.nk; ++kt, ++it) {
      const int s = it % S::STAGES;
      mbar_wait(full + s, (it / S::STAGES) & 1);
      const unsigned char* a = sm + s * S::STAGE;
      const unsigned char* b = sm + s * S::STAGE + S::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major W: step 32 bytes along each row; MN-major: 16 rows down,
        // the next 64-column atom BK * 128 bytes on (LBO)
        const uint64_t db = NK ? wgmma_desc(b + kk * 32, 16, 1024, 1)
                               : wgmma_desc(b + kk * 16 * 128, BK * 128, 1024, 1);
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt)
          wgmma_ss_n128<NK ? 0 : 1>(acc[mt], wgmma_desc(a + mt * 64 * 128 + kk * 32, 16, 1024, 1),
                                    db, kt > 0 || kk > 0);
      }
      wgmma_commit();
      if (kt > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % S::STAGES);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int e = 0; e < NA; ++e) fence_operand(acc[mt][e]);
    if (lane == 0) mbar_arrive(empty + (it - 1) % S::STAGES);
    if (i + 1 < nu) pass_turn();

    // Epilogue, one 64 x 64 output sub-tile at a time, through a staging
    // buffer in shared memory (128-byte rows, 16-byte chunks swizzled by
    // row % 8: conflict-free both ways): bias (from the copied slice), GELU
    // and residual in f32 on the accumulators, one rounding to bf16, then
    // 16-byte coalesced stores, each warp writing whole 128-byte rows.  The
    // residual is read the same way one sub-tile ahead.  Sub-tiles wholly
    // past M or N are skipped, chunks past them masked.
    if (p.bias) mbar_wait(bbar, nb++ & 1);
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int t = 0; t < NSUB; ++t) {
      if (!valid(t)) continue;  // warpgroup-uniform
      const int mt = t / TN, tn = t % TN;
      unsigned char* cb = cbuf + (sub & 1) * SUB_BYTES;
      float v[SUB / 2];  // this sub-tile's accumulators: 4 j + {0, 1} row g, + {2, 3} row g + 8
#pragma unroll
      for (int e = 0; e < SUB / 2; ++e) v[e] = acc[mt][tn * (SUB / 2) + e];
      if (p.res) {  // the residual into the staging buffer
#pragma unroll
        for (int c = 0; c < SUB / 16; ++c) {
          const int r = crow + 16 * c;
          *reinterpret_cast<uint4*>(cb + r * 128 + ((cchunk ^ (r & 7)) << 4)) = rres[c];
        }
      }
      wg_sync();  // the buffer's previous readers are done; the residual is in
      int t2 = t + 1;  // the next sub-tile's residual, in flight meanwhile
      while (t2 < NSUB && !valid(t2)) ++t2;
      if (p.res && t2 < NSUB) load_res(t2);
      // bias and GELU on every value first (32 independent chains), then
      // the residual reads, then the stores: a read-modify-write per pair
      // would order each pair's shared-memory load after the last store
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j) {
        float2 bv = make_float2(0.f, 0.f);
        if (p.bias)
          bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias_s + tn * SUB + 8 * j + 2 * q));
#pragma unroll
        for (int e = 0; e < 4; ++e) v[4 * j + e] = epilogue<GELU>(v[4 * j + e], e & 1 ? bv.y : bv.x, 0.f);
      }
      // row r = 16 warp + g + 8 h of the sub-tile, chunk j swizzled by r % 8 = g
      auto pair = [&](int j, int h) {
        return reinterpret_cast<__nv_bfloat162*>(cb + (warp * 16 + g + 8 * h) * 128 + ((j ^ g) << 4) +
                                                 q * 4);
      };
      if (p.res) {
#pragma unroll
        for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 rv = __bfloat1622float2(*pair(j, h));
            v[4 * j + 2 * h] += rv.x;
            v[4 * j + 2 * h + 1] += rv.y;
          }
      }
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *pair(j, h) = __floats2bfloat162_rn(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
      wg_sync();
      const int r0 = m0 + mt * 64, col = n0 + tn * SUB + cchunk * 8;
#pragma unroll
      for (int c = 0; c < SUB / 16; ++c) {
        const int r = crow + 16 * c;
        if (r0 + r < p.m && col < p.n)
          *reinterpret_cast<uint4*>(p.c + (r0 + r) * p.ldc + col) =
              *reinterpret_cast<const uint4*>(cb + r * 128 + ((cchunk ^ (r & 7)) << 4));
      }
      ++sub;
    }
  }
}

// Warpgroup 0 is the producer (one thread issues every TMA load), warpgroups
// 1..NWG the consumers.  The roles part once and never meet again, so
// setmaxnreg can hand the producer's registers to the consumers.
template <class S, bool NK, bool GELU>
__global__ void __launch_bounds__(S::THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tw, const WgArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S::STAGES + S::NWG];
  uint64_t *full = bars, *empty = bars + S::STAGES, *bbar = bars + 2 * S::STAGES;
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // lane 0 of each warp of the consuming warpgroup
    }
    for (int i = 0; i < S::NWG; ++i) mbar_init(bbar + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // broadcast from lane 0: the compiler then knows the role is warp-uniform
  // and keeps the wgmmas of the consumer branch asynchronous
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    if constexpr (S::NWG == 2) warpgroup_reg_dealloc<40>();
    if (threadIdx.x == 0) produce<S, NK>(&ta, &tw, p, sm, full, empty);
  } else {
    if constexpr (S::NWG == 2) warpgroup_reg_alloc<232>();
    consume<S, NK, GELU>(p, sm, full, empty, bbar, wg - 1);
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
          epilogue(acc[i][j], bias ? bias[gn] : 0.f,
                   res ? res[(long long)gm * p.ldr + gn] : 0.f, p.gelu);
    }
  }
}

template <class S, bool NK, bool GELU>
int launch_wgmma(const GemmArgs& g, cudaStream_t s) {
  CUtensorMap ta, tw;
  constexpr CUtensorMapDataType T = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = make_map_2d(&ta, T, 2, g.a, g.k, g.m, g.lda, BK, S::BM);
  if (!rc)
    rc = NK ? make_map_2d(&tw, T, 2, g.w, g.k, g.n, g.ldw, BK, BN)
            : make_map_2d(&tw, T, 2, g.w, g.n, g.k, g.ldw, 64, BK);
  if (rc) return rc;
  WgArgs p{};
  p.bias = static_cast<const bf16*>(g.bias);
  p.res = static_cast<const bf16*>(g.res);
  p.ldr = g.ldr;
  p.c = static_cast<bf16*>(g.c);
  p.ldc = g.ldc;
  p.m = g.m;
  p.n = g.n;
  p.nk = (g.k + BK - 1) / BK;
  p.ntn = (g.n + BN - 1) / BN;
  p.units = (g.m + S::BM - 1) / S::BM * p.ntn;

  auto kern = gemm_wgmma_kernel<S, NK, GELU>;
  // per device, once: the shared-memory attribute, SMs, blocks per SM
  static int per_sm[MAX_DEVICES] = {}, sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!per_sm[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kern, S::THREADS, S::ALLOC);
    if (e != cudaSuccess) return (int)e;
    if (per_sm[dev] < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  const int slots = sms[dev] * per_sm[dev];
  const int grid = p.units < slots ? p.units : slots;
  kern<<<grid, S::THREADS, S::ALLOC, s>>>(ta, tw, p);
  return (int)cudaGetLastError();
}

template <class S>
int route_wgmma(const GemmArgs& g, int w_nk, cudaStream_t s) {
  if (g.gelu) return w_nk ? launch_wgmma<S, true, true>(g, s) : launch_wgmma<S, false, true>(g, s);
  return w_nk ? launch_wgmma<S, true, false>(g, s) : launch_wgmma<S, false, false>(g, s);
}

bool tma_ok(const GemmArgs& p) {
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  return aligned(p.a) && aligned(p.w) && aligned(p.c) && (!p.res || aligned(p.res)) &&
         (!p.bias || aligned(p.bias)) && p.k % 8 == 0 && p.n % 8 == 0 &&
         (p.lda | p.ldw | p.ldc | (p.res ? p.ldr : 0)) % 8 == 0;
}

}  // namespace

// Routes (ops/_common.py GEMM_ROUTES): 0 "fma", the f32 kernel; 1 "wgmma",
// 2 "wgmma_small" (bf16; see the note at the top).
// ln_g / ln_b non-null: A is first normalised into ln_out ((M, K),
// contiguous scratch of the storage type), which the GEMM then reads.
extern "C" int yt_gemm(int route, int dtype, const void* a, long long lda, const void* w,
                       long long ldw, int w_nk, const void* bias, const void* res,
                       long long ldr, void* c, long long ldc, int m, int n, int k,
                       const void* ln_g, const void* ln_b, float eps, int gelu, void* ln_out,
                       void* stream) {
  GemmArgs p{a, lda, w, ldw, bias, res, ldr, c, ldc, m, n, k, gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = ln_g != nullptr;
  if (m <= 0 || n <= 0 || k <= 0 || (ln && (!ln_b || !ln_out)))
    return (int)cudaErrorInvalidValue;
  if (dtype != YT_BF16 && dtype != YT_F32) return (int)cudaErrorInvalidValue;
  if ((route == 0) != (dtype == YT_F32) || route < 0 || route > 2) return YT_ERR_ROUTE;
  if (ln) {
    p.a = ln_out;
    p.lda = k;
  }
  if (dtype == YT_BF16 && !tma_ok(p)) return YT_ERR_ROUTE;
  if (ln) {
    LnArgs q{a, lda, ln_g, ln_b, ln_out, m, k, eps};
    const int blocks = (m + 7) / 8;
    if (dtype == YT_BF16) layer_norm_kernel<bf16><<<blocks, 256, 0, s>>>(q);
    else layer_norm_kernel<float><<<blocks, 256, 0, s>>>(q);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (route == 1) return route_wgmma<PingPong>(p, w_nk, s);
  if (route == 2) return route_wgmma<Small>(p, w_nk, s);
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

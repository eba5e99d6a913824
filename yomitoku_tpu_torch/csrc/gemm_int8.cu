// W8A8 pieces: a row-quantize pass (optional LayerNorm prologue) and an
// int8 tensor-core GEMM whose epilogue dequantizes with row and column
// scales:
//
//   quantize:  v = LN?(x) row by row (f32);  per row, or per row and
//              K-chunk: s = max(max|v|, 1e-6) / 127, q = clip(rint(v / s))
//   GEMM:      C = epilogue(sum_c (A_c . W_c)_i32 * s_row[c] * s_col + bias)
//              A (M, K) int8, W (K, N) int8 stored n-major (W[n * ldw + k]),
//              one exact int32 partial sum per K-chunk, folded into f32
//              with that chunk's row scale; epilogue: + bias, erf-GELU?,
//              + res?, one rounding to the output type (f32 or bf16)
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
// K = 768 or 3072, N = 768 to 3072) the QKV and fc2 products are bound by
// the int8 tensor cores (1,979 TOP/s dense); the out-projection (N = 768,
// bf16 residual in and out) and fc1 (its (M, 3072) f32 GELU output, 629 MB
// per call) by HBM's 3.35 TB/s.  The TPU kernels kept the hidden
// activation, its GELU and its quantization in VMEM; an SM cannot hold a
// 512-row x 1024 chunk, so the GELU output makes one f32 round trip
// through device memory (fc1 writes it, the quantize pass reads it),
// because its quantization needs the max over a 1024-wide chunk of a row,
// which spans eight of this GEMM's column tiles.
//
// The GEMM is gemm.cu's design on int8 operands (hopper.cuh), one
// persistent block per SM:
//   * one producer thread issues TMA 2-D tile loads of A and W, 128 int8
//     along K (128 bytes, the 128-byte swizzle), into a ring of stages
//     guarded by full / empty mbarriers; TMA's zero fill covers a ragged M,
//     N or K (K % 16: row strides are 16-byte multiples);
//   * two consumer warpgroups issue wgmma.mma_async m64n128k32.s32.s8.s8,
//     both operands in shared memory and K-major (integer wgmma has no
//     transpose bit: W is read as rows of (N, K)), each k32 step 32 bytes
//     on along the swizzled rows, exact int32 sums in registers;
//     setmaxnreg moves the producer warpgroup's registers to them;
//   * blocks walk the units N-tile fastest: the blocks in flight share a
//     few row blocks of A, and W stays in the 50 MB L2;
//   * a K-chunked product keeps the f32 fold of its finished chunks in
//     registers beside the int32 sums of the current chunk, and at each
//     chunk's end waits for its wgmmas, folds (i32 * s_row[c]) * s_col
//     into f32 and starts the next chunk's sums from zero (wgmma's
//     scale-d).  Chunks are whole k tiles (a multiple of 128) or all of K;
//   * the epilogue runs on the sums in rounds of 64-row x 128-byte
//     sub-tiles (64 bf16 or 32 f32 columns): f32(acc) * s_row * s_col (or
//     the fold), + bias, erff GELU (a template argument: see gemm.cu), +
//     residual, one rounding, through swizzled staging buffers in shared
//     memory to 16-byte coalesced stores, each warp writing whole 128-byte
//     rows; the residual comes in the same way one round ahead, the unit's
//     column scales and bias by a bulk copy while the products run.
// Three schedules (routes, chosen in Python by ops/_common.py
// gemm_int8_route):
//   "wgmma"      128 x 128 units, K in one chunk, the two warpgroups taking
//                whole units in turns (named barriers), so one's epilogue
//                runs under the other's products; 2 x m64n128 int32 sums,
//                128 registers a thread (with the f32 fold, 256: too many);
//   "wgmma_coop" 128 x 128 units shared by the two warpgroups, 64 rows
//                each (64 + 64 registers with the fold): K-chunked
//                products (a W tile feeds 128 rows, half the L2 traffic of
//                64-row units, which bound fc2 there) and GELU epilogues
//                (erff, ~50 instructions a value, outlasts the products:
//                both warpgroups run it at once instead of in turns);
//   "wgmma_m64"  64 x 128 units taken in turns, any K-chunks: grids that
//                128-row units would leave under one wave.
// Taking turns goes chunk by chunk, so a warpgroup folds one chunk under
// the other's products, and a warpgroup passes the turn on as soon as it
// has issued its products.  The C entry obeys the route or returns
// YT_ERR_ROUTE; nothing falls back.
//
// Quantization follows the Pallas kernels' arithmetic: f32 LN statistics
// with var = max(E[x^2] - mean^2, 0), 1 / sqrt (not the approximate rsqrt),
// no fused multiply-adds where the JAX code rounds each operation, IEEE
// division, round half to even.  The GEMM's epilogue rounds each step as
// the plain version does (__fmul_rn / __fadd_rn: no contraction).  Not
// yet: the hidden chunk kept on chip (a later change).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

constexpr int QBK = 128;                // k per stage: one 128-byte swizzle span of int8
constexpr int QBN = 128;                // output columns of a unit: one m64n128 wgmma
constexpr int SUB_BYTES = 64 * 128;     // a staging sub-tile: 64 rows of 128 bytes
constexpr int MAX_DEVICES = 64;

struct Gemm8Args {
  const int8_t* a;  // (M, K), row stride lda
  long long lda;
  const int8_t* w;  // W element (k, n) at w[n * ldw + k]
  long long ldw;
  const float* sa;    // (M, nchunks) row scales
  const float* sw;    // (N,) column scales
  const float* bias;  // (N,) or null
  const void* res;    // (M, N) of the output type, row stride ldr, or null
  long long ldr;
  void* c;
  long long ldc;
  int m, n, k, kchunk, nchunks;
};

struct Wg8Args {
  const float* sa;
  const float* sw;
  const float* bias;
  const void* res;
  long long ldr;
  void* c;
  long long ldc;
  int m, n;
  int nk;       // k tiles of QBK
  int ktc;      // k tiles of a K-chunk (nk when K is one chunk)
  int nchunks;  // K-chunks (row scales per row)
  int ntn;      // n tiles of QBN
  int units;    // m tiles x n tiles
};

// A schedule: units of BM x QBN outputs; a ring of STAGES; FOLD: the f32
// fold of K-chunks in registers; COOP: the two consumer warpgroups share
// each unit, BM / 2 rows each, else they take whole units in turns.  Each
// consumer warpgroup also owns two staging sub-tiles and its unit's column
// scales and bias (f32).
template <int BM_, int STAGES_, bool FOLD_, bool COOP_>
struct Sched8 {
  static constexpr int BM = BM_, STAGES = STAGES_, NWG = 2;
  static constexpr bool FOLD = FOLD_, COOP = COOP_;
  static constexpr int WM = COOP ? BM / NWG : BM;  // rows of a unit a warpgroup owns
  static constexpr int MT = WM / 64;              // its m64 sub-tiles
  static constexpr int G = COOP ? 1 : NWG;        // units a group of turns holds
  static constexpr int A_BYTES = BM * QBK;
  static constexpr int STAGE = A_BYTES + QBN * QBK;
  static constexpr int C0 = STAGES * STAGE;                      // staging buffers
  static constexpr int VEC0 = C0 + NWG * 2 * SUB_BYTES;          // scales and bias
  static constexpr int ALLOC = VEC0 + NWG * 2 * QBN * 4 + 1024;  // + alignment slack
  static constexpr int THREADS = (NWG + 1) * 128;
};
using Wide = Sched8<128, 5, false, false>;  // "wgmma"      (160 KB ring)
using Narrow = Sched8<64, 7, true, false>;  // "wgmma_m64"  (168 KB ring)
using Coop = Sched8<128, 5, true, true>;    // "wgmma_coop" (160 KB ring)

// Shared-memory stage: A [BM rows][128 k], then W [QBN rows][128 k]; each
// row 128 bytes, 128-byte swizzled, every tile on a 1024-byte boundary.
// Tiles are loaded in the consumers' turn order (see consume8): a group of
// NWG units chunk by chunk, 0.0, 1.0, 0.1, 1.1, ... for two warpgroups.
template <class S>
__device__ __forceinline__ void produce8(const CUtensorMap* ta, const CUtensorMap* tw,
                                         const Wg8Args& p, unsigned char* sm, uint64_t* full,
                                         uint64_t* empty) {
  tma_prefetch_map(ta);
  tma_prefetch_map(tw);
  const int nu = (p.units - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's units
  int it = 0;
  for (int i0 = 0; i0 < nu; i0 += S::G) {
    const int gs = min(S::G, nu - i0);  // units in this group
    for (int c = 0; c < p.nchunks; ++c)
      for (int i = i0; i < i0 + gs; ++i) {
        const int u = blockIdx.x + i * gridDim.x;
        const int m0 = u / p.ntn * S::BM, n0 = u % p.ntn * QBN;
        for (int kt = c * p.ktc; kt < min(p.nk, (c + 1) * p.ktc); ++kt, ++it) {
          const int s = it % S::STAGES, use = it / S::STAGES;
          if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
          unsigned char* a = sm + s * S::STAGE;
          mbar_expect_tx(full + s, S::STAGE);
          tma_load_2d(a, ta, full + s, kt * QBK, m0);
          tma_load_2d(a + S::A_BYTES, tw, full + s, kt * QBK, n0);
        }
      }
  }
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

// (i32 * s_row) * s_col, each product rounded (the plain version's order)
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn((float)acc, s_row), s_col);
}

// w: this consumer warpgroup, 0..NWG-1 (warp-uniform).
template <class S, typename TO, bool GELU>
__device__ __forceinline__ void consume8(const Wg8Args& p, unsigned char* sm, uint64_t* full,
                                         uint64_t* empty, uint64_t* vbar, int w) {
  constexpr int NA = QBN / 2;                     // sums a thread holds per m64 sub-tile
  constexpr int SUBC = 128 / (int)sizeof(TO);     // output columns of a staging sub-tile
  constexpr int TN = QBN / SUBC;                  // staging sub-tiles across a unit
  constexpr int NSUB = S::MT * TN;                // and in all
  constexpr int JS = SUBC / 8;                    // 8-column groups of a sub-tile
  constexpr int CE = 16 / (int)sizeof(TO);        // elements of a 16-byte chunk
  constexpr int R = GELU && sizeof(TO) == 4 ? 2 : 1;  // sub-tiles an epilogue round
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  // Taking turns (not on "wgmma_coop", whose warpgroups share each unit;
  // named barrier 1 + x: warpgroup x's turn): a turn is one K-chunk of a
  // unit (the whole K on "wgmma").  Warpgroup w takes this
  // block's units w, w + NWG, ...; a group of NWG units goes chunk by
  // chunk, 0.0, 1.0, 0.1, 1.1, ..., then 2.0, 3.0, ... for two
  // warpgroups; the last group may hold fewer units, and a unit alone
  // runs its chunks without waiting.  A warpgroup passes the turn on as
  // soon as it has issued a chunk's products, before it waits for them, so
  // the next one's products queue behind them while it folds the chunk or
  // runs its epilogue.
  const int nu = (p.units - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's units
  auto my_turn = [&]() { named_bar_sync(1 + w, 256); };
  auto pass_turn = [&](int x) { named_bar_arrive(1 + x, 256); };
  auto wg_sync = [&]() { named_bar_sync(1 + S::NWG + w, 128); };  // this warpgroup alone
  unsigned char* cbuf = sm + S::C0 + w * 2 * SUB_BYTES;
  float* sw_s = reinterpret_cast<float*>(sm + S::VEC0) + w * 2 * QBN;
  float* bias_s = sw_s + QBN;
  vbar += w;
  const TO* res = static_cast<const TO*>(p.res);
  TO* out = static_cast<TO*>(p.c);
  int sub = 0;  // this warpgroup's output sub-tiles so far: staging buffer sub % 2
  int nv = 0;   // its vector copies so far
  int acc[S::MT][NA];
  float facc[S::FOLD ? S::MT : 1][S::FOLD ? NA : 1];  // the fold of finished chunks
  float sr[S::MT][2];  // row scales of this thread's rows g and g + 8, current chunk
  const int j = S::COOP ? 0 : w;  // this warpgroup's place in a group of units
  for (int i = j; i < nu; i += S::G) {
    const int u = blockIdx.x + i * gridDim.x;
    const int m0 = u / p.ntn * S::BM + (S::COOP ? w * S::WM : 0), n0 = u % p.ntn * QBN;
    if (leader) {  // the unit's column scales and bias land while the products run
      const uint32_t bytes = min(QBN, p.n - n0) * 4;
      mbar_expect_tx(vbar, p.bias ? 2 * bytes : bytes);
      bulk_load(sw_s, p.sw + n0, bytes, vbar);
      if (p.bias) bulk_load(bias_s, p.bias + n0, bytes, vbar);
    }
    bool vec_ready = false;
    auto wait_vec = [&]() {
      if (!vec_ready) mbar_wait(vbar, nv++ & 1);
      vec_ready = true;
    };
    auto row_scales = [&](int c) {
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + mt * 64 + warp * 16 + g + 8 * h;
          sr[mt][h] = row < p.m ? __ldg(p.sa + (long long)row * p.nchunks + c) : 0.f;
        }
    };
    auto valid = [&](int t) { return m0 + t / TN * 64 < p.m && n0 + t % TN * SUBC < p.n; };
    // this thread's chunks: rows crow + 16 c, 16-byte column chunk cchunk
    const int crow = (threadIdx.x % 128) / 8, cchunk = threadIdx.x % 8;
    uint4 rres[4 * R];
    auto load_res = [&](int t0) {  // the round of sub-tiles t0 ..
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int r0 = m0 + t0 / TN * 64, col = n0 + (t0 + r) % TN * SUBC + cchunk * CE;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + crow + 16 * c;
          rres[4 * r + c] = row < p.m && col < p.n
                                ? __ldg(reinterpret_cast<const uint4*>(res + row * p.ldr + col))
                                : make_uint4(0, 0, 0, 0);
        }
      }
    };
    if (res && valid(0)) load_res(0);  // in flight during the products
    row_scales(0);
    if constexpr (S::FOLD) {
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int e = 0; e < NA; ++e) facc[mt][e] = 0.f;
    }
    const int i0 = i - j, gs = min(S::G, nu - i0);  // this unit's group
    for (int c = 0; c < p.nchunks; ++c) {
      if (!S::COOP && (j > 0 || (c > 0 ? gs > 1 : i0 > 0))) my_turn();
      const int k1 = min(p.nk, (c + 1) * p.ktc);
      // the chunk's first tile in the producer's order
      int it = i0 * p.nk + (c * gs + j) * p.ktc;
      int prev = -1;  // the stage of the previous k tile, not yet released
      int s = 0;
      for (int kt = c * p.ktc; kt < k1; ++kt, ++it) {
        s = it % S::STAGES;
        mbar_wait(full + s, (it / S::STAGES) & 1);
        const unsigned char* a = sm + s * S::STAGE + (S::COOP ? w * S::WM * 128 : 0);
        const unsigned char* b = sm + s * S::STAGE + S::A_BYTES;
        const bool first = kt == c * p.ktc;  // a chunk's sums start at 0 (scale-d)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QBK / 32; ++kk) {
          const uint64_t db = wgmma_desc(b + kk * 32, 16, 1024, 1);
#pragma unroll
          for (int mt = 0; mt < S::MT; ++mt)
            wgmma_ss_s8_n128(acc[mt], wgmma_desc(a + mt * 64 * 128 + kk * 32, 16, 1024, 1), db,
                             !first || kk > 0);
        }
        wgmma_commit();
        if (kt + 1 < k1) {  // the previous tile's products are done: free its stage
          if (prev >= 0) {
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(empty + prev);
          }
          prev = s;
        }
      }
      if constexpr (!S::COOP) {
        if (j + 1 < gs) pass_turn(j + 1);  // the group's next unit, this chunk
        else if (c + 1 < p.nchunks ? gs > 1 : i0 + S::G < nu) pass_turn(0);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int e = 0; e < NA; ++e) fence_operand(acc[mt][e]);
      if (lane == 0) {
        if (prev >= 0) mbar_arrive(empty + prev);
        mbar_arrive(empty + s);
      }
      if constexpr (S::FOLD) {  // fold the chunk: f = f + (i32 * s_row[c]) * s_col
        wait_vec();
#pragma unroll
        for (int jc = 0; jc < QBN / 8; ++jc) {  // 8-column groups
          const float2 sv = *reinterpret_cast<const float2*>(sw_s + 8 * jc + 2 * q);
#pragma unroll
          for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              facc[mt][4 * jc + e] = __fadd_rn(
                  facc[mt][4 * jc + e],
                  dequant(acc[mt][4 * jc + e], sr[mt][e >> 1], e & 1 ? sv.y : sv.x));
        }
        if (c + 1 < p.nchunks) row_scales(c + 1);
      }
    }

    // Epilogue, in rounds of R output sub-tiles of 64 rows x 128 bytes (64
    // bf16 or 32 f32 columns) through staging buffers in shared memory
    // (16-byte chunks swizzled by row % 8: conflict-free both ways):
    // dequantized sums (or the fold), + bias, GELU and + residual in f32,
    // one rounding, then 16-byte coalesced stores, each warp writing whole
    // 128-byte rows.  The f32 GELU kernels (fc1) take two sub-tiles a
    // round: twice the independent erff chains (~50 instructions a value)
    // and half the barriers.  The residual is read the same way one round
    // ahead.  Sub-tiles wholly past M or N are skipped, chunks past them
    // masked.  The values are computed from the sums, never written back
    // over them: a write to a wgmma's accumulator registers makes ptxas
    // serialise the wgmmas.
    wait_vec();
#pragma unroll
    for (int t0 = 0; t0 < NSUB; t0 += R) {
      if (!valid(t0)) continue;  // warpgroup-uniform; a round shares its rows
      const int mt = t0 / TN;
      float v[R][4 * JS];  // 4 jj + {0, 1}: row g, {2, 3}: row g + 8
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int jj = 0; jj < JS; ++jj) {
          const int jc = (t0 + r) % TN * JS + jj, col = 8 * jc + 2 * q;
          const float2 sv = *reinterpret_cast<const float2*>(sw_s + col);
          const float2 bv = p.bias ? *reinterpret_cast<const float2*>(bias_s + col)
                                   : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x;  // the fold is a sum from 0 already; a single chunk's is 0 + x
            if constexpr (S::FOLD) x = facc[mt][4 * jc + e];
            else x = dequant(acc[mt][4 * jc + e], sr[mt][e >> 1], e & 1 ? sv.y : sv.x);
            if (p.bias) x = __fadd_rn(x, e & 1 ? bv.y : bv.x);
            else if constexpr (!S::FOLD) x = __fadd_rn(0.f, x);
            if constexpr (GELU) x = 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
            v[r][4 * jj + e] = x;
          }
        }
      }
      auto buf = [&](int r) { return cbuf + ((sub + r) & 1) * SUB_BYTES; };
      if (res) {  // the residual into the staging buffers
        if constexpr (R > 1) wg_sync();  // the last round's readers of both are done
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int rw = crow + 16 * c;
            *reinterpret_cast<uint4*>(buf(r) + rw * 128 + ((cchunk ^ (rw & 7)) << 4)) =
                rres[4 * r + c];
          }
      }
      wg_sync();  // the buffers' previous readers are done; the residual is in
      int t2 = t0 + R;  // the next round's residual, in flight meanwhile
      while (t2 < NSUB && !valid(t2)) t2 += R;
      if (res && t2 < NSUB) load_res(t2);
      // row rw = 16 warp + g + 8 h of a sub-tile; 16-byte chunk swizzled by rw % 8 = g
      auto pair = [&](int r, int jj, int h) {
        const int byte = (8 * jj + 2 * q) * (int)sizeof(TO);
        return reinterpret_cast<TO*>(buf(r) + (warp * 16 + g + 8 * h) * 128 +
                                     (((byte >> 4) ^ g) << 4) + (byte & 15));
      };
      if (res) {  // all residual reads before the stores: a read-modify-write
                  // per pair would order each pair's load after the last store
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int jj = 0; jj < JS; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 rv = load2(pair(r, jj, h));
              v[r][4 * jj + 2 * h] = __fadd_rn(rv.x, v[r][4 * jj + 2 * h]);
              v[r][4 * jj + 2 * h + 1] = __fadd_rn(rv.y, v[r][4 * jj + 2 * h + 1]);
            }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store2(pair(r, jj, h), v[r][4 * jj + 2 * h], v[r][4 * jj + 2 * h + 1]);
      wg_sync();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!valid(t0 + r)) continue;
        const int r0 = m0 + mt * 64, col = n0 + (t0 + r) % TN * SUBC + cchunk * CE;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rw = crow + 16 * c;
          if (r0 + rw < p.m && col < p.n)
            *reinterpret_cast<uint4*>(out + (r0 + rw) * p.ldc + col) =
                *reinterpret_cast<const uint4*>(buf(r) + rw * 128 + ((cchunk ^ (rw & 7)) << 4));
        }
      }
      sub += R;
    }
  }
}

// Warpgroup 0 is the producer (one thread issues every TMA load), warpgroups
// 1..NWG the consumers.  The roles part once and never meet again, so
// setmaxnreg can hand the producer's registers to the consumers.
template <class S, typename TO, bool GELU>
__global__ void __launch_bounds__(S::THREADS, 1)
    gemm_int8_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tw, const Wg8Args p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S::STAGES + S::NWG];
  uint64_t *full = bars, *empty = bars + S::STAGES, *vbar = bars + 2 * S::STAGES;
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, S::COOP ? 4 * S::NWG : 4);  // lane 0 of each consuming warp
    }
    for (int i = 0; i < S::NWG; ++i) mbar_init(vbar + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // broadcast from lane 0: the compiler then knows the role is warp-uniform
  // and keeps the wgmmas of the consumer branch asynchronous
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    warpgroup_reg_dealloc<40>();
    if (threadIdx.x == 0) produce8<S>(&ta, &tw, p, sm, full, empty);
  } else {
    warpgroup_reg_alloc<232>();
    consume8<S, TO, GELU>(p, sm, full, empty, vbar, wg - 1);
  }
}

template <class S, typename TO, bool GELU>
int launch8(const Gemm8Args& g, cudaStream_t s) {
  constexpr CUtensorMapDataType T = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // raw bytes
  CUtensorMap ta, tw;
  int rc = make_map_2d(&ta, T, 1, g.a, g.k, g.m, g.lda, QBK, S::BM);
  if (!rc) rc = make_map_2d(&tw, T, 1, g.w, g.k, g.n, g.ldw, QBK, QBN);
  if (rc) return rc;
  Wg8Args p{};
  p.sa = g.sa;
  p.sw = g.sw;
  p.bias = g.bias;
  p.res = g.res;
  p.ldr = g.ldr;
  p.c = g.c;
  p.ldc = g.ldc;
  p.m = g.m;
  p.n = g.n;
  p.nk = (g.k + QBK - 1) / QBK;
  p.ktc = g.nchunks > 1 ? g.kchunk / QBK : p.nk;
  p.nchunks = g.nchunks;
  p.ntn = (g.n + QBN - 1) / QBN;
  p.units = (g.m + S::BM - 1) / S::BM * p.ntn;

  auto kern = gemm_int8_kernel<S, TO, GELU>;
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

template <class S, typename TO>
int route8(const Gemm8Args& g, int gelu, cudaStream_t s) {
  return gelu ? launch8<S, TO, true>(g, s) : launch8<S, TO, false>(g, s);
}

// TMA-legal operands: 16-byte aligned bases (the vectors' too: bulk
// copies) and 16-byte multiples of every row stride.
bool tma_ok8(const Gemm8Args& p, int out_bytes) {
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  return aligned(p.a) && aligned(p.w) && aligned(p.c) && aligned(p.sw) &&
         (!p.res || aligned(p.res)) && (!p.bias || aligned(p.bias)) && p.lda % 16 == 0 &&
         p.ldw % 16 == 0 && p.ldc * out_bytes % 16 == 0 &&
         (!p.res || p.ldr * out_bytes % 16 == 0);
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

// Routes (ops/_common.py GEMM_INT8_ROUTES): 1 "wgmma" (K in one chunk),
// 2 "wgmma_m64", 3 "wgmma_coop" (see the note at the top).
// a (M, K) int8 with row stride lda; w: element (k, n) at w[n * ldw + k];
// sa (M, K / kchunk), sw (N,), bias (N,) or null, all f32; res (M, N) of the
// output type out_dtype, row stride ldr, or null; c (M, N), row stride ldc.
// K % 16 == 0, N % 8 == 0; kchunk divides K and is K or a multiple of 128.
// The routes need 16-byte aligned a, w, c, res, sw and bias, and row
// strides of 16-byte multiples (lda, ldw; ldc and ldr in the output type).
extern "C" int yt_gemm_int8(int route, const void* a, long long lda, const void* w,
                            long long ldw, const void* sa, const void* sw,
                            const void* bias, const void* res, long long ldr,
                            void* c, long long ldc, int out_dtype, int m, int n,
                            int k, int kchunk, int gelu, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || kchunk <= 0 || k % kchunk || k % 16 || n % 8 || !sa || !sw ||
      (out_dtype != YT_BF16 && out_dtype != YT_F32))
    return (int)cudaErrorInvalidValue;
  Gemm8Args p{static_cast<const int8_t*>(a), lda, static_cast<const int8_t*>(w), ldw,
              static_cast<const float*>(sa), static_cast<const float*>(sw),
              static_cast<const float*>(bias), res, ldr, c, ldc,
              m, n, k, kchunk, k / kchunk};
  const bool chunked = p.nchunks > 1;
  if (route < 1 || route > 3 || (route == 1 && chunked) || (chunked && kchunk % QBK) ||
      !tma_ok8(p, out_dtype == YT_F32 ? 4 : 2))
    return YT_ERR_ROUTE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return out_dtype == YT_F32 ? route8<Wide, float>(p, gelu, s) : route8<Wide, bf16>(p, gelu, s);
  if (route == 3)
    return out_dtype == YT_F32 ? route8<Coop, float>(p, gelu, s) : route8<Coop, bf16>(p, gelu, s);
  return out_dtype == YT_F32 ? route8<Narrow, float>(p, gelu, s) : route8<Narrow, bf16>(p, gelu, s);
}

// Head-packed attention: O = softmax(Q K^T * scale) V, per (batch, head),
// on rows laid out (B, L, H * Dh) with given batch and row strides, so Q, K
// and V may be column slices of one packed QKV buffer (no transposes).
//
// Replaces yomitoku_tpu/ops/pallas/flash_attention.py:
//   * fused_attention_heads (the PARSeq refine cross-attention, Lq = 101
//     queries over the 400-token memory; RT-DETR's AIFI and decoder
//     self-attention, 8 heads of 32),
//   * fused_attention (the (B*H, L, Dh) views of (B, H, L, Dh) tensors), and
//   * the attention core of fused_attention_block_ln(_int8) and
//     fused_attention_block (ViT self-attention, L = 400), whose
//     projections run in gemm.cu / gemm_int8.cu.
//
// What bounds it on the H100: the bytes of Q, K, V and O, once each (0.094
// ms at the ViT's (128, 8, 400, 96), 0.059 ms at the refine's q (128, 101,
// 768) over k, v (128, 400, 768), at 3.35 TB/s); the products come next
// (63 GFLOP at the ViT's shape, 0.064 ms at 989 TFLOP/s).  The Pallas kernel
// held a whole (batch, head) -- all of its logits -- in VMEM.  An SM keeps
// only a ring of K/V tiles and the 64-row Q tiles of its warpgroups, so the
// softmax stays online (running max and sum, f32) and the logits never
// leave the registers.
//
// The bf16 route (Dh in {16, 32, 46, 48, 64, 96, 128}, rows 16-byte
// aligned) is built from Hopper's parts:
//   * one producer warp issues TMA tile loads: the block's Q tiles (double
//     buffered) and K and V tiles of 80 keys (80 divides L = 400, so the ViT
//     and refine shapes carry no padded keys) into a 4-stage ring guarded by
//     full / empty mbarriers.  A 3-D tensor map (H Dh, L, B) with byte
//     strides (2 row stride, 2 batch stride) reads the packed column slices
//     and the (B*H, L, Dh) views alike, a head's atoms from column h Dh;
//     rows past L arrive zero-filled and the keys among them are masked to
//     -inf in the logits;
//   * consumer warpgroups of 64 query rows each run both products on wgmma:
//     S = Q K^T (A = Q, B = K, both K-major in shared memory) and O += P V
//     (A = P from registers: the f32 logits turned into bf16 fragments in
//     place; B = V, MN-major).  A row of 96 bf16 is 192 bytes, not a
//     multiple of the 128-byte swizzle span, so every tile is stored as
//     atoms of the widest swizzle that divides Dh (64 B atoms of 32
//     elements at Dh = 96) and the descriptors step across them;
//   * each warpgroup issues S_{j+1} before the softmax of S_j and overlaps
//     that softmax with P_j V_j; two consumer warpgroups also take turns
//     (named barriers) to issue their products, so one's softmax and
//     epilogue run under the other's wgmmas, and setmaxnreg moves the
//     producer's registers to them;
//   * blocks are persistent (one or two per SM) and walk the tiles in (b,
//     h) order, so a (batch, head)'s K and V stay in L2 while its query
//     blocks pass and the next tile's loads overlap this one's epilogue;
//   * a head dim that is not a multiple of 16 (46: parseq-tiny, D 368 on 8
//     heads) runs on a wider window (64): a head starts at column 46 h, not
//     on a 16-byte boundary, and TMA faults on a box whose first column is
//     not on one (on the card: an illegal instruction), so each head's box
//     of 64 columns starts at 46 h rounded down to a multiple of 8, the
//     head's columns at offset e = 46 h mod 8 (0, 2, 4 or 6) inside it and
//     the rest its neighbours' columns (TMA's zero fill past the last head).
//     Each warpgroup zeroes the other 18 columns of its Q rows once per
//     tile, so S = Q K^T takes nothing from K's; V's reach only O's columns
//     outside [e, e + 46), which the epilogue and the split partials never
//     store;
//   * "wgmma" takes 128 query rows per block (two consumer warpgroups share
//     each K/V tile); where that grid would not fill the card (RT-DETR at
//     batch 1 and 4), "wgmma_small" takes 64 rows per block and splits the
//     key range over as many blocks as the caller asks (at most one per key
//     tile), whose unnormalised partial outputs and (max, sum) pairs a
//     combine pass merges.
// The route is chosen in Python (ops/_common.py attention_route) and the C
// entry obeys it or returns an error; nothing falls back.
//
// Otherwise -- always for f32, where the parity checks need full f32
// products, and for bf16 head dims outside that set or rows that TMA cannot
// map -- f32 FMAs from shared memory, 4 warps x 8 query rows, Q read as
// float4.
//
// Semantics of both routes: f32 logits, running max and sum; the
// probabilities rounded to bf16 before P V, as the Pallas kernel rounds its
// weights to v's dtype; f32 accumulation; the ragged Lq and Lk edges masked
// in the kernel.  The output is of the input's type, or f32 for bf16 inputs:
// the attention of fused_attention_block_ln_int8, whose f32 output is
// quantized row by row before the out-projection, as the Pallas kernel
// quantizes its f32 attention.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 32;   // query rows per block (4 warps x 8 rows)
constexpr int RPW = 8;   // query rows per warp
constexpr int BKT = 64;  // keys per tile (2 per lane)
constexpr int NTHREADS = 128;
constexpr int DMAX = 128;  // head dim limit: 4 output dims per lane

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  int heads, lq, lk, dh, dhp;  // dhp: dh rounded up to a multiple of 4
  float scale;
};

size_t smem_bytes(int dhp) {
  return sizeof(float) *
         (size_t)(BQ * dhp + BKT * (dhp + 1) + BKT * dhp + 4 * RPW * BKT);
}

// ------------------------------------------------------------ FMA path

template <typename T, typename TO>
__global__ void __launch_bounds__(NTHREADS) attention_kernel(AttnArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int dhp = p.dhp;
  float* Qs = smem;                   // [BQ][dhp]
  float* Ks = Qs + BQ * dhp;          // [BKT][dhp + 1]  (odd pitch: no bank
                                      //  conflicts between lanes' keys)
  float* Vs = Ks + BKT * (dhp + 1);   // [BKT][dhp]
  float* Ps = Vs + BKT * dhp;         // [4 warps][RPW][BKT]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_bs + (long long)h * p.dh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_bs + (long long)h * p.dh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_bs + (long long)h * p.dh;
  TO* ob = static_cast<TO*>(p.o) + b * p.o_bs + (long long)h * p.dh;

  for (int idx = tid; idx < BQ * dhp; idx += NTHREADS) {
    const int r = idx / dhp, d = idx % dhp;
    float x = 0.f;
    if (q0 + r < p.lq && d < p.dh) x = to_f32(qb[(q0 + r) * p.q_rs + d]);
    Qs[idx] = x;
  }

  float m[RPW], l[RPW], acc[RPW][4];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  }
  float* pw = Ps + warp * RPW * BKT;
  const float* qw = Qs + warp * RPW * dhp;

  for (int k0 = 0; k0 < p.lk; k0 += BKT) {
    __syncthreads();  // Q staged / previous K, V tile consumed
    for (int idx = tid; idx < BKT * dhp; idx += NTHREADS) {
      const int kk = idx / dhp, d = idx % dhp;
      float kx = 0.f, vx = 0.f;
      if (k0 + kk < p.lk && d < p.dh) {
        kx = to_f32(kb[(k0 + kk) * p.k_rs + d]);
        vx = to_f32(vb[(k0 + kk) * p.v_rs + d]);
      }
      Ks[kk * (dhp + 1) + d] = kx;
      Vs[kk * dhp + d] = vx;
    }
    __syncthreads();

    // logits: lane owns keys k0 + lane and k0 + lane + 32 for the warp's rows
    float s0[RPW], s1[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s0[r] = s1[r] = 0.f;
    const float* ka = Ks + lane * (dhp + 1);
    const float* kc = Ks + (lane + 32) * (dhp + 1);
    for (int d = 0; d < dhp; d += 4) {
      const float a0 = ka[d], a1 = ka[d + 1], a2 = ka[d + 2], a3 = ka[d + 3];
      const float c0 = kc[d], c1 = kc[d + 1], c2 = kc[d + 2], c3 = kc[d + 3];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * dhp + d);
        s0[r] = fmaf(qv.x, a0, fmaf(qv.y, a1, fmaf(qv.z, a2, fmaf(qv.w, a3, s0[r]))));
        s1[r] = fmaf(qv.x, c0, fmaf(qv.y, c1, fmaf(qv.z, c2, fmaf(qv.w, c3, s1[r]))));
      }
    }

    // online softmax; key k0 (lane 0) is always valid, so the max is finite
    const bool v0 = k0 + lane < p.lk, v1 = k0 + lane + 32 < p.lk;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float x0 = v0 ? s0[r] * p.scale : -INFINITY;
      const float x1 = v1 ? s1[r] * p.scale : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(fmaxf(x0, x1)));
      const float corr = expf(m[r] - mn);
      const float p0 = expf(x0 - mn), p1 = expf(x1 - mn);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] *= corr;
      pw[r * BKT + lane] = p0;
      pw[r * BKT + lane + 32] = p1;
    }
    __syncwarp();

    // P V: lane owns output dims lane + 32 i
    for (int kk = 0; kk < BKT; kk += 4) {
      float4 pv[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        pv[r] = *reinterpret_cast<const float4*>(pw + r * BKT + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* vrow = Vs + (kk + j) * dhp;
        float vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          vv[i] = d < dhp ? vrow[d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float pj = j == 0 ? pv[r].x : j == 1 ? pv[r].y
                         : j == 2 ? pv[r].z : pv[r].w;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= p.lq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      if (d < p.dh) ob[row * p.o_rs + d] = from_f32<TO>(acc[r][i] * inv);
    }
  }
}

template <typename T, typename TO>
int launch(const AttnArgs& p, int batch, cudaStream_t s) {
  const size_t bytes = smem_bytes(p.dhp);
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.lq + BQ - 1) / BQ, p.heads, batch);
  attention_kernel<T, TO><<<grid, NTHREADS, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------- bf16 wgmma + TMA path

constexpr int QROWS = 64;  // query rows per consumer warpgroup (wgmma M)
constexpr int BN = 80;     // keys per K/V tile (wgmma N of S, 5 k16 steps of P V)
constexpr int NST = 4;     // K/V ring stages
constexpr int MAX_DEVICES = 64;

// A tile's rows are stored as atoms of AW elements, one swizzle span wide:
// the widest of 128, 64 or 32 bytes that divides the row.
template <int DH>
struct Atoms {
  static constexpr int AW = DH % 64 == 0 ? 64 : DH % 32 == 0 ? 32 : 16;
  static constexpr int NA = DH / AW;
  static constexpr uint32_t PITCH = AW * 2;                            // bytes per atom row
  static constexpr uint32_t SWZ = AW == 64 ? 1 : AW == 32 ? 2 : 3;     // descriptor code
  // where TMA and wgmma keep the byte at shared address ``addr`` of an
  // atom: its 16-byte chunk XOR the address bits of its 8-row group
  static __device__ __forceinline__ uint32_t swizzled(uint32_t addr) {
    return addr ^ (((addr >> 7) & (PITCH / 16 - 1)) << 4);
  }
};

// Dynamic shared memory, from a 1024-byte aligned base: Q [2 buffers][NA
// atoms][NWG * 64 rows][AW], K and V each [NST][NA][BN keys][AW].  Every
// region starts on its swizzle period, as TMA and wgmma both swizzle by
// address.
template <int DH, int NWG>
struct Layout {
  static constexpr int QBYTES = NWG * QROWS * DH * 2;
  static constexpr int KVBYTES = BN * DH * 2;
  static constexpr int K0 = 2 * QBYTES;
  static constexpr int V0 = K0 + NST * KVBYTES;
  static constexpr int ALLOC = V0 + NST * KVBYTES + 1024;  // + alignment slack
};

struct WgArgs {
  void* o;
  float* part;  // splits > 1: unnormalised partial outputs, then (max, sum) pairs
  long long o_bs, o_rs;
  int batch, heads, lq, lk;
  int nqb;     // query blocks of NWG * 64 rows per (batch, head)
  int ntk;     // key tiles of BN
  int splits;  // key splits, each of tps tiles (the last may hold fewer)
  int tps;
  int ntiles;  // nqb * splits * heads * batch
  float sl2;   // scale * log2(e): exp(x * scale) = exp2(x * sl2)
};

struct Tile {
  int b, h, qb, sp, t0, t1;
};

// Tiles are numbered query block fastest, then split, head and batch, so
// the blocks in flight share a few (batch, head)s' K and V in L2.
__device__ __forceinline__ Tile decode_tile(const WgArgs& p, int t) {
  Tile x;
  x.qb = t % p.nqb;
  t /= p.nqb;
  x.sp = t % p.splits;
  t /= p.splits;
  x.h = t % p.heads;
  x.b = t / p.heads;
  x.t0 = x.sp * p.tps;
  x.t1 = min(x.t0 + p.tps, p.ntk);
  return x;
}

// Logits of one 64 x BN tile in the accumulator layout (lane (g, q) holds
// rows g and g + 8 of its warp's 16, columns 8 j + 2 q + {0, 1}) -> the
// probabilities exp2(s * sl2 - max) in place; updates the running max and
// this lane's share of the running sum, and sets ``corr`` to the factor by
// which the output so far must be rescaled.
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&m_run)[2],
                                               float (&l_run)[2], float (&corr)[2], int k0,
                                               int lk, float sl2, int qd) {
  const bool ragged = k0 + BN > lk;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * sl2;
      if (ragged && k0 + 8 * j + 2 * qd + (e & 1) >= lk) x = -INFINITY;
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m_run[r], mx[r]);  // finite: every tile holds a valid key
    corr[r] = exp2f(m_run[r] - mn);
    m_run[r] = mn;
    l_run[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[4 * j + e] - m_run[e >> 1]);
      l_run[e >> 1] += p;
      sc[4 * j + e] = p;
    }
}

// The probabilities as the A fragments of P V: n8 blocks 2 kk and 2 kk + 1
// of the accumulator are the k-halves of the 16-key fragment kk.
__device__ __forceinline__ void to_fragments(const float (&sc)[BN / 2], uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pf[kk][i] = pack2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

// DH: the width the products run at (a multiple of 16); DO: the head's own
// width, DH or, for the padded route, less (46 in 64).  The head's columns
// lie at offset head_offset() of a window that starts on a 16-byte boundary.
template <int DO>
__device__ __forceinline__ int head_offset(int h) {
  return DO % 8 == 0 ? 0 : h * DO % 8;
}

template <int DH, int DO, int NWG>
__device__ __forceinline__ void produce(const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const WgArgs& p,
                                        unsigned char* sm, uint64_t* qfull, uint64_t* qempty,
                                        uint64_t* kfull, uint64_t* vfull, uint64_t* kvempty) {
  using A = Atoms<DH>;
  using L = Layout<DH, NWG>;
  tma_prefetch_map(tq);
  tma_prefetch_map(tk);
  tma_prefetch_map(tv);
  int it = 0, tn = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x, ++tn) {
    const Tile x = decode_tile(p, t);
    const int col0 = x.h * DO - head_offset<DO>(x.h);  // the window's first column
    const int qs = tn & 1;
    if (tn >= 2) mbar_wait(qempty + qs, ((tn >> 1) - 1) & 1);
    mbar_expect_tx(qfull + qs, L::QBYTES);
    unsigned char* qdst = sm + qs * L::QBYTES;
#pragma unroll
    for (int a = 0; a < A::NA; ++a)
      tma_load_3d(qdst + a * (NWG * QROWS * A::PITCH), tq, qfull + qs, col0 + a * A::AW,
                  x.qb * NWG * QROWS, x.b);
    for (int kt = x.t0; kt < x.t1; ++kt, ++it) {
      const int s = it % NST, use = it / NST;
      if (use > 0) mbar_wait(kvempty + s, (use - 1) & 1);
      unsigned char* kdst = sm + L::K0 + s * L::KVBYTES;
      unsigned char* vdst = sm + L::V0 + s * L::KVBYTES;
      mbar_expect_tx(kfull + s, L::KVBYTES);
#pragma unroll
      for (int a = 0; a < A::NA; ++a)
        tma_load_3d(kdst + a * (BN * A::PITCH), tk, kfull + s, col0 + a * A::AW, kt * BN,
                    x.b);
      mbar_expect_tx(vfull + s, L::KVBYTES);
#pragma unroll
      for (int a = 0; a < A::NA; ++a)
        tma_load_3d(vdst + a * (BN * A::PITCH), tv, vfull + s, col0 + a * A::AW, kt * BN,
                    x.b);
    }
  }
}

// The padded route: the columns of this warpgroup's 64 Q rows outside the
// head's [e, e + DO) set to zero (one thread a row, two columns a store),
// fenced for the async proxy that wgmma reads shared memory through,
// before any thread of the warpgroup issues S.
template <int DH, int DO, int NWG>
__device__ __forceinline__ void zero_q_pad(unsigned char* qtile, int e, int w) {
  static_assert(DO % 2 == 0, "the padded route stores column pairs");
  using A = Atoms<DH>;
  constexpr uint32_t QATOM = NWG * QROWS * A::PITCH;
  const int r = threadIdx.x % 128;
  if (r < QROWS) {
    const uint32_t base = smem_addr(qtile);
#pragma unroll
    for (int i = 0; i < DH - DO; i += 2) {
      const int c = i < e ? i : i + DO;
      const uint32_t at = A::swizzled(base + (c / A::AW) * QATOM + r * A::PITCH + (c % A::AW) * 2);
      *reinterpret_cast<uint32_t*>(qtile + (at - base)) = 0u;
    }
  }
  fence_proxy_async();
  named_bar_sync(3 + w, 128);
}

// w: this consumer warpgroup, 0..NWG-1 (warp-uniform).
template <int DH, int DO, int NWG, typename TO>
__device__ __forceinline__ void consume(const WgArgs& p, unsigned char* sm, uint64_t* qfull,
                                        uint64_t* qempty, uint64_t* kfull, uint64_t* vfull,
                                        uint64_t* kvempty, int w) {
  using A = Atoms<DH>;
  using L = Layout<DH, NWG>;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  constexpr uint32_t QATOM = NWG * QROWS * A::PITCH, KATOM = BN * A::PITCH;
  // Two warpgroups take turns to issue their products (named barriers 1
  // and 2, WG 0 first): while one runs its softmax or epilogue, the tensor
  // cores work through the other's wgmmas.
  auto my_turn = [&]() {
    if constexpr (NWG == 2) named_bar_sync(1 + w, 256);
  };
  auto pass_turn = [&]() {
    if constexpr (NWG == 2) named_bar_arrive(2 - w, 256);
  };
  if (w == 1) pass_turn();
  int it = 0, tn = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x, ++tn) {
    const Tile x = decode_tile(p, t);
    const int qs = tn & 1;
    const int r0 = (x.qb * NWG + w) * QROWS;  // this warpgroup's first row
    mbar_wait(qfull + qs, (tn >> 1) & 1);
    if (r0 >= p.lq) {  // rows past Lq: keep the ring's counts and the turns
      for (int kt = x.t0; kt <= x.t1; ++kt) {
        my_turn();
        pass_turn();
        if (kt == x.t1) break;
        mbar_wait(kfull + it % NST, (it / NST) & 1);
        if (lane == 0) mbar_arrive(kvempty + it % NST);
        ++it;
      }
      if (lane == 0) mbar_arrive(qempty + qs);
      continue;
    }
    unsigned char* qtile = sm + qs * L::QBYTES + w * QROWS * A::PITCH;
    const int e = head_offset<DO>(x.h);  // the head's first column in the window
    if constexpr (DO < DH) zero_q_pad<DH, DO, NWG>(qtile, e, w);

    float o[DH / 2], sc[BN / 2];
    uint32_t pf[BN / 16][4];
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

    auto issue_s = [&](int s) {  // S = Q K^T over Dh / 16 k-steps
      const unsigned char* ks = sm + L::K0 + s * L::KVBYTES;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int a = kk * 16 / A::AW, off = (kk * 16 % A::AW) * 2;
        wgmma_ss_n80(sc, wgmma_desc(qtile + a * QATOM + off, 16, 8 * A::PITCH, A::SWZ),
                     wgmma_desc(ks + a * KATOM + off, 16, 8 * A::PITCH, A::SWZ), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int s) {  // O += P V over BN / 16 k-steps
      const unsigned char* vs = sm + L::V0 + s * L::KVBYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<DH>(o, pf[kk], wgmma_desc(vs + kk * 16 * A::PITCH, KATOM, 8 * A::PITCH, A::SWZ),
                     1);
      wgmma_commit();
    };

    // first key tile: S_0 alone
    int sprev = it % NST, uprev = it / NST;
    mbar_wait(kfull + sprev, uprev & 1);
    my_turn();
    wgmma_fence();
    issue_s(sprev);
    pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(sc[i]);
    online_softmax(sc, m_run, l_run, corr, x.t0 * BN, p.lk, p.sl2, qd);
    to_fragments(sc, pf);
    ++it;
    // then S_j, issued before P_{j-1} V_{j-1}, whose product overlaps the
    // softmax of S_j
    for (int kt = x.t0 + 1; kt < x.t1; ++kt, ++it) {
      const int s = it % NST;
      mbar_wait(kfull + s, (it / NST) & 1);
      mbar_wait(vfull + sprev, uprev & 1);
      my_turn();
      wgmma_fence();
      issue_s(s);
      issue_pv(sprev);
      pass_turn();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(sc[i]);
      online_softmax(sc, m_run, l_run, corr, kt * BN, p.lk, p.sl2, qd);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) fence_operand(o[i]);
      if (lane == 0) mbar_arrive(kvempty + sprev);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      to_fragments(sc, pf);
      sprev = s;
      uprev = it / NST;
    }
    mbar_wait(vfull + sprev, uprev & 1);
    my_turn();
    wgmma_fence();
    issue_pv(sprev);
    pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) fence_operand(o[i]);
    if (lane == 0) {
      mbar_arrive(kvempty + sprev);
      mbar_arrive(qempty + qs);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const long long bh = (long long)x.b * p.heads + x.h;
    // on the padded route, accumulator columns 8 j + 2 qd (+1) outside the head
    auto off_head = [&](int j) { return DO < DH && (j * 8 + qd * 2 < e || j * 8 + qd * 2 >= e + DO); };
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + warp * 16 + g + hr * 8;
      if (row >= p.lq) continue;
      if (p.splits > 1) {  // unnormalised partial output and its (max, sum)
        const long long idx = ((long long)x.sp * p.batch * p.heads + bh) * p.lq + row;
        float* dst = p.part + idx * DH + qd * 2 - e;  // the head's columns first
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          if (off_head(j)) continue;
          *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
        }
        if (qd == 0) {
          float* ml = p.part + (long long)p.splits * p.batch * p.heads * p.lq * DH + idx * 2;
          *reinterpret_cast<float2*>(ml) = make_float2(m_run[hr], l_run[hr]);
        }
        continue;
      }
      const float inv = 1.f / l_run[hr];
      TO* dst = static_cast<TO*>(p.o) + x.b * p.o_bs + row * p.o_rs + x.h * DO - e + qd * 2;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        if (off_head(j)) continue;
        const float a0 = o[4 * j + 2 * hr] * inv, a1 = o[4 * j + 2 * hr + 1] * inv;
        if constexpr (sizeof(TO) == 4)
          *reinterpret_cast<float2*>(dst + j * 8) = make_float2(a0, a1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(a0, a1);
      }
    }
  }
}

// Warpgroup 0 is the producer (one thread issues every TMA load), warpgroups
// 1..NWG the consumers.  The roles part once and never meet again, so
// setmaxnreg can hand the producer's registers to the consumers.
template <int DH, int DO, int NWG, typename TO>
__global__ void __launch_bounds__((NWG + 1) * 128, (NWG == 1 && DH <= 32) ? 2 : 1)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const WgArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 + 3 * NST];
  uint64_t *qfull = bars, *qempty = bars + 2, *kfull = bars + 4, *vfull = kfull + NST,
           *kvempty = vfull + NST;
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, 4 * NWG);  // lane 0 of every consumer warp
    }
    for (int i = 0; i < NST; ++i) {
      mbar_init(kfull + i, 1);
      mbar_init(vfull + i, 1);
      mbar_init(kvempty + i, 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // broadcast from lane 0: the compiler then knows the role is warp-uniform
  // and keeps the wgmmas of the consumer branch asynchronous
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    if constexpr (NWG == 2) warpgroup_reg_dealloc<24>();
    if (threadIdx.x == 0)
      produce<DH, DO, NWG>(&tq, &tk, &tv, p, sm, qfull, qempty, kfull, vfull, kvempty);
  } else {
    if constexpr (NWG == 2) warpgroup_reg_alloc<240>();
    consume<DH, DO, NWG, TO>(p, sm, qfull, qempty, kfull, vfull, kvempty, wg - 1);
  }
}

struct CombineArgs {
  const float* part;  // partial rows of dp floats (the kernel's DH), the head's dh first
  void* o;
  long long o_bs, o_rs;
  int batch, heads, lq, dh, dp, splits;
};

// One warp per (batch, head, row): O = sum_s w_s O_s / sum_s w_s l_s with
// w_s = exp2(m_s - max_s m_s).
template <typename TO>
__global__ void __launch_bounds__(128) attention_combine_kernel(CombineArgs c) {
  const long long rows = (long long)c.batch * c.heads * c.lq;
  const long long idx = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  if (idx >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* ml = c.part + (long long)c.splits * rows * c.dp;
  float mx = -INFINITY;
  for (int s = 0; s < c.splits; ++s) mx = fmaxf(mx, ml[(s * rows + idx) * 2]);
  float l = 0.f, acc[DMAX / 32] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < c.splits; ++s) {
    const float wgt = exp2f(ml[(s * rows + idx) * 2] - mx);
    l += wgt * ml[(s * rows + idx) * 2 + 1];
    const float* src = c.part + (s * rows + idx) * c.dp;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i)
      if (lane + 32 * i < c.dh) acc[i] += wgt * src[lane + 32 * i];
  }
  const int row = (int)(idx % c.lq), h = (int)(idx / c.lq % c.heads), b = (int)(idx / c.lq / c.heads);
  TO* dst = static_cast<TO*>(c.o) + b * c.o_bs + row * c.o_rs + (long long)h * c.dh;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i)
    if (lane + 32 * i < c.dh) dst[lane + 32 * i] = from_f32<TO>(acc[i] * inv);
}

// ------------------------------------------------------ host side

// A 3-D map (H DO, L, B) of bf16 head-packed rows; boxes of one atom (AW
// columns from a column on a 16-byte boundary), ``rows`` rows, one batch
// item.
template <int DH, int DO>
int make_map(CUtensorMap* map, const void* base, int heads, int len, int batch, long long rs,
             long long bs, int rows) {
  using A = Atoms<DH>;
  if (batch == 1) bs = rs * len;  // unused; any valid stride
  const EncodeTiled fn = encoder();
  if (!fn) return YT_ERR_TENSOR_MAP;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * DO, (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[3] = {(cuuint32_t)A::AW, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = A::AW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : A::AW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : YT_ERR_TENSOR_MAP;
}

bool tma_ok(const AttnArgs& p) {
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  return aligned(p.q) && aligned(p.k) && aligned(p.v) && aligned(p.o) &&
         (p.q_bs | p.q_rs | p.k_bs | p.k_rs | p.v_bs | p.v_rs | p.o_bs | p.o_rs) % 8 == 0;
}

template <int DH, int DO, int NWG, typename TO>
int launch_wgmma(const AttnArgs& a, int batch, int splits, float* part, cudaStream_t s) {
  using L = Layout<DH, NWG>;
  CUtensorMap tq, tk, tv;
  int rc = make_map<DH, DO>(&tq, a.q, a.heads, a.lq, batch, a.q_rs, a.q_bs, NWG * QROWS);
  if (!rc) rc = make_map<DH, DO>(&tk, a.k, a.heads, a.lk, batch, a.k_rs, a.k_bs, BN);
  if (!rc) rc = make_map<DH, DO>(&tv, a.v, a.heads, a.lk, batch, a.v_rs, a.v_bs, BN);
  if (rc) return rc;
  WgArgs p{};
  p.o = a.o;
  p.part = part;
  p.o_bs = a.o_bs;
  p.o_rs = a.o_rs;
  p.batch = batch;
  p.heads = a.heads;
  p.lq = a.lq;
  p.lk = a.lk;
  p.nqb = (a.lq + NWG * QROWS - 1) / (NWG * QROWS);
  p.ntk = (a.lk + BN - 1) / BN;
  // at most ``splits`` splits of whole key tiles, none of them empty
  if (splits < 1) return YT_ERR_ROUTE;
  p.tps = (p.ntk + splits - 1) / splits;
  p.splits = (p.ntk + p.tps - 1) / p.tps;
  if (p.splits > 1 && !part) return YT_ERR_ROUTE;  // partials need their buffer
  p.ntiles = p.nqb * p.splits * a.heads * batch;
  p.sl2 = a.scale * 1.4426950408889634f;

  auto kern = attention_wgmma_kernel<DH, DO, NWG, TO>;
  constexpr int threads = (NWG + 1) * 128;
  // per device, once: the shared-memory attribute, SMs, blocks per SM
  static int per_sm[MAX_DEVICES] = {}, sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!per_sm[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kern, threads, L::ALLOC);
    if (e != cudaSuccess) return (int)e;
    if (per_sm[dev] < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  const int slots = sms[dev] * per_sm[dev];
  const int grid = p.ntiles < slots ? p.ntiles : slots;
  kern<<<grid, threads, L::ALLOC, s>>>(tq, tk, tv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return (int)e;
  CombineArgs c{part, a.o, a.o_bs, a.o_rs, batch, a.heads, a.lq, DO, DH, p.splits};
  const long long rows = (long long)batch * a.heads * a.lq;
  attention_combine_kernel<TO><<<(unsigned)((rows + 3) / 4), 128, 0, s>>>(c);
  return (int)cudaGetLastError();
}

// The width the wgmma routes compute a head of ``dh`` columns at, 0 where
// none is built: dh where wgmma's k step (16) divides it, 64 for the
// padded head of 46 (its window from the 16-byte boundary at or below the
// head's first column).  The split partials are rows of this width.
constexpr int head_width(int dh) {
  return dh == 46 ? 64
         : (dh == 16 || dh == 32 || dh == 48 || dh == 64 || dh == 96 || dh == 128) ? dh
                                                                                     : 0;
}

template <int NWG, typename TO>
int route_wgmma(const AttnArgs& a, int batch, int splits, float* part, cudaStream_t s) {
  switch (a.dh) {
    case 16: return launch_wgmma<head_width(16), 16, NWG, TO>(a, batch, splits, part, s);
    case 32: return launch_wgmma<head_width(32), 32, NWG, TO>(a, batch, splits, part, s);
    case 46: return launch_wgmma<head_width(46), 46, NWG, TO>(a, batch, splits, part, s);
    case 48: return launch_wgmma<head_width(48), 48, NWG, TO>(a, batch, splits, part, s);
    case 64: return launch_wgmma<head_width(64), 64, NWG, TO>(a, batch, splits, part, s);
    case 96: return launch_wgmma<head_width(96), 96, NWG, TO>(a, batch, splits, part, s);
    case 128: return launch_wgmma<head_width(128), 128, NWG, TO>(a, batch, splits, part, s);
  }
  return YT_ERR_ROUTE;
}

}  // namespace

// Routes (ops/_common.py ATTENTION_ROUTES): 0 the FMA kernel; 1 the wgmma
// kernel, 128 query rows per block; 2 the wgmma kernel, 64 rows per block,
// the keys split over at most ``splits`` blocks, each of whole 80-key tiles,
// and ``part`` holding their partials (room for splits * batch * heads * lq
// * (yt_attention_width(dh) + 2) floats) when splits > 1.
// out_dtype: dtype, or YT_F32 for bf16 inputs (f32 output).
extern "C" int yt_attention(int route, int splits, int dtype, int out_dtype, const void* q,
                            long long q_bs, long long q_rs, const void* k, long long k_bs,
                            long long k_rs, const void* v, long long v_bs, long long v_rs,
                            void* o, long long o_bs, long long o_rs, void* part, int batch,
                            int heads, int lq, int lk, int dh, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || dh <= 0 || dh > DMAX)
    return (int)cudaErrorInvalidValue;
  if (batch == 1) q_bs = k_bs = v_bs = o_bs = 0;  // unused
  AttnArgs p{q,    k,    v,    o,     q_bs, q_rs, k_bs,         k_rs,
             v_bs, v_rs, o_bs, o_rs,  heads, lq,  lk,           dh,
             (dh + 3) / 4 * 4, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (route == 0) {
    if (dtype == YT_BF16 && out_dtype == YT_BF16) return launch<bf16, bf16>(p, batch, s);
    if (dtype == YT_BF16 && out_dtype == YT_F32) return launch<bf16, float>(p, batch, s);
    if (dtype == YT_F32 && out_dtype == YT_F32) return launch<float, float>(p, batch, s);
    return (int)cudaErrorInvalidValue;
  }
  if ((route != 1 && route != 2) || dtype != YT_BF16 || !tma_ok(p) ||
      (route == 1 && splits != 1))
    return YT_ERR_ROUTE;
  if (out_dtype == YT_BF16)
    return route == 1 ? route_wgmma<2, bf16>(p, batch, 1, pf, s)
                      : route_wgmma<1, bf16>(p, batch, splits, pf, s);
  if (out_dtype == YT_F32)
    return route == 1 ? route_wgmma<2, float>(p, batch, 1, pf, s)
                      : route_wgmma<1, float>(p, batch, splits, pf, s);
  return YT_ERR_ROUTE;
}

// The width of the split partials' rows for a head of ``dh`` columns (the
// width the wgmma routes compute it at), 0 where no wgmma route is built.
extern "C" int yt_attention_width(int dh) { return head_width(dh); }

// Head-packed attention: O = softmax(Q K^T * scale) V, per (batch, head),
// on rows laid out (B, L, H * Dh) with given batch and row strides, so Q, K
// and V may be column slices of one packed QKV buffer (no transposes).
//
// Replaces yomitoku_tpu/ops/pallas/flash_attention.py:
//   * fused_attention_heads (the PARSeq refine cross-attention, Lq = 101
//     queries over the 400-token memory), and
//   * the attention core of fused_attention_block_ln (ViT self-attention,
//     L = 400), whose projections run in gemm.cu.
//
// What bounds it on the H100: logits are L x L per (batch, head), 128 x 8 x
// 400 x 400 f32 = 655 MB per encoder block if written out; the TPU kernel
// kept them in VMEM for a whole batch item.  Here one block owns a tile of
// query rows of one (batch, head) and walks the keys in tiles of 64 with an
// online (running max / running sum) softmax, so logits never leave the SM
// and device memory sees only Q, K, V and O (~0.3 GB per encoder block, a
// tenth of a millisecond).  What is left bounds it: the products and the
// shared-memory traffic around them.  Two paths:
//   * bf16 with Dh % 16 == 0 and 16-byte aligned rows (the recognizer):
//     QK^T and PV on the tensor cores (mma.sync m16n8k16, f32
//     accumulation), 4 warps x 16 query rows, with the logits, the softmax
//     state and the output in registers (shared memory holds only the Q,
//     K and V tiles, K and V double-buffered through cp.async);
//   * otherwise (and always for f32, where the parity checks need full f32
//     products): f32 FMAs from shared memory, 4 warps x 8 query rows, Q read
//     as float4.
// The ragged Lq and Lk edges are masked inside the kernel (the Pallas
// kernel padded Lq to a multiple of 8).  The output is of the input's type,
// or f32 for bf16 inputs: the attention of fused_attention_block_ln_int8,
// whose f32 output is quantized row by row before the out-projection, as
// the Pallas kernel quantizes its f32 attention.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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

// ------------------------------------------------- bf16 tensor-core path

constexpr int TQ = 64;  // query rows per block (4 warps x 16)
constexpr int TK = 64;  // keys per tile

// Shared memory: Q [TQ][dh + 8], then K and V, each [2 buffers][TK][dh + 8]
// (bf16).  A row pitch of dh + 8 elements is an odd multiple of 16 bytes, so
// the 8 rows of an ldmatrix fall in 8 distinct 16-byte bank groups.
size_t tc_smem_bytes(int dh) { return sizeof(bf16) * (size_t)(TQ + 4 * TK) * (dh + 8); }

// Each warp owns 16 query rows and keeps everything of them in registers:
// its Q fragments, the 16 x 64 logits of the current key tile, the running
// max and sum, and the 16 x dh output.  Lane (g, q) = (lane / 4, lane % 4)
// holds rows g and g + 8, columns 2q and 2q + 1 of each 16 x 8 tile; the
// four lanes of a row reduce with two shuffles.  K and V tiles stream
// through a double-buffered cp.async ring; the logits turn into the next
// product's A fragments without leaving the registers.
template <typename TO>
__global__ void __launch_bounds__(NTHREADS) attention_tc_kernel(AttnArgs p) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int dh = p.dh, pitch = dh + 8, nvec = dh / 8, nd = dh / 16;
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Ks = Qs + TQ * pitch;      // [2][TK][pitch]
  bf16* Vs = Ks + 2 * TK * pitch;  // [2][TK][pitch]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_bs + (long long)h * dh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_bs + (long long)h * dh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_bs + (long long)h * dh;
  TO* ob = static_cast<TO*>(p.o) + b * p.o_bs + (long long)h * dh;

  // rows past Lq and keys past Lk are zero-filled (and the keys masked)
  for (int idx = tid; idx < TQ * nvec; idx += NTHREADS) {
    const int r = idx / nvec, c = (idx % nvec) * 8;
    const bool ok = q0 + r < p.lq;
    cp_async16(Qs + r * pitch + c, ok ? qb + (q0 + r) * p.q_rs + c : qb, ok);
  }
  auto load_kv = [&](int buf, int k0) {
    bf16* ks = Ks + buf * TK * pitch;
    bf16* vs = Vs + buf * TK * pitch;
    for (int idx = tid; idx < TK * nvec; idx += NTHREADS) {
      const int r = idx / nvec, c = (idx % nvec) * 8;
      const bool ok = k0 + r < p.lk;
      cp_async16(ks + r * pitch + c, ok ? kb + (k0 + r) * p.k_rs + c : kb, ok);
      cp_async16(vs + r * pitch + c, ok ? vb + (k0 + r) * p.v_rs + c : vb, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  unsigned qf[DMAX / 16][4];
  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // running max (log2 domain) and this lane's share of the running sum,
  // for rows g and g + 8
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float sl2 = p.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  const int ntiles = (p.lk + TK - 1) / TK;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv((t + 1) & 1, (t + 1) * TK);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile t have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < DMAX / 16; ++i)
        if (i < nd)
          ldmatrix_x4(qf[i], Qs + (warp * 16 + lane % 16) * pitch + i * 16 + (lane / 16) * 8);
    }
    const bf16* ks = Ks + (t & 1) * TK * pitch;
    const bf16* vs = Vs + (t & 1) * TK * pitch;

    // S = Q K^T: 16 rows x 64 keys, f32
    float s[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX / 16; ++i) {
      if (i >= nd) continue;
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * pitch + i * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[i], r);
        mma_bf16(s[2 * np + 1], qf[i], r + 2);
      }
    }

    // online softmax (key k0 of every tile is valid: the maxima are finite)
    const int k0 = t * TK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = k0 + j * 8 + qd * 2 + (e & 1) < p.lk ? s[j][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - mn);
      m_run[r] = mn;
      l_run[r] *= corr[r];
    }
    // P = exp2(S - max) as the A fragments of P V: tiles 2kk and 2kk + 1
    // are the k-halves of the 16 x 16 fragment kk
    unsigned pf[TK / 16][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - m_run[0]), p1 = exp2f(s[j][1] - m_run[0]);
      const float p2 = exp2f(s[j][2] - m_run[1]), p3 = exp2f(s[j][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack2(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack2(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DMAX / 16; ++dp) {
        if (dp >= nd) continue;
        unsigned r[4];
        ldmatrix_x4_trans(r, vs + (kk * 16 + (lane & 15)) * pitch + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pf[kk], r);
        mma_bf16(o[2 * dp + 1], pf[kk], r + 2);
      }
    }
    __syncthreads();  // every warp is done with buffer t & 1 before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + warp * 16 + g + hr * 8;
    if (row >= p.lq) continue;
    const float inv = 1.f / l_run[hr];
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      if (j >= 2 * nd) continue;
      TO* dst = ob + row * p.o_rs + j * 8 + qd * 2;
      if constexpr (sizeof(TO) == 4)
        *reinterpret_cast<float2*>(dst) = make_float2(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
    }
  }
}

bool tc_ok(const AttnArgs& p) {
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  return p.dh % 16 == 0 && aligned(p.q) && aligned(p.k) && aligned(p.v) &&
         aligned(p.o) &&
         (p.q_bs | p.q_rs | p.k_bs | p.k_rs | p.v_bs | p.v_rs | p.o_bs |
          p.o_rs) % 8 == 0;
}

template <typename TO>
int launch_tc(const AttnArgs& p, int batch, cudaStream_t s) {
  const size_t bytes = tc_smem_bytes(p.dh);
  cudaError_t e = cudaFuncSetAttribute(
      attention_tc_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.lq + TQ - 1) / TQ, p.heads, batch);
  attention_tc_kernel<TO><<<grid, NTHREADS, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- launch

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

}  // namespace

// out_dtype: dtype, or YT_F32 for bf16 inputs (f32 output).
extern "C" int yt_attention(int dtype, int out_dtype, const void* q, long long q_bs,
                            long long q_rs, const void* k, long long k_bs,
                            long long k_rs, const void* v, long long v_bs,
                            long long v_rs, void* o, long long o_bs,
                            long long o_rs, int batch, int heads, int lq,
                            int lk, int dh, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || dh <= 0 || dh > DMAX)
    return (int)cudaErrorInvalidValue;
  AttnArgs p{q,    k,    v,    o,     q_bs, q_rs, k_bs,         k_rs,
             v_bs, v_rs, o_bs, o_rs,  heads, lq,  lk,           dh,
             (dh + 3) / 4 * 4, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == YT_BF16 && out_dtype == YT_BF16)
    return tc_ok(p) ? launch_tc<bf16>(p, batch, s) : launch<bf16, bf16>(p, batch, s);
  if (dtype == YT_BF16 && out_dtype == YT_F32)
    return tc_ok(p) ? launch_tc<float>(p, batch, s) : launch<bf16, float>(p, batch, s);
  if (dtype == YT_F32 && out_dtype == YT_F32) return launch<float, float>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

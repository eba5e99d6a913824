// Multi-scale deformable attention (RT-DETRv2 decoder cross-attention):
//   out[b, q, h*c + ch] = sum over levels l, points p of level l:
//       att[b, q, h, p] * bilinear(V_l[b, :, :, h, ch], loc[b, q, h, p])
// with grid_sample's semantics (bilinear, zeros padding, align_corners =
// False): pixel coordinates loc.x * W_l - 0.5, loc.y * H_l - 0.5, and each of
// the four taps that falls outside the map contributes zero.  value is
// (B, Len_v, nh, c), the levels' maps flattened row-major one after another;
// loc (B, Lq, nh, P, 2) and att (B, Lq, nh, P) with the points of level 0
// first; out (B, Lq, nh * c).  All contiguous.
//
// Replaces yomitoku_tpu/ops/pallas/deformable_attention.py
// (ms_deformable_attention).  The TPU has no fast gather, so the Pallas kernel
// recast each point's bilinear sample as two 2-sparse matrix products over a
// whole level map held in VMEM, one launch per level, summed outside, with
// the queries tiled by 512.
//
// What bounds it on the H100: random reads.  Per image the value is
// 8400 x 256 bf16 = 4.3 MB, which stays in the 50 MB L2, and a query reads
// 8 heads x 12 points x 4 taps of 64 bytes; there are no products worth a
// tensor core.  So the kernel is a direct gather: one warp per (batch,
// query, head), lanes over the channels, so every tap is one coalesced
// c-element row of the (B, Len_v, nh, c) value (64 bytes at c = 32 in
// bf16).  Each lane first works out one point's level, its four tap offsets
// and its four weights (bilinear weight x attention weight, zero where the
// tap is outside the map); the warp then walks the points, taking each
// point's taps from that lane by shuffles, and accumulates in f32 over all
// points of all levels: one launch, one rounded store, any Lq.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_C = 128;  // channels per head: 4 per lane
constexpr int WARPS = 8;    // warps per block

struct DeformArgs {
  const void* value;
  const void* loc;
  const void* att;
  void* out;
  long long len_v;
  int batch, heads, c, lq, levels, points;
  int h[MAX_LEVELS], w[MAX_LEVELS], pstart[MAX_LEVELS];
  long long start[MAX_LEVELS];  // first row of each level in value
};

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    deform_kernel(const DeformArgs p) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)p.batch * p.lq * p.heads) return;
  const int head = (int)(item % p.heads);
  const long long bq = item / p.heads;  // b * lq + q
  const int b = (int)(bq / p.lq);
  const T* value = static_cast<const T*>(p.value);
  const T* loc = static_cast<const T*>(p.loc) + item * p.points * 2;
  const T* att = static_cast<const T*>(p.att) + item * p.points;
  // row r of the value map starts at element (b * len_v + r) * heads * c
  const long long row_elems = (long long)p.heads * p.c;
  const T* vbase = value + (long long)b * p.len_v * row_elems + (long long)head * p.c;

  float acc[MAX_C / 32];
#pragma unroll
  for (int i = 0; i < MAX_C / 32; ++i) acc[i] = 0.f;

  for (int p0 = 0; p0 < p.points; p0 += 32) {
    // lane j prepares point p0 + j: four tap rows and four weights
    const int pt = p0 + lane;
    long long tap_row[4] = {0, 0, 0, 0};
    float tap_w[4] = {0.f, 0.f, 0.f, 0.f};
    if (pt < p.points) {
      int l = 0;
#pragma unroll
      for (int i = 1; i < MAX_LEVELS; ++i)
        if (i < p.levels && pt >= p.pstart[i]) l = i;
      const int H = p.h[l], W = p.w[l];
      const float px = to_f32(loc[2 * pt]) * (float)W - 0.5f;
      const float py = to_f32(loc[2 * pt + 1]) * (float)H - 0.5f;
      const float a = to_f32(att[pt]);
      const float x0f = floorf(px), y0f = floorf(py);
      const float wx = px - x0f, wy = py - y0f;
      // in-bounds tests on floats: a far-off (or NaN) location never
      // reaches an integer conversion
      const bool x0ok = x0f >= 0.f && x0f <= (float)(W - 1);
      const bool x1ok = x0f >= -1.f && x0f <= (float)(W - 2);
      const bool y0ok = y0f >= 0.f && y0f <= (float)(H - 1);
      const bool y1ok = y0f >= -1.f && y0f <= (float)(H - 2);
      const bool ok[4] = {y0ok && x0ok, y0ok && x1ok, y1ok && x0ok, y1ok && x1ok};
      const float wts[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx,
                            wy * (1.f - wx), wy * wx};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (!ok[t]) continue;
        const int xi = (int)x0f + (t & 1), yi = (int)y0f + (t >> 1);
        tap_row[t] = p.start[l] + (long long)yi * W + xi;
        tap_w[t] = a * wts[t];
      }
    }
    const int n = min(32, p.points - p0);
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float wt = __shfl_sync(0xffffffffu, tap_w[t], j);
        const long long row = __shfl_sync(0xffffffffu, tap_row[t], j);
        if (wt == 0.f) continue;  // outside the map (or a zero weight)
        const T* v = vbase + row * row_elems;
#pragma unroll
        for (int i = 0; i < MAX_C / 32; ++i) {
          const int ch = lane + 32 * i;
          if (ch < p.c) acc[i] += wt * to_f32(v[ch]);
        }
      }
    }
  }

  T* out = static_cast<T*>(p.out) + item * p.c;
#pragma unroll
  for (int i = 0; i < MAX_C / 32; ++i) {
    const int ch = lane + 32 * i;
    if (ch < p.c) out[ch] = from_f32<T>(acc[i]);
  }
}

template <typename T>
int launch(const DeformArgs& p, cudaStream_t s) {
  const long long items = (long long)p.batch * p.lq * p.heads;
  const long long blocks = (items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  deform_kernel<T><<<(unsigned)blocks, WARPS * 32, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// shapes_hw: (levels, 2) as (H, W); num_points: (levels,)
extern "C" int yt_ms_deformable_attention(
    int dtype, const void* value, const void* loc, const void* att, void* out,
    int batch, long long len_v, int heads, int c, int lq, int levels,
    const int* shapes_hw, const int* num_points, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || c <= 0 || c > MAX_C ||
      levels <= 0 || levels > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  DeformArgs p{};
  p.value = value;
  p.loc = loc;
  p.att = att;
  p.out = out;
  p.len_v = len_v;
  p.batch = batch;
  p.heads = heads;
  p.c = c;
  p.lq = lq;
  p.levels = levels;
  long long rows = 0;
  int points = 0;
  for (int l = 0; l < levels; ++l) {
    const int h = shapes_hw[2 * l], w = shapes_hw[2 * l + 1];
    if (h <= 0 || w <= 0 || num_points[l] <= 0) return (int)cudaErrorInvalidValue;
    p.h[l] = h;
    p.w[l] = w;
    p.start[l] = rows;
    p.pstart[l] = points;
    rows += (long long)h * w;
    points += num_points[l];
  }
  if (rows != len_v) return (int)cudaErrorInvalidValue;
  p.points = points;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == YT_BF16) return launch<bf16>(p, s);
  if (dtype == YT_F32) return launch<float>(p, s);
  return (int)cudaErrorInvalidValue;
}

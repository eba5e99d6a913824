// Multi-scale deformable attention (RT-DETRv2 decoder cross-attention):
//   out[b, q, h*c + ch] = sum over levels l, points p of level l:
//       att[b, q, h, p] * bilinear(V_l[b, :, :, h, ch], loc[b, q, h, p])
// with grid_sample's semantics (bilinear, zeros padding, align_corners =
// False): pixel coordinates loc.x * W_l - 0.5, loc.y * H_l - 0.5, and each of
// the four taps that falls outside the map contributes zero.  value is
// (B, Len_v, nh, c), the levels' maps flattened row-major one after another;
// loc (B, Lq, nh, P, 2) and att (B, Lq, nh, P) with the points of level 0
// first; out (B, Lq, nh * c).  All contiguous and of one storage type; f32
// sums over every point of every level, one rounding at the store.
//
// Replaces yomitoku_tpu/ops/pallas/deformable_attention.py
// (ms_deformable_attention).  The TPU has no fast gather, so the Pallas kernel
// recast each point's bilinear sample as two 2-sparse matrix products over a
// whole level map held in VMEM, one launch per level, summed outside.
//
// What bounds it on the H100: reading tap rows.  Per image the value is
// 8400 x 256 bf16 = 4.3 MB, which stays in the 50 MB L2; an item (batch,
// query, head) reads 4 P rows of c * sizeof(T) bytes (48 rows of 64 bytes at
// P = 12, c = 32 in bf16) and does about 2 FLOP per byte it reads.  No
// product here is worth a tensor core, so there is no wgmma; TMA has no
// gather mode, and a box per 64-byte row would cost a descriptor and a
// barrier per row, so there is no TMA: the kernel is a gather of 16-byte
// read-only vector loads, served from L2.
//
// What holds a gather back is latency: an L2 round trip is ~600 cycles, and
// a warp that walks its taps one at a time waits for one round trip per tap.
// So every tap of a chunk of points is in flight at once:
//  - one warp per item, heads innermost (a block's warps share a query's
//    lines); a tap row's c channels are split over G lanes of 16 bytes each
//    (G = 4 for bf16 at c = 32), so one load instruction reads 32 / G taps;
//  - per chunk of points, lane j reads point j's location and weight
//    (neighbouring lanes on neighbouring addresses) and writes its four taps'
//    (row, weight) to the warp's tap table in shared memory.  A tap off the
//    map gets a clamped in-map row and weight 0; the test is made on floats
//    before any integer conversion, so a NaN or far-off location contributes
//    exactly 0.  No load waits on a data-dependent branch;
//  - each lane reads its own taps' entries and issues all their loads before
//    any arithmetic: 6 loads in flight per lane at P = 12 in bf16.  At most
//    MAX_TPL taps per lane per chunk keep the registers free of spills, and
//    the launch bounds' MIN_BLOCKS give ptxas room for all of them (left to
//    itself it held the bf16 kernel to 64 registers and put the sums of the
//    first taps between the loads of the later ones);
//  - the tap groups' partial sums meet by __shfl_xor_sync in a fixed order
//    (no atomics: the same bits every run), and one group stores the output
//    row as 16-byte vectors;
//  - four warps per block: RT-DETR's 2,400 items at Lq = 300 are 600
//    blocks, 4-5 on every SM of the card;
//  - a tap's row is a 32-bit index (Len_v < 2^31: the C entry checks) that
//    one widening multiply turns into an offset from the item's 64-bit
//    base, so one instantiation serves any B * Len_v * nh * c.
// The scalar route takes rows whose bytes are not a multiple of 16 or a value
// whose base is not 16-byte aligned: the same structure with one group of
// 32 lanes over the row, each loading single elements (channels lane + 32 e).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_C = 128;   // channels per head
constexpr int WARPS = 4;     // warps (items) per block
constexpr int MIN_BLOCKS = 4;  // per SM: at most 128 registers a thread
constexpr int MAX_TPL = 8;   // taps per lane per chunk

// Routes (ops/_common.py DEFORM_ROUTES)
enum { ROUTE_VECTOR = 1, ROUTE_SCALAR = 2 };

struct DeformArgs {
  const void* value;
  const void* loc;
  const void* att;
  void* out;
  long long len_v, items;
  int heads, c, lq, levels, points;
  int h[MAX_LEVELS], w[MAX_LEVELS], start[MAX_LEVELS], pstart[MAX_LEVELS];
};

// What one lane loads of one tap row: a 16-byte vector of V elements, or
// one element.
template <typename T, int V>
using Raw = typename std::conditional<V * sizeof(T) == 16, uint4, T>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* src) {
  if constexpr (V * sizeof(T) == 16)
    return __ldg(reinterpret_cast<const uint4*>(src));
  else
    return __ldg(src);
}

template <typename T, int V>
__device__ __forceinline__ void fma_raw(float* acc, const Raw<T, V>& r, float w) {
  if constexpr (V * sizeof(T) == 16) {
    float f[V];
    if constexpr (sizeof(T) == 2) {
      unpack8(r, f);
    } else {
      f[0] = __uint_as_float(r.x);
      f[1] = __uint_as_float(r.y);
      f[2] = __uint_as_float(r.z);
      f[3] = __uint_as_float(r.w);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(w, f[i], acc[i]);
  } else {
    acc[0] = fmaf(w, to_f32(r), acc[0]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* dst, const float* acc) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 v;
    if constexpr (sizeof(T) == 2)
      v = pack8(acc);
    else
      v = make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                     __float_as_uint(acc[2]), __float_as_uint(acc[3]));
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    *dst = from_f32<T>(acc[0]);
  }
}

// G lanes per tap row, V elements per load, E loads per lane and tap (lane s
// of a group holds channels s * V + e * G * V + i, i < V, e < E).
template <typename T, int G, int V, int E>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    deform_gather_kernel(const DeformArgs p) {
  constexpr int NG = 32 / G;                                // tap groups
  constexpr int TPL = 4 * G < MAX_TPL ? 4 * G : MAX_TPL;  // taps per lane
  constexpr int CP = NG * TPL / 4;                          // points per chunk
  static_assert(CP >= 1 && CP <= 32, "a chunk's points are one per lane");
  __shared__ int2 table[WARPS][4 * CP];  // (row, weight bits) of each tap

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / G, s = lane % G;
  const long long item = (long long)blockIdx.x * WARPS + warp;
  if (item >= p.items) return;  // the whole warp
  const int head = (int)(item % p.heads);
  const long long b = item / p.heads / p.lq;
  const T* loc = static_cast<const T*>(p.loc) + item * p.points * 2;
  const T* att = static_cast<const T*>(p.att) + item * p.points;
  const int row_elems = p.heads * p.c;
  const T* vbase = static_cast<const T*>(p.value) + b * p.len_v * row_elems +
                   (long long)head * p.c + s * V;
  int2* tab = table[warp];

  bool live[E];
#pragma unroll
  for (int e = 0; e < E; ++e) live[e] = s * V + e * G * V < p.c;
  float acc[V * E];
#pragma unroll
  for (int i = 0; i < V * E; ++i) acc[i] = 0.f;

  for (int p0 = 0; p0 < p.points; p0 += CP) {
    const int n = min(CP, p.points - p0);
    if (lane < n) {  // point p0 + lane -> its four taps
      const int pt = p0 + lane;
      const float x = to_f32(__ldg(loc + 2 * pt)), y = to_f32(__ldg(loc + 2 * pt + 1));
      const float a = to_f32(__ldg(att + pt));
      int H = p.h[0], W = p.w[0], start = p.start[0];
#pragma unroll
      for (int l = 1; l < MAX_LEVELS; ++l)
        if (l < p.levels && pt >= p.pstart[l]) {
          H = p.h[l];
          W = p.w[l];
          start = p.start[l];
        }
      const float px = x * (float)W - 0.5f, py = y * (float)H - 0.5f;
      const float x0 = floorf(px), y0 = floorf(py);
      const float wx = px - x0, wy = py - y0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xf = x0 + (float)(k & 1), yf = y0 + (float)(k >> 1);
        // on floats: NaN and far-off coordinates fail here, never convert
        const bool in = xf >= 0.f && xf <= (float)(W - 1) && yf >= 0.f &&
                        yf <= (float)(H - 1);
        const int xi = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
        const int yi = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
        const float wt = ((k & 1) ? wx : 1.f - wx) * ((k >> 1) ? wy : 1.f - wy) * a;
        tab[4 * lane + k] = make_int2(start + yi * W + xi, __float_as_int(in ? wt : 0.f));
      }
    }
    __syncwarp();
    // every tap of the chunk in flight, then the arithmetic
    Raw<T, V> raw[TPL][E];
    float wt[TPL];
#pragma unroll
    for (int k = 0; k < TPL; ++k) {
      const int t = g + NG * k;
      const bool on = t < 4 * n;
      const int2 entry = on ? tab[t] : make_int2(0, 0);
      wt[k] = __int_as_float(entry.y);
      const T* src = vbase + (long long)entry.x * row_elems;
#pragma unroll
      for (int e = 0; e < E; ++e)
        raw[k][e] = on && live[e] ? load_raw<T, V>(src + e * G * V) : Raw<T, V>{};
    }
#pragma unroll
    for (int k = 0; k < TPL; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) fma_raw<T, V>(acc + e * V, raw[k][e], wt[k]);
    __syncwarp();  // the table is rewritten by the next chunk
  }

#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < V * E; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  if (g == 0) {
    T* out = static_cast<T*>(p.out) + item * p.c + s * V;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (live[e]) store_row<T, V>(out + e * G * V, acc + e * V);
  }
}

template <typename T, int G, int V, int E>
int launch(const DeformArgs& p, cudaStream_t s) {
  const long long blocks = (p.items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  deform_gather_kernel<T, G, V, E><<<(unsigned)blocks, WARPS * 32, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The vector route with G = the 16-byte pieces of a row, to a power of two.
template <typename T>
int route_launch(int route, const DeformArgs& p, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (route == ROUTE_SCALAR) return launch<T, 32, 1, MAX_C / 32>(p, s);
  if (route != ROUTE_VECTOR || p.c % V != 0 ||
      reinterpret_cast<uintptr_t>(p.value) % 16 != 0)
    return YT_ERR_ROUTE;
  const int pieces = p.c / V;
  if (pieces <= 1) return launch<T, 1, V, 1>(p, s);
  if (pieces <= 2) return launch<T, 2, V, 1>(p, s);
  if (pieces <= 4) return launch<T, 4, V, 1>(p, s);
  if (pieces <= 8) return launch<T, 8, V, 1>(p, s);
  if (pieces <= 16) return launch<T, 16, V, 1>(p, s);
  if constexpr (V == 4) return launch<T, 32, V, 1>(p, s);  // f32, c <= 128
  return YT_ERR_ROUTE;
}

}  // namespace

// route: ROUTE_VECTOR (c * sizeof(T) % 16 == 0 and a 16-byte aligned value)
// or ROUTE_SCALAR; shapes_hw: (levels, 2) as (H, W); num_points: (levels,).
extern "C" int yt_ms_deformable_attention(
    int route, int dtype, const void* value, const void* loc, const void* att,
    void* out, int batch, long long len_v, int heads, int c, int lq, int levels,
    const int* shapes_hw, const int* num_points, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || c <= 0 || c > MAX_C ||
      levels <= 0 || levels > MAX_LEVELS || len_v > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DeformArgs p{};
  p.value = value;
  p.loc = loc;
  p.att = att;
  p.out = out;
  p.len_v = len_v;
  p.items = (long long)batch * lq * heads;
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
    p.start[l] = (int)rows;
    p.pstart[l] = points;
    rows += (long long)h * w;
    points += num_points[l];
  }
  if (rows != len_v) return (int)cudaErrorInvalidValue;
  p.points = points;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == YT_BF16) return route_launch<bf16>(route, p, s);
  if (dtype == YT_F32) return route_launch<float>(route, p, s);
  return (int)cudaErrorInvalidValue;
}

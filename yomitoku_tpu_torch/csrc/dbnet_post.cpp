// DBNet probability-map postprocessing (native), the port's copy of
// yomitoku_tpu/native/dbnet_post.cpp (its dbnet_boxes entry points).
//
// Reference behavior: yomitoku/postprocessor/dbnet_postporcessor.py —
// threshold, per-region min-area-rect quads, box score, size-adaptive
// unclip, rescale.  The reference delegates to OpenCV + pyclipper C++
// wheels; this is the framework's own implementation:
//
//   * run-length connected-component labeling (8-connectivity, one pass
//     with union-find over row runs),
//   * convex hull (monotone chain) over per-row extremal pixels — every
//     hull vertex is an x-extreme of its row, so 2 points/row suffice,
//   * min-area rectangle by rotating calipers over hull edges,
//   * score = mean probability over the filled outer contour, i.e. the
//     component's foreground pixels PLUS any pixels lying between two
//     runs of the component on the same row that are not part of
//     border-connected background (enclosed holes, nested components) —
//     this matches the reference's cv2.fillPoly(outer contour) score on
//     solid, concave, and hollow blobs alike.  (The reference's
//     RETR_LIST additionally emits each *hole boundary* as its own
//     candidate contour; those score ≈ the hole's low probabilities and
//     fall below box_thresh, so they are deliberately not emulated.)
//   * analytic unclip: grow the rect by d = area*ratio/perimeter with
//     ratio = unclip_ratio / sqrt(min AABB side), as in the Python path.
//
// Built at first use with the host's g++ -O2 -shared into
// build/yomitoku_tpu_torch/ (ops/_build.py), bound via ctypes in
// yomitoku_tpu_torch/native/__init__.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Run {
  int row, x0, x1;  // inclusive pixel span [x0, x1] on `row`
  int parent;
};

int find_root(std::vector<Run>& runs, int i) {
  while (runs[i].parent != i) {
    runs[i].parent = runs[runs[i].parent].parent;
    i = runs[i].parent;
  }
  return i;
}

void unite(std::vector<Run>& runs, int a, int b) {
  a = find_root(runs, a);
  b = find_root(runs, b);
  if (a != b) runs[b].parent = a;
}

struct Pt {
  double x, y;
};

double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain; input sorted by (x, y).  Returns CCW hull.
std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
              return a.x == b.x && a.y == b.y;
            }),
            pts.end());
  const int n = (int)pts.size();
  if (n <= 2) return pts;
  std::vector<Pt> h(2 * n);
  int k = 0;
  for (int i = 0; i < n; ++i) {  // lower
    while (k >= 2 && cross(h[k - 2], h[k - 1], pts[i]) <= 0) --k;
    h[k++] = pts[i];
  }
  for (int i = n - 2, t = k + 1; i >= 0; --i) {  // upper
    while (k >= t && cross(h[k - 2], h[k - 1], pts[i]) <= 0) --k;
    h[k++] = pts[i];
  }
  h.resize(k - 1);
  return h;
}

struct Rect {
  double cx, cy;   // center
  double ux, uy;   // unit axis 1
  double w, h;     // extents along (ux,uy) and its perpendicular
};

// Min-area rectangle via rotating calipers over hull edges.
bool min_area_rect(const std::vector<Pt>& hull, Rect* out) {
  const int m = (int)hull.size();
  if (m == 0) return false;
  if (m == 1) {
    *out = {hull[0].x, hull[0].y, 1.0, 0.0, 0.0, 0.0};
    return true;
  }
  double best = 1e30;
  for (int i = 0; i < m; ++i) {
    const Pt& a = hull[i];
    const Pt& b = hull[(i + 1) % m];
    double dx = b.x - a.x, dy = b.y - a.y;
    double len = std::sqrt(dx * dx + dy * dy);
    if (len < 1e-12) continue;
    double ux = dx / len, uy = dy / len;
    double lo1 = 1e30, hi1 = -1e30, lo2 = 1e30, hi2 = -1e30;
    for (const Pt& p : hull) {
      double t1 = p.x * ux + p.y * uy;
      double t2 = -p.x * uy + p.y * ux;
      lo1 = std::min(lo1, t1); hi1 = std::max(hi1, t1);
      lo2 = std::min(lo2, t2); hi2 = std::max(hi2, t2);
    }
    double area = (hi1 - lo1) * (hi2 - lo2);
    if (area < best) {
      best = area;
      double c1 = 0.5 * (lo1 + hi1), c2 = 0.5 * (lo2 + hi2);
      out->cx = c1 * ux - c2 * uy;
      out->cy = c1 * uy + c2 * ux;
      out->ux = ux;
      out->uy = uy;
      out->w = hi1 - lo1;
      out->h = hi2 - lo2;
    }
  }
  return best < 1e30;
}

void rect_corners(const Rect& r, double halfw, double halfh, Pt c[4]) {
  double px = -r.uy, py = r.ux;  // perpendicular axis
  c[0] = {r.cx - r.ux * halfw - px * halfh, r.cy - r.uy * halfw - py * halfh};
  c[1] = {r.cx + r.ux * halfw - px * halfh, r.cy + r.uy * halfw - py * halfh};
  c[2] = {r.cx + r.ux * halfw + px * halfh, r.cy + r.uy * halfw + py * halfh};
  c[3] = {r.cx - r.ux * halfw + px * halfh, r.cy - r.uy * halfw + py * halfh};
}

// reference get_mini_boxes ordering: sort by x, then pick by y.
void order_quad(Pt c[4], Pt out[4]) {
  int idx[4] = {0, 1, 2, 3};
  std::stable_sort(idx, idx + 4, [&](int a, int b) { return c[a].x < c[b].x; });
  int i1, i2, i3, i4;
  if (c[idx[1]].y > c[idx[0]].y) { i1 = idx[0]; i4 = idx[1]; }
  else { i1 = idx[1]; i4 = idx[0]; }
  if (c[idx[3]].y > c[idx[2]].y) { i2 = idx[2]; i3 = idx[3]; }
  else { i2 = idx[3]; i3 = idx[2]; }
  out[0] = c[i1]; out[1] = c[i2]; out[2] = c[i3]; out[3] = c[i4];
}

}  // namespace

// Core implementation, parametrized over the probability element type so
// the TPU's u8 wire map postprocesses without a host-side float conversion
// (75+ ms for a 1280x960 page on a 1-core host).  thresh_t is the
// threshold in the element's domain (thresh for float maps, thresh*255
// for u8); pscale maps accumulated sums back to [0, 1] for the score.
template <typename T>
static int dbnet_boxes_impl(
    const T* prob, int h, int w,
    float thresh_t, float pscale,
    float box_thresh, float unclip_ratio,
    int min_size, int max_candidates,
    int dest_w, int dest_h,
    int16_t* quads_out,   // max_candidates * 8
    float* scores_out) {  // max_candidates
  // --- 1. run-length connected components (8-connectivity) ------------
  std::vector<Run> runs;
  runs.reserve(1024);
  std::vector<int> fg_row_start(h + 1, 0);  // runs of row y: [start[y], start[y+1])
  int prev_lo = 0, prev_hi = 0;  // [prev_lo, prev_hi) runs of row-1
  for (int y = 0; y < h; ++y) {
    const T* row = prob + (size_t)y * w;
    int cur_lo = (int)runs.size();
    fg_row_start[y] = cur_lo;
    int x = 0;
    while (x < w) {
      if (row[x] > thresh_t) {
        int x0 = x;
        while (x < w && row[x] > thresh_t) ++x;
        Run r{y, x0, x - 1, (int)runs.size()};
        runs.push_back(r);
      } else {
        ++x;
      }
    }
    int cur_hi = (int)runs.size();
    // union with 8-connected overlapping runs of the previous row
    int j = prev_lo;
    for (int i = cur_lo; i < cur_hi; ++i) {
      while (j < prev_hi && runs[j].x1 < runs[i].x0 - 1) ++j;
      for (int k = j; k < prev_hi && runs[k].x0 <= runs[i].x1 + 1; ++k)
        unite(runs, i, k);
    }
    prev_lo = cur_lo;
    prev_hi = cur_hi;
  }
  fg_row_start[h] = (int)runs.size();

  // --- 1b. background runs (4-connectivity), border-connected marking --
  // Needed for contour-fill scoring: a gap between two foreground runs of
  // one component is inside the filled outer contour iff its background
  // is NOT connected to the image border (i.e. it is a hole).
  std::vector<Run> bg;
  bg.reserve(runs.size() + h);
  std::vector<int> bg_row_start(h + 1, 0);
  std::vector<uint8_t> bg_border;  // per bg run: touches the image border
  {
    int bprev_lo = 0, bprev_hi = 0;
    for (int y = 0; y < h; ++y) {
      bg_row_start[y] = (int)bg.size();
      int cur_lo = (int)bg.size();
      int x = 0;
      int fi = fg_row_start[y];
      const int fe = fg_row_start[y + 1];
      while (x < w) {
        // skip the foreground run starting at/below x, if any
        if (fi < fe && runs[fi].x0 <= x) {
          x = runs[fi].x1 + 1;
          ++fi;
          continue;
        }
        int x1 = (fi < fe) ? runs[fi].x0 - 1 : w - 1;
        bg.push_back(Run{y, x, x1, (int)bg.size()});
        bg_border.push_back(y == 0 || y == h - 1 || x == 0 || x1 == w - 1);
        x = x1 + 1;
      }
      int cur_hi = (int)bg.size();
      int j = bprev_lo;
      for (int i = cur_lo; i < cur_hi; ++i) {
        while (j < bprev_hi && bg[j].x1 < bg[i].x0) ++j;
        for (int k = j; k < bprev_hi && bg[k].x0 <= bg[i].x1; ++k)
          unite(bg, i, k);
      }
      bprev_lo = cur_lo;
      bprev_hi = cur_hi;
    }
    bg_row_start[h] = (int)bg.size();
  }
  // propagate the border flag to roots, then to every run
  std::vector<uint8_t> bg_outside(bg.size(), 0);
  for (int i = 0; i < (int)bg.size(); ++i)
    if (bg_border[i]) bg_outside[find_root(bg, i)] = 1;
  for (int i = 0; i < (int)bg.size(); ++i)
    bg_outside[i] = bg_outside[find_root(bg, i)];

  // --- 2. gather per-component stats ----------------------------------
  const int nr = (int)runs.size();
  std::vector<int> comp_of(nr);
  for (int i = 0; i < nr; ++i) {
    comp_of[i] = find_root(runs, i);
  }
  // map root -> dense id in order of first appearance
  std::vector<int> dense(nr, -1);
  std::vector<std::vector<int>> comp_runs;
  for (int i = 0; i < nr; ++i) {
    int root = comp_of[i];
    if (dense[root] < 0) {
      dense[root] = (int)comp_runs.size();
      comp_runs.emplace_back();
    }
    comp_runs[dense[root]].push_back(i);
  }

  // --- 3. per component: hull, rect, score, unclip ---------------------
  int n_out = 0;
  const int ncomp = (int)comp_runs.size();
  for (int ci = 0; ci < ncomp && ci < max_candidates; ++ci) {
    if (n_out >= max_candidates) break;
    const auto& rs = comp_runs[ci];
    // per-row extremes + prob sum/count
    double psum = 0.0;
    long long cnt = 0;
    std::vector<Pt> pts;
    pts.reserve(rs.size() * 2);
    // merge runs on the same row first (min/max per row)
    // (runs of a row are disjoint; use each run's endpoints directly —
    //  hull of endpoints == hull of row extremes)
    for (size_t ii = 0; ii < rs.size(); ++ii) {
      const Run& r = runs[rs[ii]];
      pts.push_back({(double)r.x0, (double)r.row});
      pts.push_back({(double)r.x1, (double)r.row});
      const T* rowp = prob + (size_t)r.row * w;
      for (int xx = r.x0; xx <= r.x1; ++xx) psum += rowp[xx];
      cnt += r.x1 - r.x0 + 1;
      // Contour-fill score: the previous run of this component on the
      // same row leaves a gap; pixels in it count unless they belong to
      // border-connected background (run indices are row-major, so the
      // predecessor in `rs` is the left neighbor when rows match).
      if (ii == 0) continue;
      const Run& pr = runs[rs[ii - 1]];
      if (pr.row != r.row || pr.x1 + 1 >= r.x0) continue;
      int bi = bg_row_start[r.row];
      const int be = bg_row_start[r.row + 1];
      for (int xx = pr.x1 + 1; xx < r.x0; ++xx) {
        if (rowp[xx] > thresh_t) {  // another component nested in the gap
          psum += rowp[xx];
          ++cnt;
          continue;
        }
        while (bi < be && bg[bi].x1 < xx) ++bi;
        if (bi < be && bg[bi].x0 <= xx && !bg_outside[bi]) {
          psum += rowp[xx];
          ++cnt;
        }
      }
    }
    std::vector<Pt> hull = convex_hull(std::move(pts));
    Rect rect;
    if (!min_area_rect(hull, &rect)) continue;
    if (std::min(rect.w, rect.h) < (double)min_size) continue;
    float score = cnt ? (float)(psum / (double)cnt) * pscale : 0.0f;
    if (score < box_thresh) continue;

    // analytic unclip (python unclip_rect)
    Pt c0[4];
    rect_corners(rect, rect.w * 0.5, rect.h * 0.5, c0);
    double minx = 1e30, maxx = -1e30, miny = 1e30, maxy = -1e30;
    for (int k = 0; k < 4; ++k) {
      minx = std::min(minx, c0[k].x); maxx = std::max(maxx, c0[k].x);
      miny = std::min(miny, c0[k].y); maxy = std::max(maxy, c0[k].y);
    }
    double box_dist = std::min(maxx - minx, maxy - miny);
    double neww = rect.w, newh = rect.h;
    if (box_dist > 0) {
      double ratio = (double)unclip_ratio / std::sqrt(box_dist);
      double area = rect.w * rect.h;
      double length = 2.0 * (rect.w + rect.h);
      if (length > 0) {
        double distance = area * ratio / length;
        neww = rect.w + 2.0 * distance;
        newh = rect.h + 2.0 * distance;
      }
    }
    if (std::min(neww, newh) < (double)(min_size + 2)) continue;

    Pt grown[4], ordered[4];
    Rect grect = rect;
    rect_corners(grect, neww * 0.5, newh * 0.5, grown);
    order_quad(grown, ordered);

    for (int k = 0; k < 4; ++k) {
      double qx = std::nearbyint(ordered[k].x / (double)w * dest_w);
      double qy = std::nearbyint(ordered[k].y / (double)h * dest_h);
      qx = std::max(0.0, std::min((double)dest_w, qx));
      qy = std::max(0.0, std::min((double)dest_h, qy));
      quads_out[n_out * 8 + k * 2 + 0] = (int16_t)qx;
      quads_out[n_out * 8 + k * 2 + 1] = (int16_t)qy;
    }
    scores_out[n_out] = score;
    ++n_out;
  }
  return n_out;
}

extern "C" int dbnet_boxes(
    const float* prob, int h, int w,
    float thresh, float box_thresh, float unclip_ratio,
    int min_size, int max_candidates,
    int dest_w, int dest_h,
    int16_t* quads_out, float* scores_out) {
  return dbnet_boxes_impl<float>(
      prob, h, w, thresh, 1.0f, box_thresh, unclip_ratio,
      min_size, max_candidates, dest_w, dest_h, quads_out, scores_out);
}

// u8 wire-map entry point: v/255 > thresh  <=>  v > thresh*255 (no u8
// value lands on the boundary for the config thresholds), and the score
// sum rescales by 1/255 — bit-identical decisions to converting the map
// to float32 first, without the conversion.
extern "C" int dbnet_boxes_u8(
    const unsigned char* prob, int h, int w,
    float thresh, float box_thresh, float unclip_ratio,
    int min_size, int max_candidates,
    int dest_w, int dest_h,
    int16_t* quads_out, float* scores_out) {
  return dbnet_boxes_impl<unsigned char>(
      prob, h, w, thresh * 255.0f, 1.0f / 255.0f, box_thresh, unclip_ratio,
      min_size, max_candidates, dest_w, dest_h, quads_out, scores_out);
}

// Anti-aliased polygon scanline rasterizer (cell coverage algorithm).
//
// Native-code equivalent of the glyph/path rasterization the reference
// delegates to pdfium (C++) via pypdfium2; the port's copy of
// yomitoku_tpu/native/rasterizer.cpp.
// Fills a flattened edge list with nonzero-winding or even-odd rule into an
// 8-bit coverage mask; exact-area antialiasing per cell, FreeType-"smooth"
// style.
//
// Build: g++ -O2 -shared -fPIC -o librasterizer.so rasterizer.cpp
//
// API (C):
//   fill_edges(edges, n_edges, w, h, fill_rule, out)
//     edges: float[n_edges*4] as x0,y0,x1,y1 in pixel coords (y down)
//     fill_rule: 0 = nonzero, 1 = even-odd
//     out: uint8[w*h] coverage (0..255), caller-zeroed

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct Cell {
    float cover;  // signed sub-pixel height crossed in this cell
    float area;   // signed area to the right-side correction
};

// Accumulate one edge into the cell grid.  Standard approach: walk the
// edge scanline by scanline; within a scanline, walk pixel by pixel,
// adding (cover, area) contributions.
static void accumulate_edge(float x0, float y0, float x1, float y1,
                            int w, int h, std::vector<Cell>& cells) {
    if (y0 == y1) return;  // horizontal edges contribute nothing

    float dir = 1.0f;
    if (y0 > y1) { std::swap(x0, x1); std::swap(y0, y1); dir = -1.0f; }

    // clip vertically to [0, h]
    if (y1 <= 0.0f || y0 >= (float)h) return;
    float dxdy = (x1 - x0) / (y1 - y0);
    if (y0 < 0.0f) { x0 += dxdy * (0.0f - y0); y0 = 0.0f; }
    if (y1 > (float)h) { x1 += dxdy * ((float)h - y1); y1 = (float)h; }

    int ys = (int)std::floor(y0);
    int ye = (int)std::ceil(y1);

    float ycur = y0;
    float xcur = x0;
    for (int sy = ys; sy < ye; ++sy) {
        float ynext = std::min((float)(sy + 1), y1);
        float seg_h = ynext - ycur;           // height within this scanline
        if (seg_h <= 0.0f) { ycur = ynext; continue; }
        float xnext = xcur + dxdy * seg_h;

        // walk horizontally within the scanline
        float xa = xcur, xb = xnext;
        float ha = ycur, hb = ynext;
        (void)ha; (void)hb;
        // ensure left-to-right walk for pixel iteration
        bool flipped = false;
        if (xa > xb) { std::swap(xa, xb); flipped = true; }

        int pxs = (int)std::floor(xa);
        int pxe = (int)std::floor(xb);
        // clamp to grid; contributions left of 0 act on column 0's left edge
        if (pxe < 0) {
            // whole span left of the grid: full cover at column 0
            int col = 0;
            Cell& c = cells[sy * (w + 1) + col];
            c.cover += dir * seg_h;
            c.area  += dir * seg_h * 1.0f;  // fully to the left => full area
            ycur = ynext; xcur = xnext; continue;
        }
        if (pxs >= w) {
            // whole span right of the grid: crossing counted at sentinel
            Cell& c = cells[sy * (w + 1) + w];
            c.cover += dir * seg_h;
            ycur = ynext; xcur = xnext; continue;
        }

        if (pxs == pxe) {
            // single pixel
            int col = std::max(0, pxs);
            float xmid = 0.5f * (xa + xb) - (float)col;
            xmid = std::min(std::max(xmid, 0.0f), 1.0f);
            Cell& c = cells[sy * (w + 1) + col];
            c.cover += dir * seg_h;
            c.area  += dir * seg_h * (1.0f - xmid);
        } else {
            // multiple pixels: split seg_h proportionally to x-extent
            float inv_dx = 1.0f / (xb - xa);
            float prev_x = xa;
            for (int px = pxs; px <= pxe; ++px) {
                float seg_r = std::min((float)(px + 1), xb);
                float part = (seg_r - prev_x) * inv_dx * seg_h;
                if (px >= 0 && px < w && part != 0.0f) {
                    float xm0 = std::max(prev_x - (float)px, 0.0f);
                    float xm1 = std::min(seg_r - (float)px, 1.0f);
                    float xmid = 0.5f * (xm0 + xm1);
                    Cell& c = cells[sy * (w + 1) + px];
                    float signed_part = (flipped ? part : part);
                    // direction of vertical crossing is `dir` regardless of
                    // horizontal walk order
                    c.cover += dir * signed_part;
                    c.area  += dir * signed_part * (1.0f - xmid);
                } else if (px < 0 && part != 0.0f) {
                    Cell& c = cells[sy * (w + 1) + 0];
                    c.cover += dir * part;
                    c.area  += dir * part;  // fully left
                } else if (px >= w && part != 0.0f) {
                    Cell& c = cells[sy * (w + 1) + w];
                    c.cover += dir * part;
                }
                prev_x = seg_r;
            }
        }
        ycur = ynext; xcur = xnext;
    }
}

}  // namespace

extern "C" {

void fill_edges(const float* edges, int n_edges, int w, int h,
                int fill_rule, uint8_t* out) {
    std::vector<Cell> cells((size_t)h * (w + 1));
    std::memset(cells.data(), 0, cells.size() * sizeof(Cell));

    for (int i = 0; i < n_edges; ++i) {
        accumulate_edge(edges[i * 4 + 0], edges[i * 4 + 1],
                        edges[i * 4 + 2], edges[i * 4 + 3], w, h, cells);
    }

    for (int y = 0; y < h; ++y) {
        float acc = 0.0f;
        const Cell* row = &cells[(size_t)y * (w + 1)];
        uint8_t* orow = &out[(size_t)y * w];
        for (int x = 0; x < w; ++x) {
            // coverage inside this pixel = running winding + cell's own
            // partial area
            float cov = acc + row[x].area;
            acc += row[x].cover;
            float a;
            if (fill_rule == 0) {
                a = std::fabs(cov);
                if (a > 1.0f) a = 1.0f;
            } else {
                a = std::fmod(std::fabs(cov), 2.0f);
                if (a > 1.0f) a = 2.0f - a;
            }
            int v = (int)(a * 255.0f + 0.5f);
            orow[x] = (uint8_t)std::min(v, 255);
        }
    }
}

}  // extern "C"

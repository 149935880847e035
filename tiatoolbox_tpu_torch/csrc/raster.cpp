// Host C++ of the port's annotation rendering: OpenCV's 8-connected drawing
// (LINE_8, shift 0) into a uint8 canvas of 1 to 4 interleaved channels, in
// place, clipped at the canvas edge. Built with g++ into a shared library
// with a plain C interface and loaded with ctypes
// (tiatoolbox_tpu_torch/native).
//
// It replaces the cv2 calls of tiatoolbox_tpu/utils/visualization.py:
// fillPoly (:308-311), polylines open and closed (:303, :313-323),
// drawContours (:123, a closed polyline), filled circle (:129, :153, :299)
// and line (:149). The walks are OpenCV's, with its fixed-point arithmetic:
//
// - a one-pixel line is the 8-connected Bresenham walk of LineIterator,
//   drawn left to right between the end points clipped to the canvas;
// - a thicker line is first clipped to the canvas grown by the thickness
//   on every side; then it is a convex polygon of four corners, offset from
//   the line by round(thickness / 2 * normal) in 16.16 fixed point, filled
//   scan line by scan line with its edges walked at sub-pixel precision,
//   plus a filled circle of radius (thickness + 1) / 2 at each capped end;
// - a filled circle is the integer midpoint walk filling one span per row;
// - fillPoly collects the edges of every contour in 16.16 fixed point
//   (clipped end points where an edge leaves the canvas), draws each as a
//   one-pixel line and fills between the sorted active edges row by row
//   with the even-odd rule, from the left edge rounded up to the right edge
//   rounded down.

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kShift = 16;
constexpr int64_t kOne = int64_t{1} << kShift;
constexpr int64_t kHalf = kOne >> 1;

struct Pt {
    int64_t x, y;
};

struct Canvas {
    uint8_t* data;
    int h, w, cn;
    const uint8_t* color;

    void hline(int y, int x1, int x2) const {
        uint8_t* p = data + (static_cast<int64_t>(y) * w + x1) * cn;
        for (int x = x1; x <= x2; ++x, p += cn) {
            std::memcpy(p, color, cn);
        }
    }
    void put(int64_t x, int64_t y) const {
        if (0 <= x && x < w && 0 <= y && y < h) {
            std::memcpy(data + (y * w + x) * cn, color, cn);
        }
    }
};

// cv::clipLine over a canvas of size (w, h) in the given units.
bool clip_line(int64_t w, int64_t h, Pt& p1, Pt& p2) {
    if (w <= 0 || h <= 0) {
        return false;
    }
    const int64_t right = w - 1, bottom = h - 1;
    int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += static_cast<int64_t>(static_cast<double>(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += static_cast<int64_t>(static_cast<double>(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += static_cast<int64_t>(static_cast<double>(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += static_cast<int64_t>(static_cast<double>(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// cv::Line with LineIterator(connectivity 8, leftToRight): integer end points.
void line1(const Canvas& c, Pt p1, Pt p2) {
    if (static_cast<uint64_t>(p1.x) >= static_cast<uint64_t>(c.w) ||
        static_cast<uint64_t>(p2.x) >= static_cast<uint64_t>(c.w) ||
        static_cast<uint64_t>(p1.y) >= static_cast<uint64_t>(c.h) ||
        static_cast<uint64_t>(p2.y) >= static_cast<uint64_t>(c.h)) {
        // cv::clipLine(Size, Point&, Point&) works in int64 and writes back ints
        if (!clip_line(c.w, c.h, p1, p2)) {
            return;
        }
        p1.x = static_cast<int>(p1.x);
        p1.y = static_cast<int>(p1.y);
        p2.x = static_cast<int>(p2.x);
        p2.y = static_cast<int>(p2.y);
    }
    int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
    int64_t sx = 1, sy = 1;
    if (dx < 0) {
        dx = -dx;
        dy = -dy;
        std::swap(p1, p2);
    }
    if (dy < 0) {
        dy = -dy;
        sy = -1;
    }
    const bool vert = dy > dx;
    if (vert) {
        std::swap(dx, dy);
        std::swap(sx, sy);
    }
    int64_t err = dx - (dy + dy);
    const int64_t plus_delta = dx + dx, minus_delta = -(dy + dy);
    // minus: the step along the major axis, taken every pixel; plus: the
    // minor step, taken where the error goes negative
    int64_t minus_x = sx, minus_y = 0, plus_x = 0, plus_y = sy;
    if (vert) {
        // (dx, sx) and (dy, sy) are swapped: the major axis is y
        std::swap(minus_x, minus_y);
        std::swap(plus_x, plus_y);
    }
    const int64_t count = dx + 1;
    int64_t x = p1.x, y = p1.y;
    for (int64_t i = 0; i < count; ++i) {
        c.put(x, y);
        const int64_t mask = err < 0 ? -1 : 0;
        err += minus_delta + (plus_delta & mask);
        x += minus_x + (plus_x & mask);
        y += minus_y + (plus_y & mask);
    }
}

// cv::Line2: a line between 16.16 fixed-point end points, one pixel wide.
void line2(const Canvas& c, Pt p1, Pt p2) {
    if (!clip_line(static_cast<int64_t>(c.w) << kShift, static_cast<int64_t>(c.h) << kShift, p1, p2)) {
        return;
    }
    int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
    const int64_t j = dx < 0 ? -1 : 0;
    const int64_t ax = (dx ^ j) - j;
    const int64_t i = dy < 0 ? -1 : 0;
    const int64_t ay = (dy ^ i) - i;
    int64_t x_step, y_step;
    int ecount;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        if (j) {
            std::swap(p1, p2);
        }
        x_step = kOne;
        y_step = dy * kOne / (ax | 1);
        ecount = static_cast<int>((p2.x - p1.x) >> kShift);
    } else {
        dx = (dx ^ i) - i;
        if (i) {
            std::swap(p1, p2);
        }
        x_step = dx * kOne / (ay | 1);
        y_step = kOne;
        ecount = static_cast<int>((p2.y - p1.y) >> kShift);
    }
    p1.x += kHalf;
    p1.y += kHalf;
    c.put(static_cast<int>((p2.x + kHalf) >> kShift), static_cast<int>((p2.y + kHalf) >> kShift));
    if (ax > ay) {
        p1.x >>= kShift;
        while (ecount >= 0) {
            c.put(static_cast<int>(p1.x), static_cast<int>(p1.y >> kShift));
            p1.x++;
            p1.y += y_step;
            ecount--;
        }
    } else {
        p1.y >>= kShift;
        while (ecount >= 0) {
            c.put(static_cast<int>(p1.x >> kShift), static_cast<int>(p1.y));
            p1.x += x_step;
            p1.y++;
            ecount--;
        }
    }
}

// cv::Circle filled: the midpoint walk, one span per row it reaches.
void circle(const Canvas& c, int cx, int cy, int radius) {
    int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
    const bool inside = cx >= radius && cx < c.w - radius && cy >= radius && cy < c.h - radius;
    while (dx >= dy) {
        const int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
        int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
        if (inside) {
            c.hline(y11, x11, x12);
            c.hline(y12, x11, x12);
            c.hline(y21, x21, x22);
            c.hline(y22, x21, x22);
        } else if (x11 < c.w && x12 >= 0 && y21 < c.h && y22 >= 0) {
            x11 = std::max(x11, 0);
            x12 = std::min(x12, c.w - 1);
            if (static_cast<unsigned>(y11) < static_cast<unsigned>(c.h)) c.hline(y11, x11, x12);
            if (static_cast<unsigned>(y12) < static_cast<unsigned>(c.h)) c.hline(y12, x11, x12);
            if (x21 < c.w && x22 >= 0) {
                x21 = std::max(x21, 0);
                x22 = std::min(x22, c.w - 1);
                if (static_cast<unsigned>(y21) < static_cast<unsigned>(c.h)) c.hline(y21, x21, x22);
                if (static_cast<unsigned>(y22) < static_cast<unsigned>(c.h)) c.hline(y22, x21, x22);
            }
        }
        dy++;
        err += plus;
        plus += 2;
        const int mask = (err <= 0) - 1;
        err -= minus & mask;
        dx += mask;
        minus -= mask & 2;
    }
}

// cv::FillConvexPoly for LINE_8 with vertices in 16.16 fixed point (shift 16).
void fill_convex(const Canvas& c, const Pt* v, int npts) {
    struct Edge {
        int idx, di;
        int64_t x, dx;
        int ye;
    } edge[2];
    const int shift = kShift;
    const int64_t delta = kHalf;  // 1 << shift >> 1
    int y, imin = 0;
    int edges = npts;
    int64_t xmin, xmax, ymin, ymax;
    Pt p0 = v[npts - 1];
    xmin = xmax = v[0].x;
    ymin = ymax = v[0].y;
    for (int i = 0; i < npts; ++i) {
        const Pt p = v[i];
        if (p.y < ymin) {
            ymin = p.y;
            imin = i;
        }
        ymax = std::max(ymax, p.y);
        xmax = std::max(xmax, p.x);
        xmin = std::min(xmin, p.x);
        line2(c, p0, p);
        p0 = p;
    }
    xmin = (xmin + delta) >> shift;
    xmax = (xmax + delta) >> shift;
    ymin = (ymin + delta) >> shift;
    ymax = (ymax + delta) >> shift;
    if (npts < 3 || static_cast<int>(xmax) < 0 || static_cast<int>(ymax) < 0 ||
        static_cast<int>(xmin) >= c.w || static_cast<int>(ymin) >= c.h) {
        return;
    }
    ymax = std::min<int64_t>(ymax, c.h - 1);
    edge[0].idx = edge[1].idx = imin;
    edge[0].ye = edge[1].ye = y = static_cast<int>(ymin);
    edge[0].di = 1;
    edge[1].di = npts - 1;
    edge[0].x = edge[1].x = -kOne;
    edge[0].dx = edge[1].dx = 0;
    do {
        for (int i = 0; i < 2; ++i) {
            if (y >= edge[i].ye) {
                int idx0 = edge[i].idx, di = edge[i].di;
                int idx = idx0 + di;
                if (idx >= npts) idx -= npts;
                int ty = 0;
                for (; edges-- > 0;) {
                    ty = static_cast<int>((v[idx].y + delta) >> shift);
                    if (ty > y) {
                        const int64_t xs = v[idx0].x;
                        const int64_t xe = v[idx].x;
                        edge[i].ye = ty;
                        edge[i].dx = ((xe - xs) * 2 + (static_cast<int64_t>(ty) - y)) /
                                     (2 * (static_cast<int64_t>(ty) - y));
                        edge[i].x = xs;
                        edge[i].idx = idx;
                        break;
                    }
                    idx0 = idx;
                    idx += di;
                    if (idx >= npts) idx -= npts;
                }
            }
        }
        if (edges < 0) {
            break;
        }
        if (y >= 0) {
            int left = 0, right = 1;
            if (edge[0].x > edge[1].x) {
                left = 1;
                right = 0;
            }
            int xx1 = static_cast<int>((edge[left].x + kHalf) >> kShift);
            int xx2 = static_cast<int>((edge[right].x + kHalf) >> kShift);
            if (xx2 >= 0 && xx1 < c.w) {
                if (xx1 < 0) xx1 = 0;
                if (xx2 >= c.w) xx2 = c.w - 1;
                c.hline(y, xx1, xx2);
            }
        }
        edge[0].x += edge[0].dx;
        edge[1].x += edge[1].dx;
    } while (++y <= static_cast<int>(ymax));
}

// cv::ThickLine for LINE_8 and shift 0; flags bit 0 caps p0, bit 1 caps p1.
void thick_line(const Canvas& c, Pt p0, Pt p1, int thickness, int flags) {
    if (thickness <= 1) {
        line1(c, p0, p1);
        return;
    }
    // the segment is first clipped to the canvas grown by the thickness on
    // every side; the caps sit on the clipped end points
    p0.x += thickness;
    p0.y += thickness;
    p1.x += thickness;
    p1.y += thickness;
    if (!clip_line(static_cast<int64_t>(c.w) + 2 * thickness, static_cast<int64_t>(c.h) + 2 * thickness, p0,
                   p1)) {
        return;
    }
    p0.x -= thickness;
    p0.y -= thickness;
    p1.x -= thickness;
    p1.y -= thickness;
    constexpr double kInvOne = 1.0 / static_cast<double>(kOne);
    p0.x <<= kShift;
    p0.y <<= kShift;
    p1.x <<= kShift;
    p1.y <<= kShift;
    const double dx = (p0.x - p1.x) * kInvOne, dy = (p1.y - p0.y) * kInvOne;
    double r = dx * dx + dy * dy;
    const int odd = thickness & 1;
    const int64_t t = static_cast<int64_t>(thickness) << (kShift - 1);
    if (std::fabs(r) > DBL_EPSILON) {
        r = (t + odd * kOne * 0.5) / std::sqrt(r);
        const Pt dp{std::lrint(dy * r), std::lrint(dx * r)};
        const Pt pt[4] = {{p0.x + dp.x, p0.y + dp.y},
                          {p0.x - dp.x, p0.y - dp.y},
                          {p1.x - dp.x, p1.y - dp.y},
                          {p1.x + dp.x, p1.y + dp.y}};
        fill_convex(c, pt, 4);
    }
    for (int i = 0; i < 2; ++i) {
        if (flags & (i + 1)) {
            const int cx = static_cast<int>((p0.x + kHalf) >> kShift);
            const int cy = static_cast<int>((p0.y + kHalf) >> kShift);
            circle(c, cx, cy, static_cast<int>((t + kHalf) >> kShift));
        }
        p0 = p1;
    }
}

// cv::PolyLine
void poly_line(const Canvas& c, const Pt* v, int count, bool closed, int thickness) {
    if (count <= 0) {
        return;
    }
    int i = closed ? count - 1 : 0;
    int flags = 2 + !closed;
    Pt p0 = v[i];
    for (i = !closed; i < count; ++i) {
        const Pt p = v[i];
        thick_line(c, p0, p, thickness, flags);
        p0 = p;
        flags = 2;
    }
}

struct PolyEdge {
    int y0, y1;
    int64_t x, dx;
    PolyEdge* next;
};

// cv::CollectPolyEdges for LINE_8, shift 0, no offset.
void collect_poly_edges(const Canvas& c, const Pt* v, int count, std::vector<PolyEdge>& edges) {
    Pt pt0 = v[count - 1], pt1;
    pt0.x <<= kShift;
    for (int i = 0; i < count; ++i, pt0 = pt1) {
        pt1 = v[i];
        pt1.x <<= kShift;
        Pt pt0c = pt0, pt1c = pt1;
        Pt t0{(pt0.x + kHalf) >> kShift, pt0.y};
        Pt t1{(pt1.x + kHalf) >> kShift, pt1.y};
        line1(c, t0, t1);
        if (pt0.y == pt1.y) {
            continue;
        }
        PolyEdge edge{};
        // An edge that leaves the canvas is walked along its clipped part:
        // its slope is that of the clipped end points, and an edge clipped to
        // one row keeps the clipped x on every row.
        bool flat = false;
        if (static_cast<uint64_t>(t0.x) >= static_cast<uint64_t>(c.w) ||
            static_cast<uint64_t>(t1.x) >= static_cast<uint64_t>(c.w) ||
            static_cast<uint64_t>(t0.y) >= static_cast<uint64_t>(c.h) ||
            static_cast<uint64_t>(t1.y) >= static_cast<uint64_t>(c.h)) {
            clip_line(c.w, c.h, t0, t1);
            pt0c = {t0.x << kShift, t0.y};
            pt1c = {t1.x << kShift, t1.y};
            flat = t0.y == t1.y;
        }
        if (flat) {
            edge.dx = 0;
            pt1c.x = pt0c.x;
        } else {
            edge.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
        }
        if (pt0.y < pt1.y) {
            edge.y0 = static_cast<int>(pt0.y);
            edge.y1 = static_cast<int>(pt1.y);
            edge.x = pt0c.x + (pt0.y - pt0c.y) * edge.dx;
        } else {
            edge.y0 = static_cast<int>(pt1.y);
            edge.y1 = static_cast<int>(pt0.y);
            edge.x = pt1c.x + (pt1.y - pt1c.y) * edge.dx;
        }
        edges.push_back(edge);
    }
}

// cv::FillEdgeCollection for LINE_8.
void fill_edge_collection(const Canvas& c, std::vector<PolyEdge>& edges) {
    PolyEdge tmp{};
    const int total = static_cast<int>(edges.size());
    int y_max = INT_MIN, y_min = INT_MAX;
    int64_t x_max = -1, x_min = INT64_MAX;
    if (total < 2) {
        return;
    }
    for (int i = 0; i < total; ++i) {
        const PolyEdge& e1 = edges[i];
        const int64_t x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
        y_min = std::min(y_min, e1.y0);
        y_max = std::max(y_max, e1.y1);
        x_min = std::min(x_min, e1.x);
        x_max = std::max(x_max, e1.x);
        x_min = std::min(x_min, x1);
        x_max = std::max(x_max, x1);
    }
    if (y_max < 0 || y_min >= c.h || x_max < 0 || x_min >= (static_cast<int64_t>(c.w) << kShift)) {
        return;
    }
    std::sort(edges.begin(), edges.end(), [](const PolyEdge& e1, const PolyEdge& e2) {
        return e1.y0 - e2.y0 ? e1.y0 < e2.y0 : e1.x - e2.x ? e1.x < e2.x : e1.dx < e2.dx;
    });
    tmp.y0 = INT_MAX;
    edges.push_back(tmp);
    int i = 0;
    tmp.next = nullptr;
    PolyEdge* e = &edges[i];
    y_max = std::min(y_max, c.h);
    for (int y = e->y0; y < y_max; ++y) {
        PolyEdge *last, *prelast, *keep_prelast;
        int draw = 0;
        const bool clipline = y < 0;
        prelast = &tmp;
        last = tmp.next;
        while (last || e->y0 == y) {
            if (last && last->y1 == y) {
                // the edge ends at this row
                prelast->next = last->next;
                last = last->next;
                continue;
            }
            keep_prelast = prelast;
            if (last && (e->y0 > y || last->x < e->x)) {
                prelast = last;
                last = last->next;
            } else if (i < total) {
                prelast->next = e;
                e->next = last;
                prelast = e;
                e = &edges[++i];
            } else {
                break;
            }
            if (draw) {
                if (!clipline) {
                    // the span runs from the left edge rounded up to the
                    // right edge rounded down
                    int x1, x2;
                    if (keep_prelast->x > prelast->x) {
                        x1 = static_cast<int>((prelast->x + kOne - 1) >> kShift);
                        x2 = static_cast<int>(keep_prelast->x >> kShift);
                    } else {
                        x1 = static_cast<int>((keep_prelast->x + kOne - 1) >> kShift);
                        x2 = static_cast<int>(prelast->x >> kShift);
                    }
                    if (x1 < c.w && x2 >= 0) {
                        if (x1 < 0) x1 = 0;
                        if (x2 >= c.w) x2 = c.w - 1;
                        c.hline(y, x1, x2);
                    }
                }
                keep_prelast->x += keep_prelast->dx;
                prelast->x += prelast->dx;
            }
            draw ^= 1;
        }
        // bubble sort of the active edges by x
        keep_prelast = nullptr;
        do {
            prelast = &tmp;
            last = tmp.next;
            PolyEdge* last_exchange = nullptr;
            while (last != keep_prelast && last->next != nullptr) {
                PolyEdge* te = last->next;
                if (last->x > te->x) {
                    prelast->next = te;
                    last->next = te->next;
                    te->next = last;
                    prelast = te;
                    last_exchange = prelast;
                } else {
                    prelast = last;
                    last = te;
                }
            }
            if (last_exchange == nullptr) {
                break;
            }
            keep_prelast = last_exchange;
        } while (keep_prelast != tmp.next && keep_prelast != &tmp);
    }
}

std::vector<Pt> to_points(const int32_t* xy, int64_t n) {
    std::vector<Pt> out(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        out[i] = {xy[2 * i], xy[2 * i + 1]};
    }
    return out;
}

}  // namespace

// Every entry draws into `img`, uint8 [h, w, cn] row-major, with `color`
// holding cn bytes. Contours are given as int32 (x, y) pairs, `counts[k]`
// points for contour k, one after the other.

// cv2.fillPoly(img, contours, color) at LINE_8.
extern "C" void raster_fill_poly(uint8_t* img, int h, int w, int cn, const int32_t* xy,
                                 const int32_t* counts, int ncontours, const uint8_t* color) {
    const Canvas c{img, h, w, cn, color};
    std::vector<PolyEdge> edges;
    int64_t offset = 0;
    for (int k = 0; k < ncontours; ++k) {
        if (counts[k] > 0) {
            const std::vector<Pt> pts = to_points(xy + 2 * offset, counts[k]);
            collect_poly_edges(c, pts.data(), counts[k], edges);
        }
        offset += counts[k];
    }
    fill_edge_collection(c, edges);
}

// cv2.polylines(img, contours, closed, color, thickness) at LINE_8; also
// cv2.drawContours(img, contours, -1, color, thickness) for thickness >= 0.
extern "C" void raster_polylines(uint8_t* img, int h, int w, int cn, const int32_t* xy,
                                 const int32_t* counts, int ncontours, int closed,
                                 const uint8_t* color, int thickness) {
    const Canvas c{img, h, w, cn, color};
    int64_t offset = 0;
    for (int k = 0; k < ncontours; ++k) {
        const std::vector<Pt> pts = to_points(xy + 2 * offset, counts[k]);
        poly_line(c, pts.data(), counts[k], closed != 0, thickness);
        offset += counts[k];
    }
}

// cv2.line(img, p0, p1, color, thickness) at LINE_8.
extern "C" void raster_line(uint8_t* img, int h, int w, int cn, int x0, int y0, int x1, int y1,
                            const uint8_t* color, int thickness) {
    const Canvas c{img, h, w, cn, color};
    thick_line(c, {x0, y0}, {x1, y1}, thickness, 3);
}

// cv2.circle(img, center, radius, color, -1) at LINE_8.
extern "C" void raster_circle(uint8_t* img, int h, int w, int cn, int cx, int cy, int radius,
                              const uint8_t* color) {
    const Canvas c{img, h, w, cn, color};
    circle(c, cx, cy, radius);
}

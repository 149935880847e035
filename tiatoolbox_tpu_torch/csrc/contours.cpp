// Host C++ contour tracer with holes: the counterpart of
// cv2.findContours(mask, RETR_CCOMP, CHAIN_APPROX_SIMPLE) that
// tiatoolbox_tpu/utils/store_conversion.py:82-117 (process_contours) calls.
// Built with g++ into a shared library with a plain C interface and loaded
// with ctypes (tiatoolbox_tpu_torch/native).
//
// The algorithm is OpenCV's (Suzuki and Abe, as its contour scanner runs
// it): the mask is padded by one background pixel, made 0/1, and scanned in
// raster order. A 0 -> 1 step starts an outer border at the 1; a step from a
// pixel >= 1 to a 0 starts a hole border at the pixel left of the 0 (a pixel
// already marked as the right edge of a traced border, a negative value,
// starts nothing). Each border is followed with the 8-neighbour follower:
// the first neighbour is searched clockwise (from up-left for an outer
// border, from down-right for a hole, so holes run the other way round), then
// each next one counter-clockwise from the one after the previous pixel. A
// pixel whose right neighbour was passed as background is marked
// `nbd | 0x80` (negative), an unvisited one `nbd`; a point is written where
// the direction changes (CHAIN_APPROX_SIMPLE), a lone pixel once.
//
// RETR_CCOMP: every outer border is a child of the frame; a hole's parent is
// the border that marked the last marked pixel left of it (`lnbd`), or that
// border's parent when it is a hole. A child is inserted at the head of its
// parent's list, and the result is the tree in pre-order, so outer borders
// come last-found first, each followed by its holes, last-found first.
// Hierarchy rows are [next, previous, first child, parent], -1 for none.

#include <cstddef>
#include <cstdint>
#include <new>
#include <vector>

namespace {

// chain codes: 0 right, 1 up-right, 2 up, 3 up-left, 4 left, 5 down-left,
// 6 down, 7 down-right (y grows downward)
constexpr int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
constexpr int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

struct Contour {
    bool hole = false;
    int parent = -1;  // index into contours, -1: the frame
    int first_child = -1;
    int next = -1;  // the sibling found before this one
    int prev = -1;
    std::vector<int32_t> points;  // x, y pairs in mask coordinates
};

struct Result {
    std::vector<Contour> contours;
    std::vector<int> order;  // pre-order of the tree
};

class Scanner {
public:
    Scanner(const uint8_t* mask, int h, int w)
        : h_(h + 2), w_(w + 2), img_(static_cast<std::size_t>(h_) * w_, 0),
          owner_(static_cast<std::size_t>(h_) * w_, -1) {
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                img_[static_cast<std::size_t>(y + 1) * w_ + x + 1] =
                    mask[static_cast<std::size_t>(y) * w + x] ? 1 : 0;
            }
        }
        for (int k = 0; k < 8; ++k) {
            delta_[k] = kDy[k] * w_ + kDx[k];
            delta_[k + 8] = delta_[k];
        }
    }

    void run(Result& out) {
        int nbd = 2;
        int frame_first_child = -1;
        for (int y = 1; y < h_ - 1; ++y) {
            int lnbd_x = 0;
            int lnbd_y = y;
            int prev = 0;
            const std::size_t row = static_cast<std::size_t>(y) * w_;
            for (int x = 1; x < w_ - 1; ++x) {
                const int p = img_[row + x];
                if (p == prev) {
                    continue;
                }
                bool hole = false;
                bool start = true;
                if (!(prev == 0 && p == 1)) {
                    if (p != 0 || prev < 1) {
                        start = false;
                    } else {
                        if (prev & -2) {
                            lnbd_x = x - 1;
                        }
                        hole = true;
                    }
                }
                if (start) {
                    int parent = -1;
                    if (hole && lnbd_x > 0) {
                        parent = owner_[static_cast<std::size_t>(lnbd_y) * w_ + lnbd_x];
                        if (parent >= 0 && out.contours[parent].hole) {
                            parent = out.contours[parent].parent;
                        }
                    }
                    lnbd_x = x - hole;
                    const int index = static_cast<int>(out.contours.size());
                    out.contours.emplace_back();
                    Contour& c = out.contours.back();
                    c.hole = hole;
                    c.parent = parent;
                    const int label = nbd;
                    nbd = (nbd + 1) & 127;
                    nbd += nbd == 0 ? 3 : 0;
                    follow(row + x - hole, y, x - hole, hole, label, index, c.points);
                    // insert at the head of the parent's children
                    int& head = parent >= 0 ? out.contours[parent].first_child : frame_first_child;
                    if (head >= 0) {
                        out.contours[head].prev = index;
                        out.contours[index].next = head;
                    }
                    head = index;
                    // the scan goes on from the next pixel with what is there now
                    prev = img_[row + x];
                    if (prev & -2) {
                        lnbd_x = x;
                    }
                    continue;
                }
                prev = p;
                if (prev & -2) {
                    lnbd_x = x;
                }
            }
        }
        // pre-order of the tree below the frame
        std::vector<int> stack;
        for (int c = frame_first_child; c >= 0;) {
            out.order.push_back(c);
            if (out.contours[c].first_child >= 0) {
                stack.push_back(c);
                c = out.contours[c].first_child;
                continue;
            }
            while (c >= 0 && out.contours[c].next < 0) {
                if (stack.empty()) {
                    c = -1;
                } else {
                    c = stack.back();
                    stack.pop_back();
                }
            }
            if (c >= 0) {
                c = out.contours[c].next;
            }
        }
    }

private:
    // Follow the border that starts at pixel `start` (row y, column x of the
    // padded image), marking its pixels with `label` and `index`.
    void follow(std::size_t start, int y, int x, bool hole, int label, int index,
                std::vector<int32_t>& points) {
        const int8_t right_mark = static_cast<int8_t>(label | 0x80);
        int s_end = hole ? 0 : 4;
        int s = s_end;
        std::size_t i1 = start;
        do {
            s = (s - 1) & 7;
            i1 = start + delta_[s];
        } while (img_[i1] == 0 && s != s_end);
        if (s == s_end) {  // a lone pixel
            img_[start] = right_mark;
            owner_[start] = index;
            points.push_back(x - 1);
            points.push_back(y - 1);
            return;
        }
        std::size_t i3 = start;
        std::size_t i4 = start;
        int prev_s = s ^ 4;
        int px = x;
        int py = y;
        for (;;) {
            s_end = s;
            while (s < 15) {
                i4 = i3 + delta_[++s];
                if (img_[i4] != 0) {
                    break;
                }
            }
            s &= 7;
            if (static_cast<unsigned>(s - 1) < static_cast<unsigned>(s_end)) {
                img_[i3] = right_mark;
                owner_[i3] = index;
            } else if (img_[i3] == 1) {
                img_[i3] = static_cast<int8_t>(label);
                owner_[i3] = index;
            }
            if (s != prev_s) {
                points.push_back(px - 1);
                points.push_back(py - 1);
            }
            prev_s = s;
            px += kDx[s];
            py += kDy[s];
            if (i4 == start && i3 == i1) {
                break;
            }
            i3 = i4;
            s = (s + 4) & 7;
        }
    }

    int h_;
    int w_;
    std::vector<int8_t> img_;
    std::vector<int32_t> owner_;
    int64_t delta_[16];
};

}  // namespace

// Trace `mask` (uint8 [h, w], nonzero is foreground). Returns a handle for
// ccomp_copy and ccomp_free, or null if memory ran out; `n_contours` and
// `n_points` receive the sizes ccomp_copy fills.
extern "C" void* ccomp_trace(const uint8_t* mask, int h, int w, int64_t* n_contours,
                             int64_t* n_points) {
    Result* result = new (std::nothrow) Result();
    if (result == nullptr) {
        return nullptr;
    }
    try {
        Scanner scanner(mask, h, w);
        scanner.run(*result);
    } catch (const std::bad_alloc&) {
        delete result;
        return nullptr;
    }
    int64_t total = 0;
    for (const Contour& c : result->contours) {
        total += static_cast<int64_t>(c.points.size() / 2);
    }
    *n_contours = static_cast<int64_t>(result->order.size());
    *n_points = total;
    return result;
}

// Copy the traced contours in output order: points (x, y) int32, offsets
// [n_contours + 1] into them, hierarchy int32 [n_contours, 4].
extern "C" void ccomp_copy(const void* handle, int32_t* points, int64_t* offsets,
                           int32_t* hierarchy) {
    const Result& r = *static_cast<const Result*>(handle);
    std::vector<int> rank(r.contours.size(), -1);
    for (std::size_t i = 0; i < r.order.size(); ++i) {
        rank[r.order[i]] = static_cast<int>(i);
    }
    const auto ranked = [&](int c) { return c >= 0 ? rank[c] : -1; };
    int64_t written = 0;
    for (std::size_t i = 0; i < r.order.size(); ++i) {
        const Contour& c = r.contours[r.order[i]];
        offsets[i] = written;
        for (std::size_t k = 0; k < c.points.size(); ++k) {
            points[2 * written + static_cast<int64_t>(k)] = c.points[k];
        }
        written += static_cast<int64_t>(c.points.size() / 2);
        hierarchy[4 * i] = ranked(c.next);
        hierarchy[4 * i + 1] = ranked(c.prev);
        hierarchy[4 * i + 2] = ranked(c.first_child);
        hierarchy[4 * i + 3] = ranked(c.parent);
    }
    offsets[r.order.size()] = written;
}

extern "C" void ccomp_free(void* handle) { delete static_cast<Result*>(handle); }

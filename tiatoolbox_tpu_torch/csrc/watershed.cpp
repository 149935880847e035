// Host C++ of the HoVer-Net instance post-processing: the marker watershed
// and the outer-border follower. Built with g++ into a shared library with a
// plain C interface and loaded with ctypes (tiatoolbox_tpu_torch/native).
//
// watershed_flood: the counterpart of tiatoolbox_tpu/native/watershed.cpp,
// with the semantics of skimage.segmentation.watershed(image, markers,
// mask=mask): a priority flood in ascending image value, first in first out
// among equal values, over 4-neighbours, growing labels only into masked
// unlabelled pixels. The image is float32 (the JAX wrapper casts float64 to
// float32 too, tiatoolbox_tpu/native/__init__.py:138).
//
// outer_contours: replaces cv2.findContours(mask, RETR_TREE,
// CHAIN_APPROX_SIMPLE)[0][0] of hovernet.py:555-558, the contour of one
// instance on its bounding-box crop. It follows the outer border of the
// 8-connected pixels `labels == id` from the instance's first pixel in
// raster order, with OpenCV's border follower (Suzuki and Abe): the search
// around the start goes clockwise from up-left, the walk counter-clockwise
// on the image (down first from a top-left corner), and a point is written
// where the chain direction changes (CHAIN_APPROX_SIMPLE), so collinear
// points are dropped and a pixel the border passes twice is written twice.
// Everything outside the image counts as background, as OpenCV pads the
// image, so shapes touching the crop's edge are traced as well. For a
// map holding one 8-connected instance (every watershed region is
// 4-connected) this is cv2's first contour.

#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Node {
    float value;
    uint64_t order;
    int64_t index;
};

struct Later {
    bool operator()(const Node& a, const Node& b) const {
        if (a.value != b.value) {
            return a.value > b.value;
        }
        return a.order > b.order;
    }
};

// OpenCV's chain codes: 0 right, 1 up-right, 2 up, 3 up-left, 4 left,
// 5 down-left, 6 down, 7 down-right (y grows downward).
constexpr int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
constexpr int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

}  // namespace

extern "C" int watershed_flood(const float* image, const int32_t* markers, const uint8_t* mask,
                               int h, int w, int32_t* out) {
    const int64_t n = static_cast<int64_t>(h) * w;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = mask[i] ? markers[i] : -1;  // -1: outside the mask
    }
    std::priority_queue<Node, std::vector<Node>, Later> heap;
    uint64_t order = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (markers[i] > 0 && mask[i]) {
            heap.push({image[i], order++, i});
        }
    }
    while (!heap.empty()) {
        const Node node = heap.top();
        heap.pop();
        const int64_t y = node.index / w;
        const int64_t x = node.index - y * w;
        const int32_t label = out[node.index];
        const int64_t next[4] = {y > 0 ? node.index - w : -1, y + 1 < h ? node.index + w : -1,
                                 x > 0 ? node.index - 1 : -1, x + 1 < w ? node.index + 1 : -1};
        for (int64_t ni : next) {
            if (ni >= 0 && out[ni] == 0) {
                out[ni] = label;
                heap.push({image[ni], order++, ni});
            }
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        if (out[i] < 0) {
            out[i] = 0;
        }
    }
    return 0;
}

// labels: int32 [h, w]. For instance k, ids[k] is its label and
// starts[2k], starts[2k+1] the (y, x) of its first pixel in raster order.
// Points (x, y) go to points[2 * offsets[k] ...], offsets[n] the total;
// returns -1 if more than `capacity` points would be written, else 0.
extern "C" int outer_contours(const int32_t* labels, int h, int w, int n, const int32_t* ids,
                              const int32_t* starts, int32_t* points, int64_t capacity,
                              int64_t* offsets) {
    int64_t written = 0;
    for (int k = 0; k < n; ++k) {
        offsets[k] = written;
        const int32_t id = ids[k];
        const auto on = [&](int y, int x) {
            return y >= 0 && y < h && x >= 0 && x < w &&
                   labels[static_cast<int64_t>(y) * w + x] == id;
        };
        const auto put = [&](int x, int y) {
            if (written >= capacity) {
                return false;
            }
            points[2 * written] = x;
            points[2 * written + 1] = y;
            ++written;
            return true;
        };
        const int y0 = starts[2 * k];
        const int x0 = starts[2 * k + 1];
        // first neighbour clockwise from up-left (the pixel left of the start is background)
        int s = 4;
        int y1 = 0;
        int x1 = 0;
        bool found = false;
        for (int step = 0; step < 8; ++step) {
            s = (s - 1) & 7;
            y1 = y0 + kDy[s];
            x1 = x0 + kDx[s];
            if (on(y1, x1)) {
                found = true;
                break;
            }
        }
        if (!found) {  // a single pixel
            if (!put(x0, y0)) {
                return -1;
            }
            continue;
        }
        int y3 = y0;
        int x3 = x0;
        int prev_s = s ^ 4;
        for (;;) {
            // next border pixel counter-clockwise from the one after the previous
            int y4 = y3;
            int x4 = x3;
            for (int step = 0; step < 8; ++step) {
                s = (s + 1) & 7;
                y4 = y3 + kDy[s];
                x4 = x3 + kDx[s];
                if (on(y4, x4)) {
                    break;
                }
            }
            if (s != prev_s) {
                if (!put(x3, y3)) {
                    return -1;
                }
                prev_s = s;
            }
            if (y4 == y0 && x4 == x0 && y3 == y1 && x3 == x1) {
                break;
            }
            y3 = y4;
            x3 = x4;
            s = (s + 4) & 7;
        }
    }
    offsets[n] = written;
    return 0;
}

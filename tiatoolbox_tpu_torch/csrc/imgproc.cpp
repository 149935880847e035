// Host C++ of the port's image processing: OpenCV 5.0's resize, warpAffine,
// remap, blur, erode and dilate, bit for bit with cv2 on x86-64 but for the
// resizes cv2 hands to Intel IPP's cubic (and its int16 and float64
// linear), built with g++ into a shared library with a plain C interface
// and loaded with ctypes (tiatoolbox_tpu_torch/native).
//
// It replaces the cv2 calls of tiatoolbox_tpu/utils/transforms.py (resize),
// tools/registration/wsi_registration.py and wsicore/store_reader.py
// (warpAffine, remap, resize, blur), utils/visualization.py (blur) and the
// morphology of models/architecture/hovernet.py, hovernetplus.py,
// efficientunet_tissue_mask_model.py and tools/tissuemask.py.
//
// cv2 resizes through two libraries. Its own code (imgproc/resize.cpp) runs
// nearest, area, uint8 linear, linear exact, and linear and cubic where the
// source is narrower than 2 (linear) or 4 (cubic) pixels on a side; Intel
// IPP runs the other linear and cubic resizes. Both are reproduced:
//
// - nearest: floor(x / (dw / sw)), clamped;
// - area shrinking by integers (the source sizes divisible, so that
//   1 / (dw / sw) is within DBL_EPSILON of an integer): block sums, 2x2 with
//   1, 3 or 4 channels rounded (s + 2) >> 2 on integers and, on float32 with
//   1 or 4 channels, ((a + b) + (c + d)) * 0.25 in the 4-wide vector body;
//   other blocks summed four at a time in the working type and multiplied by
//   the float reciprocal of the area;
// - area shrinking at other factors: the overlap table of
//   computeResizeAreaTab (double, stored as float), each source row summed
//   into a float buffer, then buffer * beta accumulated per output row, all
//   in float32 (double for float64);
// - area enlarging, linear, cubic (OpenCV's own): resizeGeneric_ with
//   float32 positions, 11-bit weights on uint8 (the vertical linear pass
//   ((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2 >> 2), the
//   vertical cubic pass a chain S0 * b0 + (S1 * b1 + (S2 * b2 + S3 * b3))
//   in float32 vectors (8 wide on uint8 and 16-bit, 4 on float32) and
//   left to right in the row's tail (on uint8 in integers,
//   (s + (1 << 21)) >> 22);
// - linear through IPP: positions (d + 0.5) * (sw / dw) - 0.5 in double,
//   the fraction in the working type, each lerp a fused multiply-add
//   fma(t, b - a, a), rows first: bit for bit on uint16, and on float32 up
//   to 8x enlargements; IPP's int16 and float64 linear and its float32
//   beyond 8x part from it in a few values;
// - cubic through IPP: the same positions, A = -0.75 weights in double
//   rounded to float32, the four taps summed in pairs in float32, rows
//   first. It is not reproduced bit for bit: about one uint8 value in 10^5
//   differs by one level (tests/test_torch_imgproc.py counts them);
// - INTER_LINEAR_EXACT (uint8): 8-bit weights from double positions, rows
//   then columns, rounded at 16 fraction bits.
//
// warpAffine and remap (INTER_LINEAR, BORDER_CONSTANT) on uint8 and float32
// are OpenCV 5.0's float32 kernels as its AVX-512 dispatch runs them: the
// matrix inverted in double and rounded to float32; the source x of a pixel
// fma(x, m0, y * m1 + m2) in the 16-column vector body and
// fma(x, m0, y * m1) + m2 in the tail; the lerps fused, rows first; a pixel
// whose four taps are all outside takes the border value. Float64 images
// take OpenCV's fixed-point path: positions in 1/1024, then 1/32 of a pixel,
// weights from its float32 table, the four products summed in double.
//
// blur (BORDER_REFLECT_101, anchor at the centre) sums rows and columns as
// OpenCV's RowSum and ColumnSum do: on uint8 exactly in integers, rounded
// in 23-bit fixed point while 255 * area fits 16 bits and otherwise through
// float32 over the row's 8-wide vectors and double in its tail; on float32
// and float64 in double, rows of 3 and 5 (and any window up to 5x5) summed
// directly and others as running sums, the columns as a running sum down
// the image. erode and dilate take any uint8 structuring element with the
// anchor at (ksize / 2) and cv2's border (outside pixels neither clear an
// erosion nor set a dilation): each kernel row's runs read a sparse table
// of running maxima (minima) of power-of-two widths.
//
// Every output row depends only on the inputs, so the result does not
// depend on the number of threads; large calls split their rows (the float
// blur its columns) over std::thread. Fused multiply-adds are explicit
// (std::fma); the file is built with -ffp-contract=off semantics (a pragma:
// the flags of the build stay as they are), so nothing else is fused, also
// in the functions cloned for FMA hardware. The morphology's byte maxima use
// SSE2 (x86-64's baseline); rounding to an integer is cvRound's
// conversion under the default rounding mode.

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstddef>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <type_traits>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

// Every function keeps the source's float operations as written: none is
// fused into a multiply-add, also where a clone is built for FMA hardware.
#pragma GCC optimize("fp-contract=off")

// A function built twice, for FMA hardware and for any x86-64, the copy
// chosen when the library loads; std::fma is one instruction in the first
// and a libm call in the second, with the same result.
#define FMA_CLONES __attribute__((target_clones("fma", "default")))
#define BODY inline __attribute__((always_inline))

namespace {

enum Depth { kU8 = 0, kU16 = 1, kS16 = 2, kF32 = 3, kF64 = 4 };
enum Interp { kNearest = 0, kLinear = 1, kCubic = 2, kArea = 3, kLinearExact = 5 };
enum Status { kOk = 0, kBadDepth = 1, kBadMode = 2, kBadSize = 3 };

constexpr int kCoefBits = 11;  // INTER_RESIZE_COEF_BITS
constexpr int kCoefScale = 1 << kCoefBits;

template <typename F>
void parallel_rows(int n, int threads, F&& fn) {
    threads = std::max(1, std::min(threads, n));
    if (threads == 1) {
        fn(0, n);
        return;
    }
    const int step = (n + threads - 1) / threads;
    std::vector<std::thread> pool;
    for (int a = step; a < n; a += step) {
        pool.emplace_back([&fn, a, step, n] { fn(a, std::min(n, a + step)); });
    }
    fn(0, std::min(n, step));
    for (auto& t : pool) {
        t.join();
    }
}

inline int cv_floor(double v) {
    const int i = static_cast<int>(v);
    return i - (i > v);
}

inline int cv_ceil(double v) {
    const int i = static_cast<int>(v);
    return i + (i < v);
}

// cvRound: to nearest, ties to even (the SSE conversion under the default
// rounding mode); INT_MIN where the value is NaN or outside int, as cvRound gives
inline int cv_round(double v) {
#if defined(__SSE2__)
    return _mm_cvtsd_si32(_mm_set_sd(v));
#else
    if (!(v > -2147483649.0 && v < 2147483648.0)) {
        return INT_MIN;
    }
    return static_cast<int>(std::nearbyint(v));
#endif
}

inline int cv_round(float v) {
#if defined(__SSE2__)
    return _mm_cvtss_si32(_mm_set_ss(v));
#else
    return cv_round(static_cast<double>(v));
#endif
}

// saturate_cast<T> of a float or double: cvRound, then clamp
template <typename T>
inline T saturate(double v) {
    if constexpr (std::is_floating_point_v<T>) {
        return static_cast<T>(v);
    } else {
        const int r = cv_round(v);
        return static_cast<T>(std::min<int>(std::max<int>(r, std::numeric_limits<T>::min()), std::numeric_limits<T>::max()));
    }
}

template <typename T>
inline T saturate_f(float v) {
    if constexpr (std::is_floating_point_v<T>) {
        return static_cast<T>(v);
    } else {
        const int r = cv_round(v);
        return static_cast<T>(std::min<int>(std::max<int>(r, std::numeric_limits<T>::min()), std::numeric_limits<T>::max()));
    }
}

inline uint8_t clamp_u8(int v) { return static_cast<uint8_t>(std::min(255, std::max(0, v))); }

// working type of OpenCV's float resize paths
template <typename T>
using Work = std::conditional_t<std::is_same_v<T, double>, double, float>;

// ---------------------------------------------------------------- nearest

template <typename T>
void resize_nearest(const T* src, int sh, int sw, int cn, T* dst, int dh, int dw, int threads) {
    const double ifx = 1.0 / (static_cast<double>(dw) / sw);
    const double ify = 1.0 / (static_cast<double>(dh) / sh);
    std::vector<int> xofs(dw);
    for (int x = 0; x < dw; ++x) {
        xofs[x] = std::min(cv_floor(x * ifx), sw - 1) * cn;
    }
    parallel_rows(dh, threads, [&](int y0, int y1) {
        for (int y = y0; y < y1; ++y) {
            const T* s = src + static_cast<int64_t>(std::min(cv_floor(y * ify), sh - 1)) * sw * cn;
            T* d = dst + static_cast<int64_t>(y) * dw * cn;
            for (int x = 0; x < dw; ++x) {
                std::memcpy(d + x * cn, s + xofs[x], sizeof(T) * cn);
            }
        }
    });
}

// ---------------------------------------------------------------- area, integer factors

template <typename T>
void resize_area_fast(const T* src, int sh, int sw, int cn, T* dst, int dh, int dw, int sx, int sy, int threads) {
    using WT = std::conditional_t<std::is_same_v<T, uint8_t>, int, Work<T>>;
    const int area = sx * sy;
    const float scale = 1.f / static_cast<float>(area);
    const int64_t sstep = static_cast<int64_t>(sw) * cn;
    std::vector<int64_t> ofs(area);
    for (int y = 0, k = 0; y < sy; ++y) {
        for (int x = 0; x < sx; ++x) {
            ofs[k++] = y * sstep + x * cn;
        }
    }
    const bool int_2x2 = !std::is_floating_point_v<T> && sx == 2 && sy == 2 && (cn == 1 || cn == 3 || cn == 4);
    const bool f32_2x2 = std::is_same_v<T, float> && sx == 2 && sy == 2 && (cn == 1 || cn == 4);
    const int width = dw * cn;
    const int vec_end = f32_2x2 ? width - width % 4 : 0;  // the 4-wide vector body, in output elements
    parallel_rows(dh, threads, [&](int y0, int y1) {
        for (int y = y0; y < y1; ++y) {
            const T* s0 = src + static_cast<int64_t>(y) * sy * sstep;
            T* d = dst + static_cast<int64_t>(y) * width;
            if constexpr (!std::is_floating_point_v<T>) {
              if (int_2x2) {
                const T* s1 = s0 + sstep;
                for (int dx = 0; dx < dw; ++dx) {
                    const int j = dx * 2 * cn;
                    for (int c = 0; c < cn; ++c) {
                        d[dx * cn + c] = static_cast<T>((s0[j + c] + s0[j + cn + c] + s1[j + c] + s1[j + cn + c] + 2) >> 2);
                    }
                }
                continue;
              }
            }
            for (int dx = 0; dx < dw; ++dx) {
                for (int c = 0; c < cn; ++c) {
                    const int i = dx * cn + c;
                    const T* s = s0 + dx * sx * cn + c;
                    if (i < vec_end) {
                        const float a = static_cast<float>(s[0]) + static_cast<float>(s[cn]);
                        const float b = static_cast<float>(s[sstep]) + static_cast<float>(s[sstep + cn]);
                        d[i] = static_cast<T>((a + b) * 0.25f);
                        continue;
                    }
                    WT sum = 0;
                    int k = 0;
                    for (; k <= area - 4; k += 4) {
                        sum += static_cast<WT>(s[ofs[k]]) + static_cast<WT>(s[ofs[k + 1]]) + static_cast<WT>(s[ofs[k + 2]]) +
                               static_cast<WT>(s[ofs[k + 3]]);
                    }
                    for (; k < area; ++k) {
                        sum += static_cast<WT>(s[ofs[k]]);
                    }
                    if constexpr (std::is_same_v<T, double>) {
                        d[i] = static_cast<T>(sum * scale);
                    } else {
                        d[i] = saturate_f<T>(static_cast<float>(sum) * scale);
                    }
                }
            }
        }
    });
}

// ---------------------------------------------------------------- area, other factors

struct Decimate {
    int di, si;
    float alpha;
};

std::vector<Decimate> area_table(int ssize, int dsize, int cn, double scale) {
    std::vector<Decimate> tab;
    tab.reserve(static_cast<size_t>(ssize) * 2);
    for (int dx = 0; dx < dsize; ++dx) {
        const double fsx1 = dx * scale;
        const double fsx2 = fsx1 + scale;
        const double cell = std::min(scale, ssize - fsx1);
        int sx1 = cv_ceil(fsx1), sx2 = cv_floor(fsx2);
        sx2 = std::min(sx2, ssize - 1);
        sx1 = std::min(sx1, sx2);
        if (sx1 - fsx1 > 1e-3) {
            tab.push_back({dx * cn, (sx1 - 1) * cn, static_cast<float>((sx1 - fsx1) / cell)});
        }
        for (int sx = sx1; sx < sx2; ++sx) {
            tab.push_back({dx * cn, sx * cn, static_cast<float>(1.0 / cell)});
        }
        if (fsx2 - sx2 > 1e-3) {
            tab.push_back({dx * cn, sx2 * cn, static_cast<float>(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
        }
    }
    return tab;
}

template <typename T>
void resize_area_general(const T* src, int sh, int sw, int cn, T* dst, int dh, int dw, double scale_x, double scale_y,
                         int threads) {
    using WT = Work<T>;
    const std::vector<Decimate> xtab = area_table(sw, dw, cn, scale_x);
    const std::vector<Decimate> ytab = area_table(sh, dh, 1, scale_y);
    std::vector<int> tabofs(dh + 1, static_cast<int>(ytab.size()));
    for (int k = static_cast<int>(ytab.size()) - 1; k >= 0; --k) {
        tabofs[ytab[k].di] = k;
    }
    const int width = dw * cn;
    parallel_rows(dh, threads, [&](int y0, int y1) {
        std::vector<WT> buf(width), sum(width);
        for (int dy = y0; dy < y1; ++dy) {
            for (int j = tabofs[dy]; j < tabofs[dy + 1]; ++j) {
                const WT beta = ytab[j].alpha;
                const T* s = src + static_cast<int64_t>(ytab[j].si) * sw * cn;
                std::fill(buf.begin(), buf.end(), WT(0));
                for (const Decimate& e : xtab) {
                    for (int c = 0; c < cn; ++c) {
                        buf[e.di + c] += static_cast<WT>(s[e.si + c]) * static_cast<WT>(e.alpha);
                    }
                }
                if (j == tabofs[dy]) {
                    for (int i = 0; i < width; ++i) {
                        sum[i] = beta * buf[i];
                    }
                } else {
                    for (int i = 0; i < width; ++i) {
                        sum[i] += beta * buf[i];
                    }
                }
            }
            T* d = dst + static_cast<int64_t>(dy) * width;
            for (int i = 0; i < width; ++i) {
                d[i] = saturate<T>(static_cast<double>(sum[i]));
            }
        }
    });
}

// ---------------------------------------------------------------- OpenCV's linear and cubic (resizeGeneric_)

void interpolate_cubic(float x, float* c) {
    const float A = -0.75f;
    c[0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
    c[1] = ((A + 2) * x - (A + 3)) * x * x + 1;
    c[2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
    c[3] = 1.f - c[0] - c[1] - c[2];
}

struct GenericTaps {
    int ksize = 2;
    int xmin = 0, xmax = 0;
    std::vector<int> xofs, yofs;        // source pixel of each output column / row
    std::vector<float> alpha, beta;     // ksize weights each
    std::vector<short> ialpha, ibeta;   // uint8: weights in 11-bit fixed point
};

GenericTaps generic_taps(int sh, int sw, int dh, int dw, int interp, bool area_mode) {
    GenericTaps t;
    t.ksize = interp == kCubic ? 4 : 2;
    const int ksize2 = t.ksize / 2;
    const double inv_x = static_cast<double>(dw) / sw, inv_y = static_cast<double>(dh) / sh;
    const double scale_x = 1.0 / inv_x, scale_y = 1.0 / inv_y;
    t.xmax = dw;
    t.xofs.resize(dw);
    t.yofs.resize(dh);
    t.alpha.resize(static_cast<size_t>(dw) * t.ksize);
    t.beta.resize(static_cast<size_t>(dh) * t.ksize);
    t.ialpha.resize(t.alpha.size());
    t.ibeta.resize(t.beta.size());
    float cbuf[4] = {0, 0, 0, 0};
    for (int dx = 0; dx < dw; ++dx) {
        float fx;
        int sx;
        if (!area_mode) {
            fx = static_cast<float>((dx + 0.5) * scale_x - 0.5);
            sx = cv_floor(fx);
            fx -= sx;
        } else {
            sx = cv_floor(dx * scale_x);
            fx = static_cast<float>((dx + 1) - (sx + 1) * inv_x);
            fx = fx <= 0 ? 0.f : fx - cv_floor(fx);
        }
        if (sx < ksize2 - 1) {
            t.xmin = dx + 1;
            if (sx < 0 && interp != kCubic) {
                fx = 0, sx = 0;
            }
        }
        if (sx + ksize2 >= sw) {
            t.xmax = std::min(t.xmax, dx);
            if (sx >= sw - 1 && interp != kCubic) {
                fx = 0, sx = sw - 1;
            }
        }
        t.xofs[dx] = sx;
        if (interp == kCubic) {
            interpolate_cubic(fx, cbuf);
        } else {
            cbuf[0] = 1.f - fx;
            cbuf[1] = fx;
        }
        for (int k = 0; k < t.ksize; ++k) {
            t.alpha[dx * t.ksize + k] = cbuf[k];
            t.ialpha[dx * t.ksize + k] = saturate<short>(cbuf[k] * kCoefScale);
        }
    }
    for (int dy = 0; dy < dh; ++dy) {
        float fy;
        int sy;
        if (!area_mode) {
            fy = static_cast<float>((dy + 0.5) * scale_y - 0.5);
            sy = cv_floor(fy);
            fy -= sy;
        } else {
            sy = cv_floor(dy * scale_y);
            fy = static_cast<float>((dy + 1) - (sy + 1) * inv_y);
            fy = fy <= 0 ? 0.f : fy - cv_floor(fy);
        }
        t.yofs[dy] = sy;
        if (interp == kCubic) {
            interpolate_cubic(fy, cbuf);
        } else {
            cbuf[0] = 1.f - fy;
            cbuf[1] = fy;
        }
        for (int k = 0; k < t.ksize; ++k) {
            t.beta[dy * t.ksize + k] = cbuf[k];
            t.ibeta[dy * t.ksize + k] = saturate<short>(cbuf[k] * kCoefScale);
        }
    }
    return t;
}

// One source row through the horizontal pass, into ``out`` (dw * cn).
template <typename T, typename WT>
void generic_hpass(const T* s, int sw, int cn, int dw, const GenericTaps& t, WT* out) {
    const bool fixpt = std::is_same_v<T, uint8_t>;
    if (t.ksize == 2) {
        for (int dx = 0; dx < dw; ++dx) {
            const int sx = t.xofs[dx] * cn;
            for (int c = 0; c < cn; ++c) {
                if (dx < t.xmax) {
                    if constexpr (fixpt) {
                        out[dx * cn + c] = s[sx + c] * t.ialpha[dx * 2] + s[sx + cn + c] * t.ialpha[dx * 2 + 1];
                    } else {
                        out[dx * cn + c] = static_cast<WT>(s[sx + c]) * static_cast<WT>(t.alpha[dx * 2]) +
                                           static_cast<WT>(s[sx + cn + c]) * static_cast<WT>(t.alpha[dx * 2 + 1]);
                    }
                } else {
                    if constexpr (fixpt) {
                        out[dx * cn + c] = s[sx + c] * kCoefScale;
                    } else {
                        out[dx * cn + c] = static_cast<WT>(s[sx + c]);
                    }
                }
            }
        }
        return;
    }
    // cubic: taps clamped to the row's first and last pixels
    for (int dx = 0; dx < dw; ++dx) {
        int idx[4];
        for (int j = 0; j < 4; ++j) {
            idx[j] = std::min(std::max(t.xofs[dx] - 1 + j, 0), sw - 1) * cn;
        }
        for (int c = 0; c < cn; ++c) {
            if constexpr (fixpt) {
                int v = 0;
                for (int j = 0; j < 4; ++j) {
                    v += s[idx[j] + c] * t.ialpha[dx * 4 + j];
                }
                out[dx * cn + c] = v;
            } else {
                WT v = static_cast<WT>(s[idx[0] + c]) * static_cast<WT>(t.alpha[dx * 4]);
                for (int j = 1; j < 4; ++j) {
                    v += static_cast<WT>(s[idx[j] + c]) * static_cast<WT>(t.alpha[dx * 4 + j]);
                }
                out[dx * cn + c] = v;
            }
        }
    }
}

template <typename T, typename WT>
void generic_vpass(const WT* const* rows, int ksize, const float* beta, const short* ibeta, T* d, int width) {
    if constexpr (std::is_same_v<T, uint8_t>) {
        if (ksize == 2) {
            const int b0 = ibeta[0], b1 = ibeta[1];
            for (int x = 0; x < width; ++x) {
                d[x] = clamp_u8((((b0 * (rows[0][x] >> 4)) >> 16) + ((b1 * (rows[1][x] >> 4)) >> 16) + 2) >> 2);
            }
            return;
        }
        // cubic: 8-wide vectors in float32, the tail in integers
        const float scale = 1.f / (kCoefScale * kCoefScale);
        const float fb[4] = {ibeta[0] * scale, ibeta[1] * scale, ibeta[2] * scale, ibeta[3] * scale};
        const int vec_end = width - width % 8;
        int x = 0;
        for (; x < vec_end; ++x) {
            const float v3 = static_cast<float>(rows[3][x]) * fb[3];
            const float v2 = static_cast<float>(rows[2][x]) * fb[2] + v3;
            const float v1 = static_cast<float>(rows[1][x]) * fb[1] + v2;
            const float v0 = static_cast<float>(rows[0][x]) * fb[0] + v1;
            d[x] = clamp_u8(cv_round(v0));
        }
        for (; x < width; ++x) {
            const int v = rows[0][x] * ibeta[0] + rows[1][x] * ibeta[1] + rows[2][x] * ibeta[2] + rows[3][x] * ibeta[3];
            d[x] = clamp_u8((v + (1 << 21)) >> 22);
        }
    } else {
        if (ksize == 2) {
            const WT b0 = beta[0], b1 = beta[1];
            for (int x = 0; x < width; ++x) {
                d[x] = saturate<T>(static_cast<double>(rows[0][x] * b0 + rows[1][x] * b1));
            }
            return;
        }
        const WT b[4] = {beta[0], beta[1], beta[2], beta[3]};
        // float32: 4-wide vectors of chained multiply-adds,
        // S0 * b0 + (S1 * b1 + (S2 * b2 + S3 * b3)); 16-bit: 8-wide; float64 has none
        const int lanes = std::is_same_v<T, float> ? 4 : 8;
        const int vec_end = std::is_same_v<T, double> ? 0 : width - width % lanes;
        int x = 0;
        for (; x < vec_end; ++x) {
            const WT v = rows[0][x] * b[0] + (rows[1][x] * b[1] + (rows[2][x] * b[2] + rows[3][x] * b[3]));
            d[x] = saturate<T>(static_cast<double>(v));
        }
        for (; x < width; ++x) {
            const WT v = rows[0][x] * b[0] + rows[1][x] * b[1] + rows[2][x] * b[2] + rows[3][x] * b[3];
            d[x] = saturate<T>(static_cast<double>(v));
        }
    }
}

template <typename T>
void resize_generic(const T* src, int sh, int sw, int cn, T* dst, int dh, int dw, int interp, bool area_mode,
                    int threads) {
    using WT = std::conditional_t<std::is_same_v<T, uint8_t>, int, Work<T>>;
    const GenericTaps t = generic_taps(sh, sw, dh, dw, interp, area_mode);
    const int width = dw * cn;
    parallel_rows(dh, threads, [&](int y0, int y1) {
        std::vector<WT> buf(static_cast<size_t>(width) * t.ksize);
        int cached[4] = {-1, -1, -1, -1};
        std::vector<WT> fresh(static_cast<size_t>(width) * t.ksize);
        for (int dy = y0; dy < y1; ++dy) {
            const WT* rows[4] = {nullptr, nullptr, nullptr, nullptr};
            int want[4];
            for (int k = 0; k < t.ksize; ++k) {
                want[k] = std::min(std::max(t.yofs[dy] - t.ksize / 2 + 1 + k, 0), sh - 1);
            }
            // reuse rows already through the horizontal pass
            for (int k = 0; k < t.ksize; ++k) {
                WT* slot = fresh.data() + static_cast<size_t>(k) * width;
                int found = -1;
                for (int j = 0; j < t.ksize; ++j) {
                    if (cached[j] == want[k]) {
                        found = j;
                        break;
                    }
                }
                if (found >= 0) {
                    std::memcpy(slot, buf.data() + static_cast<size_t>(found) * width, sizeof(WT) * width);
                } else {
                    generic_hpass<T, WT>(src + static_cast<int64_t>(want[k]) * sw * cn, sw, cn, dw, t, slot);
                }
            }
            std::swap(buf, fresh);
            for (int k = 0; k < t.ksize; ++k) {
                cached[k] = want[k];
                rows[k] = buf.data() + static_cast<size_t>(k) * width;
            }
            generic_vpass<T, WT>(rows, t.ksize, &t.beta[dy * t.ksize], &t.ibeta[dy * t.ksize],
                                 dst + static_cast<int64_t>(dy) * width, width);
        }
    });
}

// ---------------------------------------------------------------- IPP's linear and cubic

struct IppTaps {
    std::vector<int> idx;       // k taps per output, clamped to the source
    std::vector<double> frac;   // linear: the fraction in double
    std::vector<float> weight;  // cubic: k weights per output
};

IppTaps ipp_taps(int n_in, int n_out, int k) {
    IppTaps t;
    t.idx.resize(static_cast<size_t>(n_out) * k);
    t.frac.resize(n_out);
    t.weight.resize(static_cast<size_t>(n_out) * k);
    const double ratio = static_cast<double>(n_in) / n_out;
    for (int d = 0; d < n_out; ++d) {
        const double f = (d + 0.5) * ratio - 0.5;
        const double s = std::floor(f);
        const double x = f - s;
        const int si = static_cast<int>(s);
        if (k == 2) {
            const bool edge = si < 0 || si >= n_in - 1;
            const int i0 = std::min(std::max(si, 0), n_in - 1);
            t.idx[d * 2] = i0;
            t.idx[d * 2 + 1] = std::min(i0 + 1, n_in - 1);
            t.frac[d] = edge ? 0.0 : x;
            continue;
        }
        const double a = -0.75;
        const double c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a;
        const double c1 = ((a + 2) * x - (a + 3)) * x * x + 1;
        const double c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1;
        const double w[4] = {c0, c1, c2, 1 - c0 - c1 - c2};
        for (int j = 0; j < 4; ++j) {
            t.idx[d * 4 + j] = std::min(std::max(si - 1 + j, 0), n_in - 1);
            t.weight[d * 4 + j] = static_cast<float>(w[j]);
        }
    }
    return t;
}

template <typename WT>
BODY void ipp_lerp_body(const WT* a, const WT* b, WT t, WT* out, int n) {
    for (int i = 0; i < n; ++i) {
        out[i] = std::fma(t, static_cast<WT>(b[i] - a[i]), a[i]);
    }
}

template <typename T>
BODY void ipp_linear_hpass_body(const T* s, int cn, int dw, const IppTaps& t, Work<T>* out) {
    using WT = Work<T>;
    for (int dx = 0; dx < dw; ++dx) {
        const WT f = static_cast<WT>(t.frac[dx]);
        const T* p0 = s + t.idx[dx * 2] * cn;
        const T* p1 = s + t.idx[dx * 2 + 1] * cn;
        for (int c = 0; c < cn; ++c) {
            const WT a = static_cast<WT>(p0[c]);
            out[dx * cn + c] = std::fma(f, static_cast<WT>(static_cast<WT>(p1[c]) - a), a);
        }
    }
}

FMA_CLONES void ipp_lerp_row(const float* a, const float* b, float t, float* out, int n) {
    ipp_lerp_body(a, b, t, out, n);
}
FMA_CLONES void ipp_lerp_row(const double* a, const double* b, double t, double* out, int n) {
    ipp_lerp_body(a, b, t, out, n);
}
FMA_CLONES void ipp_linear_hpass(const uint16_t* s, int cn, int dw, const IppTaps& t, float* out) {
    ipp_linear_hpass_body(s, cn, dw, t, out);
}
FMA_CLONES void ipp_linear_hpass(const int16_t* s, int cn, int dw, const IppTaps& t, float* out) {
    ipp_linear_hpass_body(s, cn, dw, t, out);
}
FMA_CLONES void ipp_linear_hpass(const float* s, int cn, int dw, const IppTaps& t, float* out) {
    ipp_linear_hpass_body(s, cn, dw, t, out);
}
FMA_CLONES void ipp_linear_hpass(const double* s, int cn, int dw, const IppTaps& t, double* out) {
    ipp_linear_hpass_body(s, cn, dw, t, out);
}

template <typename T>
void resize_ipp_linear(const T* src, int sh, int sw, int cn, T* dst, int dh, int dw, int threads) {
    using WT = Work<T>;
    const IppTaps tx = ipp_taps(sw, dw, 2), ty = ipp_taps(sh, dh, 2);
    const int width = dw * cn;
    parallel_rows(dh, threads, [&](int y0, int y1) {
        std::vector<WT> r0(width), r1(width), out(width);
        int c0 = -1, c1 = -1;
        for (int dy = y0; dy < y1; ++dy) {
            const int i0 = ty.idx[dy * 2], i1 = ty.idx[dy * 2 + 1];
            if (i0 == c1 && i0 != c0) {
                std::swap(r0, r1);
                std::swap(c0, c1);
            }
            if (c0 != i0) {
                ipp_linear_hpass(src + static_cast<int64_t>(i0) * sw * cn, cn, dw, tx, r0.data());
                c0 = i0;
            }
            if (c1 != i1) {
                ipp_linear_hpass(src + static_cast<int64_t>(i1) * sw * cn, cn, dw, tx, r1.data());
                c1 = i1;
            }
            ipp_lerp_row(r0.data(), r1.data(), static_cast<WT>(ty.frac[dy]), out.data(), width);
            T* d = dst + static_cast<int64_t>(dy) * width;
            for (int i = 0; i < width; ++i) {
                d[i] = saturate<T>(static_cast<double>(out[i]));
            }
        }
    });
}

// A row of float32 values to the output type: cvRound, then saturation
template <typename T>
void store_row(const float* v, T* d, int n) {
    int i = 0;
#if defined(__SSE2__)
    if constexpr (std::is_same_v<T, uint8_t>) {
        // the same rounding (cvtps2dq under the default mode, INT_MIN outside
        // int) and saturation (int32 -> int16 -> uint8) as cvRound and a clamp
        for (; i + 16 <= n; i += 16) {
            const __m128i a = _mm_cvtps_epi32(_mm_loadu_ps(v + i));
            const __m128i b = _mm_cvtps_epi32(_mm_loadu_ps(v + i + 4));
            const __m128i c = _mm_cvtps_epi32(_mm_loadu_ps(v + i + 8));
            const __m128i e = _mm_cvtps_epi32(_mm_loadu_ps(v + i + 12));
            _mm_storeu_si128(reinterpret_cast<__m128i*>(d + i),
                             _mm_packus_epi16(_mm_packs_epi32(a, b), _mm_packs_epi32(c, e)));
        }
    }
#endif
    for (; i < n; ++i) {
        d[i] = saturate_f<T>(v[i]);
    }
}

// One output row of IPP's vertical cubic pass (elementwise: as wide as the
// clone's vectors, with the same sums)
FMA_CLONES void cubic_vpass_row(const float* const* r, const float* w, float* v, int n) {
    const float *r0 = r[0], *r1 = r[1], *r2 = r[2], *r3 = r[3];
    for (int e = 0; e < n; ++e) {
        const float a = r0[e] * w[0] + r1[e] * w[1];
        const float b = r2[e] * w[2] + r3[e] * w[3];
        v[e] = a + b;
    }
}

template <typename T>
void resize_ipp_cubic(const T* src, int sh, int sw, int cn, T* dst, int dh, int dw, int threads) {
    const IppTaps tx = ipp_taps(sw, dw, 4), ty = ipp_taps(sh, dh, 4);
    const int width = dw * cn;
    // per output element: its four source elements and weights
    std::vector<int> ix(static_cast<size_t>(width) * 4);
    std::vector<float> wx(static_cast<size_t>(width) * 4);
    for (int dx = 0; dx < dw; ++dx) {
        for (int c = 0; c < cn; ++c) {
            for (int j = 0; j < 4; ++j) {
                ix[static_cast<size_t>(j) * width + dx * cn + c] = tx.idx[dx * 4 + j] * cn + c;
                wx[static_cast<size_t>(j) * width + dx * cn + c] = tx.weight[dx * 4 + j];
            }
        }
    }
    const int *i0 = ix.data(), *i1 = i0 + width, *i2 = i1 + width, *i3 = i2 + width;
    const float *w0 = wx.data(), *w1 = w0 + width, *w2 = w1 + width, *w3 = w2 + width;
    // every source row through the horizontal pass, once
    std::vector<float> rows(static_cast<size_t>(sh) * width);
    parallel_rows(sh, threads, [&](int r0, int r1) {
        std::vector<float> f(static_cast<size_t>(sw) * cn + 4, 0.f);  // the row in float32, a lane of slack
        for (int r = r0; r < r1; ++r) {
            const T* s = src + static_cast<int64_t>(r) * sw * cn;
            float* o = rows.data() + static_cast<size_t>(r) * width;
            for (int i = 0; i < sw * cn; ++i) {
                f[i] = static_cast<float>(s[i]);
            }
#if defined(__SSE2__)
            if (cn == 3 || cn == 4) {
                // a pixel's channels in one vector: the same products and sums per lane
                for (int dx = 0; dx < dw; ++dx) {
                    const int* t = &tx.idx[dx * 4];
                    const float* w = &tx.weight[dx * 4];
                    const __m128 a = _mm_add_ps(_mm_mul_ps(_mm_loadu_ps(&f[t[0] * cn]), _mm_set1_ps(w[0])),
                                                _mm_mul_ps(_mm_loadu_ps(&f[t[1] * cn]), _mm_set1_ps(w[1])));
                    const __m128 b = _mm_add_ps(_mm_mul_ps(_mm_loadu_ps(&f[t[2] * cn]), _mm_set1_ps(w[2])),
                                                _mm_mul_ps(_mm_loadu_ps(&f[t[3] * cn]), _mm_set1_ps(w[3])));
                    const __m128 v = _mm_add_ps(a, b);
                    if (cn == 4) {
                        _mm_storeu_ps(o + dx * 4, v);
                    } else {
                        _mm_storel_pi(reinterpret_cast<__m64*>(o + dx * 3), v);
                        _mm_store_ss(o + dx * 3 + 2, _mm_movehl_ps(v, v));
                    }
                }
                continue;
            }
#endif
            for (int e = 0; e < width; ++e) {
                const float a = f[i0[e]] * w0[e] + f[i1[e]] * w1[e];
                const float b = f[i2[e]] * w2[e] + f[i3[e]] * w3[e];
                o[e] = a + b;
            }
        }
    });
    parallel_rows(dh, threads, [&](int y0, int y1) {
        std::vector<float> v(width);
        for (int dy = y0; dy < y1; ++dy) {
            const int* iy = &ty.idx[dy * 4];
            const float* w = &ty.weight[dy * 4];
            const float* r[4];
            for (int j = 0; j < 4; ++j) {
                r[j] = rows.data() + static_cast<size_t>(iy[j]) * width;
            }
            cubic_vpass_row(r, w, v.data(), width);
            store_row(v.data(), dst + static_cast<int64_t>(dy) * width, width);
        }
    });
}

// ---------------------------------------------------------------- INTER_LINEAR_EXACT (uint8)

void linear_exact_taps(int n_in, int n_out, std::vector<int>& i0, std::vector<int>& i1, std::vector<uint32_t>& w0,
                       std::vector<uint32_t>& w1) {
    i0.resize(n_out), i1.resize(n_out), w0.resize(n_out), w1.resize(n_out);
    const double scale = 1.0 / (static_cast<double>(n_out) / n_in);
    for (int d = 0; d < n_out; ++d) {
        const double pos = scale * (d + 0.5) - 0.5;
        const double base = std::floor(pos);
        uint32_t f = static_cast<uint32_t>(std::nearbyint((pos - base) * 256.0));
        const int b = static_cast<int>(base);
        const bool edge = b < 0 || b >= n_in - 1;
        const int a = b >= n_in - 1 ? n_in - 1 : std::min(std::max(b, 0), n_in - 1);
        if (edge) {
            f = 0;
        }
        i0[d] = a;
        i1[d] = std::min(a + 1, n_in - 1);
        w0[d] = 256 - f;
        w1[d] = f;
    }
}

void resize_linear_exact(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw, int threads) {
    std::vector<int> x0, x1, y0, y1;
    std::vector<uint32_t> wx0, wx1, wy0, wy1;
    linear_exact_taps(sw, dw, x0, x1, wx0, wx1);
    linear_exact_taps(sh, dh, y0, y1, wy0, wy1);
    const int width = dw * cn;
    parallel_rows(dh, threads, [&](int a, int b) {
        std::vector<uint32_t> r0(width), r1(width);
        auto hpass = [&](int row, std::vector<uint32_t>& out) {
            const uint8_t* s = src + static_cast<int64_t>(row) * sw * cn;
            for (int dx = 0; dx < dw; ++dx) {
                for (int c = 0; c < cn; ++c) {
                    out[dx * cn + c] = s[x0[dx] * cn + c] * wx0[dx] + s[x1[dx] * cn + c] * wx1[dx];
                }
            }
        };
        for (int dy = a; dy < b; ++dy) {
            hpass(y0[dy], r0);
            hpass(y1[dy], r1);
            uint8_t* d = dst + static_cast<int64_t>(dy) * width;
            for (int i = 0; i < width; ++i) {
                const uint32_t v = (r0[i] * wy0[dy] + r1[i] * wy1[dy] + (1u << 15)) >> 16;
                d[i] = static_cast<uint8_t>(std::min<uint32_t>(v, 255));
            }
        }
    });
}

// ---------------------------------------------------------------- resize dispatch

template <typename T>
int resize_typed(const T* src, int sh, int sw, int cn, T* dst, int dh, int dw, int interp, int threads) {
    if (sh == dh && sw == dw) {
        std::memcpy(dst, src, sizeof(T) * static_cast<size_t>(sh) * sw * cn);
        return kOk;
    }
    const double inv_x = static_cast<double>(dw) / sw, inv_y = static_cast<double>(dh) / sh;
    const double scale_x = 1.0 / inv_x, scale_y = 1.0 / inv_y;
    const int iscale_x = saturate<int>(scale_x), iscale_y = saturate<int>(scale_y);
    const bool area_fast = std::abs(scale_x - iscale_x) < DBL_EPSILON && std::abs(scale_y - iscale_y) < DBL_EPSILON;
    const bool is_u8 = std::is_same_v<T, uint8_t>;
    switch (interp) {
        case kNearest:
            resize_nearest(src, sh, sw, cn, dst, dh, dw, threads);
            return kOk;
        case kLinearExact:
            if (!is_u8) {
                return kBadDepth;
            }
            if constexpr (std::is_same_v<T, uint8_t>) {
                resize_linear_exact(src, sh, sw, cn, dst, dh, dw, threads);
            }
            return kOk;
        case kLinear:
            if constexpr (!std::is_same_v<T, uint8_t>) {
                if (sh >= 2 && sw >= 2) {
                    resize_ipp_linear(src, sh, sw, cn, dst, dh, dw, threads);
                    return kOk;
                }
            }
            if (!(area_fast && iscale_x == 2 && iscale_y == 2)) {
                resize_generic(src, sh, sw, cn, dst, dh, dw, kLinear, false, threads);
                return kOk;
            }
            [[fallthrough]];  // a 2x uint8 shrink is the area path
        case kArea:
            if (scale_x >= 1 && scale_y >= 1) {
                if (area_fast) {
                    resize_area_fast(src, sh, sw, cn, dst, dh, dw, iscale_x, iscale_y, threads);
                } else {
                    resize_area_general(src, sh, sw, cn, dst, dh, dw, scale_x, scale_y, threads);
                }
            } else {
                resize_generic(src, sh, sw, cn, dst, dh, dw, kLinear, true, threads);
            }
            return kOk;
        case kCubic:
            if constexpr (!std::is_same_v<T, double>) {
                if (sh >= 4 && sw >= 4) {
                    resize_ipp_cubic(src, sh, sw, cn, dst, dh, dw, threads);
                    return kOk;
                }
            }
            resize_generic(src, sh, sw, cn, dst, dh, dw, kCubic, false, threads);
            return kOk;
        default:
            return kBadMode;
    }
}

// ---------------------------------------------------------------- warpAffine and remap

// OpenCV's inversion of a 2x3 affine, in double
void invert_affine(const double* m_in, double* m) {
    for (int i = 0; i < 6; ++i) {
        m[i] = m_in[i];
    }
    double det = m[0] * m[4] - m[1] * m[3];
    det = det != 0 ? 1.0 / det : 0.0;
    const double a11 = m[4] * det, a22 = m[0] * det;
    m[0] = a11;
    m[4] = a22;
    m[1] *= -det;
    m[3] *= -det;
    const double b1 = -m[0] * m[2] - m[1] * m[5];
    const double b2 = -m[3] * m[2] - m[4] * m[5];
    m[2] = b1;
    m[5] = b2;
}

template <typename T>
struct Image {
    const T* data;
    int h, w, cn;
    const float* border;  // per channel, in the working type
};

// OpenCV's float32 bilinear at float32 positions (uint8 and float32 images).
template <typename T>
BODY void lerp_taps(float ax, float ay, float p00, float p01, float p10, float p11, T* o) {
    const float top = std::fma(ax, p01 - p00, p00);
    const float bottom = std::fma(ax, p11 - p10, p10);
    const float v = std::fma(ay, bottom - top, top);
    if constexpr (std::is_same_v<T, uint8_t>) {
        *o = clamp_u8(cv_round(v));
    } else {
        *o = v;
    }
}

template <typename T, int CN>
BODY void bilinear_body(const Image<T>& im, const float* sx, const float* sy, int n, T* out) {
    const int cn = CN > 0 ? CN : im.cn;
    const int64_t row = static_cast<int64_t>(im.w) * cn;
    for (int i = 0; i < n; ++i) {
        const float fx = std::floor(sx[i]), fy = std::floor(sy[i]);
        T* o = out + static_cast<int64_t>(i) * cn;
        if (!(fx >= -1.f && fx < static_cast<float>(im.w) && fy >= -1.f && fy < static_cast<float>(im.h))) {
            for (int c = 0; c < cn; ++c) {
                o[c] = static_cast<T>(im.border[c]);
            }
            continue;
        }
        const int ix = static_cast<int>(fx), iy = static_cast<int>(fy);
        const float ax = sx[i] - fx, ay = sy[i] - fy;
        const T* r0 = im.data + (static_cast<int64_t>(iy) * im.w + ix) * cn;
        const T* r1 = r0 + row;
        if (ix >= 0 && ix + 1 < im.w && iy >= 0 && iy + 1 < im.h) {  // all four taps inside
            for (int c = 0; c < cn; ++c) {
                lerp_taps(ax, ay, static_cast<float>(r0[c]), static_cast<float>(r0[cn + c]), static_cast<float>(r1[c]),
                          static_cast<float>(r1[cn + c]), o + c);
            }
            continue;
        }
        const bool in_x0 = ix >= 0, in_x1 = ix + 1 < im.w, in_y0 = iy >= 0, in_y1 = iy + 1 < im.h;
        for (int c = 0; c < cn; ++c) {
            const float b = im.border[c];
            const float p00 = in_y0 && in_x0 ? static_cast<float>(r0[c]) : b;
            const float p01 = in_y0 && in_x1 ? static_cast<float>(r0[cn + c]) : b;
            const float p10 = in_y1 && in_x0 ? static_cast<float>(r1[c]) : b;
            const float p11 = in_y1 && in_x1 ? static_cast<float>(r1[cn + c]) : b;
            lerp_taps(ax, ay, p00, p01, p10, p11, o + c);
        }
    }
}

template <typename T>
BODY void bilinear_dispatch(const Image<T>& im, const float* sx, const float* sy, int n, T* out) {
    switch (im.cn) {
        case 1:
            bilinear_body<T, 1>(im, sx, sy, n, out);
            break;
        case 3:
            bilinear_body<T, 3>(im, sx, sy, n, out);
            break;
        case 4:
            bilinear_body<T, 4>(im, sx, sy, n, out);
            break;
        default:
            bilinear_body<T, 0>(im, sx, sy, n, out);
    }
}

// OpenCV's fixed-point bilinear (float64 images): positions in 1/32 of a pixel.
void bilinear_row_fixed(const Image<double>& im, const double* border, const int64_t* x32, const int64_t* y32, int n,
                        double* out) {
    float lo[32], hi[32];
    for (int k = 0; k < 32; ++k) {
        hi[k] = static_cast<float>(k) * (1.f / 32);
        lo[k] = 1.f - hi[k];
    }
    const int cn = im.cn;
    for (int i = 0; i < n; ++i) {
        const int64_t ix = std::min<int64_t>(std::max<int64_t>(x32[i] >> 5, -32768), 32767);
        const int64_t iy = std::min<int64_t>(std::max<int64_t>(y32[i] >> 5, -32768), 32767);
        double* o = out + static_cast<int64_t>(i) * cn;
        if (ix >= im.w || ix < -1 || iy >= im.h || iy < -1) {
            for (int c = 0; c < cn; ++c) {
                o[c] = border[c];
            }
            continue;
        }
        const int fx = static_cast<int>(x32[i] & 31), fy = static_cast<int>(y32[i] & 31);
        const double w[4] = {lo[fy] * lo[fx], lo[fy] * hi[fx], hi[fy] * lo[fx], hi[fy] * hi[fx]};
        const bool in_x0 = ix >= 0, in_x1 = ix + 1 < im.w, in_y0 = iy >= 0, in_y1 = iy + 1 < im.h;
        const double* r0 = im.data + (iy * im.w + ix) * cn;
        const double* r1 = r0 + static_cast<int64_t>(im.w) * cn;
        for (int c = 0; c < cn; ++c) {
            const double p00 = in_y0 && in_x0 ? r0[c] : border[c];
            const double p01 = in_y0 && in_x1 ? r0[cn + c] : border[c];
            const double p10 = in_y1 && in_x0 ? r1[c] : border[c];
            const double p11 = in_y1 && in_x1 ? r1[cn + c] : border[c];
            o[c] = p00 * w[0] + p01 * w[1] + p10 * w[2] + p11 * w[3];
        }
    }
}

constexpr int kVectorColumns = 16;  // columns a step of OpenCV's vector warp loop covers

FMA_CLONES void bilinear_row_f32(const Image<uint8_t>& im, const float* sx, const float* sy, int n, uint8_t* out) {
    bilinear_dispatch(im, sx, sy, n, out);
}
FMA_CLONES void bilinear_row_f32(const Image<float>& im, const float* sx, const float* sy, int n, float* out) {
    bilinear_dispatch(im, sx, sy, n, out);
}

FMA_CLONES void affine_positions(const float* m, int y, int dw, float* sx, float* sy) {
    const float fy = static_cast<float>(y);
    const float ym1 = fy * m[1], ym4 = fy * m[4];
    const float tx = ym1 + m[2], ty = ym4 + m[5];
    const int vec_end = dw - dw % kVectorColumns;
    for (int x = 0; x < vec_end; ++x) {
        sx[x] = std::fma(static_cast<float>(x), m[0], tx);
        sy[x] = std::fma(static_cast<float>(x), m[3], ty);
    }
    for (int x = vec_end; x < dw; ++x) {
        sx[x] = std::fma(static_cast<float>(x), m[0], ym1) + m[2];
        sy[x] = std::fma(static_cast<float>(x), m[3], ym4) + m[5];
    }
}

template <typename T>
void warp_affine_f32(const Image<T>& im, const double* inv, T* dst, int dh, int dw, int threads) {
    float m[6];
    for (int i = 0; i < 6; ++i) {
        m[i] = static_cast<float>(inv[i]);
    }
    parallel_rows(dh, threads, [&](int y0, int y1) {
        std::vector<float> sx(dw), sy(dw);
        for (int y = y0; y < y1; ++y) {
            affine_positions(m, y, dw, sx.data(), sy.data());
            bilinear_row_f32(im, sx.data(), sy.data(), dw, dst + static_cast<int64_t>(y) * dw * im.cn);
        }
    });
}

void warp_affine_f64(const Image<double>& im, const double* border, const double* m, double* dst, int dh, int dw,
                     int threads) {
    std::vector<int64_t> col_x(dw), col_y(dw);
    for (int x = 0; x < dw; ++x) {
        col_x[x] = static_cast<int64_t>(std::nearbyint(m[0] * x * 1024));
        col_y[x] = static_cast<int64_t>(std::nearbyint(m[3] * x * 1024));
    }
    parallel_rows(dh, threads, [&](int y0, int y1) {
        std::vector<int64_t> x32(dw), y32(dw);
        for (int y = y0; y < y1; ++y) {
            const int64_t row_x = static_cast<int64_t>(std::nearbyint((m[1] * y + m[2]) * 1024)) + 16;
            const int64_t row_y = static_cast<int64_t>(std::nearbyint((m[4] * y + m[5]) * 1024)) + 16;
            for (int x = 0; x < dw; ++x) {
                x32[x] = (row_x + col_x[x]) >> 5;
                y32[x] = (row_y + col_y[x]) >> 5;
            }
            bilinear_row_fixed(im, border, x32.data(), y32.data(), dw, dst + static_cast<int64_t>(y) * dw * im.cn);
        }
    });
}

// a map position in 1/32 of a pixel, kept within int range
inline int64_t map_fixed(float v) {
    const double r = std::nearbyint(static_cast<double>(v) * 32);
    if (std::isnan(r)) {
        return INT_MIN;
    }
    return static_cast<int64_t>(std::min(std::max(r, -1073741824.0), 1073741824.0));
}

template <typename T>
int warp_typed(const void* src, int sh, int sw, int cn, void* dst, int dh, int dw, const double* matrix,
               const float* map_x, const float* map_y, const double* border, int threads) {
    std::vector<float> border_f(cn);
    for (int c = 0; c < cn; ++c) {
        if constexpr (std::is_same_v<T, uint8_t>) {
            border_f[c] = static_cast<float>(saturate<uint8_t>(border[c]));
        } else {
            border_f[c] = static_cast<float>(border[c]);
        }
    }
    const Image<T> im{static_cast<const T*>(src), sh, sw, cn, border_f.data()};
    T* out = static_cast<T*>(dst);
    if constexpr (std::is_same_v<T, double>) {
        const Image<double> imd{static_cast<const double*>(src), sh, sw, cn, nullptr};
        if (matrix != nullptr) {
            double m[6];
            invert_affine(matrix, m);
            warp_affine_f64(imd, border, m, out, dh, dw, threads);
            return kOk;
        }
        parallel_rows(dh, threads, [&](int y0, int y1) {
            std::vector<int64_t> x32(dw), y32(dw);
            for (int y = y0; y < y1; ++y) {
                for (int x = 0; x < dw; ++x) {
                    x32[x] = map_fixed(map_x[static_cast<int64_t>(y) * dw + x]);
                    y32[x] = map_fixed(map_y[static_cast<int64_t>(y) * dw + x]);
                }
                bilinear_row_fixed(imd, border, x32.data(), y32.data(), dw, out + static_cast<int64_t>(y) * dw * cn);
            }
        });
        return kOk;
    } else {
        if (matrix != nullptr) {
            double m[6];
            invert_affine(matrix, m);
            warp_affine_f32<T>(im, m, out, dh, dw, threads);
            return kOk;
        }
        parallel_rows(dh, threads, [&](int y0, int y1) {
            for (int y = y0; y < y1; ++y) {
                const int64_t row = static_cast<int64_t>(y) * dw;
                bilinear_row_f32(im, map_x + row, map_y + row, dw, out + row * cn);
            }
        });
        return kOk;
    }
}

// ---------------------------------------------------------------- blur

// BORDER_REFLECT_101 index of i in [0, n)
inline int reflect101(int i, int n) {
    if (n == 1) {
        return 0;
    }
    const int period = 2 * (n - 1);
    i %= period;
    if (i < 0) {
        i += period;
    }
    return i >= n ? period - i : i;
}

void blur_u8(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int kw, int kh, int threads) {
    const int ax = kw / 2, ay = kh / 2;
    const int width = w * cn;
    const int area = kw * kh;
    std::vector<int> cols(w + kw - 1);
    for (int i = 0; i < w + kw - 1; ++i) {
        cols[i] = reflect101(i - ax, w) * cn;
    }
    // OpenCV's rounding of the mean: 23-bit fixed point while the sums fit
    // 16 bits, else float32 in the row's 8-wide vector body, double in its tail
    const bool fixed = area * 255 <= 65535;
    int div_scale = 1, div_delta = 0;
    if (fixed && area != 1) {
        const int d = area;
        double scalef = static_cast<double>(1 << 23) / d;
        div_scale = cv_floor(scalef);
        scalef -= div_scale;
        div_delta = d / 2;
        if (scalef < 0.5) {
            div_delta++;
        } else {
            div_scale++;
        }
    }
    const double scale = 1.0 / area;
    const float scale_f = static_cast<float>(scale);
    const int vec_end = width - width % 8;
    parallel_rows(h, threads, [&](int y0, int y1) {
        // ring of the kh padded rows' horizontal sums, exact in integers
        std::vector<int> ring(static_cast<size_t>(kh) * width), sum(width, 0);
        auto row_sum = [&](int y, int* row) {
            const uint8_t* s = src + static_cast<int64_t>(reflect101(y, h)) * width;
            for (int c = 0; c < cn; ++c) {
                int v = 0;
                for (int k = 0; k < kw; ++k) {
                    v += s[cols[k] + c];
                }
                row[c] = v;
                for (int x = 1; x < w; ++x) {
                    v += s[cols[x + kw - 1] + c] - s[cols[x - 1] + c];
                    row[x * cn + c] = v;
                }
            }
        };
        for (int k = 0; k < kh - 1; ++k) {
            int* row = ring.data() + static_cast<size_t>(k) * width;
            row_sum(y0 - ay + k, row);
            for (int i = 0; i < width; ++i) {
                sum[i] += row[i];
            }
        }
        for (int y = y0; y < y1; ++y) {
            const int k_new = (y - y0 + kh - 1) % kh, k_old = (y - y0) % kh;
            int* row = ring.data() + static_cast<size_t>(k_new) * width;
            row_sum(y - ay + kh - 1, row);
            const int* old = ring.data() + static_cast<size_t>(k_old) * width;
            uint8_t* d = dst + static_cast<int64_t>(y) * width;
            for (int i = 0; i < width; ++i) {
                const int s = sum[i] + row[i];
                if (area == 1) {
                    d[i] = static_cast<uint8_t>(s);
                } else if (fixed) {
                    d[i] = static_cast<uint8_t>((static_cast<int64_t>(s + div_delta) * div_scale) >> 23);
                } else if (i < vec_end) {
                    d[i] = clamp_u8(cv_round(static_cast<float>(s) * scale_f));
                } else {
                    d[i] = clamp_u8(cv_round(s * scale));
                }
                sum[i] = s - old[i];
            }
        }
    });
}

template <typename T>
void blur_float(const T* src, int h, int w, int cn, T* dst, int kw, int kh, int threads) {
    const int ax = kw / 2, ay = kh / 2;
    const int width = w * cn;
    std::vector<int> cols(w + kw - 1);
    for (int i = 0; i < w + kw - 1; ++i) {
        cols[i] = reflect101(i - ax, w) * cn;
    }
    const bool direct = kw == 3 || kw == 5 || (kw <= 5 && kh <= 5);
    // rows: each padded row's sums in double (rows are independent)
    const int ph = h + kh - 1;
    std::vector<double> rows(static_cast<size_t>(ph) * width);
    parallel_rows(ph, threads, [&](int r0, int r1) {
        for (int r = r0; r < r1; ++r) {
            const T* s = src + static_cast<int64_t>(reflect101(r - ay, h)) * width;
            double* o = rows.data() + static_cast<size_t>(r) * width;
            for (int c = 0; c < cn; ++c) {
                if (direct) {
                    for (int x = 0; x < w; ++x) {
                        double v = static_cast<double>(s[cols[x] + c]);
                        for (int k = 1; k < kw; ++k) {
                            v += static_cast<double>(s[cols[x + k] + c]);
                        }
                        o[x * cn + c] = v;
                    }
                    continue;
                }
                double v = 0;
                for (int k = 0; k < kw; ++k) {
                    v += static_cast<double>(s[cols[k] + c]);
                }
                o[c] = v;
                for (int x = 1; x < w; ++x) {
                    v += static_cast<double>(s[cols[x + kw - 1] + c]) - static_cast<double>(s[cols[x - 1] + c]);
                    o[x * cn + c] = v;
                }
            }
        }
    });
    // columns: a running sum down the whole image, so split by columns
    const double scale = 1.0 / (kw * kh);
    parallel_rows(width, threads, [&](int c0, int c1) {
        std::vector<double> run(c1 - c0, 0.0);
        for (int i = 0; i < kh - 1; ++i) {
            const double* r = rows.data() + static_cast<size_t>(i) * width;
            for (int x = c0; x < c1; ++x) {
                run[x - c0] = run[x - c0] + r[x];
            }
        }
        for (int y = 0; y < h; ++y) {
            const double* add = rows.data() + static_cast<size_t>(y + kh - 1) * width;
            const double* sub = rows.data() + static_cast<size_t>(y) * width;
            T* d = dst + static_cast<int64_t>(y) * width;
            for (int x = c0; x < c1; ++x) {
                const double total = run[x - c0] + add[x];
                d[x] = static_cast<T>(total * scale);
                run[x - c0] = total - sub[x];
            }
        }
    });
}

// ---------------------------------------------------------------- erode and dilate

// o[i] = max (min) of a[i] and b[i], 16 bytes at a time where SSE2 is there
inline void extreme2(uint8_t* o, const uint8_t* a, const uint8_t* b, size_t n, bool dilate) {
    size_t i = 0;
#if defined(__SSE2__)
    if (dilate) {
        for (; i + 16 <= n; i += 16) {
            const __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(a + i));
            const __m128i y = _mm_loadu_si128(reinterpret_cast<const __m128i*>(b + i));
            _mm_storeu_si128(reinterpret_cast<__m128i*>(o + i), _mm_max_epu8(x, y));
        }
    } else {
        for (; i + 16 <= n; i += 16) {
            const __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(a + i));
            const __m128i y = _mm_loadu_si128(reinterpret_cast<const __m128i*>(b + i));
            _mm_storeu_si128(reinterpret_cast<__m128i*>(o + i), _mm_min_epu8(x, y));
        }
    }
#endif
    for (; i < n; ++i) {
        o[i] = dilate ? std::max(a[i], b[i]) : std::min(a[i], b[i]);
    }
}

// d[i] = max (min) of d[i], a[i] and b[i]
inline void extreme3(uint8_t* d, const uint8_t* a, const uint8_t* b, size_t n, bool dilate) {
    size_t i = 0;
#if defined(__SSE2__)
    if (dilate) {
        for (; i + 16 <= n; i += 16) {
            const __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(a + i));
            const __m128i y = _mm_loadu_si128(reinterpret_cast<const __m128i*>(b + i));
            const __m128i z = _mm_loadu_si128(reinterpret_cast<const __m128i*>(d + i));
            _mm_storeu_si128(reinterpret_cast<__m128i*>(d + i), _mm_max_epu8(z, _mm_max_epu8(x, y)));
        }
    } else {
        for (; i + 16 <= n; i += 16) {
            const __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(a + i));
            const __m128i y = _mm_loadu_si128(reinterpret_cast<const __m128i*>(b + i));
            const __m128i z = _mm_loadu_si128(reinterpret_cast<const __m128i*>(d + i));
            _mm_storeu_si128(reinterpret_cast<__m128i*>(d + i), _mm_min_epu8(z, _mm_min_epu8(x, y)));
        }
    }
#endif
    for (; i < n; ++i) {
        d[i] = dilate ? std::max(d[i], std::max(a[i], b[i])) : std::min(d[i], std::min(a[i], b[i]));
    }
}

struct Run {
    int dy, dx, len;  // kernel row offset, first column offset (from the anchor), length
};

// dst = max (dilate) or min (erode) over the kernel's pixels of src, the
// anchor at (ay, ax); outside pixels are the operation's neutral value.
void morph_u8(const uint8_t* src, int h, int w, int cn, uint8_t* dst, const uint8_t* kernel, int kh, int kw, int ay,
              int ax, bool dilate, int threads) {
    std::vector<Run> runs;
    int max_len = 1;
    for (int i = 0; i < kh; ++i) {
        for (int j = 0; j < kw;) {
            if (!kernel[i * kw + j]) {
                ++j;
                continue;
            }
            int k = j;
            while (k < kw && kernel[i * kw + k]) {
                ++k;
            }
            runs.push_back({i - ay, j - ax, k - j});
            max_len = std::max(max_len, k - j);
            j = k;
        }
    }
    const uint8_t neutral = dilate ? 0 : 255;
    const int width = w * cn;
    if (runs.empty()) {
        std::memset(dst, neutral, static_cast<size_t>(h) * width);
        return;
    }
    int levels = 1;
    while ((1 << levels) <= max_len) {
        ++levels;
    }
    int left = 0, right = 0;  // columns the runs reach left and right of a pixel
    for (const Run& r : runs) {
        left = std::max(left, -r.dx);
        right = std::max(right, r.dx + r.len - 1);
    }
    const int pad_l = left, pad_w = w + left + right + max_len;  // padded row, in pixels
    int top = 0, bottom = 0;
    for (const Run& r : runs) {
        top = std::max(top, -r.dy);
        bottom = std::max(bottom, r.dy);
    }
    constexpr int kBlock = 64;  // output rows a table covers
    parallel_rows(h, threads, [&](int t0, int t1) {
        // table[l][r][x]: max (min) of 2^l pixels from padded column x of source row r
        const size_t row_bytes = static_cast<size_t>(pad_w) * cn;
        const int max_rows = std::min(kBlock, t1 - t0) + top + bottom;
        std::vector<uint8_t> table(static_cast<size_t>(levels) * max_rows * row_bytes);
        for (int y0 = t0; y0 < t1; y0 += kBlock) {
            const int y1 = std::min(t1, y0 + kBlock);
            const int n_rows = (y1 - y0) + top + bottom;
            auto at = [&](int l, int r) { return table.data() + (static_cast<size_t>(l) * max_rows + r) * row_bytes; };
            for (int r = 0; r < n_rows; ++r) {
                const int sy = y0 - top + r;
                uint8_t* base = at(0, r);
                std::memset(base, neutral, row_bytes);
                if (sy >= 0 && sy < h) {
                    std::memcpy(base + static_cast<size_t>(pad_l) * cn, src + static_cast<int64_t>(sy) * width, width);
                }
                for (int l = 1; l < levels; ++l) {
                    const size_t half = (static_cast<size_t>(1) << (l - 1)) * cn;
                    const uint8_t* a = at(l - 1, r);
                    const uint8_t* b = a + half;
                    uint8_t* o = at(l, r);
                    const size_t n = row_bytes - half;
                    extreme2(o, a, b, n, dilate);
                    std::memset(o + n, neutral, half);
                }
            }
            for (int y = y0; y < y1; ++y) {
                uint8_t* d = dst + static_cast<int64_t>(y) * width;
                std::memset(d, neutral, width);
                for (const Run& run : runs) {
                    int l = 0;
                    while ((2 << l) <= run.len) {
                        ++l;
                    }
                    const int r = y - y0 + top + run.dy;
                    const uint8_t* a = at(l, r) + static_cast<ptrdiff_t>(pad_l + run.dx) * cn;
                    const uint8_t* b = a + static_cast<ptrdiff_t>(run.len - (1 << l)) * cn;
                    extreme3(d, a, b, width, dilate);
                }
            }
        }
    });
}

}  // namespace

extern "C" {

// cv2.resize(src, (dw, dh), interpolation=interp) of a [sh, sw, cn] image of
// ``depth`` (0 uint8, 1 uint16, 2 int16, 3 float32, 4 float64); interp is
// cv2's INTER_* number (0 nearest, 1 linear, 2 cubic, 3 area, 5 linear exact).
int imgproc_resize(const void* src, int sh, int sw, int cn, int depth, void* dst, int dh, int dw, int interp,
                   int threads) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1 || cn < 1) {
        return kBadSize;
    }
    switch (depth) {
        case kU8:
            return resize_typed(static_cast<const uint8_t*>(src), sh, sw, cn, static_cast<uint8_t*>(dst), dh, dw, interp,
                                threads);
        case kU16:
            return resize_typed(static_cast<const uint16_t*>(src), sh, sw, cn, static_cast<uint16_t*>(dst), dh, dw,
                                interp, threads);
        case kS16:
            return resize_typed(static_cast<const int16_t*>(src), sh, sw, cn, static_cast<int16_t*>(dst), dh, dw, interp,
                                threads);
        case kF32:
            return resize_typed(static_cast<const float*>(src), sh, sw, cn, static_cast<float*>(dst), dh, dw, interp,
                                threads);
        case kF64:
            return resize_typed(static_cast<const double*>(src), sh, sw, cn, static_cast<double*>(dst), dh, dw, interp,
                                threads);
        default:
            return kBadDepth;
    }
}

// cv2.warpAffine(src, matrix, (dw, dh), INTER_LINEAR, BORDER_CONSTANT, border)
// of a uint8, float32 or float64 image; ``matrix`` is the 2x3 forward map.
int imgproc_warp_affine(const void* src, int sh, int sw, int cn, int depth, void* dst, int dh, int dw,
                        const double* matrix, const double* border, int threads) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1 || cn < 1) {
        return kBadSize;
    }
    switch (depth) {
        case kU8:
            return warp_typed<uint8_t>(src, sh, sw, cn, dst, dh, dw, matrix, nullptr, nullptr, border, threads);
        case kF32:
            return warp_typed<float>(src, sh, sw, cn, dst, dh, dw, matrix, nullptr, nullptr, border, threads);
        case kF64:
            return warp_typed<double>(src, sh, sw, cn, dst, dh, dw, matrix, nullptr, nullptr, border, threads);
        default:
            return kBadDepth;
    }
}

// cv2.remap(src, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT, border) with
// float32 [dh, dw] maps.
int imgproc_remap(const void* src, int sh, int sw, int cn, int depth, const float* map_x, const float* map_y, void* dst,
                  int dh, int dw, const double* border, int threads) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1 || cn < 1) {
        return kBadSize;
    }
    switch (depth) {
        case kU8:
            return warp_typed<uint8_t>(src, sh, sw, cn, dst, dh, dw, nullptr, map_x, map_y, border, threads);
        case kF32:
            return warp_typed<float>(src, sh, sw, cn, dst, dh, dw, nullptr, map_x, map_y, border, threads);
        case kF64:
            return warp_typed<double>(src, sh, sw, cn, dst, dh, dw, nullptr, map_x, map_y, border, threads);
        default:
            return kBadDepth;
    }
}

// cv2.blur(src, (kw, kh)) of a uint8, float32 or float64 image.
int imgproc_blur(const void* src, int h, int w, int cn, int depth, void* dst, int kw, int kh, int threads) {
    if (h < 1 || w < 1 || cn < 1 || kw < 1 || kh < 1) {
        return kBadSize;
    }
    switch (depth) {
        case kU8:
            blur_u8(static_cast<const uint8_t*>(src), h, w, cn, static_cast<uint8_t*>(dst), kw, kh, threads);
            return kOk;
        case kF32:
            blur_float(static_cast<const float*>(src), h, w, cn, static_cast<float*>(dst), kw, kh, threads);
            return kOk;
        case kF64:
            blur_float(static_cast<const double*>(src), h, w, cn, static_cast<double*>(dst), kw, kh, threads);
            return kOk;
        default:
            return kBadDepth;
    }
}

// cv2.erode (op 0) or cv2.dilate (op 1) of a uint8 [h, w, cn] image with the
// uint8 [kh, kw] structuring element ``kernel`` (non-zero pixels count) and
// the default anchor (kh / 2, kw / 2) and border; a 1x1 kernel copies.
int imgproc_morph(const uint8_t* src, int h, int w, int cn, uint8_t* dst, const uint8_t* kernel, int kh, int kw, int op,
                  int threads) {
    if (h < 1 || w < 1 || cn < 1 || kh < 1 || kw < 1) {
        return kBadSize;
    }
    if (op != 0 && op != 1) {
        return kBadMode;
    }
    if (kh == 1 && kw == 1) {
        std::memcpy(dst, src, static_cast<size_t>(h) * w * cn);
        return kOk;
    }
    morph_u8(src, h, w, cn, dst, kernel, kh, kw, kh / 2, kw / 2, op == 1, threads);
    return kOk;
}

}  // extern "C"

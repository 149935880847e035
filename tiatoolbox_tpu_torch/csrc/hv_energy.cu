// HoVer-Net watershed energy for Hopper (sm_90a): kernel K5.
//
// Replaces the XLA program `hv_energy` of tiatoolbox_tpu/ops/hv_energy.py:37-90
// (cv2's host front-end of hovernet.py:503-617 moved to the device):
//
//   h' = minmax(hv[..., 0])          v' = minmax(hv[..., 1])
//   Sh = sep(h', k_x = deriv, k_y = smooth)     (Sobel dx on h)
//   Sv = sep(v', k_x = smooth, k_y = deriv)     (Sobel dy on v)
//   out = max(1 - minmax(Sh), 1 - minmax(Sv))
//
// where minmax(x) = (x - min x) / max(max x - min x, 1e-30) over the whole
// map and sep() correlates along x, then along y, with BORDER_REFLECT_101
// edges (reflected as often as a small map needs). The normalisation comes
// before the convolution, as in JAX; it is not folded into the taps.
//
// The raw-canvas entry takes a count map as well and divides the hv pair by
// max(count, 1) as it loads it, with the same IEEE division as K3
// (canvas.cu), so it equals K3 followed by this kernel bit for bit and the
// caller needs no normalised copy of the canvas.
//
// A caller that already has the normalised pair's (min h, max h, min v,
// max v) on the card passes it (`minmax`): the entry then skips pass 1 and
// its ticket. K6 (canvas.cu) reduces that float4 while it packs the fetch
// plane from the same canvas sectors, with the same division and merge
// (common.cuh), so the energy keeps its bits and the canvas is read once
// less.
//
// What bounds it: device memory. The function must read the hv pair (8 B a
// pixel) and write the energy (4 B); its 2 x 2 x 21 multiply-adds a pixel
// take under a third of that time at the float32 rate. Two global min/max
// reductions stand between the input and the output, so the design makes
// three passes, three launches on the caller's stream (after one 8-byte
// memset of the tickets), no host synchronisation:
//
//   1. hv_minmax: min and max of h and v, a persistent grid with four
//      pixels' loads in flight a thread; the last block to finish (an atomic
//      ticket after __threadfence) reduces the blocks' partials. Reads the
//      pair (16 B a pixel from a 4-channel canvas, whose 32-byte sectors hold
//      whole pixels; 20 B with the count).
//   2. sobel_strip<K>: a block of 256 threads owns a strip of 128 columns,
//      threads 0-127 carrying h and 128-255 v, and walks down a run of rows
//      (400 at phase D, sized so that the grid fills the card once) in
//      stages of K rows (K = ksize, fixed at compile time for every odd size
//      3-31). A stage's K input rows of the strip and its 2R-column halo come
//      in by cp.async, one stage ahead into a second buffer, and each thread
//      normalises the elements it copied, once, in place (reflected indices
//      only on border strips and runs). The row pass makes 4 adjacent outputs
//      from one register window of 4 + 2R values read as float4s; the column
//      pass keeps each column's last K row-pass values in a register ring
//      unrolled K times, so the ring needs no moves and its taps no shared
//      memory. The 2R-row halo is paid once a run, not once a tile. Sh and Sv
//      go out interleaved, (Sh, Sv) per pixel; the last block reduces the
//      blocks' min/max partials as in pass 1. Reads the pair once more (plus
//      the halos) and writes 8 B a pixel.
//   3. combine: reads (Sh, Sv) as float4 (two pixels), writes four outputs
//      as one 16-byte (float16: 8-byte) store.
//
// Passes 2 and 3 are launched as programmatic dependents (Hopper): each may
// start while the previous pass drains, and waits for it only where it reads
// what it wrote, so pass 2's first copies overlap pass 1's tail. Divisions by
// a value fixed for many elements (the min/max range, the count) use the
// reciprocal and one fma correction, which gives the same bits as IEEE
// division (div_rcp); the count's division is still K3's to the bit.
//
// Bytes moved a pixel, phase D's 4-channel view: 16 + 16 x 1.05 (the row
// halo) + 8 + 8 + 4, about 53 B (62 B from the raw canvas with the count)
// against the 12 B of the bound; PERF.md gives the time against both. Sums
// take the taps in order with fmaf, as the tile-based design this one
// replaced did, and the two agree bit for bit; against cuDNN's or XLA's order
// they differ by a few ulp, within 2e-6 after the [0, 1] normalisations.

#include <atomic>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 31;     // ksize up to 31 (radius 15), as cv2's Sobel
constexpr int kThreads = 256;    // min/max and combine blocks
constexpr int kStrip = 128;      // columns of a Sobel block
constexpr int kStripThreads = 2 * kStrip;  // one thread a column and channel
constexpr int kRowOut = 4;       // adjacent row-pass outputs from one register window
constexpr int kGroupsPerRow = kStrip / kRowOut;
static_assert(kGroupsPerRow % 32 == 0, "a warp's row-pass units must share a channel");

struct Taps {
    float deriv[kMaxTaps];
    float smooth[kMaxTaps];
};

// Pixel (y, x) of the hv pair at hv[y * rs + x * ps + {0, 1}]; with a count
// map (cnt != nullptr) divided by max(cnt[y * crs + x * cps], 1).
struct HvMap {
    const float* hv;
    int64_t rs, ps;
    const float* cnt;
    int64_t crs, cps;
    int h, w;
};

// The raw pair and count of pixel (y, x), loads only: a caller issues a
// batch of these before any division, whose slow-path branch would otherwise
// split the batch and leave one load in flight at a time.
struct RawPair {
    float a, b, n;
};

__device__ __forceinline__ RawPair load_raw(HvMap m, int y, int x) {
    const float* p = m.hv + y * m.rs + x * m.ps;
    return {__ldg(p), __ldg(p + 1), m.cnt != nullptr ? __ldg(m.cnt + y * m.crs + x * m.cps) : 1.0f};
}

// The pair divided by max(count, 1) (K3's division), where there is a count.
__device__ __forceinline__ float2 divide(HvMap m, RawPair r) {
    if (m.cnt == nullptr) {
        return make_float2(r.a, r.b);
    }
    const float n = fmaxf(r.n, 1.0f);
    const float rn = __frcp_rn(n);
    return make_float2(div_rcp(r.a, n, rn), div_rcp(r.b, n, rn));
}

// Programmatic dependent launch (Hopper): a kernel launched with
// launch_after() may start while the previous kernel on the stream runs;
// it calls wait_for_previous() before it reads what that kernel wrote, which
// returns once the previous grid has finished and its writes are visible.
// allow_next() lets the next such kernel start early. Both are no-ops in a
// kernel launched the ordinary way.
__device__ __forceinline__ void wait_for_previous() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void allow_next() { asm volatile("griddepcontrol.launch_dependents;"); }

__device__ __forceinline__ int reflect101(int i, int n) {
    if (n == 1) {
        return 0;
    }
    const int period = 2 * (n - 1);
    i = abs(i) % period;
    return i >= n ? period - i : i;
}

// Pass 1: rows across blocks (grid-striding), columns across threads, four
// pixels a thread in flight.
__global__ void __launch_bounds__(kThreads) hv_minmax(HvMap m, float4* partials, unsigned* ticket,
                                                      float4* result) {
    allow_next();
    float4 acc = empty_minmax();
    for (int y = blockIdx.x; y < m.h; y += gridDim.x) {
        for (int x0 = threadIdx.x; x0 < m.w; x0 += 4 * kThreads) {
            RawPair r[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int x = x0 + q * kThreads;
                if (x < m.w) {
                    r[q] = load_raw(m, y, x);
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (x0 + q * kThreads < m.w) {
                    const float2 p = divide(m, r[q]);
                    acc = merge(acc, p.x, p.y);
                }
            }
        }
    }
    grid_minmax(acc, partials, ticket, result);
}

// Shared memory of sobel_strip<K>: two buffers of a stage's input rows of h
// and v ([K][kIn] each, kIn >= kStrip + 2R columns, whole float4s for the
// row windows), one of the count where there is one, then the row-pass rows
// ([K][kStrip] each). The input planes are filled raw by asynchronous copies
// and normalised in place; the next stage's copies go to the other buffer.
template <int K>
struct StripShape {
    static constexpr int kRadius = K / 2;
    static constexpr int kWindow = (kRowOut + K - 1 + 3) / 4 * 4;
    static constexpr int kIn = kStrip - kRowOut + kWindow;
    static constexpr int kCopies = (K * kIn + kStripThreads - 1) / kStripThreads;
    static constexpr size_t smem(bool with_count) {
        return sizeof(float) * K * ((with_count ? 5 : 4) * kIn + 2 * kStrip);
    }
};

// Input element e of a stage: row e / kIn, column e % kIn of the planes.
// Thread tid copies (and later normalises) elements tid + i * kStripThreads.
template <int K>
__device__ __forceinline__ void copy_stage(HvMap m, int row0, bool row_border, int col0,
                                           bool col_border, float* in, float* in_n) {
    using Shape = StripShape<K>;
    constexpr int kIn = Shape::kIn;
#pragma unroll
    for (int i = 0; i < Shape::kCopies; ++i) {
        const int e = threadIdx.x + i * kStripThreads;
        if (e < K * kIn) {
            const int u = e / kIn;
            const int j = e - u * kIn;
            const int gy = row_border ? reflect101(row0 + u, m.h) : row0 + u;
            const int gx = col_border ? reflect101(col0 + j, m.w) : col0 + j;
            const float* p = m.hv + gy * m.rs + gx * m.ps;
            __pipeline_memcpy_async(in + e, p, sizeof(float));
            __pipeline_memcpy_async(in + K * kIn + e, p + 1, sizeof(float));
            if (m.cnt != nullptr) {
                __pipeline_memcpy_async(in_n + e, m.cnt + gy * m.crs + gx * m.cps, sizeof(float));
            }
        }
    }
    __pipeline_commit();
}

// Row pass of one channel: kRowOut adjacent outputs of row u from one
// register window, taps (the derivative's, or the smoothing's) in order.
template <int K, bool kDeriv>
__device__ __forceinline__ void row_window(const float* src, float* dst, const Taps& taps,
                                           int u, int col) {
    using Shape = StripShape<K>;
    float win[Shape::kWindow];
    const float4* w4 = reinterpret_cast<const float4*>(src + u * Shape::kIn + col);
#pragma unroll
    for (int i = 0; i < Shape::kWindow / 4; ++i) {
        const float4 q = w4[i];
        win[4 * i] = q.x;
        win[4 * i + 1] = q.y;
        win[4 * i + 2] = q.z;
        win[4 * i + 3] = q.w;
    }
    float o[kRowOut];
#pragma unroll
    for (int p = 0; p < kRowOut; ++p) {
        float a = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            a = fmaf(kDeriv ? taps.deriv[k] : taps.smooth[k], win[p + k], a);
        }
        o[p] = a;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + u * kStrip + col);
#pragma unroll
    for (int i = 0; i < kRowOut / 4; ++i) {
        d4[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
    }
}

// Column pass of one channel over a stage: each new row-pass value goes into
// the register ring, and each full window gives one output, taps in order
// (the ring is unrolled K times, so its indices are fixed).
template <int K, bool kDeriv>
__device__ __forceinline__ void column_ring(const float* rows, const Taps& taps, float (&ring)[K],
                                            int stage, int y0, int y_end, int x, int w,
                                            float* out, float2& range) {
    constexpr int R = K / 2;
#pragma unroll
    for (int u = 0; u < K; ++u) {
        ring[u] = rows[u * kStrip + (threadIdx.x & (kStrip - 1))];
        const int i = stage * K + u;  // input row of the run
        const int y = y0 + i - 2 * R;
        if (i >= 2 * R && y < y_end && x < w) {
            float a = 0.0f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                a = fmaf(kDeriv ? taps.deriv[k] : taps.smooth[k], ring[(u + 1 + k) % K], a);
            }
            out[2 * (static_cast<int64_t>(y) * w + x)] = a;
            range = make_float2(fminf(range.x, a), fmaxf(range.y, a));
        }
    }
}

// Pass 2: Sobel of one strip and run of rows (see the file's note). Threads
// 0-127 carry h, 128-255 v, one column each. Per stage: wait for the
// thread's own copies and normalise them in place; barrier; start the next
// stage's copies into the other buffer, which overlap the row pass, its
// barrier and the column pass. Two blocks an SM, at up to 128 registers a
// thread: three, at 85, ran slower.
template <int K>
__global__ void __launch_bounds__(kStripThreads, 2)
    sobel_strip(HvMap m, const float4* __restrict__ hv_mm, Taps taps, int run_rows,
                float2* __restrict__ s, float4* partials, unsigned* ticket, float4* s_mm) {
    using Shape = StripShape<K>;
    constexpr int R = Shape::kRadius;
    constexpr int kIn = Shape::kIn;
    extern __shared__ float4 smem4[];
    float* in_buf = reinterpret_cast<float*>(smem4);  // [2][h, v][K][kIn]
    float* row_h = in_buf + 4 * K * kIn;
    float* row_v = row_h + K * kStrip;
    float* in_n = row_v + K * kStrip;

    const int tid = threadIdx.x;
    const int channel = tid / kStrip;  // warp-uniform
    const int x0 = blockIdx.x * kStrip;
    const int y0 = blockIdx.y * run_rows;
    const int y_end = min(y0 + run_rows, m.h);
    const int n_stages = (y_end - y0 + 2 * R + K - 1) / K;
    const int col0 = x0 - R;
    const bool col_border = col0 < 0 || col0 + kIn > m.w;
    const int x = x0 + (tid & (kStrip - 1));
    auto row_border = [&](int stage) {
        const int row0 = y0 - R + stage * K;
        return row0 < 0 || row0 + K > m.h;
    };
    copy_stage<K>(m, y0 - R, row_border(0), col0, col_border, in_buf, in_n);
    allow_next();
    wait_for_previous();  // pass 1's min/max, and its partials' slots
    const float4 mm = *hv_mm;
    const float dh = fmaxf(mm.y - mm.x, 1e-30f);
    const float dv = fmaxf(mm.w - mm.z, 1e-30f);
    const float rdh = 1.0f / dh;
    const float rdv = 1.0f / dv;

    float ring[K];
    float2 acc = make_float2(CUDART_INF_F, -CUDART_INF_F);
    float* out = reinterpret_cast<float*>(s) + channel;
    for (int stage = 0; stage < n_stages; ++stage) {
        float* in_h = in_buf + (stage & 1) * 2 * K * kIn;
        float* in_v = in_h + K * kIn;
        // 1. this thread's copies of the stage, each element normalised once
        __pipeline_wait_prior(0);
#pragma unroll
        for (int i = 0; i < Shape::kCopies; ++i) {
            const int e = tid + i * kStripThreads;
            if (e < K * kIn) {
                float2 p = make_float2(in_h[e], in_v[e]);
                if (m.cnt != nullptr) {
                    p = divide(m, RawPair{p.x, p.y, in_n[e]});
                }
                in_h[e] = div_rcp(p.x - mm.x, dh, rdh);
                in_v[e] = div_rcp(p.y - mm.z, dv, rdv);
            }
        }
        __syncthreads();
        if (stage + 1 < n_stages) {
            copy_stage<K>(m, y0 - R + (stage + 1) * K, row_border(stage + 1), col0, col_border,
                          in_buf + ((stage + 1) & 1) * 2 * K * kIn, in_n);
        }
        // 2. row pass (k_x): deriv on h, smooth on v; a channel's K x 32
        //    units fill whole warps, so a warp's units share a channel
        for (int unit = tid; unit < 2 * K * kGroupsPerRow; unit += kStripThreads) {
            const int c = unit / (K * kGroupsPerRow);
            const int rest = unit - c * K * kGroupsPerRow;
            const int u = rest / kGroupsPerRow;
            const int col = (rest - u * kGroupsPerRow) * kRowOut;
            if (c == 0) {
                row_window<K, true>(in_h, row_h, taps, u, col);
            } else {
                row_window<K, false>(in_v, row_v, taps, u, col);
            }
        }
        __syncthreads();
        // 3. column pass (k_y): smooth on h, deriv on v, from the register ring
        if (channel == 0) {
            column_ring<K, false>(row_h, taps, ring, stage, y0, y_end, x, m.w, out, acc);
        } else {
            column_ring<K, true>(row_v, taps, ring, stage, y0, y_end, x, m.w, out, acc);
        }
    }
    const float4 inf4 = empty_minmax();
    grid_minmax(channel == 0 ? make_float4(acc.x, acc.y, inf4.z, inf4.w)
                             : make_float4(inf4.x, inf4.y, acc.x, acc.y),
                partials, ticket, s_mm);
}

__device__ __forceinline__ float energy(float sh, float sv, float4 mm, float dh, float dv) {
    return fmaxf(1.0f - (sh - mm.x) / dh, 1.0f - (sv - mm.z) / dv);
}

// Pass 3: four pixels a thread and step, grid-striding; the last n % 4
// pixels one a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads) combine(const float4* __restrict__ s2, int64_t n,
                                                    const float4* __restrict__ s_mm,
                                                    T* __restrict__ out) {
    wait_for_previous();  // pass 2's (Sh, Sv) and their min/max
    const float4 mm = *s_mm;
    const float dh = fmaxf(mm.y - mm.x, 1e-30f);
    const float dv = fmaxf(mm.w - mm.z, 1e-30f);
    const int64_t n4 = n / 4;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t g = first; g < n4; g += step) {
        const float4 a = __ldcs(s2 + 2 * g);
        const float4 b = __ldcs(s2 + 2 * g + 1);
        store4(out + 4 * g, make_float4(energy(a.x, a.y, mm, dh, dv), energy(a.z, a.w, mm, dh, dv),
                                        energy(b.x, b.y, mm, dh, dv), energy(b.z, b.w, mm, dh, dv)));
    }
    const int64_t i = 4 * n4 + first;
    if (i < n) {
        const float2 p = reinterpret_cast<const float2*>(s2)[i];
        store1(out + i, energy(p.x, p.y, mm, dh, dv));
    }
}

// Grid of sobel_strip<K> for an h x w map: strips of kStrip columns, and runs
// of rows sized so that strips x runs fills the card once, each run a whole
// number of K-row stages (2R of them halo).
struct StripGrid {
    int strips, runs, run_rows;
};

template <int K>
cudaError_t strip_grid(int h, int w, bool with_count, StripGrid* g) {
    static std::atomic<int> cache[2][occupancy::kMaxDevices];
    using Shape = StripShape<K>;
    int slots = 0;
    const cudaError_t err = occupancy::resident_blocks(
        sobel_strip<K>, kStripThreads, Shape::smem(with_count), cache[with_count], &slots,
        Shape::smem(true));
    if (err != cudaSuccess) {
        return err;
    }
    constexpr int R = K / 2;
    g->strips = (w + kStrip - 1) / kStrip;
    const int runs = slots / g->strips > 1 ? slots / g->strips : 1;
    const int rows = (h + runs - 1) / runs;
    const int stages = (rows + 2 * R + K - 1) / K;
    g->run_rows = stages * K - 2 * R;
    g->runs = (h + g->run_rows - 1) / g->run_rows;
    return cudaSuccess;
}

struct Scratch {
    float2* s;            // (Sh, Sv) per pixel
    float4* partials;     // pass 1's, then pass 2's
    float4* hv_mm;        // min/max of h and v
    float4* s_mm;         // min/max of Sh and Sv
    unsigned* tickets;    // pass 1's, pass 2's
};

constexpr int kMaxMinmaxBlocks = 132 * 8;

// Floats of scratch for an h x w map and `partials` Sobel blocks, laid out
// as Scratch; every part starts 16-byte aligned.
int64_t scratch_floats(int h, int w, int partials) {
    const int64_t maps = (2 * static_cast<int64_t>(h) * w + 3) & ~int64_t{3};
    return maps + 4 * (static_cast<int64_t>(kMaxMinmaxBlocks) + partials + 2) + 4;
}

Scratch carve(float* scratch, int h, int w, int partials) {
    Scratch sc;
    sc.s = reinterpret_cast<float2*>(scratch);
    float4* parts = reinterpret_cast<float4*>(scratch + ((2 * static_cast<int64_t>(h) * w + 3) & ~int64_t{3}));
    sc.partials = parts;
    sc.hv_mm = parts + (kMaxMinmaxBlocks > partials ? kMaxMinmaxBlocks : partials);
    sc.s_mm = sc.hv_mm + 1;
    sc.tickets = reinterpret_cast<unsigned*>(sc.s_mm + 1);
    return sc;
}

// Launches kernel<<<grid, block, smem, s>>>(args...) so that it may start
// before the previous kernel on s has finished (see wait_for_previous).
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                         cudaStream_t s, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// hv_mm: the min/max of h and v, pass 1's (sc.hv_mm) or the caller's.
template <int K>
cudaError_t launch_sobel(const HvMap& m, const Taps& taps, const float4* hv_mm, const Scratch& sc,
                         cudaStream_t s) {
    StripGrid g;
    const bool with_count = m.cnt != nullptr;
    const cudaError_t err = strip_grid<K>(m.h, m.w, with_count, &g);
    if (err != cudaSuccess) {
        return err;
    }
    return launch_after(sobel_strip<K>, dim3(g.strips, g.runs), dim3(kStripThreads),
                        StripShape<K>::smem(with_count), s, m, hv_mm, taps, g.run_rows, sc.s,
                        sc.partials, sc.tickets + 1, sc.s_mm);
}

// Calls F<K>::run(args...) for the odd ksize K in [3, kMaxTaps].
template <template <int> class F, typename... Args>
cudaError_t by_ksize(int ksize, Args&&... args) {
    switch (ksize) {
        case 3: return F<3>::run(args...);
        case 5: return F<5>::run(args...);
        case 7: return F<7>::run(args...);
        case 9: return F<9>::run(args...);
        case 11: return F<11>::run(args...);
        case 13: return F<13>::run(args...);
        case 15: return F<15>::run(args...);
        case 17: return F<17>::run(args...);
        case 19: return F<19>::run(args...);
        case 21: return F<21>::run(args...);
        case 23: return F<23>::run(args...);
        case 25: return F<25>::run(args...);
        case 27: return F<27>::run(args...);
        case 29: return F<29>::run(args...);
        case 31: return F<31>::run(args...);
        default: return cudaErrorInvalidValue;
    }
}

template <int K>
struct GridOf {
    static cudaError_t run(int h, int w, bool with_count, StripGrid* g) {
        return strip_grid<K>(h, w, with_count, g);
    }
};

template <int K>
struct SobelOf {
    static cudaError_t run(const HvMap& m, const Taps& taps, const float4* hv_mm, const Scratch& sc,
                           cudaStream_t s) {
        return launch_sobel<K>(m, taps, hv_mm, sc, s);
    }
};

int minmax_blocks(int h) {
    int device = 0;
    int n_sm = 132;
    if (cudaGetDevice(&device) == cudaSuccess) {
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    }
    const int cap = n_sm * 8 < kMaxMinmaxBlocks ? n_sm * 8 : kMaxMinmaxBlocks;
    return h < cap ? h : cap;
}

}  // namespace

// Floats of scratch the caller allocates for an h x w map, this ksize and
// with or without a count map; -1 for a ksize the kernel does not take or a
// failed device query.
extern "C" int64_t hv_energy_scratch_floats(int h, int w, int ksize, int with_count) {
    StripGrid g;
    if (h <= 0 || w <= 0 || by_ksize<GridOf>(ksize, h, w, with_count != 0, &g) != cudaSuccess) {
        return -1;
    }
    return scratch_floats(h, w, g.strips * g.runs);
}

// hv: float32, pixel (y, x) channel c at hv[y * row_stride + x * pix_stride + c],
// c in {0, 1}. count: nullptr, or float32 with pixel (y, x) at
// count[y * count_row_stride + x * count_pix_stride], which divides the pair
// (max(count, 1)) on load. deriv, smooth: ksize host taps. minmax: nullptr,
// or 4 device floats, 16-byte aligned, (min h, max h, min v, max v) of the
// (divided) pair, which replace pass 1. out: [h, w] float32 (half_out == 0)
// or float16. scratch: hv_energy_scratch_floats(h, w, ksize) floats, 16-byte
// aligned.
extern "C" int hv_energy_launch(const float* hv, int64_t row_stride, int64_t pix_stride,
                                const float* count, int64_t count_row_stride,
                                int64_t count_pix_stride, int h, int w, const float* deriv,
                                const float* smooth, int ksize, const float* minmax,
                                float* scratch, void* out, int half_out, cudaStream_t s) {
    if (h <= 0 || w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    if (ksize < 3 || ksize > kMaxTaps || ksize % 2 == 0 ||
        ((reinterpret_cast<uintptr_t>(scratch) | reinterpret_cast<uintptr_t>(minmax)) & 15u) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Taps taps{};
    for (int k = 0; k < ksize; ++k) {
        taps.deriv[k] = deriv[k];
        taps.smooth[k] = smooth[k];
    }
    StripGrid g;
    cudaError_t err = by_ksize<GridOf>(ksize, h, w, count != nullptr, &g);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const HvMap m{hv, row_stride, pix_stride, count, count_row_stride, count_pix_stride, h, w};
    const Scratch sc = carve(scratch, h, w, g.strips * g.runs);
    const float4* hv_mm = reinterpret_cast<const float4*>(minmax);
    if (hv_mm != nullptr) {  // only pass 2's ticket
        err = cudaMemsetAsync(sc.tickets + 1, 0, sizeof(unsigned), s);
    } else {
        err = cudaMemsetAsync(sc.tickets, 0, 2 * sizeof(unsigned), s);
        if (err == cudaSuccess) {
            hv_minmax<<<minmax_blocks(h), kThreads, 0, s>>>(m, sc.partials, sc.tickets, sc.hv_mm);
            err = cudaGetLastError();
        }
        hv_mm = sc.hv_mm;
    }
    if (err == cudaSuccess) {
        err = by_ksize<SobelOf>(ksize, m, taps, hv_mm, sc, s);
    }
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int64_t n = static_cast<int64_t>(h) * w;
    int blocks = 0;
    static std::atomic<int> cache_f32[occupancy::kMaxDevices];
    static std::atomic<int> cache_f16[occupancy::kMaxDevices];
    err = half_out ? occupancy::resident_blocks(combine<__half>, kThreads, 0, cache_f16, &blocks)
                   : occupancy::resident_blocks(combine<float>, kThreads, 0, cache_f32, &blocks);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int64_t wanted = (n / 4 + kThreads - 1) / kThreads;
    const int grid = static_cast<int>(wanted < 1 ? 1 : (wanted < blocks ? wanted : blocks));
    const float4* s2 = reinterpret_cast<const float4*>(sc.s);
    const float4* s_mm = sc.s_mm;
    err = half_out ? launch_after(combine<__half>, dim3(grid), dim3(kThreads), 0, s, s2, n, s_mm,
                                  static_cast<__half*>(out))
                   : launch_after(combine<float>, dim3(grid), dim3(kThreads), 0, s, s2, n, s_mm,
                                  static_cast<float*>(out));
    return static_cast<int>(err);
}

extern "C" const char* hv_energy_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

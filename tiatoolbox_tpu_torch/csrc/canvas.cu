// Whole-slide canvas stitching for Hopper (sm_90a): scatter-accumulate (K2),
// normalise-crop-cast (K3) and normalise-and-pack (K6).
//
// K2 replaces the XLA program `scatter_accumulate` in
// tiatoolbox_tpu/ops/canvas.py:19-72, a lax.scan of dynamic_update_slice:
// for i = 0..N-1 in order, wherever valid_i,
//
//   canvas[y_i:y_i+h, x_i:x_i+w, :] += patch_i      count[...] += 1
//
// Neighbouring patches of a batch overlap (output 512, stride 450), so one
// thread per (patch, pixel) would need atomics, whose order of additions
// changes from run to run. This kernel gathers instead: one thread per
// canvas pixel of the union bounding box of the batch's valid patches (and
// per group of up to 8 channels) walks the N patches in index order and adds
// each one that covers its pixel, keeping the sums in registers, then writes
// once. Each channel's float additions happen in the scan's order, so the
// result equals the sequential version bit for bit. The first channel group
// adds the number of covering patches to the count (small integers, exact in
// float32). Pixels no patch covers are neither read nor written. The batch's
// (y, x, valid) table is one 16-byte read-only load per patch, the same for
// every thread of a block.
//
// K3 replaces `normalize_canvas` (ops/canvas.py:77) fused with the crop and
// cast of semantic_segmentor.py:461-495: for rows [y0, y0+bh) and columns
// [0, w), out = canvas / max(count, 1), cast to float32 or float16. The
// division is IEEE (no --use_fast_math) and the float16 cast rounds to
// nearest even, as PyTorch's `.to(torch.float16)` does, so the kernel equals
// its plain version bit for bit. It reads the canvas rows and their counts
// once and writes the output once: bound by device memory. The design keeps
// bytes in flight and instructions per byte low: a persistent grid whose
// warps take chunks of 128 groups of 4 consecutive output elements; a lane
// has 4 16-byte canvas loads in flight (streaming hints, __ldcs/__stcs:
// nothing reads the canvas or the output again on the card), and the warp
// loads each pixel's count once, coalesced, into shared memory; the pixel of
// an element is a 32-bit multiply and shift by a channel count fixed at
// compile time (instances for 1-8 channels; others read it at run time).
// Rows are one flat span when w == width; otherwise each row is a span,
// whose start a scalar head of up to 3 elements aligns to the output's
// 16-byte (float16: 8-byte) words, with 16-, 8- or 4-byte loads after it as
// the canvas's alignment allows (the padded canvas's rows start on 16-byte
// boundaries only when width x C is a multiple of 4), and a scalar tail.
//
// K6 replaces the pointwise fetch plane of the multitask engine:
// `_make_normalized_block_fn` (semantic_segmentor.py:461-495) with HoVerNet's
// `block_fetch_transform` (hovernet.py:662-672). For rows [0, h) and columns
// [0, w) it packs (canvas[np] / max(count, 1) >= 0.5) in bit 0 and
// round(canvas[tp] / max(count, 1)) (half to even, as jnp.round) shifted left
// by one into one uint8. It reads the two channels and the count (12 bytes a
// pixel) and writes 1 byte; the same IEEE divide, compare, rint and shift as
// the plain version, so the two agree bit for bit.
//
// All three are bound by device memory: K2 reads the patches once and reads
// and writes the covered canvas and count once; K3 and K6 read the canvas
// rows and their counts and write their output once. None does more than a
// few arithmetic operations per byte. K2 is one thread per pixel (its stores
// land on lines it has just read), K6 one thread per output pixel.

#include <atomic>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kGroup = 8;  // channels one scatter thread carries

// One thread per canvas pixel of the box and group of up to kGroup
// channels (blockIdx.z), so the patch tests are paid once per pixel, not
// once per channel.
__global__ void scatter_accumulate_kernel(float* __restrict__ canvas, float* __restrict__ count,
                                          int64_t width, int channels,
                                          const float* __restrict__ patches, int n, int ph,
                                          int pw, const int4* __restrict__ table, int y0, int x0,
                                          int bh, int bw) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= bw) {
        return;
    }
    const int x = x0 + col;
    const int c0 = blockIdx.z * kGroup;
    const int nc = channels - c0 < kGroup ? channels - c0 : kGroup;
    for (int r = blockIdx.y; r < bh; r += gridDim.y) {
        const int y = y0 + r;
        const int64_t pixel = static_cast<int64_t>(y) * width + x;
        float* at = canvas + pixel * channels + c0;
        float v[kGroup];
        int hits = 0;
        for (int i = 0; i < n; ++i) {
            const int4 t = __ldg(table + i);  // (y, x, valid, unused)
            if (!t.z || y < t.x || y >= t.x + ph || x < t.y || x >= t.y + pw) {
                continue;
            }
            const float* p =
                patches + ((static_cast<int64_t>(i) * ph + (y - t.x)) * pw + (x - t.y)) * channels + c0;
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
                if (c < nc) {
                    v[c] = (hits == 0 ? at[c] : v[c]) + p[c];
                }
            }
            ++hits;
        }
        if (hits > 0) {
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
                if (c < nc) {
                    at[c] = v[c];
                }
            }
            if (blockIdx.z == 0) {
                count[pixel] += static_cast<float>(hits);
            }
        }
    }
}

// -- K3: normalise-crop-cast ---------------------------------------------------

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kNormUnroll = 4;                      // 16-byte loads a lane has in flight
constexpr int kChunkGroups = 32 * kNormUnroll;      // groups of 4 elements a warp takes at once
constexpr int kChunkPixels = 4 * kChunkGroups + 2;  // most pixels a chunk's elements belong to

// Four consecutive canvas elements from p, which lies D elements past a
// 16-byte boundary (D == 1 stands for any odd offset).
template <int D>
__device__ __forceinline__ float4 load4(const float* p) {
    if constexpr (D == 0) {
        return __ldcs(reinterpret_cast<const float4*>(p));
    } else if constexpr (D == 2) {
        const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
        const float2 b = __ldcs(reinterpret_cast<const float2*>(p + 2));
        return make_float4(a.x, a.y, b.x, b.y);
    } else {
        return make_float4(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2), __ldcs(p + 3));
    }
}

struct NormRows {
    const float* canvas;  // [H, width, channels]
    const float* count;   // [H, width]
    void* out;            // [bh, w, channels]
    int64_t width;
    int y0, bh, w, channels;
    int span_rows;    // rows of one contiguous span: 1, or many when w == width
    int span_chunks;  // warp chunks of a span
    int n_items;      // spans x span_chunks
};

// Groups [g0, g_end) of 4 elements of one span, after its head. The warp
// issues its canvas loads first, then loads the chunk's counts once per pixel
// (coalesced) into its slice of shared memory, then divides each element by
// its pixel's count.
template <int C, int D, typename T>
__device__ __forceinline__ void normalize_chunk(const float* __restrict__ in,
                                                const float* __restrict__ cnt, T* __restrict__ out,
                                                uint32_t ch, uint32_t head, uint32_t g0,
                                                uint32_t g_end, float* hits) {
    // count loads a lane makes: C == 0 (run-time channels) means 9 or more
    constexpr int kPixLoads = (4 * kChunkGroups / (C > 0 ? C : 9) + 2 + 31) / 32;
    const uint32_t lane = threadIdx.x & 31;
    float4 v[kNormUnroll];
#pragma unroll
    for (int j = 0; j < kNormUnroll; ++j) {
        const uint32_t g = g0 + j * 32 + lane;
        if (g < g_end) {
            v[j] = load4<D>(in + head + 4 * g);
        }
    }
    const uint32_t p0 = (head + 4 * g0) / ch;
    const uint32_t n_pix = (head + 4 * g_end - 1) / ch - p0 + 1;
#pragma unroll
    for (int k = 0; k < kPixLoads; ++k) {
        const uint32_t i = lane + 32 * k;
        if (i < n_pix) {
            hits[i] = fmaxf(__ldcs(cnt + p0 + i), 1.0f);
        }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kNormUnroll; ++j) {
        const uint32_t g = g0 + j * 32 + lane;
        if (g < g_end) {
            const uint32_t e = head + 4 * g;
            float4 r;
            r.x = v[j].x / hits[e / ch - p0];
            r.y = v[j].y / hits[(e + 1) / ch - p0];
            r.z = v[j].z / hits[(e + 2) / ch - p0];
            r.w = v[j].w / hits[(e + 3) / ch - p0];
            store4(out + e, r);
        }
    }
    __syncwarp();
}

// A persistent grid whose warps take (span, chunk) items in turn. C is the
// channel count fixed at compile time (0: read from the arguments), so the
// pixel of an element is a 32-bit multiply and shift.
template <int C, typename T>
__global__ void __launch_bounds__(kNormThreads) normalize_rows_kernel(NormRows a) {
    __shared__ float hits[kNormWarps][kChunkPixels];
    const uint32_t ch = C > 0 ? C : a.channels;
    const int warp = threadIdx.x >> 5;
    const uint32_t lane = threadIdx.x & 31;
    for (int item = blockIdx.x * kNormWarps + warp; item < a.n_items;
         item += gridDim.x * kNormWarps) {
        const int span = item / a.span_chunks;
        const uint32_t chunk = item - span * a.span_chunks;
        const int r0 = span * a.span_rows;
        const int rows = min(a.span_rows, a.bh - r0);
        const int64_t y = a.y0 + r0;
        const float* in = a.canvas + y * a.width * ch;
        const float* cnt = a.count + y * a.width;
        T* out = static_cast<T*>(a.out) + static_cast<int64_t>(r0) * a.w * ch;
        const uint32_t n_el = static_cast<uint32_t>(rows) * a.w * ch;
        // a scalar head aligns the output to 4 elements; d is where the
        // input then lies against a 16-byte boundary
        const uint32_t out_phase = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(out) / sizeof(T)) & 3u;
        const uint32_t head = min((4u - out_phase) & 3u, n_el);
        const uint32_t d = (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(in) >> 2) + head) & 3u;
        const uint32_t n_vec = (n_el - head) >> 2;
        if (chunk == 0 && lane < 8) {  // head (lanes 0-3) and tail (lanes 4-7), one element each
            const uint32_t e = lane < 4 ? lane : head + 4 * n_vec + (lane - 4);
            if (lane < 4 ? e < head : e < n_el) {
                store1(out + e, __ldcs(in + e) / fmaxf(__ldcs(cnt + e / ch), 1.0f));
            }
        }
        const uint32_t g0 = chunk * kChunkGroups;
        if (g0 >= n_vec) {
            continue;
        }
        const uint32_t g_end = min(g0 + kChunkGroups, n_vec);
        if (d == 0) {
            normalize_chunk<C, 0>(in, cnt, out, ch, head, g0, g_end, hits[warp]);
        } else if (d == 2) {
            normalize_chunk<C, 2>(in, cnt, out, ch, head, g0, g_end, hits[warp]);
        } else {
            normalize_chunk<C, 1>(in, cnt, out, ch, head, g0, g_end, hits[warp]);
        }
    }
}

template <int C, typename T>
cudaError_t launch_normalize(const NormRows& a, cudaStream_t s) {
    static std::atomic<int> cache[occupancy::kMaxDevices];
    int cap = 0;
    const cudaError_t err =
        occupancy::resident_blocks(normalize_rows_kernel<C, T>, kNormThreads, 0, cache, &cap);
    if (err != cudaSuccess) {
        return err;
    }
    const int wanted = (a.n_items + kNormWarps - 1) / kNormWarps;
    normalize_rows_kernel<C, T><<<wanted < cap ? wanted : cap, kNormThreads, 0, s>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_normalize_any(const NormRows& a, cudaStream_t s) {
    switch (a.channels) {
        case 1: return launch_normalize<1, T>(a, s);
        case 2: return launch_normalize<2, T>(a, s);
        case 3: return launch_normalize<3, T>(a, s);
        case 4: return launch_normalize<4, T>(a, s);
        case 5: return launch_normalize<5, T>(a, s);
        case 6: return launch_normalize<6, T>(a, s);
        case 7: return launch_normalize<7, T>(a, s);
        case 8: return launch_normalize<8, T>(a, s);
        default: return launch_normalize<0, T>(a, s);
    }
}

// Items of a row across blockIdx.x, rows across blockIdx.y (striding past
// the grid's limit), channel groups across blockIdx.z.
static dim3 grid_for(int64_t row_items, int rows, int groups) {
    return dim3(static_cast<unsigned>((row_items + kThreads - 1) / kThreads),
                rows < kMaxGridY ? rows : kMaxGridY, groups);
}

// table: device int32 [n, 4] of (y, x, valid, unused), positions already
// inside the canvas; (y0, x0, bh, bw) the union box of the valid patches.
extern "C" int canvas_scatter_accumulate(float* canvas, float* count, int64_t width,
                                         int channels, const float* patches, int n, int ph,
                                         int pw, const int* table, int y0, int x0, int bh,
                                         int bw, cudaStream_t s) {
    if (n <= 0 || bh <= 0 || bw <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int groups = (channels + kGroup - 1) / kGroup;
    scatter_accumulate_kernel<<<grid_for(bw, bh, groups), kThreads, 0, s>>>(
        canvas, count, width, channels, patches, n, ph, pw,
        reinterpret_cast<const int4*>(table), y0, x0, bh, bw);
    return static_cast<int>(cudaGetLastError());
}

// out: [bh, w, channels], float32 (half_out == 0) or float16 (half_out != 0).
// Rows are one contiguous span when w == width (cut every 2^30 elements, so
// element indices stay 32-bit), else one span each.
extern "C" int canvas_normalize_rows(const float* canvas, const float* count, int64_t width,
                                     int channels, int y0, int bh, int w, void* out,
                                     int half_out, cudaStream_t s) {
    if (bh <= 0 || w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    constexpr int64_t kSpanElems = int64_t{1} << 30;
    const int64_t row_elems = static_cast<int64_t>(w) * channels;
    if (channels <= 0 || row_elems > kSpanElems) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    NormRows a{canvas, count, out, width, y0, bh, w, channels, 1, 1, 0};
    if (w == width) {
        const int64_t rows = kSpanElems / row_elems;
        a.span_rows = static_cast<int>(rows < bh ? rows : bh);
    }
    const int64_t spans = (bh + a.span_rows - 1) / a.span_rows;
    const int64_t groups = a.span_rows * row_elems / 4;
    const int64_t chunks = (groups + kChunkGroups - 1) / kChunkGroups;
    a.span_chunks = static_cast<int>(chunks > 1 ? chunks : 1);
    const int64_t items = spans * a.span_chunks;
    if (items > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    a.n_items = static_cast<int>(items);
    const cudaError_t err = half_out ? launch_normalize_any<__half>(a, s)
                                     : launch_normalize_any<float>(a, s);
    return static_cast<int>(err);
}

// One thread per output pixel, grid-striding over the h x w crop.
__global__ void pack_fg_tp_kernel(const float* __restrict__ canvas, const float* __restrict__ count,
                                  int64_t width, int channels, int tp_channel, int h, int w,
                                  uint8_t* __restrict__ out) {
    const int64_t n = static_cast<int64_t>(h) * w;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
        const int64_t y = i / w;
        const int64_t pixel = y * width + (i - y * w);
        const float hits = fmaxf(count[pixel], 1.0f);
        const float* at = canvas + pixel * channels;
        unsigned v = at[0] / hits >= 0.5f ? 1u : 0u;
        if (tp_channel >= 0) {
            const unsigned tp = static_cast<unsigned>(rintf(at[tp_channel] / hits));
            v |= (tp << 1) & 0xffu;
        }
        out[i] = static_cast<uint8_t>(v);
    }
}

// out: uint8 [h, w]; channel 0 is the foreground probability; tp_channel < 0
// packs the foreground bit only.
extern "C" int canvas_pack_fg_tp(const float* canvas, const float* count, int64_t width,
                                 int channels, int tp_channel, int h, int w, uint8_t* out,
                                 cudaStream_t s) {
    if (h <= 0 || w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int64_t n = static_cast<int64_t>(h) * w;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
    pack_fg_tp_kernel<<<blocks, kThreads, 0, s>>>(canvas, count, width, channels, tp_channel, h,
                                                  w, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* canvas_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// changes from run to run. This kernel gathers instead: a thread owns canvas
// pixels and adds, in index order, each patch that covers them, keeping the
// sums in registers, then writes once. Each channel's float additions happen
// in the scan's order, so the result equals the sequential version bit for
// bit; the count gains the number of covering patches (small integers, exact
// in float32). Pixels no patch covers are neither read nor written.
//
// The design for Hopper:
// - The batch's valid entries (y, x, patch index) travel by value in the
//   kernel's parameter struct (__grid_constant__): a launch uploads nothing.
//   A struct holds kScatterEntries; a longer batch is launched in chunks, in
//   index order, on one stream (the wrapper does so), so a later chunk adds
//   to what the earlier ones wrote, as the scan does.
// - Blocks take 32 x 32 tiles of the entries' union box. At its start one
//   warp tests the entries against the tile, 32 a __ballot_sync, and keeps
//   those that meet it in shared memory, in index order. A tile that no
//   patch meets returns at once (a batch that crosses patch rows leaves much
//   of its box uncovered, and the per-patch feed leaves gaps), and a pixel
//   walks only the tile's short list (1-4 patches on the engines' grids)
//   instead of all N entries.
// - Lanes take neighbouring columns and each thread 4 rows. Where C is a
//   multiple of 4 and the canvas and patches are 16-byte aligned (C = 4 on
//   phase D), a pixel's channels move as 16-byte float4 words; otherwise as
//   scalars, C fixed at compile time for 1-8 channels and read at run time
//   beyond (groups of 8 channels across blockIdx.z).
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
// `block_fetch_transform` (hovernet.py:662-672), and the global min/max of
// the normalised hv pair that its `final_fetch_transform` (hovernet.py:674,
// the energy's first step, ops/hv_energy.py:76-77) needs. For rows [0, h)
// and columns [0, w) it packs (canvas[np] / max(count, 1) >= 0.5) in bit 0
// and round(canvas[tp] / max(count, 1)) (half to even, as jnp.round;
// saturated to [0, 255], as astype(jnp.uint8)) shifted left by one into one
// uint8, and reduces (min h, max h, min v, max v) of channels 1 and 2 divided
// by max(count, 1) into a float4, the input of K5's Sobel pass
// (hv_energy.cu), which then skips its own first pass. The division is K5's
// (div_rcp by the count's reciprocal, the bits of IEEE division), then the
// same compare, rint, clamp and shift as the plain version, so the two agree
// bit for bit, and K5 gets the min/max its pass 1 would give.
//
// All three are bound by device memory: K2 reads the patches once and reads
// and writes the covered canvas and count once; K3 and K6 read the canvas
// rows and their counts and write their output once. None does more than a
// few arithmetic operations per byte. A K2 thread owns its pixels (its stores
// land on lines it has just read).
//
// K6 on a 4-channel canvas cannot read less than whole pixels: a 32-byte
// sector holds two, so np and tp bring the hv pair with them, and the bytes
// that must move are 16 + 4 (count) + 1 = 21 a pixel. The design reads them
// once and uses all of them: a lane takes a group of 4 adjacent pixels, C
// 16-byte words of canvas (4 at C = 4, 3 at C = 3) and one of counts, with
// the group's loads issued before any arithmetic, and writes the group's 4
// bytes as one 32-bit word (two groups a lane in flight, or 512 threads a
// block, measured slower on the card; 128 threads slower still). Warps take
// (row, chunk of 32 groups) items of a persistent grid, so a pixel's place
// is a row and a column, with no 64-bit division. A row's groups start where
// the count (and so the canvas) is 16-byte aligned; the up to 3 pixels
// before that and the up to 3 after the last whole group go one a lane.
// Other channel counts, or a canvas not aligned where its count is, take one
// pixel a lane, with scalar loads. The min/max is merged in registers, then
// by block and grid as K5's pass 1 does (common.cuh), with a ticket that the
// entry zeroes on the stream before the launch, as K5's entry does.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

// -- K2: scatter-accumulate ---------------------------------------------------

// Entries one launch takes. They travel in the parameter struct, whose
// portable limit is 4,096 bytes: 60 bytes of pointers and sizes plus 12
// bytes an entry.
constexpr int kScatterEntries = 320;
constexpr int kScatterWarps = 8;
constexpr int kScatterRows = 4;                         // canvas rows a thread carries
constexpr int kTileW = 32;                              // a lane a column
constexpr int kTileH = kScatterWarps * kScatterRows;    // rows of a block's tile
constexpr int kGroup = 8;  // channels a thread carries when C is read at run time

struct ScatterEntry {
    int y, x;   // top-left corner, inside the canvas
    int index;  // the patch's index in the batch
};

struct ScatterArgs {
    float* canvas;         // [H, width, channels]
    float* count;          // [H, width]
    const float* patches;  // [N, ph, pw, channels]
    int64_t width;
    int channels, ph, pw;
    int n;        // entries: the valid ones, in index order
    int y0, x0;   // the top-left corner of their union box
    int tiles_x;  // tiles across the box
    ScatterEntry entry[kScatterEntries];
};
static_assert(sizeof(ScatterArgs) <= 4096, "K2's parameters exceed the portable 4,096 bytes");

// G channels of one pixel at p (the first nc of them when C is read at run
// time), as 16-byte words when kVec.
template <int G, bool kVec>
__device__ __forceinline__ void load_px(float (&v)[G], const float* p, int nc) {
    if constexpr (kVec) {
#pragma unroll
        for (int c = 0; c < G; c += 4) {
            const float4 t = *reinterpret_cast<const float4*>(p + c);
            v[c] = t.x;
            v[c + 1] = t.y;
            v[c + 2] = t.z;
            v[c + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int c = 0; c < G; ++c) {
            if (c < nc) {
                v[c] = p[c];
            }
        }
    }
}

template <int G, bool kVec>
__device__ __forceinline__ void add_px(float (&v)[G], const float* p, int nc) {
    if constexpr (kVec) {
#pragma unroll
        for (int c = 0; c < G; c += 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(p + c));
            v[c] += t.x;
            v[c + 1] += t.y;
            v[c + 2] += t.z;
            v[c + 3] += t.w;
        }
    } else {
#pragma unroll
        for (int c = 0; c < G; ++c) {
            if (c < nc) {
                v[c] += __ldg(p + c);
            }
        }
    }
}

template <int G, bool kVec>
__device__ __forceinline__ void store_px(const float (&v)[G], float* p, int nc) {
    if constexpr (kVec) {
#pragma unroll
        for (int c = 0; c < G; c += 4) {
            *reinterpret_cast<float4*>(p + c) = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
        }
    } else {
#pragma unroll
        for (int c = 0; c < G; ++c) {
            if (c < nc) {
                p[c] = v[c];
            }
        }
    }
}

// One block a tile (blockIdx.x) and group of channels (blockIdx.z; one group
// unless C is read at run time). C: the channel count fixed at compile time,
// or 0.
template <int C, bool kVec>
__global__ void __launch_bounds__(kScatterWarps * 32)
    scatter_tiles_kernel(const __grid_constant__ ScatterArgs a) {
    constexpr int G = C > 0 ? C : kGroup;
    __shared__ ScatterEntry meets[kScatterEntries];
    __shared__ int n_meets;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int tile_row = blockIdx.x / a.tiles_x;
    const int tx0 = a.x0 + (blockIdx.x - tile_row * a.tiles_x) * kTileW;
    const int ty0 = a.y0 + tile_row * kTileH;
    if (warp == 0) {
        int found = 0;
        for (int base = 0; base < a.n; base += 32) {
            const int i = base + lane;
            ScatterEntry e{};
            bool hit = false;
            if (i < a.n) {
                e = a.entry[i];
                hit = e.y < ty0 + kTileH && e.y + a.ph > ty0 && e.x < tx0 + kTileW && e.x + a.pw > tx0;
            }
            const unsigned mask = __ballot_sync(0xffffffffu, hit);
            if (hit) {
                meets[found + __popc(mask & ((1u << lane) - 1u))] = e;
            }
            found += __popc(mask);
        }
        if (lane == 0) {
            n_meets = found;
        }
    }
    __syncthreads();
    const int m = n_meets;
    if (m == 0) {
        return;
    }
    const int ch = C > 0 ? C : a.channels;
    const int c0 = C > 0 ? 0 : static_cast<int>(blockIdx.z) * kGroup;
    const int nc = C > 0 ? C : min(kGroup, ch - c0);
    const int x = tx0 + lane;
    const int y = ty0 + warp * kScatterRows;
    int hits[kScatterRows] = {};
    for (int j = 0; j < m; ++j) {
        const ScatterEntry e = meets[j];
        if (static_cast<unsigned>(x - e.x) < static_cast<unsigned>(a.pw)) {
#pragma unroll
            for (int r = 0; r < kScatterRows; ++r) {
                hits[r] += static_cast<unsigned>(y + r - e.y) < static_cast<unsigned>(a.ph);
            }
        }
    }
    float v[kScatterRows][G];
    float n0[kScatterRows];
#pragma unroll
    for (int r = 0; r < kScatterRows; ++r) {
        if (hits[r] > 0) {
            const int64_t pixel = static_cast<int64_t>(y + r) * a.width + x;
            load_px<G, kVec>(v[r], a.canvas + pixel * ch + c0, nc);
            if (c0 == 0) {
                n0[r] = a.count[pixel];
            }
        }
    }
    for (int j = 0; j < m; ++j) {
        const ScatterEntry e = meets[j];
        const int dx = x - e.x;
        if (static_cast<unsigned>(dx) >= static_cast<unsigned>(a.pw)) {
            continue;
        }
        const float* p = a.patches + (static_cast<int64_t>(e.index) * a.ph * a.pw + dx) * ch + c0;
#pragma unroll
        for (int r = 0; r < kScatterRows; ++r) {
            const int dy = y + r - e.y;
            if (static_cast<unsigned>(dy) < static_cast<unsigned>(a.ph)) {
                add_px<G, kVec>(v[r], p + static_cast<int64_t>(dy) * a.pw * ch, nc);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < kScatterRows; ++r) {
        if (hits[r] > 0) {
            const int64_t pixel = static_cast<int64_t>(y + r) * a.width + x;
            store_px<G, kVec>(v[r], a.canvas + pixel * ch + c0, nc);
            if (c0 == 0) {
                a.count[pixel] = n0[r] + static_cast<float>(hits[r]);
            }
        }
    }
}

template <int C, bool kVec = false>
cudaError_t launch_scatter(const ScatterArgs& a, int tiles, cudaStream_t s, int groups = 1) {
    scatter_tiles_kernel<C, kVec><<<dim3(tiles, 1, groups), kScatterWarps * 32, 0, s>>>(a);
    return cudaGetLastError();
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

// entries: host int32 [n, 3] of (y, x, patch index), the batch's valid
// entries in index order, positions inside the canvas; n <= kScatterEntries
// (the wrapper launches a longer batch in chunks, in order). (y0, x0, bh,
// bw): the entries' union box.
extern "C" int canvas_scatter_accumulate(float* canvas, float* count, int64_t width,
                                         int channels, const float* patches, int ph, int pw,
                                         const int* entries, int n, int y0, int x0, int bh,
                                         int bw, cudaStream_t s) {
    if (n <= 0 || bh <= 0 || bw <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int64_t tiles_x = (bw + kTileW - 1) / kTileW;
    const int64_t tiles = tiles_x * ((bh + kTileH - 1) / kTileH);
    if (n > kScatterEntries || channels <= 0 || tiles > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    ScatterArgs a{};
    a.canvas = canvas;
    a.count = count;
    a.patches = patches;
    a.width = width;
    a.channels = channels;
    a.ph = ph;
    a.pw = pw;
    a.n = n;
    a.y0 = y0;
    a.x0 = x0;
    a.tiles_x = static_cast<int>(tiles_x);
    for (int i = 0; i < n; ++i) {
        a.entry[i] = ScatterEntry{entries[3 * i], entries[3 * i + 1], entries[3 * i + 2]};
    }
    const int t = static_cast<int>(tiles);
    const bool aligned = ((reinterpret_cast<uintptr_t>(canvas) | reinterpret_cast<uintptr_t>(patches)) & 15u) == 0;
    if (aligned && channels == 4) {
        return static_cast<int>(launch_scatter<4, true>(a, t, s));
    }
    if (aligned && channels == 8) {
        return static_cast<int>(launch_scatter<8, true>(a, t, s));
    }
    switch (channels) {
        case 1: return static_cast<int>(launch_scatter<1>(a, t, s));
        case 2: return static_cast<int>(launch_scatter<2>(a, t, s));
        case 3: return static_cast<int>(launch_scatter<3>(a, t, s));
        case 4: return static_cast<int>(launch_scatter<4>(a, t, s));
        case 5: return static_cast<int>(launch_scatter<5>(a, t, s));
        case 6: return static_cast<int>(launch_scatter<6>(a, t, s));
        case 7: return static_cast<int>(launch_scatter<7>(a, t, s));
        case 8: return static_cast<int>(launch_scatter<8>(a, t, s));
        default: return static_cast<int>(launch_scatter<0>(a, t, s, (channels + kGroup - 1) / kGroup));
    }
}

extern "C" int canvas_scatter_max_entries() { return kScatterEntries; }

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

// -- K6: pack the foreground and type, reduce the hv pair ----------------------

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackItemPixels = 4 * 32;  // a warp item: a group of 4 pixels a lane
constexpr int kMaxPackBlocks = 4096;     // partials the scratch holds

struct PackArgs {
    const float* canvas;  // [H, width, channels], channels >= 3: [np, h, v, ...]
    const float* count;   // [H, width]
    uint8_t* out;         // [h, w]
    int64_t width;
    int channels;
    int tp;  // type channel, or -1
    int h, w;
    int row_items;     // warp items a row
    int n_items;       // h x row_items
    float4* partials;  // a float4 a block
    unsigned* ticket;  // zero when the kernel starts
    float4* minmax;    // (min h, max h, min v, max v)
};

// The byte of one pixel from its raw channels and count; its normalised hv
// pair goes into acc.
__device__ __forceinline__ unsigned pack_pixel(const PackArgs& a, float fg, float tp, float hh,
                                               float vv, float cnt, float4& acc) {
    const float n = fmaxf(cnt, 1.0f);
    const float r = __frcp_rn(n);
    unsigned v = div_rcp(fg, n, r) >= 0.5f ? 1u : 0u;
    if (a.tp >= 0) {  // saturated to [0, 255], as JAX casts a float to uint8
        v |= (static_cast<unsigned>(fminf(fmaxf(rintf(div_rcp(tp, n, r)), 0.0f), 255.0f)) << 1) & 0xffu;
    }
    acc = merge(acc, div_rcp(hh, n, r), div_rcp(vv, n, r));
    return v;
}

// Pixel x of a row, one lane, scalar loads (C read at run time).
__device__ __forceinline__ unsigned pack_scalar(const PackArgs& a, const float* row,
                                                const float* cnt, int x, float4& acc) {
    const float* px = row + static_cast<int64_t>(x) * a.channels;
    const float tp = a.tp >= 0 ? __ldcs(px + a.tp) : 0.0f;
    return pack_pixel(a, __ldcs(px), tp, __ldcs(px + 1), __ldcs(px + 2), __ldcs(cnt + x), acc);
}

// Element i (fixed at compile time) of C 16-byte words.
template <int C>
__device__ __forceinline__ float element(const float4 (&f)[C], int i) {
    const float4 t = f[i >> 2];
    return (i & 3) == 0 ? t.x : (i & 3) == 1 ? t.y : (i & 3) == 2 ? t.z : t.w;
}

// Channel c (read at run time) of pixel q (fixed) of a group: selects over
// the C channels, not an index into registers, which would go to local memory.
template <int C>
__device__ __forceinline__ float channel(const float4 (&f)[C], int q, int c) {
    float r = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
        r = k == c ? element<C>(f, q * C + k) : r;
    }
    return r;
}

// One warp item: chunk `chunk` of row y. kVec: C (3 or 4) fixed, a group of
// 4 pixels a lane from the row's aligned start `head`; else one pixel a lane.
template <int C, bool kVec>
__device__ __forceinline__ void pack_item(const PackArgs& a, int y, int chunk, float4& acc) {
    const int lane = threadIdx.x & 31;
    const int64_t p0 = static_cast<int64_t>(y) * a.width;  // the row's first pixel
    const float* row = a.canvas + p0 * (C > 0 ? C : a.channels);
    const float* cnt = a.count + p0;
    uint8_t* out = a.out + static_cast<int64_t>(y) * a.w;
    if constexpr (!kVec) {
#pragma unroll
        for (int j = 0; j < kPackItemPixels / 32; ++j) {
            const int x = chunk * kPackItemPixels + j * 32 + lane;
            if (x < a.w) {
                out[x] = static_cast<uint8_t>(pack_scalar(a, row, cnt, x, acc));
            }
        }
    } else {
        // pixels before `head` (where the count is 16-byte aligned, and so the
        // canvas: the entry checks) and after the last whole group, one a lane
        const unsigned cnt_word = static_cast<unsigned>(reinterpret_cast<uintptr_t>(cnt) >> 2);
        const int head = min(static_cast<int>((0u - cnt_word) & 3u), a.w);
        const int n_groups = (a.w - head) >> 2;
        if (chunk == 0 && lane < 8) {
            const int x = lane < 4 ? lane : head + 4 * n_groups + lane - 4;
            if (lane < 4 ? x < head : x < a.w) {
                out[x] = static_cast<uint8_t>(pack_scalar(a, row, cnt, x, acc));
            }
        }
        const int g = chunk * 32 + lane;
        if (g >= n_groups) {
            return;
        }
        // the group's loads, all issued before any arithmetic
        const int x = head + 4 * g;
        const float4* src = reinterpret_cast<const float4*>(row + x * C);
        float4 f[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
            f[k] = __ldcs(src + k);
        }
        const float4 n = __ldcs(reinterpret_cast<const float4*>(cnt + x));
        const float counts[4] = {n.x, n.y, n.z, n.w};
        unsigned word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const unsigned b = pack_pixel(a, element<C>(f, q * C), channel<C>(f, q, a.tp),
                                          element<C>(f, q * C + 1), element<C>(f, q * C + 2),
                                          counts[q], acc);
            word |= b << (8 * q);
        }
        uint8_t* o = out + x;
        if ((reinterpret_cast<uintptr_t>(out + head) & 3u) == 0) {
            __stcs(reinterpret_cast<unsigned*>(o), word);
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                o[q] = static_cast<uint8_t>(word >> (8 * q));
            }
        }
    }
}

template <int C, bool kVec>
__global__ void __launch_bounds__(kPackThreads) pack_kernel(PackArgs a) {
    const int warp = threadIdx.x >> 5;
    float4 acc = empty_minmax();
    for (int item = blockIdx.x * kPackWarps + warp; item < a.n_items; item += gridDim.x * kPackWarps) {
        const int y = item / a.row_items;
        pack_item<C, kVec>(a, y, item - y * a.row_items, acc);
    }
    grid_minmax(acc, a.partials, a.ticket, a.minmax);
}

template <int C, bool kVec>
cudaError_t launch_pack(PackArgs a, cudaStream_t s) {
    static std::atomic<int> cache[occupancy::kMaxDevices];
    int cap = 0;
    const cudaError_t err = occupancy::resident_blocks(pack_kernel<C, kVec>, kPackThreads, 0, cache, &cap);
    if (err != cudaSuccess) {
        return err;
    }
    const int wanted = (a.n_items + kPackWarps - 1) / kPackWarps;
    const int blocks = std::min({wanted, cap, kMaxPackBlocks});
    pack_kernel<C, kVec><<<blocks, kPackThreads, 0, s>>>(a);
    return cudaGetLastError();
}

// Floats of K6's scratch: the blocks' partials and the ticket.
extern "C" int canvas_pack_scratch_floats() { return 4 * (kMaxPackBlocks + 1); }

// out: uint8 [h, w]; channel 0 is the foreground probability, channels 1 and
// 2 the hv pair; tp_channel < 0 packs the foreground bit only. minmax (4
// device floats, 16-byte aligned) gets (min h, max h, min v, max v) of the
// pair divided by max(count, 1), through scratch (canvas_pack_scratch_floats()
// floats, 16-byte aligned), whose ticket the entry zeroes on the stream.
extern "C" int canvas_pack_fg_tp(const float* canvas, const float* count, int64_t width,
                                 int channels, int tp_channel, int h, int w, uint8_t* out,
                                 float* scratch, float* minmax, cudaStream_t s) {
    if (h <= 0 || w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    if (channels < 3 || tp_channel >= channels || scratch == nullptr || minmax == nullptr ||
        ((reinterpret_cast<uintptr_t>(scratch) | reinterpret_cast<uintptr_t>(minmax)) & 15u) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    PackArgs a{};
    a.canvas = canvas;
    a.count = count;
    a.out = out;
    a.width = width;
    a.channels = channels;
    a.tp = tp_channel < 0 ? -1 : tp_channel;
    a.h = h;
    a.w = w;
    a.partials = reinterpret_cast<float4*>(scratch);
    a.ticket = reinterpret_cast<unsigned*>(scratch + 4 * kMaxPackBlocks);
    a.minmax = reinterpret_cast<float4*>(minmax);
    // Groups of 4 pixels start where the count is 16-byte aligned; the
    // canvas must be aligned at the same pixels: at C = 4 wherever its base
    // is, at C = 3 where its base's and the count's float offsets from a
    // 16-byte boundary add up to a multiple of 4 (as for any whole-pixel
    // shift of an aligned pair).
    const uintptr_t kc = reinterpret_cast<uintptr_t>(canvas) >> 2;
    const uintptr_t kn = reinterpret_cast<uintptr_t>(count) >> 2;
    const bool vec = (channels == 4 && (kc & 3u) == 0) || (channels == 3 && ((kc + kn) & 3u) == 0);
    // a warp item is 32 groups (vectorised) or kPackItemPixels pixels
    a.row_items = vec ? std::max(1, (w / 4 + 31) / 32) : (w + kPackItemPixels - 1) / kPackItemPixels;
    const int64_t items = static_cast<int64_t>(h) * a.row_items;
    if (items > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    a.n_items = static_cast<int>(items);
    cudaError_t err = cudaMemsetAsync(a.ticket, 0, sizeof(unsigned), s);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    if (vec && channels == 4) {
        err = launch_pack<4, true>(a, s);
    } else if (vec) {
        err = launch_pack<3, true>(a, s);
    } else {
        err = launch_pack<0, false>(a, s);
    }
    return static_cast<int>(err);
}

extern "C" const char* canvas_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

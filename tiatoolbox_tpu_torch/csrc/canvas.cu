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
// nearest even, as PyTorch's `.to(torch.float16)` does.
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
// All three are bound by device memory: K2 reads the patches once and reads and
// writes the covered canvas and count once; K3 reads the canvas rows and
// their counts and writes the output once. Neither does more than one
// arithmetic operation per byte. Both kernels are simple, with 4-byte
// accesses: K2 one thread per pixel (its stores land on lines it has just
// read), K3 one thread per element (its output lines are written only, and
// unit-stride stores write whole sectors).

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ void store(float* out, int64_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__half* out, int64_t i, float v) {
    out[i] = __float2half_rn(v);
}

// One thread per output element (pixel, channel): loads and stores are
// unit-stride across a warp. (A thread per pixel, with stores 20 bytes apart,
// was slower here: it writes partial sectors.)
template <typename T>
__global__ void normalize_rows_kernel(const float* __restrict__ canvas,
                                      const float* __restrict__ count, int64_t width,
                                      int channels, int y0, int bh, int64_t row_elems,
                                      T* __restrict__ out) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= row_elems) {
        return;
    }
    const int64_t x = e / channels;
    for (int r = blockIdx.y; r < bh; r += gridDim.y) {
        const int64_t y = y0 + r;
        const float n = fmaxf(count[y * width + x], 1.0f);
        store(out, r * row_elems + e, canvas[y * width * channels + e] / n);
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
extern "C" int canvas_normalize_rows(const float* canvas, const float* count, int64_t width,
                                     int channels, int y0, int bh, int w, void* out,
                                     int half_out, cudaStream_t s) {
    if (bh <= 0 || w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int64_t row_elems = static_cast<int64_t>(w) * channels;
    const dim3 grid = grid_for(row_elems, bh, 1);
    if (half_out) {
        normalize_rows_kernel<__half><<<grid, kThreads, 0, s>>>(
            canvas, count, width, channels, y0, bh, row_elems, static_cast<__half*>(out));
    } else {
        normalize_rows_kernel<float><<<grid, kThreads, 0, s>>>(
            canvas, count, width, channels, y0, bh, row_elems, static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
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

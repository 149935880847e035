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
// Four launches on the caller's stream, no host synchronisation:
//   1. minmax_partials: per block min and max of h and v (grid-stride), then
//      reduce_partials in one block. Min and max do not depend on order, so
//      the result is exact.
//   2. sobel_tile: a TH x TW output tile per block. The block loads the
//      normalised h and v of the tile plus a radius-R halo into shared
//      memory (reflected indices), runs the row pass into a second shared
//      buffer ((TH + 2R) x TW), then the column pass, in the JAX order
//      (k_x first). It writes Sh and Sv and the block's min and max of each.
//   3. reduce_partials over the tile blocks' min and max.
//   4. combine: element-wise max(1 - Sh', 1 - Sv'), float32 or float16 out.
//
// What bounds it: device memory. The function must read the hv pair (8 B a
// pixel) and write the energy (4 B); at about 170 flop a pixel it is far
// below the float32 rate. This simple design moves more: hv twice (the
// min/max pass and the tile pass, read from a [H, W, C] canvas whose pixels
// are C floats apart), Sh and Sv written and read once (16 B). Sums take the
// taps in order with fmaf, so they differ from cuDNN's or XLA's order by a
// few ulp; after the [0, 1] normalisations that is within 2e-6.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTW = 32;          // tile width (one warp across)
constexpr int kTH = 16;          // tile height
constexpr int kMaxTaps = 31;     // ksize up to 31 (radius 15), as cv2's Sobel
constexpr int kThreads = 256;
constexpr int kPartialBlocks = 1024;

struct Taps {
    float deriv[kMaxTaps];
    float smooth[kMaxTaps];
};

__device__ __forceinline__ int reflect101(int i, int n) {
    if (n == 1) {
        return 0;
    }
    const int period = 2 * (n - 1);
    i = abs(i) % period;
    return i >= n ? period - i : i;
}

__device__ __forceinline__ float norm01(float x, float mn, float mx) {
    return (x - mn) / fmaxf(mx - mn, 1e-30f);
}

// (min a, max a, min b, max b) of a block, written by thread 0 to *out.
__device__ void block_minmax(float4 m, float4* out) {
    __shared__ float4 warp_part[32];
    for (int off = 16; off > 0; off >>= 1) {
        m.x = fminf(m.x, __shfl_down_sync(0xffffffffu, m.x, off));
        m.y = fmaxf(m.y, __shfl_down_sync(0xffffffffu, m.y, off));
        m.z = fminf(m.z, __shfl_down_sync(0xffffffffu, m.z, off));
        m.w = fmaxf(m.w, __shfl_down_sync(0xffffffffu, m.w, off));
    }
    const int tid = threadIdx.x + threadIdx.y * blockDim.x;
    const int n_warps = (blockDim.x * blockDim.y + 31) / 32;
    if ((tid & 31) == 0) {
        warp_part[tid >> 5] = m;
    }
    __syncthreads();
    if (tid < 32) {
        m = tid < n_warps ? warp_part[tid]
                          : make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
        for (int off = 16; off > 0; off >>= 1) {
            m.x = fminf(m.x, __shfl_down_sync(0xffffffffu, m.x, off));
            m.y = fmaxf(m.y, __shfl_down_sync(0xffffffffu, m.y, off));
            m.z = fminf(m.z, __shfl_down_sync(0xffffffffu, m.z, off));
            m.w = fmaxf(m.w, __shfl_down_sync(0xffffffffu, m.w, off));
        }
        if (tid == 0) {
            *out = m;
        }
    }
}

__device__ __forceinline__ float4 merge(float4 m, float a, float b) {
    return make_float4(fminf(m.x, a), fmaxf(m.y, a), fminf(m.z, b), fmaxf(m.w, b));
}

__global__ void minmax_partials(const float* __restrict__ hv, int64_t row_stride,
                                int pix_stride, int h, int w, float4* __restrict__ partials) {
    float4 m = make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
    const int64_t n = static_cast<int64_t>(h) * w;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
        const int64_t y = i / w;
        const int64_t x = i - y * w;
        const float* p = hv + y * row_stride + x * pix_stride;
        m = merge(m, p[0], p[1]);
    }
    block_minmax(m, partials + blockIdx.x);
}

__global__ void reduce_partials(const float4* __restrict__ partials, int n,
                                float4* __restrict__ out) {
    float4 m = make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float4 p = partials[i];
        m = make_float4(fminf(m.x, p.x), fmaxf(m.y, p.y), fminf(m.z, p.z), fmaxf(m.w, p.w));
    }
    block_minmax(m, out);
}

// Dynamic shared memory: two input tiles (TH + 2R) x (TW + 2R), then two
// row-pass tiles (TH + 2R) x TW.
__global__ void sobel_tile(const float* __restrict__ hv, int64_t row_stride, int pix_stride,
                           int h, int w, const float4* __restrict__ hv_minmax, Taps taps,
                           int radius, float* __restrict__ sh, float* __restrict__ sv,
                           float4* __restrict__ partials) {
    extern __shared__ float smem[];
    const int ksize = 2 * radius + 1;
    const int in_h = kTH + 2 * radius;
    const int in_w = kTW + 2 * radius;
    float* in_h_tile = smem;
    float* in_v_tile = in_h_tile + in_h * in_w;
    float* row_h = in_v_tile + in_h * in_w;
    float* row_v = row_h + in_h * kTW;
    const int x0 = blockIdx.x * kTW;
    const int y0 = blockIdx.y * kTH;
    const int tid = threadIdx.x + threadIdx.y * kTW;
    const int n_threads = kTW * blockDim.y;
    const float4 mm = *hv_minmax;

    for (int i = tid; i < in_h * in_w; i += n_threads) {
        const int ty = i / in_w;
        const int tx = i - ty * in_w;
        const int gy = reflect101(y0 - radius + ty, h);
        const int gx = reflect101(x0 - radius + tx, w);
        const float* p = hv + gy * row_stride + static_cast<int64_t>(gx) * pix_stride;
        in_h_tile[i] = norm01(p[0], mm.x, mm.y);
        in_v_tile[i] = norm01(p[1], mm.z, mm.w);
    }
    __syncthreads();
    // row pass (k_x): deriv on h, smooth on v
    for (int i = tid; i < in_h * kTW; i += n_threads) {
        const int ty = i / kTW;
        const int tx = i - ty * kTW;
        const float* a = in_h_tile + ty * in_w + tx;
        const float* b = in_v_tile + ty * in_w + tx;
        float acc_h = 0.0f;
        float acc_v = 0.0f;
        for (int k = 0; k < ksize; ++k) {
            acc_h = fmaf(taps.deriv[k], a[k], acc_h);
            acc_v = fmaf(taps.smooth[k], b[k], acc_v);
        }
        row_h[i] = acc_h;
        row_v[i] = acc_v;
    }
    __syncthreads();
    // column pass (k_y): smooth on h, deriv on v
    float4 m = make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
    const int x = x0 + threadIdx.x;
    for (int ty = threadIdx.y; ty < kTH; ty += blockDim.y) {
        const int y = y0 + ty;
        float acc_h = 0.0f;
        float acc_v = 0.0f;
        for (int k = 0; k < ksize; ++k) {
            acc_h = fmaf(taps.smooth[k], row_h[(ty + k) * kTW + threadIdx.x], acc_h);
            acc_v = fmaf(taps.deriv[k], row_v[(ty + k) * kTW + threadIdx.x], acc_v);
        }
        if (y < h && x < w) {
            const int64_t o = static_cast<int64_t>(y) * w + x;
            sh[o] = acc_h;
            sv[o] = acc_v;
            m = merge(m, acc_h, acc_v);
        }
    }
    block_minmax(m, partials + blockIdx.y * gridDim.x + blockIdx.x);
}

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) {
    return v;
}
template <>
__device__ __forceinline__ __half cast_out<__half>(float v) {
    return __float2half_rn(v);
}

template <typename T>
__global__ void combine(const float* __restrict__ sh, const float* __restrict__ sv, int64_t n,
                        const float4* __restrict__ s_minmax, T* __restrict__ out) {
    const float4 mm = *s_minmax;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
        const float a = 1.0f - norm01(sh[i], mm.x, mm.y);
        const float b = 1.0f - norm01(sv[i], mm.z, mm.w);
        out[i] = cast_out<T>(fmaxf(a, b));
    }
}

}  // namespace

// Sh and Sv, then (16-byte aligned) the min/max partials.
static int64_t maps_floats(int h, int w) { return (2 * static_cast<int64_t>(h) * w + 3) & ~3ll; }

// Floats of scratch the caller allocates for an h x w map.
extern "C" int64_t hv_energy_scratch_floats(int h, int w) {
    const int64_t tiles = static_cast<int64_t>((w + kTW - 1) / kTW) * ((h + kTH - 1) / kTH);
    return maps_floats(h, w) + 4 * (kPartialBlocks + tiles + 2);
}

// hv: float32, pixel (y, x) channel c at hv[y * row_stride + x * pix_stride + c],
// c in {0, 1}. deriv, smooth: ksize host taps. out: [h, w] float32
// (half_out == 0) or float16. scratch: hv_energy_scratch_floats(h, w) floats,
// 16-byte aligned.
extern "C" int hv_energy_launch(const float* hv, int64_t row_stride, int pix_stride, int h, int w,
                                const float* deriv, const float* smooth, int ksize,
                                float* scratch, void* out, int half_out, cudaStream_t s) {
    if (h <= 0 || w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    if (ksize < 1 || ksize > kMaxTaps || ksize % 2 == 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Taps taps{};
    for (int k = 0; k < ksize; ++k) {
        taps.deriv[k] = deriv[k];
        taps.smooth[k] = smooth[k];
    }
    const int radius = ksize / 2;
    const int64_t n = static_cast<int64_t>(h) * w;
    const dim3 tiles((w + kTW - 1) / kTW, (h + kTH - 1) / kTH);
    const int n_tiles = static_cast<int>(tiles.x * tiles.y);
    float4* partials = reinterpret_cast<float4*>(scratch + maps_floats(h, w));
    float4* hv_minmax = partials + kPartialBlocks;
    float4* tile_partials = hv_minmax + 1;
    float4* s_minmax = tile_partials + n_tiles;
    float* sh = scratch;
    float* sv = scratch + n;

    int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
    blocks = blocks < kPartialBlocks ? blocks : kPartialBlocks;
    minmax_partials<<<blocks, kThreads, 0, s>>>(hv, row_stride, pix_stride, h, w, partials);
    reduce_partials<<<1, 1024, 0, s>>>(partials, blocks, hv_minmax);
    const size_t smem = sizeof(float) * (2 * (kTH + 2 * radius) * (kTW + 2 * radius) +
                                         2 * (kTH + 2 * radius) * kTW);
    // at most 34.6 KB (radius 15): no opt-in above the 48 KB default needed
    sobel_tile<<<tiles, dim3(kTW, kThreads / kTW), smem, s>>>(
        hv, row_stride, pix_stride, h, w, hv_minmax, taps, radius, sh, sv, tile_partials);
    reduce_partials<<<1, 1024, 0, s>>>(tile_partials, n_tiles, s_minmax);
    int out_blocks = static_cast<int>((n + kThreads - 1) / kThreads);
    out_blocks = out_blocks < 132 * 16 ? out_blocks : 132 * 16;
    if (half_out) {
        combine<__half><<<out_blocks, kThreads, 0, s>>>(sh, sv, n, s_minmax,
                                                        static_cast<__half*>(out));
    } else {
        combine<float><<<out_blocks, kThreads, 0, s>>>(sh, sv, n, s_minmax,
                                                       static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hv_energy_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

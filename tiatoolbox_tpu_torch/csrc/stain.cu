// Stain-normalisation tile transform for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_stain_kernel` / `_stain_pallas_program` in
// tiatoolbox_tpu/ops/stain.py:58-135. Per pixel of an interleaved uint8 RGB
// image:
//
//   od[k]  = max(-log(max(x[k], 1) / 255), 1e-6)          k = r, g, b
//   c[j]   = (sum_k od[k] * P[k][j]) * s[j]                j = 0, 1
//   out[k] = uint8(clip(255 * exp(-(c[0] * M[0][k] + c[1] * M[1][k])), 0, 255))
//
// with the float-to-uint8 conversion truncating, as the Pallas kernel's
// int32 hop and astype(uint8) do.
//
// Bound: 6 bytes of device memory per pixel (3 read, 3 written). At the main
// path's batch (64x224x224) that is 19.3 MB, 5.75 us at 3.35 TB/s. On an
// NVIDIA H100 80GB HBM3 at 700 W a plain device copy of the same bytes takes
// about 7.5 us and this kernel about 10.3 us. What keeps the kernel above
// both is instruction issue: with accurate expf a pixel still needs about
// 58 instructions. The design keeps that count low and the memory accesses
// whole:
//
// - OD depends only on the byte value: each block fills a 256-entry table
//   in shared memory once, with the same accurate logf and expression as
//   per-pixel code, and a pixel does 3 table reads instead of 3 logs.
// - The clip and the truncation cost no integer or conversion instruction:
//   255 * saturate(e) equals clip(255 * e, 0, 255) for every e >= 0 and NaN,
//   and adding 2^23 with rounding toward zero leaves trunc(v) in the low
//   byte for 0 <= v <= 255. P, s and the accurate expf are unchanged, so
//   every output byte is the one the per-pixel version computes.
// - A warp moves 512 pixels (1536 bytes) a step: three fully coalesced
//   16-byte streaming loads a lane into a per-warp shared buffer, from which
//   each lane takes its 16 pixels (48 contiguous bytes, no bank conflict),
//   and back the same way for the stores. The vector path needs both
//   pointers 16-byte aligned; the last n_pix % 512 pixels, and a whole call
//   whose pointers are not aligned, take a scalar loop over the same table.
// - The grid is persistent: at most as many blocks as the card holds at
//   once (occupancy queried once per device and cached), each warp
//   grid-striding over 512-pixel steps.
//
// Tensor cores have no role: the per-pixel products are 3x2 and 2x3.
// Built without --use_fast_math, so logf/expf are the accurate versions.
//
// The second entry, stain_augment_u8 (K7), replaces the device program
// augment_tiles_jax (tiatoolbox_tpu/tools/stainaugment.py:129-154): the same
// pixel pipeline with S = 2 or 3 stains and a factor and an offset per tile
// and stain,
//
//   c[j]   = (sum_k od[k] * P[k][j]) * alpha[t][j] + beta[t][j]
//   out[k] = uint8(clip(255 * exp(-sum_j c[j] * M[j][k]), 0, 255))
//
// where t is the pixel's tile, pixel_index / (H * W). K7 moves K1's 6 bytes
// a pixel and, at 2 stains, does K1's floating-point work (one FFMA by
// alpha where K1 has one FMUL by s), so it is bound as K1 is: by instruction
// issue. Its arithmetic is augment_pixel below, in one order; every path
// runs it, so every path writes the same bytes.
//
// What K7 adds to K1 is the tile. Its first design found a lane's tile with
// a 64-bit division (a software routine: the tile size is a runtime value),
// reloaded the factors where the lane's 16 pixels crossed into the next
// tile, and so tested every pixel: the unrolled 16-pixel body fell into 16
// basic blocks, and the compiler could not interleave the expf chains of
// neighbouring pixels. It took 0.01445 ms at 64x224x224x3, against K1's
// 0.0102 ms, on an NVIDIA H100 80GB HBM3 at 700 W.
//
// The tile-uniform path (stain_augment_tiles_kernel) takes every call whose
// tiles hold a multiple of 16 pixels and whose pointers are 16-byte aligned
// (every square tile with a side divisible by 4). Then each 16-pixel chunk
// (one lane's 48 bytes) lies in one tile, chunk / (H * W / 16): one 32-bit
// division by a uniform divisor a lane-step, the S factors and offsets
// loaded once a lane-step into registers, and a 16-pixel body with no
// branch, one basic block as K1's. At 2 stains its main loop compiles to
// K1's 928 instructions (58 a pixel; the first design's took 1,224, with
// the division's CALL and 5 branches), and it takes 0.0101 ms, K1's time
// (3 stains: 1,039 instructions, 0.0116 ms).
//
// The grid is K1's persistent grid of 512-pixel warp-steps over the whole
// batch, not a 2-D grid of (tile, chunk of the tile) with the factors
// loaded once a block. Timed in turns at 64x224x224x3 (before the launch
// bound below), the 2-D grid took 0.0116-0.0125 ms against 0.0111-0.0112
// at 2 stains, 0.0127-0.0131 against 0.0117-0.0118 at 3, and 0.0485
// against 0.0426-0.0428 over the 2^24 colours: a 224^2 tile is 12.25
// blocks of 4096 pixels, so each tile's last block idles most of its warps
// and tests each word at the tile's end, where the persistent grid needs no
// test at a tile's end and no idle warp. The last n_chunks % 32 chunks go
// one to a thread, straight from global memory.
//
// The general path (stain_augment_kernel) keeps the first design for the
// rest: tiles of any pixel count (a lane finds its tile once and reloads
// the factors where its pixels cross into the next), and views that are not
// 16-byte aligned (one pixel to a thread-step). The wrapper chooses the path
// (ops/stain.py::augment_path) and the entry refuses the tile-uniform path
// where its conditions do not hold.
//
// Times and instruction counts: scripts/kernel_ab.py --cases k7, on an
// NVIDIA H100 80GB HBM3 at 700 W.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

struct StainCoefs {
    float p[6];  // P, 3x2 row-major: OD -> concentrations
    float s[2];  // per-stain concentration scale
    float m[6];  // M, 2x3 row-major: target stain matrix
};

constexpr int kThreads = 256;
constexpr int kLanePixels = 16;               // 48 bytes: three 16-byte words
constexpr int kWarpPixels = 32 * kLanePixels;  // 1536 bytes: 96 16-byte words
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float optical_density(uint32_t v) {
    const float x = v == 0 ? 1.0f : static_cast<float>(v);
    return fmaxf(-logf(x / 255.0f), 1e-6f);
}

// The output byte in the low 8 bits; the upper bits are not zero.
__device__ __forceinline__ uint32_t to_u8(float c0, float c1, float w0, float w1) {
    const float val = 255.0f * __saturatef(expf(-(c0 * w0 + c1 * w1)));
    return __float_as_uint(__fadd_rz(val, 8388608.0f));
}

// One pixel: input bytes r, g, b -> output bytes in the low 8 bits of o[0..2].
__device__ __forceinline__ void transform_pixel(const float* od, uint32_t r, uint32_t g,
                                                uint32_t b, const StainCoefs& c,
                                                uint32_t o[3]) {
    const float od_r = od[r];
    const float od_g = od[g];
    const float od_b = od[b];
    const float c0 = (od_r * c.p[0] + od_g * c.p[2] + od_b * c.p[4]) * c.s[0];
    const float c1 = (od_r * c.p[1] + od_g * c.p[3] + od_b * c.p[5]) * c.s[1];
    o[0] = to_u8(c0, c1, c.m[0], c.m[3]);
    o[1] = to_u8(c0, c1, c.m[1], c.m[4]);
    o[2] = to_u8(c0, c1, c.m[2], c.m[5]);
}

// 16 pixels, 48 bytes in place: three 16-byte words in, three out.
__device__ __forceinline__ void transform_lane(const float* od, uint4* words,
                                               const StainCoefs& c) {
    const uint4 a = words[0];
    const uint4 b = words[1];
    const uint4 d = words[2];
    const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d.x, d.y, d.z, d.w};
    uint32_t o[12] = {};
#pragma unroll
    for (int p = 0; p < kLanePixels; ++p) {
        uint32_t v[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int byte = 3 * p + k;
            v[k] = (w[byte / 4] >> (8 * (byte % 4))) & 0xFFu;
        }
        uint32_t r[3];
        transform_pixel(od, v[0], v[1], v[2], c, r);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int byte = 3 * p + k;
            o[byte / 4] |= (r[k] & 0xFFu) << (8 * (byte % 4));
        }
    }
    words[0] = make_uint4(o[0], o[1], o[2], o[3]);
    words[1] = make_uint4(o[4], o[5], o[6], o[7]);
    words[2] = make_uint4(o[8], o[9], o[10], o[11]);
}

// Pixels [0, 512 * n_steps) go 512 to a warp-step through 16-byte vectors
// (both pointers are then 16-byte aligned); pixels [512 * n_steps, n_pix)
// go one to a thread-step through bytes.
__global__ void __launch_bounds__(kThreads)
stain_transform_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       int64_t n_steps, int64_t n_pix, StainCoefs c) {
    __shared__ float od[256];
    __shared__ uint4 staged[kThreads / 32][3 * 32];
    for (int v = threadIdx.x; v < 256; v += blockDim.x) {
        od[v] = optical_density(v);
    }
    __syncthreads();

    const uint32_t lane = threadIdx.x % 32;
    uint4* buf = staged[threadIdx.x / 32];
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (int64_t step = first / 32; step < n_steps; step += stride / 32) {
        const uint4* src = in4 + 96 * step;
        const uint4 x0 = __ldcs(src + lane);
        const uint4 x1 = __ldcs(src + 32 + lane);
        const uint4 x2 = __ldcs(src + 64 + lane);
        __syncwarp();  // the previous step's stores have read the buffer
        buf[lane] = x0;
        buf[32 + lane] = x1;
        buf[64 + lane] = x2;
        __syncwarp();
        transform_lane(od, buf + 3 * lane, c);
        __syncwarp();
        uint4* dst = out4 + 96 * step;
        __stcs(dst + lane, buf[lane]);
        __stcs(dst + 32 + lane, buf[32 + lane]);
        __stcs(dst + 64 + lane, buf[64 + lane]);
    }

    for (int64_t i = kWarpPixels * n_steps + first; i < n_pix; i += stride) {
        const int64_t at = 3 * i;
        uint32_t r[3];
        transform_pixel(od, in[at], in[at + 1], in[at + 2], c, r);
        out[at] = static_cast<uint8_t>(r[0]);
        out[at + 1] = static_cast<uint8_t>(r[1]);
        out[at + 2] = static_cast<uint8_t>(r[2]);
    }
}

// -- stain augmentation (S stains, per-tile factors) ----------------------------

struct AugmentCoefs {
    float p[9];  // P, 3xS row-major: OD -> concentrations
    float m[9];  // M, Sx3 row-major: stain matrix
};

template <int S>
__device__ __forceinline__ void load_tile(const float* alpha, const float* beta, int64_t t,
                                          float a[S], float b[S]) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
        a[j] = alpha[S * t + j];
        b[j] = beta[S * t + j];
    }
}

template <int S>
__device__ __forceinline__ void augment_pixel(const float* od, uint32_t r, uint32_t g, uint32_t b,
                                              const AugmentCoefs& c, const float a[S],
                                              const float off[S], uint32_t o[3]) {
    const float od_r = od[r];
    const float od_g = od[g];
    const float od_b = od[b];
    float conc[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
        conc[j] = (od_r * c.p[j] + od_g * c.p[S + j] + od_b * c.p[2 * S + j]) * a[j] + off[j];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < S; ++j) {
            sum += conc[j] * c.m[3 * j + k];
        }
        const float val = 255.0f * __saturatef(expf(-sum));
        o[k] = __float_as_uint(__fadd_rz(val, 8388608.0f));
    }
}

// 16 pixels of one tile, 48 bytes in place: three 16-byte words in, three out.
template <int S>
__device__ __forceinline__ void augment_lane(const float* od, uint4* words, const AugmentCoefs& c,
                                             const float a[S], const float off[S]) {
    const uint4 wa = words[0];
    const uint4 wb = words[1];
    const uint4 wd = words[2];
    const uint32_t w[12] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w, wd.x, wd.y, wd.z, wd.w};
    uint32_t o[12] = {};
#pragma unroll
    for (int q = 0; q < kLanePixels; ++q) {
        uint32_t v[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int byte = 3 * q + k;
            v[k] = (w[byte / 4] >> (8 * (byte % 4))) & 0xFFu;
        }
        uint32_t r[3];
        augment_pixel<S>(od, v[0], v[1], v[2], c, a, off, r);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int byte = 3 * q + k;
            o[byte / 4] |= (r[k] & 0xFFu) << (8 * (byte % 4));
        }
    }
    words[0] = make_uint4(o[0], o[1], o[2], o[3]);
    words[1] = make_uint4(o[4], o[5], o[6], o[7]);
    words[2] = make_uint4(o[8], o[9], o[10], o[11]);
}

// The tile-uniform path: n_chunks chunks of 16 pixels, tile_chunks to a tile,
// both pointers 16-byte aligned. Chunks [0, 32 * (n_chunks / 32)) go 32 to a
// warp-step through the per-warp buffer, as stain_transform_kernel's pixels;
// the rest one to a thread-step, straight from global memory.
//
// The launch bound asks for S == 2 ? 6 : 5 blocks an SM at once, which caps
// the registers: 40 at 2 stains (K1's count; 48 without the bound), so the
// main batch's 784 blocks of 8 warp-steps all fit on the card's 132 SMs in
// one wave; 48 at 3 stains (62 without), where 6 blocks would spill.
template <int S>
__global__ void __launch_bounds__(kThreads, S == 2 ? 6 : 5)
stain_augment_tiles_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                           uint32_t n_chunks, uint32_t tile_chunks,
                           const float* __restrict__ alpha, const float* __restrict__ beta,
                           AugmentCoefs c) {
    __shared__ float od[256];
    __shared__ uint4 staged[kThreads / 32][3 * 32];
    for (int v = threadIdx.x; v < 256; v += blockDim.x) {
        od[v] = optical_density(v);
    }
    __syncthreads();

    const uint32_t lane = threadIdx.x % 32;
    uint4* buf = staged[threadIdx.x / 32];
    const uint32_t first = blockIdx.x * blockDim.x + threadIdx.x;
    const uint32_t stride = gridDim.x * blockDim.x;
    const uint32_t n_steps = n_chunks / 32;
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    float a[S];
    float b[S];
    for (uint32_t step = first / 32; step < n_steps; step += stride / 32) {
        const uint4* src = in4 + 96 * static_cast<size_t>(step);
        const uint4 x0 = __ldcs(src + lane);
        const uint4 x1 = __ldcs(src + 32 + lane);
        const uint4 x2 = __ldcs(src + 64 + lane);
        load_tile<S>(alpha, beta, (32 * step + lane) / tile_chunks, a, b);
        __syncwarp();  // the previous step's stores have read the buffer
        buf[lane] = x0;
        buf[32 + lane] = x1;
        buf[64 + lane] = x2;
        __syncwarp();
        augment_lane<S>(od, buf + 3 * lane, c, a, b);
        __syncwarp();
        uint4* dst = out4 + 96 * static_cast<size_t>(step);
        __stcs(dst + lane, buf[lane]);
        __stcs(dst + 32 + lane, buf[32 + lane]);
        __stcs(dst + 64 + lane, buf[64 + lane]);
    }

    for (uint32_t chunk = 32 * n_steps + first; chunk < n_chunks; chunk += stride) {
        const uint4* src = in4 + 3 * static_cast<size_t>(chunk);
        uint4 words[3] = {__ldcs(src), __ldcs(src + 1), __ldcs(src + 2)};
        load_tile<S>(alpha, beta, chunk / tile_chunks, a, b);
        augment_lane<S>(od, words, c, a, b);
        uint4* dst = out4 + 3 * static_cast<size_t>(chunk);
        __stcs(dst, words[0]);
        __stcs(dst + 1, words[1]);
        __stcs(dst + 2, words[2]);
    }
}

// The general path: pixels [0, 512 * n_steps) in 16-byte vectors, the rest
// one to a thread, as stain_transform_kernel; tile_pix = H * W, any size.
template <int S>
__global__ void __launch_bounds__(kThreads)
stain_augment_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     int64_t n_steps, int64_t n_pix, int64_t tile_pix,
                     const float* __restrict__ alpha, const float* __restrict__ beta,
                     AugmentCoefs c) {
    __shared__ float od[256];
    __shared__ uint4 staged[kThreads / 32][3 * 32];
    for (int v = threadIdx.x; v < 256; v += blockDim.x) {
        od[v] = optical_density(v);
    }
    __syncthreads();

    const uint32_t lane = threadIdx.x % 32;
    uint4* buf = staged[threadIdx.x / 32];
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    float a[S];
    float b[S];
    for (int64_t step = first / 32; step < n_steps; step += stride / 32) {
        const uint4* src = in4 + 96 * step;
        const uint4 x0 = __ldcs(src + lane);
        const uint4 x1 = __ldcs(src + 32 + lane);
        const uint4 x2 = __ldcs(src + 64 + lane);
        __syncwarp();
        buf[lane] = x0;
        buf[32 + lane] = x1;
        buf[64 + lane] = x2;
        __syncwarp();

        const int64_t p0 = kWarpPixels * step + kLanePixels * lane;
        int64_t t = p0 / tile_pix;
        // the lane's first pixel of the next tile, counted from p0 (16: none)
        int cross = static_cast<int>(min((t + 1) * tile_pix - p0, int64_t{kLanePixels}));
        load_tile<S>(alpha, beta, t, a, b);
        uint4* words = buf + 3 * lane;
        const uint4 wa = words[0];
        const uint4 wb = words[1];
        const uint4 wd = words[2];
        const uint32_t w[12] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y,
                                wb.z, wb.w, wd.x, wd.y, wd.z, wd.w};
        uint32_t o[12] = {};
#pragma unroll
        for (int q = 0; q < kLanePixels; ++q) {
            if (q == cross) {
                ++t;
                cross = static_cast<int>(min(cross + tile_pix, int64_t{kLanePixels}));
                load_tile<S>(alpha, beta, t, a, b);
            }
            uint32_t v[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int byte = 3 * q + k;
                v[k] = (w[byte / 4] >> (8 * (byte % 4))) & 0xFFu;
            }
            uint32_t r[3];
            augment_pixel<S>(od, v[0], v[1], v[2], c, a, b, r);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int byte = 3 * q + k;
                o[byte / 4] |= (r[k] & 0xFFu) << (8 * (byte % 4));
            }
        }
        words[0] = make_uint4(o[0], o[1], o[2], o[3]);
        words[1] = make_uint4(o[4], o[5], o[6], o[7]);
        words[2] = make_uint4(o[8], o[9], o[10], o[11]);
        __syncwarp();
        uint4* dst = out4 + 96 * step;
        __stcs(dst + lane, buf[lane]);
        __stcs(dst + 32 + lane, buf[32 + lane]);
        __stcs(dst + 64 + lane, buf[64 + lane]);
    }

    for (int64_t i = kWarpPixels * n_steps + first; i < n_pix; i += stride) {
        load_tile<S>(alpha, beta, i / tile_pix, a, b);
        const int64_t at = 3 * i;
        uint32_t r[3];
        augment_pixel<S>(od, in[at], in[at + 1], in[at + 2], c, a, b, r);
        out[at] = static_cast<uint8_t>(r[0]);
        out[at + 1] = static_cast<uint8_t>(r[1]);
        out[at + 2] = static_cast<uint8_t>(r[2]);
    }
}

// SM count times resident blocks per SM of `kernel`, once per device.
static cudaError_t persistent_blocks(const void* kernel, std::atomic<int>* cached, int* blocks) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) {
        return err;
    }
    if (device < kMaxDevices) {
        *blocks = cached[device].load(std::memory_order_relaxed);
        if (*blocks > 0) {
            return cudaSuccess;
        }
    }
    int n_sm = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    }
    if (err != cudaSuccess) {
        return err;
    }
    *blocks = n_sm * (per_sm > 0 ? per_sm : 1);
    if (device < kMaxDevices) {
        cached[device].store(*blocks, std::memory_order_relaxed);
    }
    return cudaSuccess;
}

extern "C" int stain_transform_u8(const uint8_t* in, uint8_t* out, int64_t n_pix,
                                  StainCoefs c, cudaStream_t s) {
    if (n_pix <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    static std::atomic<int> cached[kMaxDevices];
    int cap = 0;
    const cudaError_t err =
        persistent_blocks(reinterpret_cast<const void*>(stain_transform_kernel), cached, &cap);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
    const int64_t n_steps = aligned ? n_pix / kWarpPixels : 0;
    const int64_t n_scalar = n_pix - kWarpPixels * n_steps;
    const int64_t threads = 32 * n_steps > n_scalar ? 32 * n_steps : n_scalar;
    const int64_t wanted = (threads + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
    stain_transform_kernel<<<blocks, kThreads, 0, s>>>(in, out, n_steps, n_pix, c);
    return static_cast<int>(cudaGetLastError());
}

// Blocks for `threads` threads, at most `cap`.
static int grid_blocks(int64_t threads, int cap) {
    const int64_t wanted = (threads + kThreads - 1) / kThreads;
    return static_cast<int>(wanted < cap ? wanted : cap);
}

static bool aligned16(const uint8_t* in, const uint8_t* out) {
    return ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
}

template <int S>
static int launch_augment(const uint8_t* in, uint8_t* out, int64_t n_pix, int64_t tile_pix,
                          bool tile_uniform, const float* alpha, const float* beta,
                          const AugmentCoefs& c, cudaStream_t s) {
    static std::atomic<int> cached_tiles[kMaxDevices];
    static std::atomic<int> cached_general[kMaxDevices];
    int cap = 0;
    if (tile_uniform) {
        const cudaError_t err = persistent_blocks(
            reinterpret_cast<const void*>(stain_augment_tiles_kernel<S>), cached_tiles, &cap);
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
        const int64_t n_chunks = n_pix / kLanePixels;
        const int64_t tail = n_chunks % 32;
        const int blocks = grid_blocks(n_chunks - tail > tail ? n_chunks - tail : tail, cap);
        stain_augment_tiles_kernel<S><<<blocks, kThreads, 0, s>>>(
            in, out, static_cast<uint32_t>(n_chunks), static_cast<uint32_t>(tile_pix / kLanePixels),
            alpha, beta, c);
        return static_cast<int>(cudaGetLastError());
    }
    const cudaError_t err = persistent_blocks(
        reinterpret_cast<const void*>(stain_augment_kernel<S>), cached_general, &cap);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int64_t n_steps = aligned16(in, out) ? n_pix / kWarpPixels : 0;
    const int64_t n_scalar = n_pix - kWarpPixels * n_steps;
    const int blocks = grid_blocks(32 * n_steps > n_scalar ? 32 * n_steps : n_scalar, cap);
    stain_augment_kernel<S><<<blocks, kThreads, 0, s>>>(in, out, n_steps, n_pix, tile_pix, alpha,
                                                        beta, c);
    return static_cast<int>(cudaGetLastError());
}

// n_stains is 2 or 3; alpha and beta are [n_pix / tile_pix, n_stains] float32
// on the device. tile_uniform asks for the tile-uniform path, which needs
// tile_pix % 16 == 0, both pointers 16-byte aligned and n_pix / 16 < 2^31;
// otherwise the general path runs. Returns a cudaError_t, or
// cudaErrorInvalidValue for another stain count, a tile size that does not
// divide the pixels, or the tile-uniform path where it cannot run.
extern "C" int stain_augment_u8(const uint8_t* in, uint8_t* out, int64_t n_pix, int64_t tile_pix,
                                int n_stains, int tile_uniform, const float* alpha,
                                const float* beta, AugmentCoefs c, cudaStream_t s) {
    if (n_pix <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    if (tile_pix <= 0 || n_pix % tile_pix != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (tile_uniform && (tile_pix % kLanePixels != 0 || !aligned16(in, out) ||
                         n_pix / kLanePixels >= (int64_t{1} << 31))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n_stains == 2) {
        return launch_augment<2>(in, out, n_pix, tile_pix, tile_uniform != 0, alpha, beta, c, s);
    }
    if (n_stains == 3) {
        return launch_augment<3>(in, out, n_pix, tile_pix, tile_uniform != 0, alpha, beta, c, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* stain_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

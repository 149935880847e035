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

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

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

// SM count times resident blocks per SM, once per device.
static cudaError_t persistent_blocks(int* blocks) {
    static std::atomic<int> cached[kMaxDevices];
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
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stain_transform_kernel,
                                                            kThreads, 0);
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
    int cap = 0;
    const cudaError_t err = persistent_blocks(&cap);
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

extern "C" const char* stain_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

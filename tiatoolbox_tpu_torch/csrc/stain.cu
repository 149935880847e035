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
// Bound: the function moves 6 bytes of device memory per pixel (3 read,
// 3 written) and does 3 log and 3 exp per pixel. Design: one pass over the
// interleaved NHWC bytes, one pixel per thread per step of a grid-stride
// loop with int64 offsets, no planar gather/scatter and no intermediate in
// device memory. The 14 coefficients travel by value in the kernel's
// parameter space. Built without --use_fast_math, so logf/expf are the
// accurate versions.

#include <cstdint>
#include <cuda_runtime.h>

struct StainCoefs {
    float p[6];  // P, 3x2 row-major: OD -> concentrations
    float s[2];  // per-stain concentration scale
    float m[6];  // M, 2x3 row-major: target stain matrix
};

__device__ __forceinline__ float optical_density(uint8_t v) {
    const float x = v == 0 ? 1.0f : static_cast<float>(v);
    return fmaxf(-logf(x / 255.0f), 1e-6f);
}

__device__ __forceinline__ uint8_t to_u8(float c0, float c1, float w0, float w1) {
    const float val = 255.0f * expf(-(c0 * w0 + c1 * w1));
    return static_cast<uint8_t>(fminf(fmaxf(val, 0.0f), 255.0f));
}

__global__ void stain_transform_kernel(const uint8_t* __restrict__ in,
                                       uint8_t* __restrict__ out,
                                       int64_t n_pix, StainCoefs c) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n_pix; i += stride) {
        const int64_t o = 3 * i;
        const float od_r = optical_density(in[o]);
        const float od_g = optical_density(in[o + 1]);
        const float od_b = optical_density(in[o + 2]);
        const float c0 = (od_r * c.p[0] + od_g * c.p[2] + od_b * c.p[4]) * c.s[0];
        const float c1 = (od_r * c.p[1] + od_g * c.p[3] + od_b * c.p[5]) * c.s[1];
        out[o] = to_u8(c0, c1, c.m[0], c.m[3]);
        out[o + 1] = to_u8(c0, c1, c.m[1], c.m[4]);
        out[o + 2] = to_u8(c0, c1, c.m[2], c.m[5]);
    }
}

extern "C" int stain_transform_u8(const uint8_t* in, uint8_t* out, int64_t n_pix,
                                  StainCoefs c, cudaStream_t s) {
    if (n_pix <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    int device = 0;
    int n_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int threads = 256;
    const int64_t wanted = (n_pix + threads - 1) / threads;
    const int64_t cap = static_cast<int64_t>(n_sm) * 16;  // enough blocks in flight
    const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
    stain_transform_kernel<<<blocks, threads, 0, s>>>(in, out, n_pix, c);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stain_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Helpers shared by the port's kernels: persistent-grid sizing and the
// 4-element vector stores of float32 or float16 outputs.
#pragma once

#include <atomic>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace occupancy {

constexpr int kMaxDevices = 16;

// *blocks = SMs x resident blocks per SM of `kernel` at `threads` threads and
// `smem` bytes of dynamic shared memory (at least one per SM). The result is
// kept in cache[device], which the caller owns (one array per kernel and
// shared-memory size). A kernel launched with more than 48 KB of dynamic
// shared memory is allowed `smem_max` bytes (at least `smem`) first.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            std::atomic<int> (&cache)[kMaxDevices], int* blocks,
                            size_t smem_max = 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) {
        return err;
    }
    if (device < kMaxDevices) {
        *blocks = cache[device].load(std::memory_order_relaxed);
        if (*blocks > 0) {
            return cudaSuccess;
        }
    }
    int n_sm = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    smem_max = smem_max > smem ? smem_max : smem;
    if (err == cudaSuccess && smem_max > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem_max));
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    }
    if (err != cudaSuccess) {
        return err;
    }
    *blocks = n_sm * (per_sm > 0 ? per_sm : 1);
    if (device < kMaxDevices) {
        cache[device].store(*blocks, std::memory_order_relaxed);
    }
    return cudaSuccess;
}

}  // namespace occupancy

// Four consecutive outputs (16 bytes of float32, 8 of float16, rounded to
// nearest even as PyTorch's cast), and one, with streaming hints: nothing on
// the card reads these outputs again.
__device__ __forceinline__ unsigned half_bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ void store4(float* o, float4 r) {
    __stcs(reinterpret_cast<float4*>(o), r);
}
__device__ __forceinline__ void store4(__half* o, float4 r) {
    __stcs(reinterpret_cast<uint2*>(o), make_uint2(half_bits(r.x) | half_bits(r.y) << 16,
                                                   half_bits(r.z) | half_bits(r.w) << 16));
}
__device__ __forceinline__ void store1(float* o, float v) { __stcs(o, v); }
__device__ __forceinline__ void store1(__half* o, float v) {
    __stcs(reinterpret_cast<unsigned short*>(o), static_cast<unsigned short>(half_bits(v)));
}

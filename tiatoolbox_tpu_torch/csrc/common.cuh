// Helpers shared by the port's kernels: persistent-grid sizing, the
// 4-element vector stores of float32 or float16 outputs, the division by a
// reciprocal, and the min/max of a pair of channels over a whole grid (K5's
// first pass and K6 reduce the hv pair with the same code).
#pragma once

#include <atomic>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

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

// a / d rounded to nearest, given r = RN(1 / d): q = RN(a r) lies within an
// ulp of a / d, the residual a - q d is exact with fmaf, and RN(q + (a - q d) r)
// is the correctly rounded quotient (Markstein's theorem), the bits of
// a / d wherever nothing underflows. Three instructions and no branch, where
// the division's slow-path check costs about ten and splits the code.
__device__ __forceinline__ float div_rcp(float a, float d, float r) {
    const float q = a * r;
    return fmaf(fmaf(-q, d, a), r, q);
}

// Min/max of a pair (a, b) as one float4 (min a, max a, min b, max b). fminf
// and fmaxf give the same result in any order, so the partials may be merged
// as blocks finish.
__device__ __forceinline__ float4 empty_minmax() {
    return make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
}

__device__ __forceinline__ float4 merge(float4 m, float a, float b) {
    return make_float4(fminf(m.x, a), fmaxf(m.y, a), fminf(m.z, b), fmaxf(m.w, b));
}

__device__ __forceinline__ float4 merge(float4 m, float4 p) {
    return make_float4(fminf(m.x, p.x), fmaxf(m.y, p.y), fminf(m.z, p.z), fmaxf(m.w, p.w));
}

// (min a, max a, min b, max b) of a block, written by thread 0 to *out.
__device__ inline void block_minmax(float4 m, float4* out) {
    __shared__ float4 warp_part[32];
    for (int off = 16; off > 0; off >>= 1) {
        m = merge(m, make_float4(__shfl_down_sync(0xffffffffu, m.x, off),
                                 __shfl_down_sync(0xffffffffu, m.y, off),
                                 __shfl_down_sync(0xffffffffu, m.z, off),
                                 __shfl_down_sync(0xffffffffu, m.w, off)));
    }
    const int tid = threadIdx.x;
    const int n_warps = (blockDim.x + 31) / 32;
    if ((tid & 31) == 0) {
        warp_part[tid >> 5] = m;
    }
    __syncthreads();
    if (tid < 32) {
        m = tid < n_warps ? warp_part[tid] : empty_minmax();
        for (int off = 16; off > 0; off >>= 1) {
            m = merge(m, make_float4(__shfl_down_sync(0xffffffffu, m.x, off),
                                     __shfl_down_sync(0xffffffffu, m.y, off),
                                     __shfl_down_sync(0xffffffffu, m.z, off),
                                     __shfl_down_sync(0xffffffffu, m.w, off)));
        }
        if (tid == 0) {
            *out = m;
        }
    }
}

// The block's min/max goes to partials[block]; the last block of the grid to
// get there (its ticket is the grid's size less one) reduces all partials
// into *result. *ticket is zero when the kernel starts. Every thread of
// every block calls it.
__device__ inline void grid_minmax(float4 m, float4* partials, unsigned* ticket, float4* result) {
    __shared__ bool last;
    const unsigned n_blocks = gridDim.x * gridDim.y;
    const unsigned block = blockIdx.y * gridDim.x + blockIdx.x;
    block_minmax(m, partials + block);
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(ticket, 1u) == n_blocks - 1;
    }
    __syncthreads();
    if (!last) {
        return;
    }
    __threadfence();
    float4 r = empty_minmax();
    for (unsigned i = threadIdx.x; i < n_blocks; i += blockDim.x) {
        r = merge(r, __ldcg(partials + i));
    }
    block_minmax(r, result);
}

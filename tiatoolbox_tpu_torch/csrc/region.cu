// Patch extraction from a device-resident slide band for Hopper (sm_90a): K4.
//
// Replaces the XLA program `extract_patches` in
// tiatoolbox_tpu/ops/region.py:42-58 (a vmapped lax.dynamic_slice):
//
//   out[b, y, x, :] = band[sy_b + y, sx_b + x, :]     b < B, y < ph, x < pw
//
// on a uint8 band [Hb, Wb, C], with (sy_b, sx_b) already inside the band.
// It is a copy of bytes, bound by device memory: each output byte is read
// once from the band and written once, and nothing else is read.
//
// The design keeps every thread on 16-byte words:
// - The patches' band offsets travel by value in the kernel's parameter
//   struct (__grid_constant__), so a launch uploads nothing; a batch longer
//   than the struct holds is launched in chunks by the wrapper.
// - The work is one flat space of (patch row, 16-byte output word), walked
//   by a grid-strided launch of full 256-thread blocks sized to the SMs, so
//   no thread idles on a short row (phase D's rows are 48 words).
// - A patch row starts at any byte of the band (sx x 3 is rarely a multiple
//   of 16), so a thread reads the one or two aligned 16-byte words that hold
//   its 16 bytes (__ldg of uint4, never a word past the one that holds its
//   last byte) and shifts them into place with __funnelshift_r.
// - It stores one 16-byte word where every output row is a whole number of
//   words (pw x C = 768 and 3,072 bytes on the engines' paths); elsewhere
//   one byte at a time.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kThreads = 256;

// Patches one launch takes. Their offsets travel in the parameter struct,
// whose portable limit is 4,096 bytes: 48 bytes of pointers and sizes plus
// 8 bytes a patch.
constexpr int kExtractPatches = 500;

struct ExtractArgs {
    const uint8_t* band;
    uint8_t* out;  // [n, ph, row_bytes]
    int64_t band_row_bytes;
    int row_bytes;  // pw x channels
    int words;      // 16-byte words of an output row; the last may be partial
    int ph;
    int n_items;       // n x ph x words, below 2^31
    int vector_store;  // row_bytes % 16 == 0 and out 16-byte aligned
    int64_t offset[kExtractPatches];  // band byte offset of each patch's first byte
};
static_assert(sizeof(ExtractArgs) <= 4096, "K4's parameters exceed the portable 4,096 bytes");

// The 16 bytes from s, of which the first n (1-16) are used: one or two
// aligned 16-byte loads, then a funnel shift by s's offset in its word.
__device__ __forceinline__ uint4 load16(const uint8_t* s, int n) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(s);
    const uint4* w = reinterpret_cast<const uint4*>(at & ~uintptr_t{15});
    const unsigned off = static_cast<unsigned>(at & 15u);
    const uint4 lo = __ldg(w);
    if (off == 0) {
        return lo;
    }
    const uint4 hi = static_cast<int>(off) + n > 16 ? __ldg(w + 1) : make_uint4(0u, 0u, 0u, 0u);
    const unsigned u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const unsigned q = off >> 2;
    const unsigned sh = (off & 3u) * 8u;
    unsigned t[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        t[k] = q == 0 ? u[k] : q == 1 ? u[k + 1] : q == 2 ? u[k + 2] : u[k + 3];
    }
    return make_uint4(__funnelshift_r(t[0], t[1], sh), __funnelshift_r(t[1], t[2], sh),
                      __funnelshift_r(t[2], t[3], sh), __funnelshift_r(t[3], t[4], sh));
}

__global__ void __launch_bounds__(kThreads) extract_patches_kernel(const __grid_constant__ ExtractArgs a) {
    const unsigned stride = gridDim.x * blockDim.x;
    for (unsigned item = blockIdx.x * blockDim.x + threadIdx.x; item < static_cast<unsigned>(a.n_items);
         item += stride) {
        const unsigned row = item / a.words;
        const unsigned o = 16u * (item - row * a.words);
        const unsigned b = row / a.ph;
        const unsigned y = row - b * a.ph;
        const int n = min(16, a.row_bytes - static_cast<int>(o));
        const uint8_t* src = a.band + a.offset[b] + static_cast<int64_t>(y) * a.band_row_bytes + o;
        uint8_t* dst = a.out + static_cast<int64_t>(row) * a.row_bytes + o;
        const uint4 v = load16(src, n);
        if (a.vector_store) {
            *reinterpret_cast<uint4*>(dst) = v;
        } else {
            const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                if (k < n) {
                    dst[k] = static_cast<uint8_t>(u[k >> 2] >> (8 * (k & 3)));
                }
            }
        }
    }
}

// band: [band_h, band_w, channels] uint8; offsets: host int64 [n_patches],
// each patch's first byte in the band ((y x band_w + x) x channels, inside
// the band); n_patches <= kExtractPatches (the wrapper launches longer
// batches in chunks); out: [n_patches, ph, pw, channels] uint8.
extern "C" int region_extract_patches(const uint8_t* band, int64_t band_w, int channels,
                                      const int64_t* offsets, int n_patches, int ph, int pw,
                                      uint8_t* out, cudaStream_t s) {
    if (n_patches <= 0 || ph <= 0 || pw <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int64_t row_bytes = static_cast<int64_t>(pw) * channels;
    const int64_t words = (row_bytes + 15) / 16;
    const int64_t items = static_cast<int64_t>(n_patches) * ph * words;
    if (n_patches > kExtractPatches || channels <= 0 || items > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    ExtractArgs a{};
    a.band = band;
    a.out = out;
    a.band_row_bytes = band_w * channels;
    a.row_bytes = static_cast<int>(row_bytes);
    a.words = static_cast<int>(words);
    a.ph = ph;
    a.n_items = static_cast<int>(items);
    a.vector_store = row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
    for (int i = 0; i < n_patches; ++i) {
        a.offset[i] = offsets[i];
    }
    static std::atomic<int> cache[occupancy::kMaxDevices];
    int cap = 0;
    const cudaError_t err = occupancy::resident_blocks(extract_patches_kernel, kThreads, 0, cache, &cap);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int64_t wanted = (items + kThreads - 1) / kThreads;
    extract_patches_kernel<<<static_cast<int>(wanted < cap ? wanted : cap), kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int region_extract_max_patches() { return kExtractPatches; }

// An empty kernel, with no parameters or with K4's parameter struct: the
// floor under a launch, for timing.
__global__ void empty_kernel() {}
__global__ void empty_args_kernel(const __grid_constant__ ExtractArgs) {}

extern "C" int region_empty_launch(int with_args, cudaStream_t s) {
    if (with_args) {
        empty_args_kernel<<<1, 32, 0, s>>>(ExtractArgs{});
    } else {
        empty_kernel<<<1, 32, 0, s>>>();
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* region_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

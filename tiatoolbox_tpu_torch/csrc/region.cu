// Patch extraction from a device-resident slide band for Hopper (sm_90a): K4.
//
// Replaces the XLA program `extract_patches` in
// tiatoolbox_tpu/ops/region.py:42-58 (a vmapped lax.dynamic_slice):
//
//   out[b, y, x, :] = band[sy_b + y, sx_b + x, :]     b < B, y < ph, x < pw
//
// on a uint8 band [Hb, Wb, C], with (sy_b, sx_b) already inside the band.
// It is a copy of bytes, bound by device memory: each output byte is read
// once from the band and written once. One thread moves 16 consecutive
// bytes of an output row; the band rows start at any byte, so the thread
// reads its 16 bytes one by one (neighbouring threads read neighbouring
// bytes, so the loads coalesce) and, when every output row is a whole
// number of 16-byte words, writes them as one 16-byte store.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__global__ void extract_patches_kernel(const uint8_t* __restrict__ band, int64_t band_row_bytes,
                                       int channels, const int* __restrict__ starts, int ph,
                                       int64_t patch_row_bytes, int64_t n_rows,
                                       uint8_t* __restrict__ out, int vector_store) {
    const int64_t o = 16 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
    if (o >= patch_row_bytes) {
        return;
    }
    for (int64_t row = blockIdx.y; row < n_rows; row += gridDim.y) {
        const int64_t b = row / ph;
        const int64_t y = row % ph;
        const int64_t sy = __ldg(starts + 2 * b);
        const int64_t sx = __ldg(starts + 2 * b + 1);
        const uint8_t* src = band + (sy + y) * band_row_bytes + sx * channels + o;
        uint8_t* dst = out + row * patch_row_bytes + o;
        if (vector_store) {
            uint32_t w[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                w[j] = static_cast<uint32_t>(src[4 * j]) |
                       (static_cast<uint32_t>(src[4 * j + 1]) << 8) |
                       (static_cast<uint32_t>(src[4 * j + 2]) << 16) |
                       (static_cast<uint32_t>(src[4 * j + 3]) << 24);
            }
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
            const int64_t left = patch_row_bytes - o;
            const int n = left < 16 ? static_cast<int>(left) : 16;
            for (int k = 0; k < n; ++k) {
                dst[k] = src[k];
            }
        }
    }
}

// band: [band_h, band_w, channels] uint8; starts: device int32 [n_patches, 2]
// (y, x) inside the band; out: [n_patches, ph, pw, channels] uint8.
extern "C" int region_extract_patches(const uint8_t* band, int64_t band_w, int channels,
                                      const int* starts, int n_patches, int ph, int pw,
                                      uint8_t* out, cudaStream_t s) {
    if (n_patches <= 0 || ph <= 0 || pw <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int64_t patch_row_bytes = static_cast<int64_t>(pw) * channels;
    const int64_t n_rows = static_cast<int64_t>(n_patches) * ph;
    const int vector_store =
        patch_row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
    const int64_t words = (patch_row_bytes + 15) / 16;
    const dim3 grid(static_cast<unsigned>((words + kThreads - 1) / kThreads),
                    static_cast<unsigned>(n_rows < kMaxGridY ? n_rows : kMaxGridY));
    extract_patches_kernel<<<grid, kThreads, 0, s>>>(band, band_w * channels, channels, starts,
                                                     ph, patch_row_bytes, n_rows, out,
                                                     vector_store);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* region_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

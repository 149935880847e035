// The yuv420 wire's unpack for Hopper (sm_90a): K8.
//
// Replaces the XLA programs of tiatoolbox_tpu/ops/colorconv.py:
// `yuv420_batch_to_rgb` (:118), fused into the model's forward with its
// division by 255 (`ModelABC.apply_u8`, tiatoolbox_tpu/models/models_abc.py:
// 245-257), and the band program `_unpack_band_program` (:107-115).
//
// A packed image is uint8 planes [1.5 H, W]: the Y plane (H rows), then the
// Cb and the Cr plane, each (H/2, W/2) stored row-major in H/4 rows of width
// W. Per pixel, with the chroma of its 2x2 block (nearest upsampling):
//
//   cb = Cb - 128, cr = Cr - 128
//   r = fma(1.403, cr, y)
//   g = fma(-0.344, cb, fma(-0.714, cr, y))
//   b = fma(1.773, cb, y)
//
// each clipped to [0, 255]. These are the float32 operations XLA compiles the
// JAX expression into (each product contracted into a fused multiply-add, in
// this order), so the results are JAX's bits: unfused multiplies and adds, or
// roundf for the band's round-half-to-even, would each differ.
//
// Two entries:
// - batch: [B, 1.5 H, W] -> NHWC [B, H, W, 3] float32 or bfloat16, times a
//   scale (1/255 for the model, the multiply XLA makes of JAX's "/ 255"),
//   computed in float32 and rounded once to the output type;
// - band: [1.5 H', W'] -> uint8 [h, w, 3], the image cropped to the band's
//   (h, w) <= (H', W') and rounded half to even (rintf).
//
// Bound: device memory. Each input byte is read once (1.5 B a pixel) and each
// output written once: 13.5 B a pixel in float32, 7.5 in bfloat16, 4.5 for
// the band; about 16 float operations a pixel are nothing beside that.
//
// Design: one thread per 2x2 block of pixels, grid-strided over all blocks of
// all images (32-bit indices: the entry refuses 2^31 blocks or more), so a
// thread reads its Cb and Cr bytes once, its four Y bytes as two 16-bit
// words, and writes its two rows of two pixels: six values a row, as 8-byte
// words in float32, 4-byte words in bfloat16, and 2-byte words for the band
// where its cropped row starts on an even byte (bytes where it does not, or
// where the crop cuts the pair). Neighbouring threads read and write
// neighbouring addresses.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

enum Mode : int { kFloat32 = 0, kBFloat16 = 1, kBandU8 = 2 };

struct Args {
    const uint8_t* planes;  // [n, 1.5 h, w]
    void* out;
    unsigned items;  // n x (h / 2) x (w / 2) blocks, below 2^31
    int h;          // image rows (a multiple of 4)
    int w;          // image columns (even)
    int out_h;      // band: rows kept
    int out_w;      // band: columns kept
    float scale;    // batch: the factor applied before the cast
};

__device__ __forceinline__ float clip255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

// The three channels of one pixel from its luma and its block's chroma.
__device__ __forceinline__ void to_rgb(float y, float cb, float cr, float* rgb) {
    rgb[0] = clip255(__fmaf_rn(1.403f, cr, y));
    rgb[1] = clip255(__fmaf_rn(-0.344f, cb, __fmaf_rn(-0.714f, cr, y)));
    rgb[2] = clip255(__fmaf_rn(1.773f, cb, y));
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

template <int M>
__global__ void __launch_bounds__(kThreads) yuv420_kernel(const Args a) {
    const unsigned half_w = static_cast<unsigned>(a.w) >> 1;
    const unsigned half_h = static_cast<unsigned>(a.h) >> 1;
    const int64_t plane_bytes = static_cast<int64_t>(a.h + half_h) * a.w;
    const int64_t luma_bytes = static_cast<int64_t>(a.h) * a.w;
    const int64_t chroma_bytes = static_cast<int64_t>(half_h) * half_w;
    const unsigned stride = gridDim.x * blockDim.x;
    for (unsigned item = blockIdx.x * blockDim.x + threadIdx.x; item < a.items; item += stride) {
        const unsigned rest = item / half_w;
        const int j = static_cast<int>(item - rest * half_w);
        const unsigned b = rest / half_h;
        const int i = static_cast<int>(rest - b * half_h);
        const uint8_t* p = a.planes + b * plane_bytes;
        const int64_t c = static_cast<int64_t>(i) * half_w + j;
        const float cb = static_cast<float>(__ldg(p + luma_bytes + c)) - 128.0f;
        const float cr = static_cast<float>(__ldg(p + luma_bytes + chroma_bytes + c)) - 128.0f;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
            const int y = 2 * i + dy;
            const int x = 2 * j;
            // the two Y bytes of this row: x is even, so the word is aligned
            const unsigned short pair =
                __ldg(reinterpret_cast<const unsigned short*>(p + static_cast<int64_t>(y) * a.w + x));
            float v[6];
            to_rgb(static_cast<float>(pair & 0xffu), cb, cr, v);
            to_rgb(static_cast<float>(pair >> 8), cb, cr, v + 3);
            if (M == kBandU8) {
                if (y >= a.out_h) {
                    continue;
                }
                uint8_t* o = static_cast<uint8_t*>(a.out) + (static_cast<int64_t>(y) * a.out_w + x) * 3;
                if (x + 1 < a.out_w && (reinterpret_cast<uintptr_t>(o) & 1u) == 0) {
                    unsigned short* o2 = reinterpret_cast<unsigned short*>(o);
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        o2[k] = static_cast<unsigned short>(static_cast<unsigned>(rintf(v[2 * k])) |
                                                            static_cast<unsigned>(rintf(v[2 * k + 1])) << 8);
                    }
                } else {
                    const int n = x + 1 < a.out_w ? 6 : (x < a.out_w ? 3 : 0);
                    for (int k = 0; k < n; ++k) {
                        o[k] = static_cast<uint8_t>(rintf(v[k]));
                    }
                }
            } else {
                const int64_t first = ((static_cast<int64_t>(b) * a.h + y) * a.w + x) * 3;  // 6 values from here
                if (M == kFloat32) {
                    float2* o = reinterpret_cast<float2*>(static_cast<float*>(a.out) + first);
                    __stcs(o, make_float2(v[0] * a.scale, v[1] * a.scale));
                    __stcs(o + 1, make_float2(v[2] * a.scale, v[3] * a.scale));
                    __stcs(o + 2, make_float2(v[4] * a.scale, v[5] * a.scale));
                } else {
                    unsigned* o = reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(a.out) + first);
                    __stcs(o, bf16_bits(v[0] * a.scale) | bf16_bits(v[1] * a.scale) << 16);
                    __stcs(o + 1, bf16_bits(v[2] * a.scale) | bf16_bits(v[3] * a.scale) << 16);
                    __stcs(o + 2, bf16_bits(v[4] * a.scale) | bf16_bits(v[5] * a.scale) << 16);
                }
            }
        }
    }
}

template <int M>
cudaError_t launch(const Args& a, cudaStream_t s) {
    static std::atomic<int> cache[occupancy::kMaxDevices];
    int cap = 0;
    const cudaError_t err = occupancy::resident_blocks(yuv420_kernel<M>, kThreads, 0, cache, &cap);
    if (err != cudaSuccess) {
        return err;
    }
    const int64_t wanted = (static_cast<int64_t>(a.items) + kThreads - 1) / kThreads;
    yuv420_kernel<M><<<static_cast<int>(wanted < cap ? wanted : cap), kThreads, 0, s>>>(a);
    return cudaGetLastError();
}

}  // namespace

// planes: [n, 1.5 h, w] uint8, contiguous and 2-byte aligned; h % 4 == 0,
// w % 2 == 0. mode 0: out float32 [n, h, w, 3]; mode 1: out bfloat16
// [n, h, w, 3] (8- and 4-byte aligned), each value times `scale`; mode 2:
// n == 1, out uint8 [out_h, out_w, 3] with out_h <= h, out_w <= w.
extern "C" int colorconv_yuv420_to_rgb(const uint8_t* planes, int n, int h, int w, void* out, int mode,
                                       int out_h, int out_w, float scale, cudaStream_t s) {
    if (n <= 0 || h <= 0 || w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int64_t items = static_cast<int64_t>(n) * (h / 2) * (w / 2);
    if (h % 4 != 0 || w % 2 != 0 || items > INT32_MAX ||
        (mode == kBandU8 && (n != 1 || out_h > h || out_w > w))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Args a{};
    a.planes = planes;
    a.out = out;
    a.items = static_cast<unsigned>(items);
    a.h = h;
    a.w = w;
    a.out_h = out_h;
    a.out_w = out_w;
    a.scale = scale;
    switch (mode) {
        case kFloat32:
            return static_cast<int>(launch<kFloat32>(a, s));
        case kBFloat16:
            return static_cast<int>(launch<kBFloat16>(a, s));
        case kBandU8:
            return static_cast<int>(launch<kBandU8>(a, s));
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* colorconv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

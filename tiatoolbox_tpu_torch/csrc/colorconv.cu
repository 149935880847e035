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
//   (h, w) <= (H', W') and rounded half to even.
//
// Bound: device memory. Each input byte is read once (1.5 B a pixel) and each
// output written once: 13.5 B a pixel in float32, 7.5 in bfloat16, 4.5 for
// the band; about 16 float operations a pixel are nothing beside that.
//
// Design: one chroma row feeds two luma rows, so the unit of work ("item") is
// a row pair, cut into column tiles as even as a multiple of four columns
// allows where a row is wider than 252 pixels (at most 508: C's band rows of
// 6874 pixels are 14 tiles of 492). A persistent grid of CTAs splits the
// items evenly, each CTA a contiguous run, and walks its run in strips of
// four items, one output row a warp. For each strip:
// - four threads work out the items' offsets (two divisions an item, not
//   two a 2x2 block), one strip ahead, into a table in shared memory;
// - the items' two luma rows, Cb row and Cr row come into shared memory by
//   16-byte cp.async copies of each row's 16-byte aligned cover (a row
//   starts at any byte: at odd chroma widths, at W not a multiple of 16, on
//   a cropped band), one strip ahead, so they arrive while the strip before
//   is unpacked and stored; the one CTA-wide barrier a strip makes them
//   visible;
// - a lane unpacks a cell of four pixels whose output starts at a multiple of
//   four output pixels, reading its luma and chroma as aligned 32-bit words
//   of shared memory, and writes its twelve values as three 16-, 8- or
//   4-byte words (float32, bfloat16, uint8) into its warp's staging row,
//   which keeps the output's alignment modulo 16. A row's first and last
//   cells, which it may start or end inside, run as the others: their pixels
//   beside the row read bytes beside it and write staging bytes that are not
//   written out, so no lane takes a slower path;
// - the warp then writes its staging row out in 16-byte stores (512
//   contiguous bytes a warp instruction), a lane a byte of a partial first or
//   last 16-byte chunk; only the warp's own barrier is needed, as no other
//   warp touches its staging row.
// Per value the work is the three fmas and as few instructions besides as the
// bits allow: the integer-to-float conversions are exact float additions of
// 2^23; where 255 x scale rounds to 1 (the model's /255) the clip and the
// scale are one saturating multiply; the band rounds with an addition of
// 1.5 x 2^23 (half to even, as rintf) and clamps the integers two at a time
// (min.relu.s16x2).

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;      // output rows a strip: one a warp
constexpr int kPairs = kRows / 2;  // items (row pairs of a tile) a strip
constexpr int kNarrow = 252;       // the widest tile of the narrow instances
constexpr int kWide = 508;         // and of the wide ones

enum Mode : int { kFloat32 = 0, kBFloat16 = 1, kBandU8 = 2 };

constexpr int value_bytes(int mode) { return mode == kFloat32 ? 4 : (mode == kBFloat16 ? 2 : 1); }
constexpr int round16(int v) { return (v + 15) / 16 * 16; }

struct Args {
    const uint8_t* planes;  // [n, 1.5 h, w]
    void* out;              // [n, out_h, out_w, 3]
    int64_t plane_bytes;    // 1.5 h w
    int64_t luma_bytes;     // h w
    int64_t chroma_bytes;   // h w / 4
    unsigned items;         // n x pairs x tiles
    unsigned pairs;         // row pairs unpacked an image: ceil(out_h / 2)
    unsigned tiles;         // column tiles a row pair
    int tile_w;             // pixels a tile (a multiple of 4)
    int w;                  // plane columns (even)
    int out_h;              // output rows an image
    int out_w;              // output columns
    float scale;            // batch: the factor applied before the cast
};

// One item: a row pair (rows 2i and 2i + 1 of image b) of one column tile.
struct Item {
    int64_t y;  // planes offset of its first luma byte in row 2i (row 2i + 1 is w later)
    int64_t c;  // planes offset of its first Cb byte (its Cr is chroma_bytes later)
    int64_t o;  // output pixel index of its first pixel in row 2i (row 2i + 1 is out_w later)
    int cols;   // pixels a row
    int rows;   // output rows: 2, 1 (the band's last row of an odd out_h), 0 past the CTA's run
};

// Dynamic shared memory of one instance: two input stages (luma rows, Cb
// rows, Cr rows) and a staging row a warp. Every slot is 16-byte aligned. An
// input row's cover starts up to 15 bytes into its slot, after 16 bytes of
// margin, and the 32-bit reads of its first and last cells reach up to 4
// bytes before and 7 past it. A staging row starts its slot's 64-byte margin
// plus up to 15 bytes in, and the stores of its first and last cells reach
// up to 36 bytes before and after it.
template <int M, int TW>
struct Layout {
    static constexpr int kValue = value_bytes(M);
    static constexpr int kLuma = 16 + round16(TW) + 32;
    static constexpr int kChroma = 16 + round16(TW / 2) + 32;
    static constexpr int kOut = 64 + round16(3 * kValue * TW) + 64;
    static constexpr int kStage = kRows * kLuma + 2 * kPairs * kChroma;
    static constexpr int kBytes = 2 * kStage + kRows * kOut;
    static __device__ __forceinline__ unsigned luma(int stage, int row) { return stage * kStage + row * kLuma + 16; }
    static __device__ __forceinline__ unsigned cb(int stage, int item) {
        return stage * kStage + kRows * kLuma + item * kChroma + 16;
    }
    static __device__ __forceinline__ unsigned cr(int stage, int item) { return cb(stage, item) + kPairs * kChroma; }
    static __device__ __forceinline__ unsigned out(int row) { return 2 * kStage + row * kOut + 64; }
};

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Byte k of `word` as a float, less `bias`: 2^23 + byte is a float's exact
// bit pattern, and subtracting 2^23 + bias from it is exact.
template <int K>
__device__ __forceinline__ float byte_f(unsigned word, float bias) {
    return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 | K)) - (8388608.0f + bias);
}

__device__ __forceinline__ float clip255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

// The three channels of one pixel from its luma and its block's chroma, not
// yet clipped.
__device__ __forceinline__ void to_rgb(float y, float cb, float cr, float* rgb) {
    rgb[0] = __fmaf_rn(1.403f, cr, y);
    rgb[1] = __fmaf_rn(-0.344f, cb, __fmaf_rn(-0.714f, cr, y));
    rgb[2] = __fmaf_rn(1.773f, cb, y);
}

// rintf(v) for v in (-2^22, 2^22), as the low 16 bits of the result (two's
// complement): adding 1.5 x 2^23 leaves a float whose unit is 1, rounded half
// to even, with the integer in its low bits.
__device__ __forceinline__ unsigned round_bits(float v) { return __float_as_uint(v + 12582912.0f); }

// Each signed 16-bit half of v clamped to [0, 255].
__device__ __forceinline__ unsigned clamp_u8x2(unsigned v) {
    unsigned r;
    asm("min.relu.s16x2 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(0x00FF00FFu));
    return r;
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// One output value of an unclipped channel v: clip255(v) x scale in float32
// or bfloat16, or rintf(clip255(v)) for the band. Where 255 x scale rounds to
// exactly 1 (kUnit), clip255(v) x scale is v x scale saturated to [0, 1]:
// rounding is monotone, so v <= 0 gives a product <= 0 and v >= 255 one >= 1.
template <int M, bool kUnit>
__device__ __forceinline__ float scaled(float v, float scale) {
    return kUnit ? __saturatef(v * scale) : clip255(v) * scale;
}

// Four pixels' twelve unclipped values into staging at `at` (16-, 8- or
// 4-byte aligned). The band rounds first and clamps the integers, two in
// one instruction: rintf is monotone and keeps 0 and 255, so that is
// rintf(clip255(v)).
template <int M, bool kUnit>
__device__ __forceinline__ void store_cell(uint8_t* smem, unsigned at, const float* v, float scale) {
    if (M == kFloat32) {
        float4* o = reinterpret_cast<float4*>(smem + at);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            o[k] = make_float4(scaled<M, kUnit>(v[4 * k], scale), scaled<M, kUnit>(v[4 * k + 1], scale),
                               scaled<M, kUnit>(v[4 * k + 2], scale), scaled<M, kUnit>(v[4 * k + 3], scale));
        }
    } else if (M == kBFloat16) {
        uint2* o = reinterpret_cast<uint2*>(smem + at);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            o[k] = make_uint2(bf16x2(scaled<M, kUnit>(v[4 * k], scale), scaled<M, kUnit>(v[4 * k + 1], scale)),
                              bf16x2(scaled<M, kUnit>(v[4 * k + 2], scale), scaled<M, kUnit>(v[4 * k + 3], scale)));
        }
    } else {
        unsigned q[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
            q[k] = clamp_u8x2(__byte_perm(round_bits(v[2 * k]), round_bits(v[2 * k + 1]), 0x5410));
        }
        unsigned* o = reinterpret_cast<unsigned*>(smem + at);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            o[k] = __byte_perm(q[2 * k], q[2 * k + 1], 0x6420);
        }
    }
}

__device__ __forceinline__ Item decode(const Args& a, unsigned item, unsigned end) {
    Item it{};
    if (item >= end) {
        return it;
    }
    const unsigned p = item / a.tiles;
    const unsigned t = item - p * a.tiles;
    const unsigned b = p / a.pairs;
    const int i = static_cast<int>(p - b * a.pairs);
    const int c0 = static_cast<int>(t) * a.tile_w;
    it.cols = min(a.tile_w, a.out_w - c0);
    it.rows = min(2, a.out_h - 2 * i);
    it.y = b * a.plane_bytes + static_cast<int64_t>(2 * i) * a.w + c0;
    it.c = b * a.plane_bytes + a.luma_bytes + static_cast<int64_t>(i) * (a.w / 2) + c0 / 2;
    it.o = (static_cast<int64_t>(b) * a.out_h + 2 * i) * a.out_w + c0;
    return it;
}

// Start the copies of a strip's rows into input stage `stage`: a warp a row,
// a lane a 16-byte chunk of the row's aligned cover.
template <int M, int TW>
__device__ __forceinline__ void load_strip(const Args& a, const Item* items, int stage, uint8_t* smem) {
    using L = Layout<M, TW>;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int q = warp; q < kRows + 2 * kPairs; q += kWarps) {
        const bool luma = q < kRows;
        const int j = luma ? q >> 1 : (q - kRows) % kPairs;
        const Item& it = items[j];
        if (it.rows == 0) {
            continue;
        }
        int64_t off;
        int n;
        unsigned dst;
        if (luma) {
            off = it.y + (q & 1) * a.w;
            n = it.cols;
            dst = L::luma(stage, q);
        } else {
            const bool cr = q >= kRows + kPairs;
            off = it.c + (cr ? a.chroma_bytes : 0);
            n = (it.cols + 1) >> 1;
            dst = cr ? L::cr(stage, j) : L::cb(stage, j);
        }
        const uint8_t* src = a.planes + off;
        const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
        const uint8_t* cover = src - skew;
        const int chunks = (skew + n + 15) >> 4;
        for (int k = lane; k < chunks; k += 32) {
            cp_async16(smem + dst + 16 * k, cover + 16 * k);
        }
    }
}

// Unpack a strip from input stage `stage` into the staging rows: warp w
// takes row w & 1 of item w / 2, a lane every 32nd cell of it, so the byte
// offsets of a lane's luma and chroma within their words stay the same from
// one of its cells to the next.
template <int M, int TW, bool kUnit>
__device__ __forceinline__ void unpack_strip(const Args& a, const Item* items, int stage, uint8_t* smem) {
    using L = Layout<M, TW>;
    constexpr int kValue = L::kValue;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int j = warp >> 1;
    const int d = warp & 1;
    const Item it = items[j];
    if (d >= it.rows) {
        return;
    }
    const uintptr_t planes = reinterpret_cast<uintptr_t>(a.planes);
    const int ly = L::luma(stage, warp) + static_cast<int>((planes + it.y + d * a.w) & 15);
    const int lb = L::cb(stage, j) + static_cast<int>((planes + it.c) & 15);
    const int lr = L::cr(stage, j) + static_cast<int>((planes + it.c + a.chroma_bytes) & 15);
    const int64_t o = it.o + d * a.out_w;
    const int lo = L::out(warp) + static_cast<int>((reinterpret_cast<uintptr_t>(a.out) + o * 3 * kValue) & 15);
    const int head = static_cast<int>(o & 3);
    const int cells = (head + it.cols + 3) >> 2;
    const bool odd = head & 1;
    const unsigned* words = reinterpret_cast<const unsigned*>(smem);
    const int x = 4 * lane - head;
    const unsigned ay = ly + x, ab = lb + (x >> 1), ar = lr + (x >> 1);
    const unsigned sy = 8 * (ay & 3), sb = 8 * (ab & 3), sr = 8 * (ar & 3);
    unsigned wy = ay >> 2, wb = ab >> 2, wr = ar >> 2;
    unsigned at = lo + 3 * kValue * x;
    for (int k = lane; k < cells; k += 32, wy += 32, wb += 16, wr += 16, at += 3 * kValue * 128) {
        const unsigned yw = __funnelshift_r(words[wy], words[wy + 1], sy);
        const unsigned bw = __funnelshift_r(words[wb], words[wb + 1], sb);
        const unsigned rw = __funnelshift_r(words[wr], words[wr + 1], sr);
        const float b0 = byte_f<0>(bw, 128.0f), b1 = byte_f<1>(bw, 128.0f), b2 = byte_f<2>(bw, 128.0f);
        const float r0 = byte_f<0>(rw, 128.0f), r1 = byte_f<1>(rw, 128.0f), r2 = byte_f<2>(rw, 128.0f);
        float v[12];
        to_rgb(byte_f<0>(yw, 0.0f), b0, r0, v);
        to_rgb(byte_f<1>(yw, 0.0f), odd ? b1 : b0, odd ? r1 : r0, v + 3);
        to_rgb(byte_f<2>(yw, 0.0f), b1, r1, v + 6);
        to_rgb(byte_f<3>(yw, 0.0f), odd ? b2 : b1, odd ? r2 : r1, v + 9);
        store_cell<M, kUnit>(smem, at, v, a.scale);
    }
}

// Write warp w's staging row out: a lane 16 bytes at a time, and a byte of
// the row's partial first and last 16-byte chunks.
template <int M, int TW>
__device__ __forceinline__ void store_strip(const Args& a, const Item* items, const uint8_t* smem) {
    using L = Layout<M, TW>;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const Item& it = items[warp >> 1];
    const int d = warp & 1;
    if (d >= it.rows) {
        return;
    }
    uint8_t* row = static_cast<uint8_t*>(a.out) + (it.o + d * a.out_w) * 3 * L::kValue;
    const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
    uint8_t* cover = row - skew;
    const int end = skew + it.cols * 3 * L::kValue;
    const int inside = skew ? 16 : 0;
    const int outside = end & ~15;
    const uint8_t* from = smem + L::out(warp);
    for (int k = inside + 16 * lane; k < outside; k += 16 * 32) {
        __stcs(reinterpret_cast<uint4*>(cover + k), *reinterpret_cast<const uint4*>(from + k));
    }
    const int head = skew + lane;
    if (head < min(inside, end)) {
        cover[head] = from[head];
    }
    const int tail = max(outside, inside) + lane;
    if (lane < 16 && tail < end) {
        cover[tail] = from[tail];
    }
}

template <int M, int TW, bool kUnit>
__global__ void __launch_bounds__(kThreads) yuv420_kernel(const Args a) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ Item table[3][kPairs];
    const unsigned begin = static_cast<unsigned>(static_cast<uint64_t>(a.items) * blockIdx.x / gridDim.x);
    const unsigned end = static_cast<unsigned>(static_cast<uint64_t>(a.items) * (blockIdx.x + 1) / gridDim.x);
    const unsigned strips = (end - begin + kPairs - 1) / kPairs;
    const int tid = threadIdx.x;
    if (strips == 0) {
        return;
    }
    if (tid < kPairs) {
        table[0][tid] = decode(a, begin + tid, end);
    }
    __syncthreads();
    load_strip<M, TW>(a, table[0], 0, smem);
    cp_async_commit();
    for (unsigned s = 0; s < strips; ++s) {
        const bool more = s + 1 < strips;
        // table (s + 1) % 3 was last read for strip s - 2, before the last barrier
        if (more && tid < kPairs) {
            table[(s + 1) % 3][tid] = decode(a, begin + (s + 1) * kPairs + tid, end);
        }
        cp_async_wait_all();
        // strip s is in its stage, strip s - 1's staging rows are written out,
        // and strip s + 1's items are in the table
        __syncthreads();
        if (more) {
            load_strip<M, TW>(a, table[(s + 1) % 3], (s + 1) & 1, smem);
            cp_async_commit();
        }
        unpack_strip<M, TW, kUnit>(a, table[s % 3], s & 1, smem);
        __syncwarp();  // a warp writes out only the staging row it wrote
        store_strip<M, TW>(a, table[s % 3], smem);
    }
}

template <int M, int TW, bool kUnit>
cudaError_t launch(const Args& a, cudaStream_t s) {
    constexpr int kBytes = Layout<M, TW>::kBytes;
    static std::atomic<int> cache[occupancy::kMaxDevices];
    int cap = 0;
    const cudaError_t err = occupancy::resident_blocks(yuv420_kernel<M, TW, kUnit>, kThreads, kBytes, cache, &cap);
    if (err != cudaSuccess) {
        return err;
    }
    const int64_t wanted = (static_cast<int64_t>(a.items) + kPairs - 1) / kPairs;
    yuv420_kernel<M, TW, kUnit><<<static_cast<int>(wanted < cap ? wanted : cap), kThreads, kBytes, s>>>(a);
    return cudaGetLastError();
}

template <int M, int TW>
cudaError_t launch_unit(const Args& a, cudaStream_t s) {
    if constexpr (M != kBandU8) {
        if (255.0f * a.scale == 1.0f) {
            return launch<M, TW, true>(a, s);
        }
    }
    return launch<M, TW, false>(a, s);
}

// Cut the rows into tiles no wider than the instance's widest, as even as
// a multiple of four columns allows, and launch.
template <int M>
cudaError_t launch_mode(Args a, int n, cudaStream_t s) {
    const bool narrow = a.out_w <= kNarrow;
    const int widest = narrow ? kNarrow : kWide;
    const int tiles = (a.out_w + widest - 1) / widest;
    a.tiles = static_cast<unsigned>(tiles);
    a.tile_w = ((a.out_w + tiles - 1) / tiles + 3) / 4 * 4;
    a.items = static_cast<unsigned>(n) * a.pairs * a.tiles;  // at most n (h / 2) (w / 2), below 2^31
    return narrow ? launch_unit<M, kNarrow>(a, s) : launch_unit<M, kWide>(a, s);
}

}  // namespace

// planes: [n, 1.5 h, w] uint8, contiguous and 2-byte aligned; h % 4 == 0,
// w % 2 == 0. out: 16-byte aligned (a fresh allocation is). mode 0: out
// float32 [n, h, w, 3]; mode 1: out bfloat16 [n, h, w, 3], each value times
// `scale`; mode 2: n == 1, out uint8 [out_h, out_w, 3] with out_h <= h,
// out_w <= w.
extern "C" int colorconv_yuv420_to_rgb(const uint8_t* planes, int n, int h, int w, void* out, int mode,
                                       int out_h, int out_w, float scale, cudaStream_t s) {
    if (n <= 0 || h <= 0 || w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int64_t blocks = static_cast<int64_t>(n) * (h / 2) * (w / 2);
    if (h % 4 != 0 || w % 2 != 0 || blocks > INT32_MAX || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
        (mode == kBandU8 && (n != 1 || out_h > h || out_w > w))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (mode != kBandU8) {
        out_h = h;
        out_w = w;
    }
    if (out_h <= 0 || out_w <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    Args a{};
    a.planes = planes;
    a.out = out;
    a.luma_bytes = static_cast<int64_t>(h) * w;
    a.chroma_bytes = a.luma_bytes / 4;
    a.plane_bytes = a.luma_bytes + 2 * a.chroma_bytes;
    a.pairs = static_cast<unsigned>((out_h + 1) / 2);
    a.w = w;
    a.out_h = out_h;
    a.out_w = out_w;
    a.scale = scale;
    switch (mode) {
        case kFloat32:
            return static_cast<int>(launch_mode<kFloat32>(a, n, s));
        case kBFloat16:
            return static_cast<int>(launch_mode<kBFloat16>(a, n, s));
        case kBandU8:
            return static_cast<int>(launch_mode<kBandU8>(a, n, s));
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* colorconv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

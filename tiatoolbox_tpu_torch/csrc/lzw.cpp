// TIFF LZW and PackBits decoders of the port's TIFF reader: a port of
// tiatoolbox_tpu/native/lzw.cpp (LZW :14-110, PackBits :115-139), the codecs
// libtiff implements in tif_lzw.c and tif_packbits.c. Built with g++ into a
// shared library with a plain C interface and loaded with ctypes
// (tiatoolbox_tpu_torch/native). Both return the bytes written, or -1 on a
// malformed stream or an output overflow; the caller then decodes the
// block with the pure-Python decoders of wsicore/tiffio.py, as JAX's
// reader does (tiffio.py:428-437 there).

#include <cstdint>
#include <cstring>

extern "C" {

// Decodes `src_len` bytes of TIFF LZW into `dst` (capacity `dst_cap`).
// Returns bytes written, or -1 on malformed input / overflow.
int64_t lzw_decode(const uint8_t* src, uint64_t src_len, uint8_t* dst,
                   uint64_t dst_cap) {
    constexpr int kClear = 256;
    constexpr int kEoi = 257;
    constexpr int kFirst = 258;
    constexpr int kMaxCode = 4096;

    // table entries as (prev_code, suffix_byte); strings materialize by
    // walking prev links backwards (bounded by kMaxCode)
    int16_t prev_code[kMaxCode];
    uint8_t suffix[kMaxCode];
    uint16_t length[kMaxCode];
    for (int i = 0; i < 256; ++i) {
        prev_code[i] = -1;
        suffix[i] = static_cast<uint8_t>(i);
        length[i] = 1;
    }

    uint64_t bitpos = 0;
    const uint64_t bit_len = src_len * 8;
    int bits = 9;
    int next_code = kFirst;
    int64_t out = 0;
    int prev = -1;
    uint8_t scratch[kMaxCode];

    auto read_code = [&]() -> int {
        if (bitpos + bits > bit_len) return kEoi;
        uint64_t byte = bitpos >> 3;
        int shift = static_cast<int>(bitpos & 7);
        uint32_t window = 0;
        for (int i = 0; i < 4 && byte + i < src_len; ++i)
            window |= static_cast<uint32_t>(src[byte + i]) << (24 - 8 * i);
        bitpos += bits;
        return static_cast<int>((window << shift) >> (32 - bits));
    };

    auto emit = [&](int code) -> int {
        // materialize string for `code` back-to-front into scratch
        int n = length[code];
        if (out + n > static_cast<int64_t>(dst_cap)) return -1;
        int c = code;
        for (int i = n - 1; i >= 0; --i) {
            scratch[i] = suffix[c];
            c = prev_code[c];
        }
        std::memcpy(dst + out, scratch, n);
        out += n;
        return 0;
    };

    while (true) {
        int code = read_code();
        if (code == kEoi) break;
        if (code == kClear) {
            next_code = kFirst;
            bits = 9;
            prev = -1;
            continue;
        }
        if (prev < 0) {
            if (code >= 256) return -1;  // first code must be literal
            if (emit(code)) return -1;
            prev = code;
            continue;
        }
        if (code < next_code) {
            // known code: add prev + first_byte(code)
            if (next_code < kMaxCode) {
                int c = code;
                while (prev_code[c] >= 0) c = prev_code[c];
                prev_code[next_code] = static_cast<int16_t>(prev);
                suffix[next_code] = suffix[c];
                length[next_code] = static_cast<uint16_t>(length[prev] + 1);
                ++next_code;
            }
            if (emit(code)) return -1;
        } else if (code == next_code && next_code < kMaxCode) {
            // KwKwK case: new entry is prev + first_byte(prev)
            int c = prev;
            while (prev_code[c] >= 0) c = prev_code[c];
            prev_code[next_code] = static_cast<int16_t>(prev);
            suffix[next_code] = suffix[c];
            length[next_code] = static_cast<uint16_t>(length[prev] + 1);
            ++next_code;
            if (emit(code)) return -1;
        } else {
            return -1;  // code beyond table: corrupt stream
        }
        prev = code;
        // TIFF early change: widen one code EARLIER than generic LZW
        if (next_code == (1 << bits) - 1 && bits < 12) ++bits;
    }
    return out;
}

}  // extern "C"

extern "C" {

// PackBits (TIFF §9) decode. Returns bytes written, or -1 on overflow.
int64_t packbits_decode(const uint8_t* src, uint64_t src_len, uint8_t* dst,
                        uint64_t dst_cap) {
    uint64_t i = 0;
    int64_t out = 0;
    while (i < src_len) {
        uint8_t header = src[i++];
        if (header > 128) {  // repeat next byte 257-header times
            if (i >= src_len) break;
            int n = 257 - header;
            if (out + n > static_cast<int64_t>(dst_cap)) return -1;
            std::memset(dst + out, src[i++], n);
            out += n;
        } else if (header < 128) {  // literal run of header+1 bytes
            int n = header + 1;
            if (i + n > src_len) n = static_cast<int>(src_len - i);
            if (out + n > static_cast<int64_t>(dst_cap)) return -1;
            std::memcpy(dst + out, src + i, n);
            i += n;
            out += n;
        }  // 128 = no-op
    }
    return out;
}

}  // extern "C"

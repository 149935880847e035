// Baseline JPEG decoder of the port's slide reader: the counterpart of
// tiatoolbox_tpu/native/jpegdec.cpp (libjpeg on threads) and of the
// cv2.imdecode call of tiatoolbox_tpu/wsicore/tiffio.py:406-415. Built with
// g++ into a shared library with a plain C interface and loaded with ctypes
// (tiatoolbox_tpu_torch/native). It uses no third-party header.
//
// It reproduces libjpeg-turbo's default decompression (islow IDCT, fancy
// upsampling, the jdcolor.c tables) bit for bit:
//
// - frames: SOF0 and SOF1, 8-bit, 1 or 3 components, one interleaved scan,
//   any integral sampling ratio (h2v1, h1v2 and h2v2 fancy as jdsample.c
//   does, box replication for every other ratio and for a component at
//   most 2 samples wide); DQT with 8- or 16-bit entries, DHT (the standard
//   tables stand in for a missing one, as jdhuff.c jinit_huff_decoder
//   does), DRI and RST0-7, byte stuffing and fill bytes, and tables
//   redefined anywhere before the scan;
// - colour space as jdapimin.c default_decompress_parms picks it: a JFIF
//   APP0 means YCbCr, else an Adobe APP14 (transform 0 RGB, 1 YCbCr), else
//   component ids 'R','G','B' mean RGB, any other ids YCbCr;
// - the bit reader of jdhuff.c, with both of libjpeg-turbo's paths (the
//   fast one while 512 bytes a block remain and no restart interval is
//   set), so that a stream also fails where cv2's does: cv2's memory
//   source cannot be refilled, so a fill that reaches the end of the data
//   before a marker suspends the decode and cv2 returns no image. Where a
//   marker ends the data early, zero bits are fed and later MCUs of the
//   segment stay zero (uniform grey), as jpeg_fill_bit_buffer does;
// - jidctint.c jpeg_idct_islow, its outputs through the 1024-entry
//   post-IDCT range table (so out-of-range values wrap, as in C).
//
// Progressive (SOF2), arithmetic, lossless, hierarchical and 12-bit frames,
// and a baseline image split over several scans, are refused with their own
// status codes.
//
// jpeg_decode_batch decodes n streams held in one blob on std::thread
// workers into [n, tile_h, tile_w, out_ch] uint8, copying min(h, tile_h)
// rows and min(w, tile_w) columns into the zeroed output, as
// tiatpu_decode_jpeg_batch does (jpegdec.cpp:57-63 there). Each worker
// writes only its own tiles and status entries.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "jpeg_common.h"

namespace {

using namespace jpeg_common;

enum Status : int32_t {
    kOk = 0,
    kNoSoi = 1,
    kProgressive = 2,
    kArithmetic = 3,
    kPrecision = 4,
    kLossless = 5,
    kMultiScan = 6,
    kBadSegment = 7,
    kShortData = 8,
    kBadHuffTable = 9,
    kNoQuantTable = 10,
    kSampling = 11,
    kComponents = 12,
    kNoImage = 13,
    kUnknownMarker = 14,
    kHeaderShort = 15,
};

const char* status_message(int32_t code) {
    switch (code) {
        case kOk: return "ok";
        case kNoSoi: return "not a JPEG stream (no SOI marker)";
        case kProgressive: return "progressive JPEG (SOF2) is not supported";
        case kArithmetic: return "arithmetic-coded JPEG is not supported";
        case kPrecision: return "only 8-bit JPEG samples are supported";
        case kLossless: return "lossless or hierarchical JPEG is not supported";
        case kMultiScan: return "a baseline image split over several scans is not supported";
        case kBadSegment: return "corrupt JPEG marker segment";
        case kShortData: return "JPEG entropy data ends before a marker (truncated stream)";
        case kBadHuffTable: return "corrupt JPEG Huffman table";
        case kNoQuantTable: return "a component's quantisation table is not defined";
        case kSampling: return "unsupported JPEG sampling factors";
        case kComponents: return "only 1- and 3-component JPEG frames are supported";
        case kNoImage: return "JPEG stream has no image (EOI before SOS)";
        case kUnknownMarker: return "unknown JPEG marker";
        case kHeaderShort: return "JPEG header ends early";
        default: return "unknown JPEG status";
    }
}

// -- tables ------------------------------------------------------------------

struct HuffSpec {
    bool defined = false;
    uint8_t bits[17] = {0};
    uint8_t vals[256] = {0};
};

struct Derived {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint16_t lookup[256];  // (code length << 8) | symbol; 9 << 8: longer than 8
    uint8_t vals[256];
};

// jdhuff.c jpeg_make_d_derived_tbl.
int32_t derive(const HuffSpec& spec, bool dc, Derived* d) {
    char huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        int i = spec.bits[l];
        if (p + i > 256) return kBadHuffTable;
        while (i--) huffsize[p++] = static_cast<char>(l);
    }
    huffsize[p] = 0;
    const int numsymbols = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) {
            huffcode[p++] = code;
            code++;
        }
        if (static_cast<int64_t>(code) >= (int64_t{1} << si)) return kBadHuffTable;
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (spec.bits[l]) {
            d->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
            p += spec.bits[l];
            d->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
        } else {
            d->maxcode[l] = -1;
        }
    }
    d->valoffset[17] = 0;
    d->maxcode[17] = 0xFFFFF;
    for (int i = 0; i < 256; ++i) d->lookup[i] = 9 << 8;
    p = 0;
    for (int l = 1; l <= 8; ++l) {
        for (int i = 1; i <= spec.bits[l]; ++i, ++p) {
            int lookbits = static_cast<int>(huffcode[p]) << (8 - l);
            for (int ctr = 1 << (8 - l); ctr > 0; --ctr) {
                d->lookup[lookbits++] = static_cast<uint16_t>((l << 8) | spec.vals[p]);
            }
        }
    }
    if (dc) {
        for (int i = 0; i < numsymbols; ++i) {
            if (spec.vals[i] > 15) return kBadHuffTable;
        }
    }
    std::memcpy(d->vals, spec.vals, 256);
    return kOk;
}

void standard_table(HuffSpec* spec, const uint8_t* bits, const uint8_t* vals, int n) {
    spec->defined = true;
    std::memcpy(spec->bits, bits, 17);
    std::memset(spec->vals, 0, 256);
    std::memcpy(spec->vals, vals, n);
}

// jdmaster.c prepare_range_limit_table, the post-IDCT part: index
// (value & 1023) of a value centred on 0.
struct Tables {
    uint8_t idct_limit[1024];
    int32_t cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    int32_t rgb_y[3][256];
    Tables() {
        for (int i = 0; i < 1024; ++i) {
            const int s = ((i + 512) & 1023) - 512;
            idct_limit[i] = static_cast<uint8_t>(std::clamp(s + 128, 0, 255));
        }
        // jdcolor.c build_ycc_rgb_table
        for (int i = 0; i < 256; ++i) {
            const int64_t x = i - 128;
            cr_r[i] = static_cast<int32_t>((fix(1.40200) * x + kOneHalf) >> kScaleBits);
            cb_b[i] = static_cast<int32_t>((fix(1.77200) * x + kOneHalf) >> kScaleBits);
            cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
            cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + kOneHalf);
            // jdcolor.c rgb_gray_convert (the jccolor.c Y weights)
            rgb_y[0][i] = static_cast<int32_t>(fix(0.29900) * i);
            rgb_y[1][i] = static_cast<int32_t>(fix(0.58700) * i);
            rgb_y[2][i] = static_cast<int32_t>(fix(0.11400) * i + kOneHalf);
        }
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// -- the bit reader (jdhuff.c / jdhuff.h) -------------------------------------

constexpr int kMinGetBits = 57;  // BIT_BUF_SIZE 64 - 7
constexpr size_t kFastBytesPerBlock = 512;

struct Source {
    const uint8_t* data;
    size_t size;
    int unread_marker = 0;
    bool insufficient = false;
};

struct Bits {
    uint64_t buf = 0;
    int bits = 0;
    size_t pos = 0;
};

inline int get_bits(Bits& b, int n) {
    b.bits -= n;
    return static_cast<int>(b.buf >> b.bits) & ((1 << n) - 1);
}

inline int extend(int x, int s) {
    return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

// jpeg_fill_bit_buffer. false: the data ended before a marker (suspension).
bool fill_slow(Source& src, Bits& b, int nbits) {
    if (src.unread_marker == 0) {
        while (b.bits < kMinGetBits) {
            if (b.pos >= src.size) return false;
            int c = src.data[b.pos++];
            if (c == 0xFF) {
                do {
                    if (b.pos >= src.size) return false;
                    c = src.data[b.pos++];
                } while (c == 0xFF);
                if (c == 0) {
                    c = 0xFF;
                } else {
                    src.unread_marker = c;
                    break;
                }
            }
            b.buf = (b.buf << 8) | static_cast<uint64_t>(c);
            b.bits += 8;
        }
        if (src.unread_marker == 0) return true;
    }
    if (nbits > b.bits) {
        src.insufficient = true;
        b.buf <<= kMinGetBits - b.bits;
        b.bits = kMinGetBits;
    }
    return true;
}

// HUFF_DECODE with jpeg_huff_decode.
bool huff_slow(Source& src, Bits& b, const Derived& t, int* out) {
    int nb;
    if (b.bits < 8) {
        if (!fill_slow(src, b, 0)) return false;
        if (b.bits < 8) {
            nb = 1;
            goto slow;
        }
    }
    {
        const int look = static_cast<int>(b.buf >> (b.bits - 8)) & 0xFF;
        nb = t.lookup[look] >> 8;
        if (nb <= 8) {
            b.bits -= nb;
            *out = t.lookup[look] & 0xFF;
            return true;
        }
    }
slow:
    {
        int l = nb;
        if (b.bits < l && !fill_slow(src, b, l)) return false;
        int32_t code = get_bits(b, l);
        while (code > t.maxcode[l]) {
            code <<= 1;
            if (b.bits < 1 && !fill_slow(src, b, 1)) return false;
            code |= get_bits(b, 1);
            l++;
        }
        *out = l > 16 ? 0 : t.vals[(code + t.valoffset[l]) & 0xFF];
    }
    return true;
}

inline bool bits_slow(Source& src, Bits& b, int s, int* out) {
    if (b.bits < s && !fill_slow(src, b, s)) return false;
    *out = get_bits(b, s);
    return true;
}

// FILL_BIT_BUFFER_FAST / GET_BYTE: six bytes whenever 16 bits or fewer are
// left; a marker is backed out and zero bits loaded in its place.
struct Fast {
    const uint8_t* data;
    size_t size;
    bool marker = false;
    int at(size_t i) const { return i < size ? data[i] : 0; }
    void get_byte(Bits& b) {
        const int c0 = at(b.pos++);
        const int c1 = at(b.pos);
        b.buf = (b.buf << 8) | static_cast<uint64_t>(c0);
        b.bits += 8;
        if (c0 == 0xFF) {
            b.pos++;
            if (c1 != 0) {
                marker = true;
                b.pos -= 2;
                b.buf &= ~uint64_t{0xFF};
            }
        }
    }
    void fill(Bits& b) {
        if (b.bits <= 16) {
            for (int i = 0; i < 6; ++i) get_byte(b);
        }
    }
    int huff(Bits& b, const Derived& t) {
        fill(b);
        int s = t.lookup[static_cast<int>(b.buf >> (b.bits - 8)) & 0xFF];
        int nb = s >> 8;
        b.bits -= nb;
        s &= 0xFF;
        if (nb > 8) {
            s = static_cast<int>(b.buf >> b.bits) & ((1 << nb) - 1);
            while (s > t.maxcode[nb]) {
                s <<= 1;
                s |= get_bits(b, 1);
                nb++;
            }
            s = nb > 16 ? 0 : t.vals[(s + t.valoffset[nb]) & 0xFF];
        }
        return s;
    }
};

// -- the decoder ---------------------------------------------------------------

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;
    int dw = 0, dh = 0;        // downsampled size (jdinput.c)
    int bw = 0, bh = 0;        // blocks held in the plane
    int stride = 0;
    std::vector<uint8_t> plane;
    int16_t qt[64];            // ISLOW_MULT_TYPE: short
    bool needed = true;
};

class Decoder {
   public:
    Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

    int32_t read_header();
    int32_t decode_scan();
    void output(uint8_t* dst, int tile_h, int tile_w, int out_ch);
    void set_output_channels(int out_ch);

    int width = 0, height = 0, ncomp = 0;

   private:
    bool byte(int* c) {
        if (pos_ >= size_) return false;
        *c = data_[pos_++];
        return true;
    }
    bool word(int* c) {
        int a, b;
        if (!byte(&a) || !byte(&b)) return false;
        *c = (a << 8) | b;
        return true;
    }
    int32_t next_marker(int* marker);
    int32_t segment_sof(int marker);
    int32_t segment_dqt();
    int32_t segment_dht();
    int32_t segment_dri();
    int32_t segment_sos();
    int32_t segment_app(int marker);
    int32_t skip_segment();
    bool process_restart(Source& src, Bits& b);
    bool decode_mcu_slow(Source& src, Bits& b, int32_t* dc, int16_t (*blocks)[64]);
    bool decode_mcu_fast(Bits& b, int32_t* dc, int16_t (*blocks)[64]);
    void idct_block(const int16_t* coef, Component& c, int bx, int by);
    void upsample_row(const Component& c, int y, uint8_t* out, int32_t* colsum, uint8_t* wide);

    const uint8_t* data_;
    size_t size_;
    size_t pos_ = 0;

    uint16_t qt_[4][64];
    bool qt_defined_[4] = {false, false, false, false};
    HuffSpec dc_spec_[4], ac_spec_[4];
    int restart_interval_ = 0;
    bool saw_sof_ = false;
    bool saw_jfif_ = false, saw_adobe_ = false;
    int adobe_transform_ = 0;
    bool rgb_ = false;  // colour space RGB (else YCbCr) for 3 components

    Component comp_[3];
    int max_h_ = 1, max_v_ = 1;
    int mcus_x_ = 0, mcus_y_ = 0;
    int blocks_in_mcu_ = 0;
    int scan_order_[3] = {0, 1, 2};
    int mcu_comp_[10];       // component of each block of an MCU
    int mcu_bx_[10], mcu_by_[10];
    Derived dc_tbl_[3], ac_tbl_[3];
    int next_restart_num_ = 0;
    int out_ch_ = 3;
};

// jdmarker.c next_marker: skip to the next FF, swallow fill FFs and FF 00.
int32_t Decoder::next_marker(int* marker) {
    int c;
    for (;;) {
        if (!byte(&c)) return kHeaderShort;
        while (c != 0xFF) {
            if (!byte(&c)) return kHeaderShort;
        }
        do {
            if (!byte(&c)) return kHeaderShort;
        } while (c == 0xFF);
        if (c != 0) break;
    }
    *marker = c;
    return kOk;
}

int32_t Decoder::skip_segment() {
    int length;
    if (!word(&length)) return kHeaderShort;
    if (length < 2) return kBadSegment;
    if (size_ - pos_ < static_cast<size_t>(length - 2)) return kHeaderShort;
    pos_ += length - 2;
    return kOk;
}

int32_t Decoder::segment_app(int marker) {
    int length;
    if (!word(&length)) return kHeaderShort;
    if (length < 2) return kBadSegment;
    const size_t datalen = static_cast<size_t>(length - 2);
    if (size_ - pos_ < datalen) return kHeaderShort;
    const uint8_t* d = data_ + pos_;
    if (marker == 0xE0 && datalen >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) {
        saw_jfif_ = true;
    } else if (marker == 0xEE && datalen >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
        saw_adobe_ = true;
        adobe_transform_ = d[11];
    }
    pos_ += datalen;
    return kOk;
}

int32_t Decoder::segment_sof(int marker) {
    (void)marker;
    if (saw_sof_) return kBadSegment;
    int length, precision, n;
    if (!word(&length) || !byte(&precision) || !word(&height) || !word(&width) || !byte(&n)) {
        return kHeaderShort;
    }
    if (precision != 8) return kPrecision;
    if (height <= 0 || width <= 0 || n <= 0) return kBadSegment;
    if (length - 8 != n * 3) return kBadSegment;
    if (n != 1 && n != 3) return kComponents;
    ncomp = n;
    for (int i = 0; i < n; ++i) {
        int id, samp, tq;
        if (!byte(&id) || !byte(&samp) || !byte(&tq)) return kHeaderShort;
        Component& c = comp_[i];
        c.id = id;
        c.h = samp >> 4;
        c.v = samp & 15;
        c.tq = tq;
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || tq > 3) return kSampling;
    }
    saw_sof_ = true;
    return kOk;
}

int32_t Decoder::segment_dqt() {
    int length;
    if (!word(&length)) return kHeaderShort;
    length -= 2;
    while (length > 0) {
        int n;
        if (!byte(&n)) return kHeaderShort;
        const int prec = n >> 4;
        n &= 15;
        if (n > 3 || prec > 1) return kBadSegment;
        for (int i = 0; i < 64; ++i) {
            int q;
            if (prec ? !word(&q) : !byte(&q)) return kHeaderShort;
            qt_[n][kNaturalOrder[i]] = static_cast<uint16_t>(q);
        }
        qt_defined_[n] = true;
        length -= 65 + (prec ? 64 : 0);
    }
    return length == 0 ? kOk : kBadSegment;
}

int32_t Decoder::segment_dht() {
    int length;
    if (!word(&length)) return kHeaderShort;
    length -= 2;
    while (length > 16) {
        int index;
        if (!byte(&index)) return kHeaderShort;
        HuffSpec spec;
        int count = 0;
        for (int i = 1; i <= 16; ++i) {
            int c;
            if (!byte(&c)) return kHeaderShort;
            spec.bits[i] = static_cast<uint8_t>(c);
            count += c;
        }
        length -= 17;
        if (count > 256 || count > length) return kBadHuffTable;
        for (int i = 0; i < count; ++i) {
            int c;
            if (!byte(&c)) return kHeaderShort;
            spec.vals[i] = static_cast<uint8_t>(c);
        }
        length -= count;
        spec.defined = true;
        if (index & 0x10) {
            index -= 0x10;
            if (index < 0 || index > 3) return kBadHuffTable;
            ac_spec_[index] = spec;
        } else {
            if (index < 0 || index > 3) return kBadHuffTable;
            dc_spec_[index] = spec;
        }
    }
    return length == 0 ? kOk : kBadSegment;
}

int32_t Decoder::segment_dri() {
    int length, interval;
    if (!word(&length)) return kHeaderShort;
    if (length != 4) return kBadSegment;
    if (!word(&interval)) return kHeaderShort;
    restart_interval_ = interval;
    return kOk;
}

int32_t Decoder::segment_sos() {
    if (!saw_sof_) return kBadSegment;
    int length, n;
    if (!word(&length) || !byte(&n)) return kHeaderShort;
    if (length != n * 2 + 6 || n < 1 || n > 4) return kBadSegment;
    int order[4];
    for (int i = 0; i < n; ++i) {
        int id, tables;
        if (!byte(&id) || !byte(&tables)) return kHeaderShort;
        int ci = -1;
        for (int k = 0; k < ncomp; ++k) {
            if (comp_[k].id == id) ci = k;
        }
        if (ci < 0) return kBadSegment;
        for (int k = 0; k < i; ++k) {
            if (order[k] == ci) return kBadSegment;
        }
        order[i] = ci;
        comp_[ci].td = tables >> 4;
        comp_[ci].ta = tables & 15;
    }
    int ss, se, ahal;
    if (!byte(&ss) || !byte(&se) || !byte(&ahal)) return kHeaderShort;
    if (n != ncomp) return kMultiScan;
    std::copy(order, order + n, scan_order_);
    next_restart_num_ = 0;
    return kOk;
}

int32_t Decoder::read_header() {
    int c0, c1;
    if (!byte(&c0) || !byte(&c1)) return kNoSoi;
    if (c0 != 0xFF || c1 != 0xD8) return kNoSoi;
    for (;;) {
        int marker;
        int32_t st = next_marker(&marker);
        if (st != kOk) return st;
        if (marker == 0xC0 || marker == 0xC1) {
            st = segment_sof(marker);
        } else if (marker == 0xC2 || marker == 0xC6) {
            return marker == 0xC2 ? kProgressive : kLossless;
        } else if (marker == 0xC3 || marker == 0xC5 || marker == 0xC7) {
            return kLossless;
        } else if (marker >= 0xC9 && marker <= 0xCF && marker != 0xCC) {
            return kArithmetic;
        } else if (marker == 0xC8) {
            return kUnknownMarker;
        } else if (marker == 0xC4) {
            st = segment_dht();
        } else if (marker == 0xCC) {
            return kArithmetic;  // DAC: arithmetic conditioning
        } else if (marker == 0xDB) {
            st = segment_dqt();
        } else if (marker == 0xDD) {
            st = segment_dri();
        } else if (marker == 0xDA) {
            st = segment_sos();
            if (st != kOk) return st;
            break;
        } else if (marker == 0xD9) {
            return kNoImage;
        } else if (marker == 0xD8) {
            return kBadSegment;  // a second SOI
        } else if (marker >= 0xE0 && marker <= 0xEF) {
            st = segment_app(marker);
        } else if (marker == 0xFE || marker == 0xDC) {
            st = skip_segment();  // COM, DNL
        } else if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) {
            st = kOk;  // RSTn and TEM carry no parameters
        } else {
            return kUnknownMarker;
        }
        if (st != kOk) return st;
    }

    // jdinput.c initial_setup / per_scan_setup, jdapimin.c colour space
    if (ncomp == 3) {
        if (saw_jfif_) {
            rgb_ = false;
        } else if (saw_adobe_) {
            rgb_ = adobe_transform_ == 0;
        } else {
            rgb_ = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
        }
    }
    max_h_ = max_v_ = 1;
    for (int i = 0; i < ncomp; ++i) {
        max_h_ = std::max(max_h_, comp_[i].h);
        max_v_ = std::max(max_v_, comp_[i].v);
    }
    for (int i = 0; i < ncomp; ++i) {
        Component& c = comp_[i];
        if (max_h_ % c.h || max_v_ % c.v) return kSampling;
        c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + max_h_ - 1) / max_h_);
        c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + max_v_ - 1) / max_v_);
        if (!qt_defined_[c.tq]) return kNoQuantTable;
        for (int k = 0; k < 64; ++k) c.qt[k] = static_cast<int16_t>(qt_[c.tq][k]);
        if (c.td > 3 || c.ta > 3) return kBadHuffTable;
    }
    if (ncomp == 1) {
        Component& c = comp_[0];
        mcus_x_ = (c.dw + 7) / 8;
        mcus_y_ = (c.dh + 7) / 8;
        c.bw = mcus_x_;
        c.bh = mcus_y_;
        blocks_in_mcu_ = 1;
        mcu_comp_[0] = 0;
        mcu_bx_[0] = mcu_by_[0] = 0;
    } else {
        mcus_x_ = (width + 8 * max_h_ - 1) / (8 * max_h_);
        mcus_y_ = (height + 8 * max_v_ - 1) / (8 * max_v_);
        blocks_in_mcu_ = 0;
        for (int si = 0; si < ncomp; ++si) {
            const int i = scan_order_[si];
            Component& c = comp_[i];
            c.bw = mcus_x_ * c.h;
            c.bh = mcus_y_ * c.v;
            if (blocks_in_mcu_ + c.h * c.v > 10) return kSampling;  // D_MAX_BLOCKS_IN_MCU
            for (int y = 0; y < c.v; ++y) {
                for (int x = 0; x < c.h; ++x) {
                    mcu_comp_[blocks_in_mcu_] = i;
                    mcu_bx_[blocks_in_mcu_] = x;
                    mcu_by_[blocks_in_mcu_] = y;
                    blocks_in_mcu_++;
                }
            }
        }
    }
    // jdhuff.c jinit_huff_decoder: the standard tables fill undefined slots 0, 1
    if (!dc_spec_[0].defined) standard_table(&dc_spec_[0], kDcLuminanceBits, kDcLuminanceVals, 12);
    if (!ac_spec_[0].defined) standard_table(&ac_spec_[0], kAcLuminanceBits, kAcLuminanceVals, 162);
    if (!dc_spec_[1].defined) standard_table(&dc_spec_[1], kDcChrominanceBits, kDcChrominanceVals, 12);
    if (!ac_spec_[1].defined) standard_table(&ac_spec_[1], kAcChrominanceBits, kAcChrominanceVals, 162);
    for (int i = 0; i < ncomp; ++i) {
        const Component& c = comp_[i];
        if (!dc_spec_[c.td].defined || !ac_spec_[c.ta].defined) return kBadHuffTable;
        int32_t st = derive(dc_spec_[c.td], true, &dc_tbl_[i]);
        if (st == kOk) st = derive(ac_spec_[c.ta], false, &ac_tbl_[i]);
        if (st != kOk) return st;
    }
    return kOk;
}

void Decoder::set_output_channels(int out_ch) {
    out_ch_ = out_ch;
    // jdmaster.c: a grey output of a YCbCr frame needs the luma alone
    if (ncomp == 3 && out_ch == 1 && !rgb_) comp_[1].needed = comp_[2].needed = false;
}

// jdhuff.c decode_mcu_slow.
bool Decoder::decode_mcu_slow(Source& src, Bits& b, int32_t* dc, int16_t (*blocks)[64]) {
    for (int blkn = 0; blkn < blocks_in_mcu_; ++blkn) {
        const int ci = mcu_comp_[blkn];
        int16_t* block = blocks[blkn];
        int s, r;
        if (!huff_slow(src, b, dc_tbl_[ci], &s)) return false;
        if (s) {
            if (!bits_slow(src, b, s, &r)) return false;
            s = extend(r, s);
        }
        s = static_cast<int>(static_cast<uint32_t>(s) + static_cast<uint32_t>(dc[ci]));
        dc[ci] = s;
        block[0] = static_cast<int16_t>(s);
        const Derived& ac = ac_tbl_[ci];
        for (int k = 1; k < 64; ++k) {
            if (!huff_slow(src, b, ac, &s)) return false;
            r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                int v;
                if (!bits_slow(src, b, s, &v)) return false;
                block[kNaturalOrder[k]] = static_cast<int16_t>(extend(v, s));
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }
    return true;
}

// jdhuff.c decode_mcu_fast; false where a marker was met (the MCU is then
// decoded again on the slow path from the state before it).
bool Decoder::decode_mcu_fast(Bits& b, int32_t* dc, int16_t (*blocks)[64]) {
    Fast f{data_, size_};
    for (int blkn = 0; blkn < blocks_in_mcu_; ++blkn) {
        const int ci = mcu_comp_[blkn];
        int16_t* block = blocks[blkn];
        int s = f.huff(b, dc_tbl_[ci]);
        if (s) {
            f.fill(b);
            const int r = get_bits(b, s);
            s = extend(r, s);
        }
        s = static_cast<int>(static_cast<uint32_t>(s) + static_cast<uint32_t>(dc[ci]));
        dc[ci] = s;
        block[0] = static_cast<int16_t>(s);
        const Derived& ac = ac_tbl_[ci];
        for (int k = 1; k < 64; ++k) {
            s = f.huff(b, ac);
            int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                f.fill(b);
                r = get_bits(b, s);
                block[kNaturalOrder[k]] = static_cast<int16_t>(extend(r, s));
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }
    return !f.marker;
}

// jdhuff.c process_restart with jdmarker.c read_restart_marker and
// jpeg_resync_to_restart. false: the data ended while looking for a marker.
bool Decoder::process_restart(Source& src, Bits& b) {
    b.bits = 0;
    auto next = [&]() -> bool {
        int c;
        for (;;) {
            if (b.pos >= src.size) return false;
            c = src.data[b.pos++];
            while (c != 0xFF) {
                if (b.pos >= src.size) return false;
                c = src.data[b.pos++];
            }
            do {
                if (b.pos >= src.size) return false;
                c = src.data[b.pos++];
            } while (c == 0xFF);
            if (c != 0) break;
        }
        src.unread_marker = c;
        return true;
    };
    if (src.unread_marker == 0 && !next()) return false;
    const int desired = next_restart_num_;
    if (src.unread_marker == 0xD0 + desired) {
        src.unread_marker = 0;
    } else {
        for (;;) {
            const int m = src.unread_marker;
            int action;
            if (m < 0xC0) {
                action = 2;
            } else if (m < 0xD0 || m > 0xD7) {
                action = 3;
            } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
                action = 3;
            } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
                action = 2;
            } else {
                action = 1;
            }
            if (action == 1) {
                src.unread_marker = 0;
                break;
            }
            if (action == 3) break;
            if (!next()) return false;
        }
    }
    next_restart_num_ = (next_restart_num_ + 1) & 7;
    if (src.unread_marker == 0) src.insufficient = false;
    return true;
}

// jidctint.c jpeg_idct_islow into the component's plane.
void Decoder::idct_block(const int16_t* coef, Component& c, int bx, int by) {
    const uint8_t* limit = tables().idct_limit;
    const int16_t* q = c.qt;
    int32_t ws[64];
    for (int col = 0; col < 8; ++col) {
        const int16_t* in = coef + col;
        const int16_t* qp = q + col;
        int32_t* w = ws + col;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
            in[48] == 0 && in[56] == 0) {
            const int32_t dcval = static_cast<int32_t>(
                static_cast<int64_t>(static_cast<int32_t>(in[0]) * qp[0]) * (1 << kPass1Bits));
            for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
            continue;
        }
        int64_t z2 = static_cast<int32_t>(in[16]) * qp[16];
        int64_t z3 = static_cast<int32_t>(in[48]) * qp[48];
        int64_t z1 = (z2 + z3) * kFix0_541196100;
        int64_t tmp2 = z1 + z3 * -kFix1_847759065;
        int64_t tmp3 = z1 + z2 * kFix0_765366865;
        z2 = static_cast<int32_t>(in[0]) * qp[0];
        z3 = static_cast<int32_t>(in[32]) * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
        int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = static_cast<int32_t>(in[56]) * qp[56];
        tmp1 = static_cast<int32_t>(in[40]) * qp[40];
        tmp2 = static_cast<int32_t>(in[24]) * qp[24];
        tmp3 = static_cast<int32_t>(in[8]) * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * kFix1_175875602;
        tmp0 *= kFix0_298631336;
        tmp1 *= kFix2_053119869;
        tmp2 *= kFix3_072711026;
        tmp3 *= kFix1_501321110;
        z1 *= -kFix0_899976223;
        z2 *= -kFix2_562915447;
        z3 *= -kFix1_961570560;
        z4 *= -kFix0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        constexpr int kShift = kConstBits - kPass1Bits;
        w[0] = static_cast<int32_t>(descale(tmp10 + tmp3, kShift));
        w[56] = static_cast<int32_t>(descale(tmp10 - tmp3, kShift));
        w[8] = static_cast<int32_t>(descale(tmp11 + tmp2, kShift));
        w[48] = static_cast<int32_t>(descale(tmp11 - tmp2, kShift));
        w[16] = static_cast<int32_t>(descale(tmp12 + tmp1, kShift));
        w[40] = static_cast<int32_t>(descale(tmp12 - tmp1, kShift));
        w[24] = static_cast<int32_t>(descale(tmp13 + tmp0, kShift));
        w[32] = static_cast<int32_t>(descale(tmp13 - tmp0, kShift));
    }
    for (int row = 0; row < 8; ++row) {
        const int32_t* w = ws + 8 * row;
        uint8_t* out = c.plane.data() + static_cast<size_t>(by * 8 + row) * c.stride + bx * 8;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
            w[7] == 0) {
            const uint8_t dcval = limit[descale(w[0], kPass1Bits + 3) & 1023];
            std::memset(out, dcval, 8);
            continue;
        }
        int64_t z2 = w[2];
        int64_t z3 = w[6];
        int64_t z1 = (z2 + z3) * kFix0_541196100;
        int64_t tmp2 = z1 + z3 * -kFix1_847759065;
        int64_t tmp3 = z1 + z2 * kFix0_765366865;
        int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
        int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * kFix1_175875602;
        tmp0 *= kFix0_298631336;
        tmp1 *= kFix2_053119869;
        tmp2 *= kFix3_072711026;
        tmp3 *= kFix1_501321110;
        z1 *= -kFix0_899976223;
        z2 *= -kFix2_562915447;
        z3 *= -kFix1_961570560;
        z4 *= -kFix0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        constexpr int kShift = kConstBits + kPass1Bits + 3;
        out[0] = limit[descale(tmp10 + tmp3, kShift) & 1023];
        out[7] = limit[descale(tmp10 - tmp3, kShift) & 1023];
        out[1] = limit[descale(tmp11 + tmp2, kShift) & 1023];
        out[6] = limit[descale(tmp11 - tmp2, kShift) & 1023];
        out[2] = limit[descale(tmp12 + tmp1, kShift) & 1023];
        out[5] = limit[descale(tmp12 - tmp1, kShift) & 1023];
        out[3] = limit[descale(tmp13 + tmp0, kShift) & 1023];
        out[4] = limit[descale(tmp13 - tmp0, kShift) & 1023];
    }
}

int32_t Decoder::decode_scan() {
    for (int i = 0; i < ncomp; ++i) {
        Component& c = comp_[i];
        c.stride = c.bw * 8;
        if (c.needed) c.plane.assign(static_cast<size_t>(c.stride) * c.bh * 8, 0);
    }
    Source src{data_, size_};
    Bits b;
    b.pos = pos_;
    int32_t dc[3] = {0, 0, 0};
    int16_t blocks[10][64];
    int restarts_to_go = restart_interval_;
    const size_t fast_bytes = kFastBytesPerBlock * blocks_in_mcu_;
    for (int my = 0; my < mcus_y_; ++my) {
        for (int mx = 0; mx < mcus_x_; ++mx) {
            bool usefast = true;
            if (restart_interval_) {
                if (restarts_to_go == 0) {
                    if (!process_restart(src, b)) return kShortData;
                    dc[0] = dc[1] = dc[2] = 0;
                    restarts_to_go = restart_interval_;
                }
                usefast = false;
            }
            if (src.size - std::min(src.size, b.pos) < fast_bytes || src.unread_marker != 0) {
                usefast = false;
            }
            std::memset(blocks, 0, sizeof(int16_t) * 64 * blocks_in_mcu_);
            if (!src.insufficient) {
                bool done = false;
                if (usefast) {
                    Bits fb = b;
                    int32_t fdc[3] = {dc[0], dc[1], dc[2]};
                    if (decode_mcu_fast(fb, fdc, blocks)) {
                        b = fb;
                        dc[0] = fdc[0];
                        dc[1] = fdc[1];
                        dc[2] = fdc[2];
                        done = true;
                    } else {
                        std::memset(blocks, 0, sizeof(int16_t) * 64 * blocks_in_mcu_);
                    }
                }
                if (!done && !decode_mcu_slow(src, b, dc, blocks)) return kShortData;
            }
            if (restart_interval_) restarts_to_go--;
            for (int k = 0; k < blocks_in_mcu_; ++k) {
                Component& c = comp_[mcu_comp_[k]];
                if (!c.needed) continue;
                idct_block(blocks[k], c, mx * c.h + mcu_bx_[k], my * c.v + mcu_by_[k]);
            }
        }
    }
    return kOk;
}

// jdsample.c: one output row of a component at full resolution.
void Decoder::upsample_row(const Component& c, int y, uint8_t* out, int32_t* colsum,
                           uint8_t* wide) {
    const int hr = max_h_ / c.h, vr = max_v_ / c.v;
    const int dw = c.dw;
    const uint8_t* plane = c.plane.data();
    const int stride = c.stride;
    if (hr == 1 && vr == 1) {
        std::memcpy(out, plane + static_cast<size_t>(y) * stride, width);
        return;
    }
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
        const uint8_t* in = plane + static_cast<size_t>(y) * stride;
        wide[0] = in[0];
        wide[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < dw - 1; ++i) {
            const int v3 = in[i] * 3;
            wide[2 * i] = static_cast<uint8_t>((v3 + in[i - 1] + 1) >> 2);
            wide[2 * i + 1] = static_cast<uint8_t>((v3 + in[i + 1] + 2) >> 2);
        }
        wide[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        wide[2 * dw - 1] = in[dw - 1];
        std::memcpy(out, wide, width);
        return;
    }
    if ((hr == 1 && vr == 2) || (hr == 2 && vr == 2 && dw > 2)) {
        // context rows: the row above for even output rows, below for odd,
        // replicated at the top and bottom (jdmainct.c)
        const int r0 = y >> 1;
        const bool below = y & 1;
        const int r1 = below ? std::min(r0 + 1, c.dh - 1) : std::max(r0 - 1, 0);
        const uint8_t* p0 = plane + static_cast<size_t>(r0) * stride;
        const uint8_t* p1 = plane + static_cast<size_t>(r1) * stride;
        if (hr == 1) {  // h1v2_fancy_upsample
            const int bias = below ? 2 : 1;
            for (int x = 0; x < width; ++x) {
                out[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
            }
            return;
        }
        for (int i = 0; i < dw; ++i) colsum[i] = p0[i] * 3 + p1[i];  // h2v2_fancy_upsample
        wide[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
        wide[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
        for (int i = 1; i < dw - 1; ++i) {
            wide[2 * i] = static_cast<uint8_t>((colsum[i] * 3 + colsum[i - 1] + 8) >> 4);
            wide[2 * i + 1] = static_cast<uint8_t>((colsum[i] * 3 + colsum[i + 1] + 7) >> 4);
        }
        wide[2 * dw - 2] = static_cast<uint8_t>((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
        wide[2 * dw - 1] = static_cast<uint8_t>((colsum[dw - 1] * 4 + 7) >> 4);
        std::memcpy(out, wide, width);
        return;
    }
    const uint8_t* in = plane + static_cast<size_t>(y / vr) * stride;  // box
    for (int x = 0; x < width; ++x) out[x] = in[x / hr];
}

void Decoder::output(uint8_t* dst, int tile_h, int tile_w, int out_ch) {
    const Tables& t = tables();
    const int rows = std::min(height, tile_h);
    const int cols = std::min(width, tile_w);
    std::vector<uint8_t> row(static_cast<size_t>(width) * 3);
    std::vector<uint8_t> wide(static_cast<size_t>(width) * 4 + 16);
    std::vector<int32_t> colsum(static_cast<size_t>(width) + 8);
    for (int y = 0; y < rows; ++y) {
        uint8_t* o = dst + static_cast<size_t>(y) * tile_w * out_ch;
        for (int i = 0; i < ncomp; ++i) {
            if (comp_[i].needed) {
                upsample_row(comp_[i], y, row.data() + static_cast<size_t>(i) * width,
                             colsum.data(), wide.data());
            }
        }
        const uint8_t* c0 = row.data();
        const uint8_t* c1 = c0 + width;
        const uint8_t* c2 = c1 + width;
        if (ncomp == 1) {
            for (int x = 0; x < cols; ++x) {
                for (int k = 0; k < out_ch; ++k) o[x * out_ch + k] = c0[x];
            }
        } else if (out_ch == 1) {
            if (rgb_) {
                for (int x = 0; x < cols; ++x) {
                    o[x] = static_cast<uint8_t>(
                        (t.rgb_y[0][c0[x]] + t.rgb_y[1][c1[x]] + t.rgb_y[2][c2[x]]) >> kScaleBits);
                }
            } else {
                std::memcpy(o, c0, cols);
            }
        } else if (rgb_) {
            for (int x = 0; x < cols; ++x) {
                o[3 * x] = c0[x];
                o[3 * x + 1] = c1[x];
                o[3 * x + 2] = c2[x];
            }
        } else {
            for (int x = 0; x < cols; ++x) {  // jdcolor.c ycc_rgb_convert
                const int yy = c0[x], cb = c1[x], cr = c2[x];
                o[3 * x] = static_cast<uint8_t>(std::clamp(yy + t.cr_r[cr], 0, 255));
                o[3 * x + 1] = static_cast<uint8_t>(
                    std::clamp(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits), 0, 255));
                o[3 * x + 2] = static_cast<uint8_t>(std::clamp(yy + t.cb_b[cb], 0, 255));
            }
        }
    }
}

int32_t decode_one(const uint8_t* data, size_t size, uint8_t* dst, int tile_h, int tile_w,
                   int out_ch) {
    Decoder d(data, size);
    int32_t st = d.read_header();
    if (st != kOk) return st;
    d.set_output_channels(out_ch);
    st = d.decode_scan();
    if (st != kOk) return st;
    d.output(dst, tile_h, tile_w, out_ch);
    return kOk;
}

}  // namespace

extern "C" {

// Frame size of one stream: hwc = {height, width, components}. Returns a
// status code (0 when the header through the first SOS is supported).
int32_t jpeg_header(const uint8_t* data, uint64_t size, int32_t* hwc) {
    Decoder d(data, size);
    const int32_t st = d.read_header();
    if (st == kOk) {
        hwc[0] = d.height;
        hwc[1] = d.width;
        hwc[2] = d.ncomp;
    }
    return st;
}

const char* jpeg_status_message(int32_t code) { return status_message(code); }

// 1 when a status refuses a feature this decoder lacks and libjpeg-turbo
// decodes (progressive or arithmetic coding, 12-bit or lossless frames, a
// baseline image over several scans, other sampling factors or component
// counts); 0 for success and for a stream libjpeg-turbo rejects as well
// (a corrupt or truncated stream, or an unknown marker: JERR_UNKNOWN_MARKER).
int32_t jpeg_status_unsupported(int32_t code) {
    switch (code) {
        case kProgressive:
        case kArithmetic:
        case kPrecision:
        case kLossless:
        case kMultiScan:
        case kSampling:
        case kComponents:
            return 1;
        default:
            return 0;
    }
}

// Decode n streams (stream i is data[offsets[i], offsets[i] + sizes[i]))
// into out, [n, tile_h, tile_w, out_ch] uint8 and zeroed by the caller,
// on min(n_threads, n) threads. status[i] gets stream i's code. Returns the
// index of the first stream that failed, or -1.
int32_t jpeg_decode_batch(const uint8_t* data, const uint64_t* offsets, const uint64_t* sizes,
                          int32_t n, uint8_t* out, int32_t tile_h, int32_t tile_w,
                          int32_t out_ch, int32_t n_threads, int32_t* status) {
    if (out_ch != 1 && out_ch != 3) {
        for (int i = 0; i < n; ++i) status[i] = kComponents;
        return n > 0 ? 0 : -1;
    }
    const size_t tile_bytes = static_cast<size_t>(tile_h) * tile_w * out_ch;
    std::atomic<int> next{0};
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) return;
            status[i] = decode_one(data + offsets[i], sizes[i], out + tile_bytes * i, tile_h,
                                   tile_w, out_ch);
        }
    };
    n_threads = std::max(1, std::min(n_threads, n));
    if (n_threads == 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        threads.reserve(n_threads);
        for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
        for (auto& th : threads) th.join();
    }
    for (int i = 0; i < n; ++i) {
        if (status[i] != kOk) return i;
    }
    return -1;
}

}  // extern "C"

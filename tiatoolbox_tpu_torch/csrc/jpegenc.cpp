// Baseline JPEG encoder of the port's TIFF writer: the counterpart of the
// cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, q]) call of
// tiatoolbox_tpu/wsicore/tiffio.py:694-704, which runs libjpeg(-turbo)
// with its defaults. Built with g++ into a shared library with a plain C
// interface and loaded with ctypes (tiatoolbox_tpu_torch/native).
//
// libjpeg's defaults, step by step:
// - jcparam.c jpeg_set_quality(q, force_baseline): the Annex K tables
//   scaled by jpeg_quality_scaling, entries clamped to 1..255;
// - colour: jccolor.c rgb_ycc_convert's fixed-point tables, then 4:2:0
//   (luma 2x2, chroma 1x1) with jcsample.c h2v2_downsample, whose rounding
//   bias alternates 1, 2 along a row; grey frames have one component;
// - edges (jcprepct.c, jcsample.c): the last column is replicated at full
//   resolution; the last row to an even count before the chroma is
//   downsampled, then each plane's last row to the MCU; the MCU's dummy
//   blocks past the image repeat the previous block's DC with zero AC
//   (jccoefct.c);
// - jfdctint.c jpeg_fdct_islow, then jcdctmgr.c's rounding division by
//   8 x the table entry (libjpeg-turbo's reciprocal multiply gives the same
//   quotients; tests/test_torch_jpeg.py checks every divisor);
// - the standard Huffman tables, no restart interval, 1-bits padding the
//   last byte (jchuff.c), and the markers in jcmarker.c's order: SOI, JFIF
//   1.01 APP0 (no density unit, 1:1), one DQT per table, SOF0, one DHT per
//   table (DC then AC, luma then chroma), SOS, the scan, EOI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_common.h"

namespace {

using namespace jpeg_common;

struct HuffCodes {
    uint16_t code[256];
    uint8_t size[256];
};

// jchuff.c jpeg_make_c_derived_tbl.
void make_codes(const uint8_t* bits, const uint8_t* vals, HuffCodes* t) {
    std::memset(t, 0, sizeof(*t));
    uint16_t code = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l]; ++i) {
            t->code[vals[p]] = code++;
            t->size[vals[p]] = static_cast<uint8_t>(l);
            p++;
        }
        code <<= 1;
    }
}

class Writer {
   public:
    explicit Writer(std::vector<uint8_t>* out) : out_(out) {}
    void byte(int b) { out_->push_back(static_cast<uint8_t>(b)); }
    void word(int w) {
        byte(w >> 8);
        byte(w & 0xFF);
    }
    // jchuff.c emit_bits with byte stuffing
    void bits(uint32_t code, int size) {
        buf_ = (buf_ << size) | (code & ((1u << size) - 1));
        n_ += size;
        while (n_ >= 8) {
            n_ -= 8;
            const int c = static_cast<int>((buf_ >> n_) & 0xFF);
            byte(c);
            if (c == 0xFF) byte(0);
        }
    }
    void flush() {
        if (n_) bits(0x7F, 8 - n_);  // fill the partial byte with ones
    }

   private:
    std::vector<uint8_t>* out_;
    uint64_t buf_ = 0;
    int n_ = 0;
};

int quality_scaling(int quality) {  // jcparam.c jpeg_quality_scaling
    quality = std::clamp(quality, 1, 100);
    return quality < 50 ? 5000 / quality : 200 - quality * 2;
}

void scaled_table(const int* basic, int scale, int* out) {  // jpeg_add_quant_table
    for (int i = 0; i < 64; ++i) {
        int64_t temp = (static_cast<int64_t>(basic[i]) * scale + 50) / 100;
        out[i] = static_cast<int>(std::clamp<int64_t>(temp, 1, 255));
    }
}

// jfdctint.c jpeg_fdct_islow, in place.
void fdct_islow(int32_t* data) {
    for (int row = 0; row < 8; ++row) {
        int32_t* d = data + 8 * row;
        int64_t tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
        int64_t tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
        int64_t tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
        int64_t tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        d[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4] = static_cast<int32_t>((tmp10 - tmp11) * (1 << kPass1Bits));
        int64_t z1 = (tmp12 + tmp13) * kFix0_541196100;
        d[2] = static_cast<int32_t>(descale(z1 + tmp13 * kFix0_765366865, kConstBits - kPass1Bits));
        d[6] = static_cast<int32_t>(descale(z1 + tmp12 * -kFix1_847759065, kConstBits - kPass1Bits));
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        const int64_t z5 = (z3 + z4) * kFix1_175875602;
        tmp4 *= kFix0_298631336;
        tmp5 *= kFix2_053119869;
        tmp6 *= kFix3_072711026;
        tmp7 *= kFix1_501321110;
        z1 *= -kFix0_899976223;
        z2 *= -kFix2_562915447;
        z3 *= -kFix1_961570560;
        z4 *= -kFix0_390180644;
        z3 += z5;
        z4 += z5;
        d[7] = static_cast<int32_t>(descale(tmp4 + z1 + z3, kConstBits - kPass1Bits));
        d[5] = static_cast<int32_t>(descale(tmp5 + z2 + z4, kConstBits - kPass1Bits));
        d[3] = static_cast<int32_t>(descale(tmp6 + z2 + z3, kConstBits - kPass1Bits));
        d[1] = static_cast<int32_t>(descale(tmp7 + z1 + z4, kConstBits - kPass1Bits));
    }
    for (int col = 0; col < 8; ++col) {
        int32_t* d = data + col;
        int64_t tmp0 = d[0] + d[56], tmp7 = d[0] - d[56];
        int64_t tmp1 = d[8] + d[48], tmp6 = d[8] - d[48];
        int64_t tmp2 = d[16] + d[40], tmp5 = d[16] - d[40];
        int64_t tmp3 = d[24] + d[32], tmp4 = d[24] - d[32];
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        d[0] = static_cast<int32_t>(descale(tmp10 + tmp11, kPass1Bits));
        d[32] = static_cast<int32_t>(descale(tmp10 - tmp11, kPass1Bits));
        int64_t z1 = (tmp12 + tmp13) * kFix0_541196100;
        d[16] = static_cast<int32_t>(descale(z1 + tmp13 * kFix0_765366865, kConstBits + kPass1Bits));
        d[48] = static_cast<int32_t>(descale(z1 + tmp12 * -kFix1_847759065, kConstBits + kPass1Bits));
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        const int64_t z5 = (z3 + z4) * kFix1_175875602;
        tmp4 *= kFix0_298631336;
        tmp5 *= kFix2_053119869;
        tmp6 *= kFix3_072711026;
        tmp7 *= kFix1_501321110;
        z1 *= -kFix0_899976223;
        z2 *= -kFix2_562915447;
        z3 *= -kFix1_961570560;
        z4 *= -kFix0_390180644;
        z3 += z5;
        z4 += z5;
        d[56] = static_cast<int32_t>(descale(tmp4 + z1 + z3, kConstBits + kPass1Bits));
        d[40] = static_cast<int32_t>(descale(tmp5 + z2 + z4, kConstBits + kPass1Bits));
        d[24] = static_cast<int32_t>(descale(tmp6 + z2 + z3, kConstBits + kPass1Bits));
        d[8] = static_cast<int32_t>(descale(tmp7 + z1 + z4, kConstBits + kPass1Bits));
    }
}

// One component's samples, padded to whole blocks by edge replication.
struct Plane {
    int bw = 0, bh = 0;      // blocks of real data (width_in_blocks, height_in_blocks)
    int stride = 0;
    std::vector<uint8_t> px;
    const uint8_t* row(int y) const { return px.data() + static_cast<size_t>(y) * stride; }
};

class Encoder {
   public:
    Encoder(const uint8_t* px, int h, int w, int ch, int quality)
        : px_(px), h_(h), w_(w), ch_(ch) {
        const int scale = quality_scaling(quality);
        scaled_table(kStdLuminanceQuant, scale, qt_[0]);
        scaled_table(kStdChrominanceQuant, scale, qt_[1]);
        make_codes(kDcLuminanceBits, kDcLuminanceVals, &dc_[0]);
        make_codes(kAcLuminanceBits, kAcLuminanceVals, &ac_[0]);
        make_codes(kDcChrominanceBits, kDcChrominanceVals, &dc_[1]);
        make_codes(kAcChrominanceBits, kAcChrominanceVals, &ac_[1]);
    }

    void encode(std::vector<uint8_t>* out);

   private:
    void build_planes();
    void headers(Writer& wr);
    void block(Writer& wr, const Plane& p, int bx, int by, int tbl, int* last_dc);
    void dummy(Writer& wr, int tbl, int* last_dc, int dc);
    void emit(Writer& wr, int tbl, const int32_t* q, int* last_dc);

    const uint8_t* px_;
    int h_, w_, ch_;
    int qt_[2][64];
    HuffCodes dc_[2], ac_[2];
    Plane planes_[3];
    int last_block_dc_ = 0;  // DC of the block written last (the dummy blocks copy it)
};

void Encoder::build_planes() {
    if (ch_ == 1) {
        Plane& p = planes_[0];
        p.bw = (w_ + 7) / 8;
        p.bh = (h_ + 7) / 8;
        p.stride = p.bw * 8;
        p.px.resize(static_cast<size_t>(p.stride) * p.bh * 8);
        for (int y = 0; y < p.bh * 8; ++y) {
            const uint8_t* src = px_ + static_cast<size_t>(std::min(y, h_ - 1)) * w_;
            uint8_t* dst = p.px.data() + static_cast<size_t>(y) * p.stride;
            std::memcpy(dst, src, w_);
            std::memset(dst + w_, src[w_ - 1], p.stride - w_);
        }
        return;
    }
    // jccolor.c rgb_ycc_start
    static int32_t tab[8][256];
    static const bool built = [] {
        for (int i = 0; i < 256; ++i) {
            tab[0][i] = static_cast<int32_t>(fix(0.29900) * i);
            tab[1][i] = static_cast<int32_t>(fix(0.58700) * i);
            tab[2][i] = static_cast<int32_t>(fix(0.11400) * i + kOneHalf);
            tab[3][i] = static_cast<int32_t>(-fix(0.16874) * i);
            tab[4][i] = static_cast<int32_t>(-fix(0.33126) * i);
            tab[5][i] = static_cast<int32_t>(fix(0.50000) * i + (int64_t{128} << kScaleBits) +
                                             kOneHalf - 1);
            tab[6][i] = static_cast<int32_t>(-fix(0.41869) * i);
            tab[7][i] = static_cast<int32_t>(-fix(0.08131) * i);
        }
        return true;
    }();
    (void)built;
    const int mcus_x = (w_ + 15) / 16, mcus_y = (h_ + 15) / 16;
    // full-resolution planes, the last column and row replicated to the MCU
    const int fw = mcus_x * 16, fh = mcus_y * 16;
    std::vector<uint8_t> full[3];
    for (auto& f : full) f.resize(static_cast<size_t>(fw) * fh);
    for (int y = 0; y < h_; ++y) {
        const uint8_t* src = px_ + static_cast<size_t>(y) * w_ * 3;
        for (int x = 0; x < w_; ++x) {
            const int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
            const size_t o = static_cast<size_t>(y) * fw + x;
            full[0][o] = static_cast<uint8_t>((tab[0][r] + tab[1][g] + tab[2][b]) >> kScaleBits);
            full[1][o] = static_cast<uint8_t>((tab[3][r] + tab[4][g] + tab[5][b]) >> kScaleBits);
            full[2][o] = static_cast<uint8_t>((tab[5][r] + tab[6][g] + tab[7][b]) >> kScaleBits);
        }
    }
    for (auto& f : full) {
        for (int y = 0; y < fh; ++y) {
            uint8_t* row = f.data() + static_cast<size_t>(y) * fw;
            if (y >= h_) std::memcpy(row, f.data() + static_cast<size_t>(h_ - 1) * fw, fw);
            else std::memset(row + w_, row[w_ - 1], fw - w_);
        }
    }
    Plane& luma = planes_[0];
    luma.bw = (w_ + 7) / 8;
    luma.bh = (h_ + 7) / 8;
    luma.stride = fw;
    luma.px = std::move(full[0]);
    for (int c = 1; c < 3; ++c) {  // jcsample.c h2v2_downsample
        Plane& p = planes_[c];
        p.bw = mcus_x;
        p.bh = mcus_y;
        p.stride = mcus_x * 8;
        p.px.resize(static_cast<size_t>(p.stride) * mcus_y * 8);
        // jcprepct.c pads the full rows to an even count before downsampling
        // and the downsampled rows after it, each with its last row
        const int real = (h_ + 1) / 2;
        for (int y = 0; y < mcus_y * 8; ++y) {
            const uint8_t* r0 = full[c].data() + static_cast<size_t>(2 * std::min(y, real - 1)) * fw;
            const uint8_t* r1 = r0 + fw;
            uint8_t* dst = p.px.data() + static_cast<size_t>(y) * p.stride;
            int bias = 1;
            for (int x = 0; x < p.stride; ++x) {
                dst[x] = static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
                bias ^= 3;
            }
        }
    }
}

void Encoder::emit(Writer& wr, int tbl, const int32_t* q, int* last_dc) {  // jchuff.c encode_one_block
    int temp = q[0] - *last_dc;
    *last_dc = q[0];
    int temp2 = temp;
    if (temp < 0) {
        temp = -temp;
        temp2--;
    }
    int nbits = 0;
    while (temp) {
        nbits++;
        temp >>= 1;
    }
    wr.bits(dc_[tbl].code[nbits], dc_[tbl].size[nbits]);
    if (nbits) wr.bits(static_cast<uint32_t>(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
        temp = q[kNaturalOrder[k]];
        if (temp == 0) {
            r++;
            continue;
        }
        while (r > 15) {
            wr.bits(ac_[tbl].code[0xF0], ac_[tbl].size[0xF0]);
            r -= 16;
        }
        temp2 = temp;
        if (temp < 0) {
            temp = -temp;
            temp2--;
        }
        nbits = 1;
        while (temp >>= 1) nbits++;
        const int sym = (r << 4) + nbits;
        wr.bits(ac_[tbl].code[sym], ac_[tbl].size[sym]);
        wr.bits(static_cast<uint32_t>(temp2), nbits);
        r = 0;
    }
    if (r > 0) wr.bits(ac_[tbl].code[0], ac_[tbl].size[0]);
}

void Encoder::block(Writer& wr, const Plane& p, int bx, int by, int tbl, int* last_dc) {
    int32_t d[64];
    for (int y = 0; y < 8; ++y) {
        const uint8_t* row = p.row(by * 8 + y) + bx * 8;
        for (int x = 0; x < 8; ++x) d[8 * y + x] = static_cast<int32_t>(row[x]) - 128;
    }
    fdct_islow(d);
    int32_t q[64];
    for (int i = 0; i < 64; ++i) {  // jcdctmgr.c: rounding division by 8 x the entry
        const int32_t qval = qt_[tbl][i] << 3;
        int32_t temp = d[i];
        if (temp < 0) {
            temp = -temp + (qval >> 1);
            temp = temp >= qval ? temp / qval : 0;
            temp = -temp;
        } else {
            temp += qval >> 1;
            temp = temp >= qval ? temp / qval : 0;
        }
        q[i] = temp;
    }
    last_block_dc_ = q[0];
    emit(wr, tbl, q, last_dc);
}

void Encoder::dummy(Writer& wr, int tbl, int* last_dc, int dc) {
    int32_t q[64] = {0};
    q[0] = dc;
    emit(wr, tbl, q, last_dc);
}

void Encoder::headers(Writer& wr) {
    wr.word(0xFFD8);
    // JFIF APP0: version 1.01, density unit 0, density 1:1, no thumbnail
    const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                            0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    for (uint8_t b : app0) wr.byte(b);
    const int ntables = ch_ == 3 ? 2 : 1;
    for (int t = 0; t < ntables; ++t) {
        wr.word(0xFFDB);
        wr.word(67);
        wr.byte(t);
        for (int i = 0; i < 64; ++i) wr.byte(qt_[t][kNaturalOrder[i]]);
    }
    wr.word(0xFFC0);
    wr.word(8 + 3 * ch_);
    wr.byte(8);
    wr.word(h_);
    wr.word(w_);
    wr.byte(ch_);
    for (int c = 0; c < ch_; ++c) {
        wr.byte(c + 1);
        wr.byte(ch_ == 3 && c == 0 ? 0x22 : 0x11);
        wr.byte(c == 0 ? 0 : 1);
    }
    auto dht = [&](int index, const uint8_t* bits, const uint8_t* vals, int n) {
        wr.word(0xFFC4);
        wr.word(2 + 1 + 16 + n);
        wr.byte(index);
        for (int l = 1; l <= 16; ++l) wr.byte(bits[l]);
        for (int i = 0; i < n; ++i) wr.byte(vals[i]);
    };
    dht(0x00, kDcLuminanceBits, kDcLuminanceVals, 12);
    dht(0x10, kAcLuminanceBits, kAcLuminanceVals, 162);
    if (ch_ == 3) {
        dht(0x01, kDcChrominanceBits, kDcChrominanceVals, 12);
        dht(0x11, kAcChrominanceBits, kAcChrominanceVals, 162);
    }
    wr.word(0xFFDA);
    wr.word(6 + 2 * ch_);
    wr.byte(ch_);
    for (int c = 0; c < ch_; ++c) {
        wr.byte(c + 1);
        wr.byte(c == 0 ? 0x00 : 0x11);
    }
    wr.byte(0);
    wr.byte(63);
    wr.byte(0);
}

void Encoder::encode(std::vector<uint8_t>* out) {
    build_planes();
    Writer wr(out);
    headers(wr);
    if (ch_ == 1) {
        const Plane& p = planes_[0];
        int last = 0;
        for (int by = 0; by < p.bh; ++by) {
            for (int bx = 0; bx < p.bw; ++bx) block(wr, p, bx, by, 0, &last);
        }
    } else {
        int last[3] = {0, 0, 0};
        const int mcus_x = (w_ + 15) / 16, mcus_y = (h_ + 15) / 16;
        const Plane& luma = planes_[0];
        for (int my = 0; my < mcus_y; ++my) {
            for (int mx = 0; mx < mcus_x; ++mx) {
                // luma: real blocks, then dummies repeating the previous block's DC
                for (int yy = 0; yy < 2; ++yy) {
                    const int by = 2 * my + yy;
                    for (int xx = 0; xx < 2; ++xx) {
                        const int bx = 2 * mx + xx;
                        if (by < luma.bh && bx < luma.bw) {
                            block(wr, luma, bx, by, 0, &last[0]);
                        } else {
                            dummy(wr, 0, &last[0], last_block_dc_);
                        }
                    }
                }
                block(wr, planes_[1], mx, my, 1, &last[1]);
                block(wr, planes_[2], mx, my, 1, &last[2]);
            }
        }
    }
    wr.flush();
    wr.word(0xFFD9);
}

}  // namespace

extern "C" {

// Encode h x w x ch uint8 pixels (ch 3: RGB, ch 1: grey) at `quality`
// into out (capacity cap). Returns the stream's length, or -(needed length)
// when cap is too small, or 0 on bad arguments.
int64_t jpeg_encode(const uint8_t* pixels, int32_t h, int32_t w, int32_t ch, int32_t quality,
                    uint8_t* out, uint64_t cap) {
    if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (ch != 1 && ch != 3)) return 0;
    std::vector<uint8_t> stream;
    stream.reserve(static_cast<size_t>(h) * w * ch / 4 + 1024);
    Encoder(pixels, h, w, ch, quality).encode(&stream);
    if (stream.size() > cap) return -static_cast<int64_t>(stream.size());
    std::memcpy(out, stream.data(), stream.size());
    return static_cast<int64_t>(stream.size());
}

}  // extern "C"

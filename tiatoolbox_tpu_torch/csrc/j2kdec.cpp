// The port's JPEG 2000 (ISO/IEC 15444-1) decoder: the role OpenJPEG plays
// behind cv2.imdecode / cv2.imread in JAX's wsicore/jp2.py:229-244,
// wsireader.py:1075-1108, tiffio.py:416-422 and dicom.py:361-375.
//
// It reproduces OpenJPEG 2.5's pixels: the reversible path (5/3, RCT) bit
// for bit, truncated code-blocks included (a newly significant coefficient
// is set to the middle of its interval, and the reversible path halves it
// with C's division, as OpenJPEG's t1.c does); the irreversible path (9/7,
// ICT) in OpenJPEG's float operations and order (dwt.c, mct.c, tcd.c's
// lrintf), so within a level of it. Keep -ffp-contract and -march out of
// this file's flags: a fused multiply-add changes the 9/7 path's floats.
//
// What it reads: main and tile-part headers (SIZ, COD/COC, QCD/QCC, SOT with
// several tile-parts a tile and Psot = 0, SOD, COM; TLM, PLM, PLT and CRG
// skipped); tag trees and packet headers in all five progression orders,
// any number of layers, user-defined precincts, SOP and EPH; the MQ and raw
// block decoders with every code-block style flag; no, derived and
// expounded quantisation; the 5/3 and 9/7 inverse transforms over band and
// code-block partitions anchored at the tile's absolute coordinates; inverse
// RCT/ICT, the DC level shift and a clamp to 8 bits. A JP2 file is read to
// its jp2c box. What it refuses, naming the feature: POC, PPM/PPT, RGN,
// component sub-sampling, precision other than 8-bit unsigned, component
// counts other than 1 and 3, and HTJ2K (the CAP marker, Part 15 Rsiz or
// code-block style). A truncated or corrupt stream raises too.
//
// C interface (ctypes, tiatoolbox_tpu_torch/native/__init__.py):
//   j2k_header       image and tile geometry of a codestream or JP2 file
//   j2k_decode_tiles listed tiles of one codestream, each into its own
//                    buffer, on threads
//   j2k_decode_batch codestreams, each whole into its own buffer, on
//                    threads (one image; TIFF tiles; DICOM frames)
// Each returns 0, or -1 with a message in the caller's buffer. The workers
// touch no Python object (ctypes drops the GIL for the call).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "j2k_common.h"

namespace {

using namespace j2k_common;

struct J2kError {
    std::string message;
};

[[noreturn]] void corrupt(const std::string& what) { throw J2kError{"corrupt stream: " + what}; }
[[noreturn]] void truncated(const std::string& what) { throw J2kError{"truncated stream: " + what}; }
[[noreturn]] void unsupported(const std::string& feature) {
    throw J2kError{"unsupported JPEG 2000 feature: " + feature};
}

std::string hex16(uint32_t v) {
    static const char* digits = "0123456789ABCDEF";
    std::string s = "0x";
    for (int shift = 12; shift >= 0; shift -= 4) s += digits[(v >> shift) & 15];
    return s;
}

int ceil_div(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

// -- parameters ---------------------------------------------------------------

struct CodingStyle {
    int levels = 0;
    int xcb = 6, ycb = 6;  // code-block size exponents
    int style = 0;         // code-block style bits
    int transform = 1;     // 1: 5/3 reversible, 0: 9/7 irreversible
    int ppx[33], ppy[33];
    CodingStyle() {
        std::fill(ppx, ppx + 33, 15);
        std::fill(ppy, ppy + 33, 15);
    }
};

struct QuantStyle {
    int style = 0;  // 0 none, 1 scalar derived, 2 scalar expounded
    int guard = 2;
    int n = 0;
    uint16_t expn[97] = {}, mant[97] = {};
    // exponent and mantissa of band `b` (0 LL, then 3 a resolution level)
    void band(int b, int& e, int& m) const {
        if (style == 1) {  // derived: one step per decomposition level below LL's (E-5)
            e = b == 0 ? expn[0] : std::max(0, int(expn[0]) - (b - 1) / 3);
            m = mant[0];
            return;
        }
        if (b >= n) corrupt("quantisation has no step for band " + std::to_string(b));
        e = expn[b];
        m = mant[b];
    }
};

struct Params {
    int prog = 0, layers = 1, mct = 0;
    bool sop = false, eph = false;
    std::vector<CodingStyle> cod;
    std::vector<QuantStyle> qnt;
};

struct Segment {  // a marker segment: its code and body
    uint16_t marker;
    const uint8_t* body;
    int len;
};

struct Reader {
    const uint8_t* p;
    int n, pos = 0;
    const char* what;
    Reader(const uint8_t* data, int size, const char* w) : p(data), n(size), what(w) {}
    void need(int k) const {
        if (pos + k > n) truncated(what);
    }
    int u8() {
        need(1);
        return p[pos++];
    }
    int u16() {
        need(2);
        const int v = p[pos] << 8 | p[pos + 1];
        pos += 2;
        return v;
    }
    uint32_t u32() {
        need(4);
        const uint32_t v = uint32_t(p[pos]) << 24 | uint32_t(p[pos + 1]) << 16 | uint32_t(p[pos + 2]) << 8 | p[pos + 3];
        pos += 4;
        return v;
    }
};

void check_block_style(int style) {
    if (style & 0xC0) unsupported("HTJ2K block coding (code-block style " + hex16(style) + ")");
}

void read_spcod(Reader& r, CodingStyle& cs, bool precincts) {
    cs.levels = r.u8();
    if (cs.levels > 32) corrupt("more than 32 decomposition levels");
    const int xcb = r.u8(), ycb = r.u8();
    if (xcb > 8 || ycb > 8 || xcb + ycb > 8) corrupt("code-block size out of range");
    cs.xcb = xcb + 2;
    cs.ycb = ycb + 2;
    cs.style = r.u8();
    check_block_style(cs.style);
    cs.transform = r.u8();
    if (cs.transform > 1) unsupported("wavelet transform " + std::to_string(cs.transform) + " (Part 2)");
    for (int i = 0; i <= cs.levels; ++i) {
        if (precincts) {
            const int v = r.u8();
            cs.ppx[i] = v & 15;
            cs.ppy[i] = v >> 4;
            if (i > 0 && (cs.ppx[i] == 0 || cs.ppy[i] == 0)) corrupt("precinct size 1 above resolution 0");
        } else {
            cs.ppx[i] = cs.ppy[i] = 15;
        }
    }
}

void apply_cod(const Segment& s, Params& p) {
    Reader r(s.body, s.len, "COD");
    const int scod = r.u8();
    p.prog = r.u8();
    if (p.prog > 4) corrupt("progression order " + std::to_string(p.prog));
    p.layers = r.u16();
    if (p.layers < 1) corrupt("no quality layers");
    p.mct = r.u8();
    if (p.mct > 1) unsupported("multiple component transform " + std::to_string(p.mct) + " (Part 2)");
    p.sop = scod & 2;
    p.eph = scod & 4;
    CodingStyle cs;
    read_spcod(r, cs, scod & 1);
    for (auto& c : p.cod) c = cs;
}

int component_index(Reader& r, int ncomp) {
    const int c = ncomp < 257 ? r.u8() : r.u16();
    if (c >= ncomp) corrupt("component index " + std::to_string(c));
    return c;
}

void apply_coc(const Segment& s, Params& p) {
    Reader r(s.body, s.len, "COC");
    const int c = component_index(r, int(p.cod.size()));
    const int scoc = r.u8();
    read_spcod(r, p.cod[c], scoc & 1);
}

void read_quant(Reader& r, QuantStyle& q) {
    const int sq = r.u8();
    q.style = sq & 31;
    q.guard = sq >> 5;
    const int rest = r.n - r.pos;
    if (q.style == 0) {
        q.n = std::min(rest, 97);
        for (int i = 0; i < q.n; ++i) {
            q.expn[i] = r.u8() >> 3;
            q.mant[i] = 0;
        }
    } else if (q.style == 1 || q.style == 2) {
        q.n = q.style == 1 ? 1 : std::min(rest / 2, 97);
        if (q.n < 1) truncated("quantisation steps");
        for (int i = 0; i < q.n; ++i) {
            const int v = r.u16();
            q.expn[i] = v >> 11;
            q.mant[i] = v & 0x7FF;
        }
    } else {
        corrupt("quantisation style " + std::to_string(q.style));
    }
}

void apply_qcd(const Segment& s, Params& p) {
    Reader r(s.body, s.len, "QCD");
    QuantStyle q;
    read_quant(r, q);
    for (auto& c : p.qnt) c = q;
}

void apply_qcc(const Segment& s, Params& p) {
    Reader r(s.body, s.len, "QCC");
    const int c = component_index(r, int(p.qnt.size()));
    read_quant(r, p.qnt[c]);
}

// Compose COD, COC, QCD and QCC segments with the standard's precedence
// (tile-part COC > tile-part COD > main COC > main COD, and so for QCC/QCD).
void apply_segments(const std::vector<Segment>& segs, Params& p) {
    for (const auto& s : segs)
        if (s.marker == kCOD) apply_cod(s, p);
    for (const auto& s : segs)
        if (s.marker == kCOC) apply_coc(s, p);
    for (const auto& s : segs)
        if (s.marker == kQCD) apply_qcd(s, p);
    for (const auto& s : segs)
        if (s.marker == kQCC) apply_qcc(s, p);
}

// -- the codestream -----------------------------------------------------------

struct TilePart {
    int tpsot;
    std::vector<Segment> header;
    const uint8_t* data;
    int64_t len;
};

struct Codestream {
    const uint8_t* data = nullptr;
    int64_t size = 0;
    uint32_t xsiz = 0, ysiz = 0, xosiz = 0, yosiz = 0, xtsiz = 0, ytsiz = 0, xtosiz = 0, ytosiz = 0;
    int ncomp = 0, ntx = 0, nty = 0;
    std::vector<Segment> main;
    Params params;  // main header's
    std::vector<std::vector<TilePart>> tiles;

    int width() const { return int(xsiz - xosiz); }
    int height() const { return int(ysiz - yosiz); }
    void tile_bounds(int t, int& x0, int& y0, int& x1, int& y1) const {
        const int i = t % ntx, j = t / ntx;
        x0 = int(std::max<int64_t>(int64_t(xtosiz) + int64_t(i) * xtsiz, xosiz));
        y0 = int(std::max<int64_t>(int64_t(ytosiz) + int64_t(j) * ytsiz, yosiz));
        x1 = int(std::min<int64_t>(int64_t(xtosiz) + int64_t(i + 1) * xtsiz, xsiz));
        y1 = int(std::min<int64_t>(int64_t(ytosiz) + int64_t(j + 1) * ytsiz, ysiz));
    }
};

// The codestream inside `data`: the data itself when it opens with SOC,
// else the payload of a JP2 file's jp2c box.
void locate_codestream(const uint8_t* data, int64_t size, const uint8_t*& cs, int64_t& cs_size) {
    if (size >= 2 && data[0] == 0xFF && data[1] == 0x4F) {
        cs = data;
        cs_size = size;
        return;
    }
    static const uint8_t sig[12] = {0, 0, 0, 12, 'j', 'P', ' ', ' ', 0x0D, 0x0A, 0x87, 0x0A};
    if (size < 12 || std::memcmp(data, sig, 12) != 0) corrupt("neither a J2K codestream nor a JP2 file");
    int64_t pos = 0;
    while (pos + 8 <= size) {
        uint64_t len = uint64_t(data[pos]) << 24 | uint64_t(data[pos + 1]) << 16 | uint64_t(data[pos + 2]) << 8 | data[pos + 3];
        const bool jp2c = std::memcmp(data + pos + 4, "jp2c", 4) == 0;
        int64_t head = 8;
        if (len == 1) {
            if (pos + 16 > size) truncated("JP2 box header");
            len = 0;
            for (int k = 0; k < 8; ++k) len = len << 8 | data[pos + 8 + k];
            head = 16;
        } else if (len == 0) {
            len = uint64_t(size - pos);
        }
        if (len < uint64_t(head)) corrupt("JP2 box length");
        if (jp2c) {
            cs = data + pos + head;
            cs_size = std::min<int64_t>(int64_t(len) - head, size - pos - head);
            if (cs_size < 2 || cs[0] != 0xFF || cs[1] != 0x4F) corrupt("jp2c box holds no codestream");
            return;
        }
        pos += int64_t(len);
    }
    corrupt("JP2 file has no jp2c box");
}

bool skipped_marker(uint16_t m) { return m == kTLM || m == kPLM || m == kPLT || m == kCRG || m == kCOM; }

void refuse_marker(uint16_t m, bool tile) {
    if (m == kPOC) unsupported("progression order change (POC)");
    if (m == kPPM) unsupported("packed packet headers (PPM)");
    if (m == kPPT) unsupported("packed packet headers (PPT)");
    if (m == kRGN) unsupported("region of interest (RGN)");
    if (m == kCAP) unsupported("HTJ2K (CAP marker)");
    corrupt(std::string("unexpected marker ") + hex16(m) + (tile ? " in a tile-part header" : " in the main header"));
}

void parse_codestream(const uint8_t* data, int64_t size, Codestream& cs) {
    locate_codestream(data, size, cs.data, cs.size);
    const uint8_t* p = cs.data;
    const int64_t n = cs.size;
    auto u16 = [&](int64_t at) -> int {
        if (at + 2 > n) truncated("main header");
        return p[at] << 8 | p[at + 1];
    };
    int64_t pos = 2;
    bool have_siz = false, have_cod = false, have_qcd = false;
    while (true) {
        const int m = u16(pos);
        if (m == kSOT) break;
        if ((m >> 8) != 0xFF) corrupt("main header holds no marker at byte " + std::to_string(pos));
        const int len = u16(pos + 2);
        if (len < 2 || pos + 2 + len > n) truncated("main header segment " + hex16(m));
        const uint8_t* body = p + pos + 4;
        const int blen = len - 2;
        if (m == kSIZ) {
            Reader r(body, blen, "SIZ");
            const int rsiz = r.u16();
            if (rsiz & 0x4000) unsupported("HTJ2K (Part 15 Rsiz)");
            cs.xsiz = r.u32();
            cs.ysiz = r.u32();
            cs.xosiz = r.u32();
            cs.yosiz = r.u32();
            cs.xtsiz = r.u32();
            cs.ytsiz = r.u32();
            cs.xtosiz = r.u32();
            cs.ytosiz = r.u32();
            cs.ncomp = r.u16();
            if (cs.xsiz <= cs.xosiz || cs.ysiz <= cs.yosiz || cs.xtsiz == 0 || cs.ytsiz == 0 ||
                cs.xtosiz > cs.xosiz || cs.ytosiz > cs.yosiz || uint64_t(cs.xtosiz) + cs.xtsiz <= cs.xosiz ||
                uint64_t(cs.ytosiz) + cs.ytsiz <= cs.yosiz || cs.xsiz > 0x7FFFFFFFu || cs.ysiz > 0x7FFFFFFFu)
                corrupt("SIZ geometry");
            for (int c = 0; c < cs.ncomp; ++c) {
                const int ssiz = r.u8(), xr = r.u8(), yr = r.u8();
                if (ssiz != 7) {
                    unsupported("component precision " + std::to_string((ssiz & 0x7F) + 1) + " bits " +
                                ((ssiz & 0x80) ? "signed" : "unsigned") + " (only 8-bit unsigned)");
                }
                if (xr != 1 || yr != 1) unsupported("component sub-sampling");
            }
            if (cs.ncomp != 1 && cs.ncomp != 3)
                unsupported(std::to_string(cs.ncomp) + " components (only 1 and 3)");
            have_siz = true;
        } else if (m == kCOD || m == kCOC || m == kQCD || m == kQCC) {
            if (!have_siz) corrupt("coding segment before SIZ");
            cs.main.push_back({uint16_t(m), body, blen});
            have_cod |= m == kCOD;
            have_qcd |= m == kQCD;
        } else if (!skipped_marker(uint16_t(m))) {
            refuse_marker(uint16_t(m), false);
        }
        pos += 2 + len;
    }
    if (!have_siz || !have_cod || !have_qcd) corrupt("main header lacks SIZ, COD or QCD");
    cs.params.cod.assign(cs.ncomp, CodingStyle());
    cs.params.qnt.assign(cs.ncomp, QuantStyle());
    apply_segments(cs.main, cs.params);
    cs.ntx = ceil_div(int64_t(cs.xsiz) - cs.xtosiz, cs.xtsiz);
    cs.nty = ceil_div(int64_t(cs.ysiz) - cs.ytosiz, cs.ytsiz);
    if (int64_t(cs.ntx) * cs.nty > 65535) corrupt("more than 65535 tiles");
    cs.tiles.assign(size_t(cs.ntx) * cs.nty, {});
    // tile-parts
    while (pos + 2 <= n) {
        const int m = p[pos] << 8 | p[pos + 1];
        if (m == kEOC) break;
        if (m != kSOT) corrupt("expected SOT at byte " + std::to_string(pos));
        if (pos + 12 > n) truncated("SOT");
        const int lsot = u16(pos + 2);
        if (lsot != 10) corrupt("SOT length");
        const int isot = u16(pos + 4);
        const uint32_t psot = uint32_t(p[pos + 6]) << 24 | uint32_t(p[pos + 7]) << 16 | uint32_t(p[pos + 8]) << 8 | p[pos + 9];
        const int tpsot = p[pos + 10];
        if (isot >= int(cs.tiles.size())) corrupt("tile index " + std::to_string(isot));
        int64_t end;
        if (psot == 0) {  // the last tile-part: to EOC
            end = n >= 2 && p[n - 2] == 0xFF && p[n - 1] == 0xD9 ? n - 2 : n;
        } else {
            end = pos + int64_t(psot);
            if (end > n) truncated("tile-part " + std::to_string(isot) + " runs past the data");
        }
        TilePart tp;
        tp.tpsot = tpsot;
        int64_t q = pos + 12;
        while (true) {
            if (q + 2 > end) truncated("tile-part header");
            const int mk = p[q] << 8 | p[q + 1];
            if (mk == kSOD) {
                q += 2;
                break;
            }
            if (q + 4 > end) truncated("tile-part header");
            const int len = p[q + 2] << 8 | p[q + 3];
            if (len < 2 || q + 2 + len > end) truncated("tile-part segment " + hex16(mk));
            if (mk == kCOD || mk == kCOC || mk == kQCD || mk == kQCC) {
                tp.header.push_back({uint16_t(mk), p + q + 4, len - 2});
            } else if (!skipped_marker(uint16_t(mk))) {
                refuse_marker(uint16_t(mk), true);
            }
            q += 2 + len;
        }
        tp.data = p + q;
        tp.len = end - q;
        cs.tiles[isot].push_back(tp);
        pos = end;
    }
    for (auto& parts : cs.tiles)
        std::stable_sort(parts.begin(), parts.end(), [](const TilePart& a, const TilePart& b) { return a.tpsot < b.tpsot; });
}

// -- the packet-header bit reader and tag-tree decoding ------------------------

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint32_t buf = 0;
    int ct = 0;
    BitReader(const uint8_t* start, const uint8_t* stop) : p(start), end(stop) {}
    void byte_in() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        if (p >= end) truncated("packet header");
        buf |= *p++;
    }
    int bit() {
        if (ct == 0) byte_in();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i) v = v << 1 | uint32_t(bit());
        return v;
    }
    void align() {
        if ((buf & 0xFF) == 0xFF) byte_in();
        ct = 0;
    }
};

// 1 when the tree's value at `leaf` is below `threshold` (OpenJPEG's tgt.c).
int tag_decode(BitReader& bio, TagTree& tree, int leaf, int threshold) {
    int stack[32], depth = 0;
    int node = leaf;
    while (tree.nodes[node].parent >= 0) {
        stack[depth++] = node;
        node = tree.nodes[node].parent;
    }
    int low = 0;
    while (true) {
        auto& nd = tree.nodes[node];
        if (low > nd.low) nd.low = low;
        else low = nd.low;
        while (low < threshold && low < nd.value) {
            if (bio.bit()) nd.value = low;
            else ++low;
        }
        nd.low = low;
        if (depth == 0) break;
        node = stack[--depth];
    }
    return tree.nodes[node].value < threshold;
}

// -- tile structure -------------------------------------------------------------

struct CodeSegment {
    int passes = 0, max_passes = 0;
    int64_t len = 0;
};

struct CodeBlock {
    int x0, y0, x1, y1;  // band coordinates
    int numbps = 0;
    int lblock = 3;
    bool included = false;
    int new_passes = 0;
    std::vector<CodeSegment> segs;
    std::vector<int64_t> new_lens;  // bytes of this packet for each touched segment
    int first_new_seg = 0;
    std::vector<uint8_t> data;
};

struct BandState {
    int mb;      // Mb: the band's most significant bit-plane count
    float step;  // OpenJPEG's band step (irreversible path)
    std::vector<CodeBlock> blocks;  // the band's code-block grid
};

struct TagPair {  // one band of one precinct
    TagTree incl, zbp;
};

struct TileComponent {
    ComponentGeometry geom;
    std::vector<std::vector<BandState>> bands;             // [resolution][band]
    std::vector<std::vector<std::vector<TagPair>>> trees;  // [resolution][precinct][band]
};

void build_component(TileComponent& tc, const CodingStyle& cs, const QuantStyle& q, int x0, int y0, int x1, int y1) {
    tc.geom = component_geometry(x0, y0, x1, y1, cs.levels, cs.xcb, cs.ycb, cs.ppx, cs.ppy);
    const int nres = int(tc.geom.res.size());
    tc.bands.assign(nres, {});
    tc.trees.assign(nres, {});
    for (int r = 0; r < nres; ++r) {
        const ResolutionGeometry& res = tc.geom.res[r];
        for (int b = 0; b < int(res.bands.size()); ++b) {
            const BandGeometry& g = res.bands[b];
            BandState band;
            int e, m;
            q.band(r == 0 ? 0 : 3 * (r - 1) + b + 1, e, m);
            band.mb = e + q.guard - 1;
            // OpenJPEG's 9/7 bands carry their gain in the transform: R_b = 8
            band.step = cs.transform == 0 ? static_cast<float>((1.0 + m / 2048.0) * std::pow(2.0, 8 - e)) : 1.0f;
            band.blocks.resize(size_t(g.gw) * g.gh);
            for (int k = 0; k < int(band.blocks.size()); ++k) {
                int rect[4];
                g.block(k, rect);
                CodeBlock& cb = band.blocks[k];
                cb.x0 = rect[0];
                cb.y0 = rect[1];
                cb.x1 = rect[2];
                cb.y1 = rect[3];
            }
            tc.bands[r].push_back(std::move(band));
        }
        tc.trees[r].resize(res.precincts.size());
        for (size_t p = 0; p < res.precincts.size(); ++p) {
            tc.trees[r][p].resize(res.bands.size());
            for (size_t b = 0; b < res.bands.size(); ++b) {
                const PrecinctGeometry& pg = res.precincts[p][b];
                tc.trees[r][p][b].incl.init(pg.cw, pg.ch);
                tc.trees[r][p][b].zbp.init(pg.cw, pg.ch);
            }
        }
    }
}

// -- tier 2 -------------------------------------------------------------------------

void new_segment(CodeBlock& cb, int style) {
    CodeSegment s;
    const int index = int(cb.segs.size());
    s.max_passes = segment_max_passes(style, index, index ? cb.segs.back().max_passes : 0);
    cb.segs.push_back(s);
}

void read_packet(TileComponent& tc, const CodingStyle& cs, int r, int prec, int layer, bool sop, bool eph,
                 const uint8_t*& pos, const uint8_t* end) {
    const std::vector<PrecinctGeometry>& pgs = tc.geom.res[r].precincts[prec];
    std::vector<TagPair>& trees = tc.trees[r][prec];
    if (sop && end - pos >= 2 && pos[0] == 0xFF && pos[1] == 0x91) {
        if (end - pos < 6) truncated("SOP marker");
        pos += 6;
    }
    BitReader bio(pos, end);
    const bool present = bio.bit();
    std::vector<CodeBlock*> touched;
    if (present) {
        for (size_t b = 0; b < pgs.size(); ++b) {
            BandState& band = tc.bands[r][b];
            for (size_t k = 0; k < pgs[b].blocks.size(); ++k) {
                CodeBlock& cb = band.blocks[pgs[b].blocks[k]];
                bool included;
                if (!cb.included) included = tag_decode(bio, trees[b].incl, int(k), layer + 1);
                else included = bio.bit();
                if (!included) continue;
                if (!cb.included) {
                    int i = 0;
                    while (!tag_decode(bio, trees[b].zbp, int(k), i)) {
                        ++i;
                        if (i > 64) corrupt("zero bit-plane count");
                    }
                    cb.numbps = band.mb + 1 - i;
                    if (cb.numbps < 0 || cb.numbps > 30) corrupt("code-block bit-plane count " + std::to_string(cb.numbps));
                    cb.included = true;
                    new_segment(cb, cs.style);
                }
                // number of coding passes (Table B.4)
                int n;
                if (!bio.bit()) n = 1;
                else if (!bio.bit()) n = 2;
                else {
                    n = int(bio.bits(2));
                    if (n < 3) n += 3;
                    else {
                        n = int(bio.bits(5));
                        if (n < 31) n += 6;
                        else n = int(bio.bits(7)) + 37;
                    }
                }
                while (bio.bit()) ++cb.lblock;
                cb.new_passes = n;
                if (cb.segs.back().passes == cb.segs.back().max_passes) new_segment(cb, cs.style);
                cb.first_new_seg = int(cb.segs.size()) - 1;
                cb.new_lens.clear();
                int seg = cb.first_new_seg;
                int left = n;
                while (true) {
                    CodeSegment& s = cb.segs[seg];
                    const int take = std::min(s.max_passes - s.passes, left);
                    const int nbits = cb.lblock + floor_log2(take);
                    if (nbits > 32) corrupt("code-block segment length field");
                    cb.new_lens.push_back(int64_t(bio.bits(nbits)));
                    s.passes += take;
                    left -= take;
                    if (left <= 0) break;
                    new_segment(cb, cs.style);
                    ++seg;
                }
                touched.push_back(&cb);
            }
        }
    }
    bio.align();
    pos = bio.p;
    if (eph) {
        if (end - pos >= 2 && pos[0] == 0xFF && pos[1] == 0x92) pos += 2;
        else corrupt("missing EPH marker");
    }
    for (CodeBlock* cb : touched) {
        for (size_t k = 0; k < cb->new_lens.size(); ++k) {
            const int64_t len = cb->new_lens[k];
            if (len > end - pos) truncated("packet body");
            cb->data.insert(cb->data.end(), pos, pos + len);
            cb->segs[cb->first_new_seg + k].len += len;
            pos += len;
        }
    }
}

// -- tier 1: the MQ and raw decoders and the three passes ----------------------

struct MqDecoder {
    const uint8_t* bp;
    uint32_t a, c, ct;
    MqContext ctx[kNumContexts];

    // `data` must be followed by two 0xFF bytes (OpenJPEG's artificial marker)
    void init_mq(const uint8_t* data) {
        bp = data;
        c = uint32_t(*bp) << 16;
        byte_in();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void init_raw(const uint8_t* data) {
        bp = data;
        c = 0;
        ct = 0;
    }
    void byte_in() {
        if (*bp == 0xFF) {
            if (bp[1] > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                ++bp;
                c += uint32_t(*bp) << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += uint32_t(*bp) << 8;
            ct = 8;
        }
    }
    void renorm() {
        do {
            if (ct == 0) byte_in();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
    }
    int decode(int cx) {
        MqContext& s = ctx[cx];
        const MqState& st = kMqStates[s.state];
        const uint32_t qe = st.qe;
        int d;
        a -= qe;
        if ((c >> 16) < qe) {
            if (a < qe) {
                a = qe;
                d = s.mps;
                s.state = st.nmps;
            } else {
                a = qe;
                d = 1 - s.mps;
                if (st.swtch) s.mps = uint8_t(1 - s.mps);
                s.state = st.nlps;
            }
            renorm();
        } else {
            c -= qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < qe) {
                    d = 1 - s.mps;
                    if (st.swtch) s.mps = uint8_t(1 - s.mps);
                    s.state = st.nlps;
                } else {
                    d = s.mps;
                    s.state = st.nmps;
                }
                renorm();
            } else {
                d = s.mps;
            }
        }
        return d;
    }
    int raw_bit() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (*bp > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        --ct;
        return (c >> ct) & 1;
    }
};

struct BlockDecoder {
    int w = 0, h = 0, stride = 0;
    std::vector<uint32_t> flags;  // (w + 2) x (h + 2)
    std::vector<int32_t> data;    // w x h, twice the coefficient (OpenJPEG's extra half bit)
    std::vector<uint8_t> scratch;
    MqDecoder mq;
    int orient = 0;
    const ContextTables* tables = &context_tables();

    uint32_t* fl(int x, int y) { return &flags[size_t(y + 1) * stride + x + 1]; }
    // the flags a coefficient in row k of its stripe sees: in vertically
    // causal mode the last row ignores the stripe below
    template <bool VSC>
    static uint32_t seen(uint32_t f, int k) {
        return (VSC && k == 3) ? (f & ~uint32_t(kBelow)) : f;
    }
    template <bool RAW>
    int bit(int cx) {
        return RAW ? mq.raw_bit() : mq.decode(cx);
    }
    template <bool RAW>
    int decode_sign(uint32_t f) {
        if (RAW) return mq.raw_bit();
        const int sc = tables->sign[sign_index(f)];
        return mq.decode(sc & 0xFF) ^ (sc >> 8);
    }
    void significant(uint32_t* f, int32_t* d, int negative, int32_t value) {
        *d = negative ? -value : value;
        set_significant(f, stride, negative);
    }

    // The three passes walk stripes of four rows, column by column.
    template <bool RAW, bool VSC>
    void sig_pass(int bpno) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        const uint8_t* zero = tables->zero[orient];
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int rows = std::min(4, h - y0);
            for (int x = 0; x < w; ++x) {
                uint32_t* f = fl(x, y0);
                int32_t* d = &data[size_t(y0) * w + x];
                for (int k = 0; k < rows; ++k, f += stride, d += w) {
                    if (*f & kSig) continue;
                    const uint32_t s = seen<VSC>(*f, k);
                    if (!(s & kNeighbours)) continue;
                    if (bit<RAW>(zero[s & kNeighbours])) significant(f, d, decode_sign<RAW>(s), oneplushalf);
                    *f |= kVisited;
                }
            }
        }
    }
    template <bool RAW, bool VSC>
    void ref_pass(int bpno) {
        const int32_t poshalf = (1 << bpno) >> 1;
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int rows = std::min(4, h - y0);
            for (int x = 0; x < w; ++x) {
                uint32_t* f = fl(x, y0);
                int32_t* d = &data[size_t(y0) * w + x];
                for (int k = 0; k < rows; ++k, f += stride, d += w) {
                    if ((*f & (kSig | kVisited)) != kSig) continue;
                    const int v = bit<RAW>(refine_context(seen<VSC>(*f, k)));
                    *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
                    *f |= kRefined;
                }
            }
        }
    }
    template <bool VSC>
    void clean_pass(int bpno, bool segsym) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        const uint8_t* zero = tables->zero[orient];
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int rows = std::min(4, h - y0);
            for (int x = 0; x < w; ++x) {
                uint32_t* f0 = fl(x, y0);
                int32_t* d0 = &data[size_t(y0) * w + x];
                int k = 0;
                if (rows == 4) {
                    const bool run = !((f0[0] | f0[stride] | f0[2 * stride]) & (kSig | kVisited | kNeighbours)) &&
                                     !(seen<VSC>(f0[3 * stride], 3) & (kSig | kVisited | kNeighbours));
                    if (run) {
                        if (!mq.decode(kCtxRunLength)) continue;  // all four stay insignificant
                        k = mq.decode(kCtxUniform) << 1;
                        k |= mq.decode(kCtxUniform);
                        uint32_t* f = f0 + size_t(k) * stride;
                        significant(f, d0 + size_t(k) * w, decode_sign<false>(seen<VSC>(*f, k)), oneplushalf);
                        ++k;
                    }
                }
                for (; k < rows; ++k) {
                    uint32_t* f = f0 + size_t(k) * stride;
                    if (*f & (kSig | kVisited)) continue;
                    const uint32_t s = seen<VSC>(*f, k);
                    if (mq.decode(zero[s & kNeighbours]))
                        significant(f, d0 + size_t(k) * w, decode_sign<false>(s), oneplushalf);
                }
                for (k = 0; k < rows; ++k) f0[size_t(k) * stride] &= ~uint32_t(kVisited);
            }
        }
        if (segsym) {
            for (int i = 0; i < 4; ++i) mq.decode(kCtxUniform);
        }
    }
    template <bool VSC>
    void pass(int passtype, bool raw, int bpno, bool segsym) {
        if (passtype == 0) {
            if (raw) sig_pass<true, VSC>(bpno);
            else sig_pass<false, VSC>(bpno);
        } else if (passtype == 1) {
            if (raw) ref_pass<true, VSC>(bpno);
            else ref_pass<false, VSC>(bpno);
        } else {
            clean_pass<VSC>(bpno, segsym);
        }
    }

    void decode(const CodeBlock& cb, int orient_, int style) {
        w = cb.x1 - cb.x0;
        h = cb.y1 - cb.y0;
        stride = w + 2;
        orient = orient_;
        const bool vsc = style & kStyleVertCausal;
        flags.assign(size_t(w + 2) * (h + 2), 0);
        data.assign(size_t(w) * h, 0);
        if (cb.numbps == 0 || cb.segs.empty()) return;
        reset_contexts(mq.ctx);
        int bpno_plus_one = cb.numbps;
        int passtype = 2;
        int64_t offset = 0;
        for (const CodeSegment& seg : cb.segs) {
            if (offset + seg.len > int64_t(cb.data.size())) corrupt("code-block data");
            scratch.assign(cb.data.begin() + offset, cb.data.begin() + offset + seg.len);
            scratch.push_back(0xFF);
            scratch.push_back(0xFF);
            offset += seg.len;
            const bool raw = (style & kStyleBypass) && bpno_plus_one <= cb.numbps - 4 && passtype < 2;
            if (raw) mq.init_raw(scratch.data());
            else mq.init_mq(scratch.data());
            for (int p = 0; p < seg.passes && bpno_plus_one >= 1; ++p) {
                if (vsc) pass<true>(passtype, raw, bpno_plus_one, style & kStyleSegSym);
                else pass<false>(passtype, raw, bpno_plus_one, style & kStyleSegSym);
                if ((style & kStyleReset) && !raw) reset_contexts(mq.ctx);
                if (++passtype == 3) {
                    passtype = 0;
                    --bpno_plus_one;
                }
            }
        }
    }
};

// -- inverse transforms ------------------------------------------------------------

// One line of a level: `x` holds sn low then dn high coefficients (sn + dn
// = len); on return it holds the interleaved samples. `cas` is the parity of
// the line's first absolute coordinate (1: it is a high-pass sample).
void idwt53_line(int32_t* x, int32_t* tmp, int len, int sn, int cas) {
    if (len <= 0) return;
    if (len == 1) {
        if (cas) x[0] /= 2;
        return;
    }
    const int dn = len - sn;
    for (int k = 0; k < sn; ++k) tmp[2 * k + cas] = x[k];
    for (int k = 0; k < dn; ++k) tmp[2 * k + 1 - cas] = x[sn + k];
    for (int p = cas; p < len; p += 2) {
        const int32_t l = p > 0 ? tmp[p - 1] : tmp[p + 1];
        const int32_t r = p + 1 < len ? tmp[p + 1] : tmp[p - 1];
        tmp[p] -= (l + r + 2) >> 2;
    }
    for (int p = 1 - cas; p < len; p += 2) {
        const int32_t l = p > 0 ? tmp[p - 1] : tmp[p + 1];
        const int32_t r = p + 1 < len ? tmp[p + 1] : tmp[p - 1];
        tmp[p] += (l + r) >> 1;
    }
    std::memcpy(x, tmp, sizeof(int32_t) * size_t(len));
}

void idwt97_line(float* x, float* tmp, int len, int sn, int cas) {
    if (len <= 1) return;  // OpenJPEG leaves a single sample as it is
    const int dn = len - sn;
    for (int k = 0; k < sn; ++k) tmp[2 * k + cas] = x[k] * kK;
    for (int k = 0; k < dn; ++k) tmp[2 * k + 1 - cas] = x[sn + k] * kTwoInvK;
    lift97(tmp, len, cas, -kDelta);
    lift97(tmp, len, 1 - cas, -kGamma);
    lift97(tmp, len, cas, -kBeta);
    lift97(tmp, len, 1 - cas, -kAlpha);
    std::memcpy(x, tmp, sizeof(float) * size_t(len));
}

template <typename T, typename Line>
void idwt_2d(T* buf, int stride, const ComponentGeometry& g, Line line) {
    const int nl = int(g.res.size()) - 1;
    int max_len = 1;
    for (const auto& r : g.res) max_len = std::max({max_len, r.x1 - r.x0, r.y1 - r.y0});
    std::vector<T> col(max_len), tmp(max_len);
    for (int r = 1; r <= nl; ++r) {
        const ResolutionGeometry& lo = g.res[r - 1];
        const ResolutionGeometry& cur = g.res[r];
        const int rw = cur.x1 - cur.x0, rh = cur.y1 - cur.y0;
        const int snx = lo.x1 - lo.x0, sny = lo.y1 - lo.y0;
        const int casx = cur.x0 & 1, casy = cur.y0 & 1;
        for (int y = 0; y < rh; ++y) line(buf + size_t(y) * stride, tmp.data(), rw, snx, casx);
        for (int x = 0; x < rw; ++x) {
            for (int y = 0; y < rh; ++y) col[y] = buf[size_t(y) * stride + x];
            line(col.data(), tmp.data(), rh, sny, casy);
            for (int y = 0; y < rh; ++y) buf[size_t(y) * stride + x] = col[y];
        }
    }
}

// -- tile decoding ---------------------------------------------------------------

void parallel_for(int n, int threads, const std::function<void(int)>& fn);

struct TileJob {
    CodeBlock* cb;
    const BandGeometry* geom;
    const BandState* band;
    int comp;
};

// Decode tile `t` into `out` (rows of `out_stride` bytes, `ncomp` bytes a pixel),
// its top-left pixel at `out`; its code-blocks on `threads` workers.
void decode_tile(const Codestream& cs, int t, uint8_t* out, int64_t out_stride, int threads) {
    int tx0, ty0, tx1, ty1;
    cs.tile_bounds(t, tx0, ty0, tx1, ty1);
    const int tw = tx1 - tx0, th = ty1 - ty0;
    const int ncomp = cs.ncomp;
    const auto& parts = cs.tiles[t];
    if (parts.empty()) truncated("tile " + std::to_string(t) + " is missing");
    Params params = cs.params;
    {
        std::vector<Segment> tile_segs;
        for (const auto& tp : parts) tile_segs.insert(tile_segs.end(), tp.header.begin(), tp.header.end());
        apply_segments(tile_segs, params);
    }
    std::vector<TileComponent> tcs(ncomp);
    std::vector<const ComponentGeometry*> geoms;
    for (int c = 0; c < ncomp; ++c) {
        build_component(tcs[c], params.cod[c], params.qnt[c], tx0, ty0, tx1, ty1);
        geoms.push_back(&tcs[c].geom);
    }
    // tier 2 over the tile's concatenated tile-part bodies
    std::vector<uint8_t> body;
    for (const auto& tp : parts) body.insert(body.end(), tp.data, tp.data + tp.len);
    const uint8_t* pos = body.data();
    const uint8_t* end = body.data() + body.size();
    for (const PacketId& id : packet_order(geoms, params.prog, params.layers, tx0, ty0)) {
        read_packet(tcs[id.comp], params.cod[id.comp], id.res, id.prec, id.layer, params.sop, params.eph, pos, end);
    }
    // tier 1 and dequantisation into per-component buffers
    std::vector<TileJob> jobs;
    for (int c = 0; c < ncomp; ++c) {
        TileComponent& tc = tcs[c];
        for (size_t r = 0; r < tc.bands.size(); ++r)
            for (size_t b = 0; b < tc.bands[r].size(); ++b)
                for (CodeBlock& cb : tc.bands[r][b].blocks) jobs.push_back({&cb, &tc.geom.res[r].bands[b], &tc.bands[r][b], c});
    }
    const bool reversible_all = [&] {
        for (int c = 0; c < ncomp; ++c)
            if (params.cod[c].transform != 1) return false;
        return true;
    }();
    std::vector<std::vector<int32_t>> ibuf(ncomp);
    std::vector<std::vector<float>> fbuf(ncomp);
    for (int c = 0; c < ncomp; ++c) {
        if (params.cod[c].transform == 1) ibuf[c].assign(size_t(tw) * th, 0);
        else fbuf[c].assign(size_t(tw) * th, 0.0f);
    }
    parallel_for(int(jobs.size()), threads, [&](int j) {
        BlockDecoder bd;
        const TileJob& job = jobs[j];
        const CodingStyle& cod = params.cod[job.comp];
        bd.decode(*job.cb, job.geom->orient, cod.style);
        const int w = bd.w, h = bd.h;
        const size_t x0 = size_t(job.geom->px + job.cb->x0 - job.geom->x0);
        const size_t y0 = size_t(job.geom->py + job.cb->y0 - job.geom->y0);
        if (cod.transform == 1) {
            int32_t* dst = ibuf[job.comp].data();
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < w; ++x) dst[(y0 + y) * tw + x0 + x] = bd.data[size_t(y) * w + x] / 2;
        } else {
            float* dst = fbuf[job.comp].data();
            const float step = 0.5f * job.band->step;
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < w; ++x)
                    dst[(y0 + y) * tw + x0 + x] = static_cast<float>(bd.data[size_t(y) * w + x]) * step;
        }
    });
    // inverse transforms
    for (int c = 0; c < ncomp; ++c) {
        if (params.cod[c].transform == 1) idwt_2d(ibuf[c].data(), tw, tcs[c].geom, idwt53_line);
        else idwt_2d(fbuf[c].data(), tw, tcs[c].geom, idwt97_line);
    }
    // colour transform, level shift and clamp
    const size_t npix = size_t(tw) * th;
    const bool mct = params.mct == 1 && ncomp >= 3;
    auto clamp8 = [](int64_t v) -> uint8_t { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    if (mct && reversible_all) {
        int32_t *c0 = ibuf[0].data(), *c1 = ibuf[1].data(), *c2 = ibuf[2].data();
        for (size_t i = 0; i < npix; ++i) {
            const int32_t y = c0[i], u = c1[i], v = c2[i];
            const int32_t g = y - ((u + v) >> 2);
            c0[i] = v + g;
            c1[i] = g;
            c2[i] = u + g;
        }
    } else if (mct) {
        for (int c = 0; c < 3; ++c)
            if (params.cod[c].transform != 0) unsupported("a colour transform over components of mixed wavelets");
        float *c0 = fbuf[0].data(), *c1 = fbuf[1].data(), *c2 = fbuf[2].data();
        for (size_t i = 0; i < npix; ++i) {
            const float y = c0[i], u = c1[i], v = c2[i];
            const float r = y + (v * 1.402f);
            const float g = y - (u * 0.34413f) - (v * 0.71414f);
            const float b = y + (u * 1.772f);
            c0[i] = r;
            c1[i] = g;
            c2[i] = b;
        }
    }
    for (int c = 0; c < ncomp; ++c) {
        for (int y = 0; y < th; ++y) {
            uint8_t* row = out + int64_t(y) * out_stride + c;
            if (params.cod[c].transform == 1) {
                const int32_t* src = ibuf[c].data() + size_t(y) * tw;
                for (int x = 0; x < tw; ++x) row[int64_t(x) * ncomp] = clamp8(int64_t(src[x]) + 128);
            } else {
                const float* src = fbuf[c].data() + size_t(y) * tw;
                for (int x = 0; x < tw; ++x) {
                    const float v = src[x];
                    int64_t q;
                    if (v > 2147483647.0f) q = 255;
                    else if (v < -2147483648.0f) q = 0;
                    else q = int64_t(std::lrintf(v)) + 128;
                    row[int64_t(x) * ncomp] = clamp8(q);
                }
            }
        }
    }
}

void parallel_for(int n, int threads, const std::function<void(int)>& fn) {
    threads = std::max(1, std::min(threads, n));
    if (threads == 1) {
        for (int i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<int> next{0};
    std::mutex mu;
    std::string err;
    std::vector<std::thread> pool;
    for (int k = 0; k < threads; ++k)
        pool.emplace_back([&] {
            try {
                for (int i; (i = next.fetch_add(1)) < n;) fn(i);
            } catch (const J2kError& e) {
                std::lock_guard<std::mutex> lock(mu);
                if (err.empty()) err = e.message;
                next.store(n);
            } catch (const std::exception& e) {  // bad_alloc, length_error
                std::lock_guard<std::mutex> lock(mu);
                if (err.empty()) err = std::string("out of memory: ") + e.what();
                next.store(n);
            }
        });
    for (auto& t : pool) t.join();
    if (!err.empty()) throw J2kError{err};
}

void set_error(char* err, int err_len, const std::string& msg) {
    if (err && err_len > 0) {
        const size_t n = std::min<size_t>(msg.size(), size_t(err_len) - 1);
        std::memcpy(err, msg.data(), n);
        err[n] = 0;
    }
}

template <typename F>
int guarded(char* err, int err_len, F fn) {
    try {
        fn();
        return 0;
    } catch (const J2kError& e) {
        set_error(err, err_len, e.message);
    } catch (const std::exception& e) {  // bad_alloc, length_error
        set_error(err, err_len, std::string("out of memory: ") + e.what());
    }
    return -1;
}

}  // namespace

extern "C" {

// info: width, height, components, image x0, y0, tile width, height, tile
// grid x0, y0, tiles across, down.
int32_t j2k_header(const uint8_t* data, uint64_t size, int64_t* info, char* err, int32_t err_len) {
    return guarded(err, err_len, [&] {
        Codestream cs;
        parse_codestream(data, int64_t(size), cs);
        const int64_t v[11] = {cs.width(), cs.height(), cs.ncomp, cs.xosiz, cs.yosiz, cs.xtsiz, cs.ytsiz,
                               cs.xtosiz, cs.ytosiz, cs.ntx, cs.nty};
        std::memcpy(info, v, sizeof(v));
    });
}

// Decode tiles indices[0..n) of one codestream; tile k goes to out +
// offsets[k] as rows of (tile width x components) bytes. Tiles are shared
// out over n_threads std::thread workers; a single tile's code-blocks are.
int32_t j2k_decode_tiles(const uint8_t* data, uint64_t size, const int32_t* indices, int32_t n, uint8_t* out,
                         const int64_t* offsets, int32_t n_threads, char* err, int32_t err_len) {
    return guarded(err, err_len, [&] {
        Codestream cs;
        parse_codestream(data, int64_t(size), cs);
        for (int k = 0; k < n; ++k)
            if (indices[k] < 0 || indices[k] >= int(cs.tiles.size())) corrupt("tile index " + std::to_string(indices[k]));
        const int outer = std::max(1, std::min<int>(n_threads, n));
        const int inner = std::max(1, n_threads / outer);
        parallel_for(n, outer, [&](int k) {
            int x0, y0, x1, y1;
            cs.tile_bounds(indices[k], x0, y0, x1, y1);
            decode_tile(cs, indices[k], out + offsets[k], int64_t(x1 - x0) * cs.ncomp, inner);
        });
    });
}

// Decode n codestreams held in one blob (stream k at blob + offsets[k],
// sizes[k] bytes), each whole into out + out_offsets[k] (height x width x
// components bytes), on n_threads workers: streams shared out first, then
// a stream's tiles, then a tile's code-blocks. On failure *failed is the
// first failing stream's index.
int32_t j2k_decode_batch(const uint8_t* blob, const int64_t* offsets, const int64_t* sizes, int32_t n, uint8_t* out,
                         const int64_t* out_offsets, int32_t n_threads, int32_t* failed, char* err, int32_t err_len) {
    *failed = -1;
    std::mutex mu;
    return guarded(err, err_len, [&] {
        const int outer = std::max(1, std::min<int>(n_threads, n));
        const int inner = std::max(1, n_threads / outer);
        parallel_for(n, outer, [&](int k) {
            try {
                Codestream cs;
                parse_codestream(blob + offsets[k], sizes[k], cs);
                const int64_t row = int64_t(cs.width()) * cs.ncomp;
                const int ntiles = int(cs.tiles.size());
                const int tile_threads = std::max(1, std::min(inner, ntiles));
                parallel_for(ntiles, tile_threads, [&](int t) {
                    int x0, y0, x1, y1;
                    cs.tile_bounds(t, x0, y0, x1, y1);
                    uint8_t* dst = out + out_offsets[k] + int64_t(y0 - int(cs.yosiz)) * row +
                                   int64_t(x0 - int(cs.xosiz)) * cs.ncomp;
                    decode_tile(cs, t, dst, row, std::max(1, inner / tile_threads));
                });
            } catch (const J2kError& e) {
                std::lock_guard<std::mutex> lock(mu);
                if (*failed < 0 || k < *failed) *failed = k;
                throw J2kError{"stream " + std::to_string(k) + ": " + e.message};
            }
        });
    });
}

}  // extern "C"

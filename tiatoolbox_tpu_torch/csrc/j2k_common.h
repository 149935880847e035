// Tables and helpers shared by the port's JPEG 2000 (ISO/IEC 15444-1)
// decoder (j2kdec.cpp) and encoder (j2kenc.cpp): the marker codes, the MQ
// coder's probability states (Annex C, Table C.2), the context tables of the
// block coder (Annex D, Tables D.1-D.4) and the 9/7 lifting constants as
// OpenJPEG 2.5 defines them (dwt.c), so that both sides lift in the same
// float operations.

#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <vector>

namespace j2k_common {

// Marker codes (Annex A).
inline constexpr uint16_t kSOC = 0xFF4F, kCAP = 0xFF50, kSIZ = 0xFF51, kCOD = 0xFF52,
                          kCOC = 0xFF53, kTLM = 0xFF55, kPLM = 0xFF57, kPLT = 0xFF58,
                          kQCD = 0xFF5C, kQCC = 0xFF5D, kRGN = 0xFF5E, kPOC = 0xFF5F,
                          kPPM = 0xFF60, kPPT = 0xFF61, kCRG = 0xFF63, kCOM = 0xFF64,
                          kSOT = 0xFF90, kSOP = 0xFF91, kEPH = 0xFF92, kSOD = 0xFF93,
                          kEOC = 0xFFD9;

// Progression orders (SGcod byte 0).
enum Progression { kLRCP = 0, kRLCP = 1, kRPCL = 2, kPCRL = 3, kCPRL = 4 };

// Code-block style bits (SPcod byte 3, Table A.19).
inline constexpr int kStyleBypass = 0x01, kStyleReset = 0x02, kStyleTermAll = 0x04,
                     kStyleVertCausal = 0x08, kStylePredTerm = 0x10, kStyleSegSym = 0x20;

// MQ coder probability states (Table C.2): Qe, next state after an MPS,
// next state after an LPS, and whether an LPS switches the MPS sense.
struct MqState {
    uint16_t qe;
    uint8_t nmps, nlps, swtch;
};
inline constexpr MqState kMqStates[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// The 19 contexts of the block coder: 0-8 zero coding, 9-13 sign coding,
// 14-16 magnitude refinement, 17 run length, 18 uniform.
inline constexpr int kNumContexts = 19, kCtxRunLength = 17, kCtxUniform = 18;

// A context: its state index and MPS sense. Every context starts at state 0
// with MPS 0, except uniform (46), run length (3) and zero-coding context 0
// (4) (Table D.7).
struct MqContext {
    uint8_t state, mps;
};
inline void reset_contexts(MqContext* ctx) {
    for (int i = 0; i < kNumContexts; ++i) ctx[i] = {0, 0};
    ctx[kCtxUniform] = {46, 0};
    ctx[kCtxRunLength] = {3, 0};
    ctx[0] = {4, 0};
}

// Per-coefficient state bits of the block coder. The eight neighbour bits
// say which neighbours are significant, the four sign bits the signs of the
// significant horizontal and vertical neighbours.
enum : uint32_t {
    kNW = 1u << 0, kN = 1u << 1, kNE = 1u << 2, kW = 1u << 3, kE = 1u << 4,
    kSW = 1u << 5, kS = 1u << 6, kSE = 1u << 7,
    kSignN = 1u << 8, kSignS = 1u << 9, kSignW = 1u << 10, kSignE = 1u << 11,
    kSig = 1u << 12, kVisited = 1u << 13, kRefined = 1u << 14,
    kNeighbours = 0xFFu,
    // what a coefficient in a stripe's last row ignores in vertically causal mode
    kBelow = kSW | kS | kSE | kSignS,
};

// Band orientations as SIZ/COD order them: LL, HL (horizontally high-pass),
// LH (vertically high-pass), HH.
enum Orientation { kLL = 0, kHL = 1, kLH = 2, kHH = 3 };

// Zero-coding context (Table D.1) of a coefficient from its neighbour bits.
inline int zero_context(int orient, uint32_t f) {
    int h = !!(f & kW) + !!(f & kE);
    int v = !!(f & kN) + !!(f & kS);
    const int d = !!(f & kNW) + !!(f & kNE) + !!(f & kSW) + !!(f & kSE);
    if (orient == kHH) {
        const int hv = h + v;
        if (d >= 3) return 8;
        if (d == 2) return hv >= 1 ? 7 : 6;
        if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
        return hv >= 2 ? 2 : hv;
    }
    if (orient == kHL) {  // the table's HL column: vertical neighbours lead
        const int t = h;
        h = v;
        v = t;
    }
    if (h == 2) return 8;
    if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
    if (v == 2) return 4;
    if (v == 1) return 3;
    return d >= 2 ? 2 : d;
}

// Sign-coding context (Tables D.2, D.3): the context and the bit the decoded
// symbol is XORed with, packed as context | xor << 8.
inline int sign_context(uint32_t f) {
    const int w = (f & kW) ? ((f & kSignW) ? -1 : 1) : 0;
    const int e = (f & kE) ? ((f & kSignE) ? -1 : 1) : 0;
    const int n = (f & kN) ? ((f & kSignN) ? -1 : 1) : 0;
    const int s = (f & kS) ? ((f & kSignS) ? -1 : 1) : 0;
    int h = w + e, v = n + s;
    h = h > 0 ? 1 : (h < 0 ? -1 : 0);
    v = v > 0 ? 1 : (v < 0 ? -1 : 0);
    int xorbit = 0;
    if (h < 0 || (h == 0 && v < 0)) {
        xorbit = 1;
        h = -h;
        v = -v;
    }
    const int ctx = h == 0 ? 9 + (v != 0) : 12 + v;  // (0,0) 9, (0,1) 10, (1,-1) 11, (1,0) 12, (1,1) 13
    return ctx | xorbit << 8;
}

// Magnitude-refinement context (Table D.4).
inline int refine_context(uint32_t f) {
    if (f & kRefined) return 16;
    return (f & kNeighbours) ? 15 : 14;
}

// Lookup tables: zero coding by orientation and neighbour byte, sign coding
// by the 4 neighbour and 4 sign bits.
struct ContextTables {
    uint8_t zero[4][256];
    uint16_t sign[256];
    ContextTables() {
        for (int o = 0; o < 4; ++o)
            for (uint32_t f = 0; f < 256; ++f) zero[o][f] = static_cast<uint8_t>(zero_context(o, f));
        for (uint32_t k = 0; k < 256; ++k) {
            // k bits: N, S, W, E significance then their signs
            uint32_t f = 0;
            if (k & 1) f |= kN;
            if (k & 2) f |= kS;
            if (k & 4) f |= kW;
            if (k & 8) f |= kE;
            if (k & 16) f |= kSignN;
            if (k & 32) f |= kSignS;
            if (k & 64) f |= kSignW;
            if (k & 128) f |= kSignE;
            sign[k] = static_cast<uint16_t>(sign_context(f));
        }
    }
};
inline const ContextTables& context_tables() {
    static const ContextTables tables;
    return tables;
}
inline int sign_index(uint32_t f) {
    return int(!!(f & kN)) | int(!!(f & kS)) << 1 | int(!!(f & kW)) << 2 | int(!!(f & kE)) << 3 |
           int(!!(f & kSignN)) << 4 | int(!!(f & kSignS)) << 5 | int(!!(f & kSignW)) << 6 |
           int(!!(f & kSignE)) << 7;
}

// Marks coefficient (x, y) of a flag plane padded by one on every side
// (row stride `stride`, `fp` at the coefficient) significant with `negative`
// sign, in itself and in its eight neighbours.
inline void set_significant(uint32_t* fp, int stride, bool negative) {
    const uint32_t neg = negative ? ~0u : 0u;
    fp[-stride - 1] |= kSE;
    fp[-stride] |= kS | (neg & kSignS);
    fp[-stride + 1] |= kSW;
    fp[-1] |= kE | (neg & kSignE);
    fp[0] |= kSig;
    fp[1] |= kW | (neg & kSignW);
    fp[stride - 1] |= kNE;
    fp[stride] |= kN | (neg & kSignN);
    fp[stride + 1] |= kNW;
}

// 9/7 lifting constants of OpenJPEG 2.5 (dwt.c): the decoder scales the
// low band by K and the high band by OpenJPEG's opj_c13318 (13318 / 8192,
// near 2/K; with 2/K itself some pixels part from OpenJPEG's by a level)
// before lifting, and the encoder undoes that after its lifting.
inline constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
                       kDelta = 0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;

inline int ceil_div_pow2(int64_t a, int e) { return static_cast<int>((a + (int64_t(1) << e) - 1) >> e); }
inline int floor_div_pow2(int64_t a, int e) { return static_cast<int>(a >> e); }
// floor(log2(v)) for v >= 1
inline int floor_log2(int64_t v) {
    int l = 0;
    while (v > 1) {
        v >>= 1;
        ++l;
    }
    return l;
}

// -- tile-component geometry (Annex B) ----------------------------------------
//
// Resolutions, bands, code-block grids and the code-blocks of each precinct,
// all anchored at the tile's absolute coordinates. The decoder and the
// encoder build the same geometry from the same coding style.

struct BandGeometry {
    int orient = 0;
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;  // band coordinates
    int cbw_exp = 0, cbh_exp = 0;        // code-block size exponents
    int gx0 = 0, gy0 = 0, gw = 0, gh = 0;  // the code-block grid: first cell, cells across and down
    int px = 0, py = 0;                  // top-left in a component buffer's deinterleaved layout
    bool empty() const { return x0 >= x1 || y0 >= y1; }
    // rectangle {x0, y0, x1, y1} of code-block k (raster order), clipped to the band
    void block(int k, int* rect) const {
        const int gx = gx0 + k % gw, gy = gy0 + k / gw;
        rect[0] = std::max(x0, gx << cbw_exp);
        rect[1] = std::max(y0, gy << cbh_exp);
        rect[2] = std::min(x1, (gx + 1) << cbw_exp);
        rect[3] = std::min(y1, (gy + 1) << cbh_exp);
    }
};

struct PrecinctGeometry {  // one band of one precinct
    int cw = 0, ch = 0;    // code-blocks across and down
    std::vector<int> blocks;  // their indices in the band's grid, raster order
};

struct ResolutionGeometry {
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int ppx = 15, ppy = 15, pw = 0, ph = 0;  // precinct exponents, precincts across and down
    std::vector<BandGeometry> bands;         // LL, or HL, LH, HH
    std::vector<std::vector<PrecinctGeometry>> precincts;  // [precinct][band]
};

struct ComponentGeometry {
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<ResolutionGeometry> res;  // the coarsest first
};

// The geometry of tile-component [x0, x1) x [y0, y1) with nl decomposition
// levels, 2^xcb x 2^ycb code-blocks and precinct exponents ppx/ppy for each
// resolution (B-14, B-15; code-blocks no larger than a band's precinct).
inline ComponentGeometry component_geometry(int x0, int y0, int x1, int y1, int nl, int xcb, int ycb,
                                            const int* ppx, const int* ppy) {
    ComponentGeometry g;
    g.x0 = x0;
    g.y0 = y0;
    g.x1 = x1;
    g.y1 = y1;
    g.res.resize(nl + 1);
    for (int r = 0; r <= nl; ++r) {
        ResolutionGeometry& res = g.res[r];
        const int shift = nl - r;
        res.x0 = ceil_div_pow2(x0, shift);
        res.y0 = ceil_div_pow2(y0, shift);
        res.x1 = ceil_div_pow2(x1, shift);
        res.y1 = ceil_div_pow2(y1, shift);
        res.ppx = ppx[r];
        res.ppy = ppy[r];
        const ResolutionGeometry* lo = r > 0 ? &g.res[r - 1] : nullptr;
        res.bands.resize(r == 0 ? 1 : 3);
        for (int b = 0; b < int(res.bands.size()); ++b) {
            BandGeometry& band = res.bands[b];
            band.orient = r == 0 ? kLL : b + 1;
            if (r == 0) {
                band.x0 = res.x0;
                band.y0 = res.y0;
                band.x1 = res.x1;
                band.y1 = res.y1;
            } else {
                const int nb = nl - r + 1;
                const int64_t ox = int64_t(band.orient & 1) << (nb - 1), oy = int64_t(band.orient >> 1) << (nb - 1);
                band.x0 = ceil_div_pow2(x0 - ox, nb);
                band.y0 = ceil_div_pow2(y0 - oy, nb);
                band.x1 = ceil_div_pow2(x1 - ox, nb);
                band.y1 = ceil_div_pow2(y1 - oy, nb);
                band.px = (band.orient & 1) ? lo->x1 - lo->x0 : 0;
                band.py = (band.orient & 2) ? lo->y1 - lo->y0 : 0;
            }
            band.cbw_exp = std::min(xcb, r == 0 ? res.ppx : res.ppx - 1);
            band.cbh_exp = std::min(ycb, r == 0 ? res.ppy : res.ppy - 1);
            if (band.empty()) continue;
            band.gx0 = floor_div_pow2(band.x0, band.cbw_exp);
            band.gy0 = floor_div_pow2(band.y0, band.cbh_exp);
            band.gw = ceil_div_pow2(band.x1, band.cbw_exp) - band.gx0;
            band.gh = ceil_div_pow2(band.y1, band.cbh_exp) - band.gy0;
        }
        if (res.x0 >= res.x1 || res.y0 >= res.y1) continue;  // no precinct, no packet
        const int px0 = floor_div_pow2(res.x0, res.ppx), py0 = floor_div_pow2(res.y0, res.ppy);
        res.pw = ceil_div_pow2(res.x1, res.ppx) - px0;
        res.ph = ceil_div_pow2(res.y1, res.ppy) - py0;
        res.precincts.assign(size_t(res.pw) * res.ph, std::vector<PrecinctGeometry>(res.bands.size()));
        // the precinct grid in band coordinates: halved above resolution 0
        const int bx_exp = r == 0 ? res.ppx : res.ppx - 1, by_exp = r == 0 ? res.ppy : res.ppy - 1;
        for (int pj = 0; pj < res.ph; ++pj)
            for (int pi = 0; pi < res.pw; ++pi) {
                const int64_t cx0 = int64_t(px0 + pi) << bx_exp, cy0 = int64_t(py0 + pj) << by_exp;
                const int64_t cx1 = cx0 + (int64_t(1) << bx_exp), cy1 = cy0 + (int64_t(1) << by_exp);
                for (size_t b = 0; b < res.bands.size(); ++b) {
                    const BandGeometry& band = res.bands[b];
                    PrecinctGeometry& pg = res.precincts[size_t(pj) * res.pw + pi][b];
                    if (band.empty()) continue;
                    const int64_t bx0 = std::max<int64_t>(cx0, band.x0), bx1 = std::min<int64_t>(cx1, band.x1);
                    const int64_t by0 = std::max<int64_t>(cy0, band.y0), by1 = std::min<int64_t>(cy1, band.y1);
                    if (bx0 >= bx1 || by0 >= by1) continue;
                    const int gx0 = floor_div_pow2(bx0, band.cbw_exp), gx1 = ceil_div_pow2(bx1, band.cbw_exp);
                    const int gy0 = floor_div_pow2(by0, band.cbh_exp), gy1 = ceil_div_pow2(by1, band.cbh_exp);
                    pg.cw = gx1 - gx0;
                    pg.ch = gy1 - gy0;
                    for (int gy = gy0; gy < gy1; ++gy)
                        for (int gx = gx0; gx < gx1; ++gx) pg.blocks.push_back((gy - band.gy0) * band.gw + (gx - band.gx0));
                }
            }
    }
    return g;
}

// Coding passes the index-th codeword segment of a code-block may hold
// (B.10.7, as OpenJPEG's t2.c opj_t2_init_seg): one with termination on
// each pass; in bypass mode the first 4 bit-planes' 10 passes, then each
// bit-plane's raw significance and refinement passes, then its MQ cleanup;
// otherwise all of them.
inline int segment_max_passes(int style, int index, int prev_max) {
    if (style & kStyleTermAll) return 1;
    if (style & kStyleBypass) return index == 0 ? 10 : ((prev_max == 1 || prev_max == 10) ? 2 : 1);
    return 109;
}

// -- packet order (B.12.1) ------------------------------------------------------

struct PacketId {
    int layer, res, comp, prec;
};

// The packets of a tile at (tx0, ty0) in progression order `prog`. In the
// position-driven orders each precinct is reached at the reference-grid
// point where B.12.1.3-5's loops first meet it.
inline std::vector<PacketId> packet_order(const std::vector<const ComponentGeometry*>& comps, int prog, int layers,
                                          int tx0, int ty0) {
    const int ncomp = int(comps.size());
    int max_res = 0;
    for (const auto* c : comps) max_res = std::max(max_res, int(c->res.size()));
    std::vector<PacketId> out;
    if (prog == kLRCP || prog == kRLCP) {
        for (int a = 0; a < (prog == kLRCP ? layers : max_res); ++a)
            for (int b = 0; b < (prog == kLRCP ? max_res : layers); ++b)
                for (int c = 0; c < ncomp; ++c) {
                    const int l = prog == kLRCP ? a : b, r = prog == kLRCP ? b : a;
                    if (r >= int(comps[c]->res.size())) continue;
                    const ResolutionGeometry& res = comps[c]->res[r];
                    for (int k = 0; k < res.pw * res.ph; ++k) out.push_back({l, r, c, k});
                }
        return out;
    }
    struct Keyed {
        int64_t k[5];
        PacketId id;
    };
    std::vector<Keyed> keyed;
    for (int c = 0; c < ncomp; ++c) {
        const int nl = int(comps[c]->res.size()) - 1;
        for (int r = 0; r <= nl; ++r) {
            const ResolutionGeometry& res = comps[c]->res[r];
            const int level = nl - r;
            const int px0 = floor_div_pow2(res.x0, res.ppx), py0 = floor_div_pow2(res.y0, res.ppy);
            for (int pj = 0; pj < res.ph; ++pj)
                for (int pi = 0; pi < res.pw; ++pi) {
                    const int64_t y = std::max<int64_t>(ty0, (int64_t(py0 + pj) << res.ppy) << level);
                    const int64_t x = std::max<int64_t>(tx0, (int64_t(px0 + pi) << res.ppx) << level);
                    for (int l = 0; l < layers; ++l) {
                        const PacketId id{l, r, c, pj * res.pw + pi};
                        if (prog == kRPCL) keyed.push_back({{r, y, x, c, l}, id});
                        else if (prog == kPCRL) keyed.push_back({{y, x, c, r, l}, id});
                        else keyed.push_back({{c, y, x, r, l}, id});
                    }
                }
        }
    }
    std::sort(keyed.begin(), keyed.end(), [](const Keyed& a, const Keyed& b) {
        return std::lexicographical_compare(a.k, a.k + 5, b.k, b.k + 5);
    });
    out.reserve(keyed.size());
    for (const auto& k : keyed) out.push_back(k.id);
    return out;
}

// -- tag trees (B.10.2) ------------------------------------------------------------

struct TagTree {
    struct Node {
        int parent, value, low;
        bool known;
    };
    std::vector<Node> nodes;  // the w x h leaves first, then each coarser level
    // A tree over w x h leaves, every value unknown (the decoder's start).
    void init(int w, int h) {
        nodes.clear();
        if (w <= 0 || h <= 0) return;
        std::vector<int> level_w, level_h, start;
        int lw = w, lh = h, total = 0;
        while (true) {
            level_w.push_back(lw);
            level_h.push_back(lh);
            start.push_back(total);
            total += lw * lh;
            if (lw == 1 && lh == 1) break;
            lw = (lw + 1) / 2;
            lh = (lh + 1) / 2;
        }
        nodes.assign(total, {-1, INT_MAX, 0, false});
        for (size_t l = 0; l + 1 < level_w.size(); ++l)
            for (int y = 0; y < level_h[l]; ++y)
                for (int x = 0; x < level_w[l]; ++x)
                    nodes[start[l] + y * level_w[l] + x].parent = start[l + 1] + (y / 2) * level_w[l + 1] + x / 2;
    }
    // The encoder's tree: the leaves' values, each node the least below it.
    void init(int w, int h, const std::vector<int>& leaves) {
        init(w, h);
        for (int i = 0; i < w * h; ++i) nodes[i].value = leaves[i];
        for (size_t i = 0; i < nodes.size(); ++i)
            if (nodes[i].parent >= 0) nodes[nodes[i].parent].value = std::min(nodes[nodes[i].parent].value, nodes[i].value);
    }
};

// One 9/7 lifting step on the interleaved line w of len samples: each
// sample at first, first + 2, ... gets (left + right) * c, a missing
// neighbour mirrored, in OpenJPEG's operation order.
inline void lift97(float* w, int len, int first, float c) {
    for (int p = first; p < len; p += 2) {
        const float l = p > 0 ? w[p - 1] : w[p + 1];
        const float r = p + 1 < len ? w[p + 1] : w[p - 1];
        w[p] = w[p] + ((l + r) * c);
    }
}

// Gain of a band in the reversible path's bit depth (Annex E: log2 of the
// 5/3 analysis gain): LL 0, HL and LH 1, HH 2.
inline int band_gain(int orient) { return orient == kLL ? 0 : (orient == kHH ? 2 : 1); }

}  // namespace j2k_common

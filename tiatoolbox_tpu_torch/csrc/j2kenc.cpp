// The port's JPEG 2000 (ISO/IEC 15444-1) encoder: the role cv2.imencode
// plays in JAX's wsicore/jp2.py:319-384 (encode_tiled_j2k, which stitches
// tiles cv2 encoded one by one into one codestream). This encoder writes one
// codestream with a tile grid directly, each tile coded at its absolute
// coordinates, its tiles on std::thread workers.
//
// Its public use is lossless: the reversible 5/3 transform with RCT, every
// coding pass kept. For tests it also writes what OpenJPEG's decoder must
// read and no stream of cv2's exercises: the irreversible 9/7 transform with
// ICT and expounded quantisation (OpenJPEG's step sizes, dwt.c
// opj_dwt_calc_explicit_stepsizes), several quality layers (the passes of
// each code-block shared out evenly), every progression order, user-defined
// precincts, every code-block style flag (bypass, reset, termination on each
// pass, vertically causal contexts, predictable termination, segmentation
// symbols), SOP and EPH markers, tiles split into several tile-parts, and
// colour components coded without the colour transform (as Aperio's YCbCr
// tiles are).
//
// C interface (ctypes, tiatoolbox_tpu_torch/native/__init__.py):
//   j2k_encode  -> a handle to the codestream (null on error, with a message)
//   j2k_encoded_copy / j2k_encoded_free

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "j2k_common.h"

namespace {

using namespace j2k_common;

struct EncodeError {
    std::string message;
};

// Options, in the order of j2k_encode's int32 array.
struct Options {
    int tile_w, tile_h;     // tile size (the image when 0)
    int levels;             // decomposition levels
    int irreversible;       // 0: 5/3 + RCT, 1: 9/7 + ICT
    int layers;             // quality layers
    int prog;               // progression order
    int cblk_style;         // code-block style bits
    int sop, eph;           // SOP / EPH markers
    int xcb, ycb;           // code-block size exponents
    int packets_per_part;   // packets a tile-part (0: one tile-part a tile)
    int precincts;          // 1: ppx/ppy below are used
    int mct;                // colour transform on 3 components
    int ppx[33], ppy[33];
    double step;            // 9/7 base step, in grey levels
};

// OpenJPEG's 9/7 synthesis norms by orientation and level (dwt.c).
const double kNorms97[4][10] = {
    {1.000, 1.965, 4.177, 8.403, 16.90, 33.84, 67.69, 135.3, 270.6, 540.9},
    {2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 549.0},
    {2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 549.0},
    {2.080, 3.865, 8.307, 17.18, 34.71, 69.59, 139.3, 278.6, 557.2, 557.2}};

struct Step {
    int expn, mant;
};

// Expounded 9/7 step of band b (0 LL, then three a resolution) as OpenJPEG
// derives it: 1/norm of the band times the base step, 13 fraction bits.
Step step97(int b, int nl, double base) {
    const int r = b == 0 ? 0 : (b - 1) / 3 + 1;
    const int orient = b == 0 ? 0 : (b - 1) % 3 + 1;
    const int level = std::min(nl - r, orient == 0 ? 9 : 8);
    const int64_t s = int64_t(std::floor(base / kNorms97[orient][level] * 8192.0));
    if (s <= 0) throw EncodeError{"9/7 step too small"};
    const int p = floor_log2(s) - 13, n = 11 - floor_log2(s);
    Step st;
    st.mant = int((n < 0 ? s >> -n : s << n) & 0x7FF);
    st.expn = 8 - p;
    if (st.expn < 0 || st.expn > 31) throw EncodeError{"9/7 step out of range"};
    return st;
}

float step_value(const Step& s) { return float((1.0 + s.mant / 2048.0) * std::pow(2.0, 8 - s.expn)); }

// -- byte sinks -------------------------------------------------------------------

struct Bytes {
    std::vector<uint8_t> v;
    void u8(int x) { v.push_back(uint8_t(x)); }
    void u16(int x) {
        u8(x >> 8);
        u8(x);
    }
    void u32(uint32_t x) {
        u16(int(x >> 16));
        u16(int(x & 0xFFFF));
    }
    void put(const std::vector<uint8_t>& b) { v.insert(v.end(), b.begin(), b.end()); }
};

struct BitWriter {  // packet headers, with a stuffed bit after each 0xFF
    std::vector<uint8_t>& out;
    uint32_t buf = 0;
    int ct = 8;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void byte_out() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        out.push_back(uint8_t(buf >> 8));
    }
    void bit(int b) {
        if (ct == 0) byte_out();
        --ct;
        buf |= uint32_t(b) << ct;
    }
    void bits(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; --i) bit((v >> i) & 1);
    }
    void flush() {
        byte_out();
        if (ct == 7) byte_out();
    }
};

// -- the MQ coder and the raw (bypass) coder ----------------------------------

struct MqEncoder {
    std::vector<uint8_t>* out = nullptr;  // out->back() is the byte B; out[0] a zero byte before the data
    uint32_t a = 0x8000, c = 0;
    int ct = 12;
    MqContext ctx[kNumContexts];
    // raw coder state
    uint32_t rc = 0;
    int rct = 8;

    void init() {
        a = 0x8000;
        c = 0;
        ct = out->back() == 0xFF ? 13 : 12;
    }
    void byte_out() {
        uint8_t& b = out->back();
        if (b == 0xFF) {
            out->push_back(uint8_t(c >> 20));
            c &= 0xFFFFF;
            ct = 7;
        } else if ((c & 0x8000000) == 0) {
            out->push_back(uint8_t(c >> 19));
            c &= 0x7FFFF;
            ct = 8;
        } else {
            ++b;
            if (b == 0xFF) {
                c &= 0x7FFFFFF;
                out->push_back(uint8_t(c >> 20));
                c &= 0xFFFFF;
                ct = 7;
            } else {
                out->push_back(uint8_t(c >> 19));
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }
    void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) byte_out();
        } while ((a & 0x8000) == 0);
    }
    void encode(int d, int cx) {
        MqContext& s = ctx[cx];
        const MqState& st = kMqStates[s.state];
        const uint32_t qe = st.qe;
        a -= qe;
        if (d == s.mps) {
            if ((a & 0x8000) == 0) {
                if (a < qe) a = qe;
                else c += qe;
                s.state = st.nmps;
                renorm();
            } else {
                c += qe;
            }
        } else {
            if (a < qe) c += qe;
            else a = qe;
            if (st.swtch) s.mps = uint8_t(1 - s.mps);
            s.state = st.nlps;
            renorm();
        }
    }
    // FLUSH (C.2.9): the segment ends at B, or before it when B is 0xFF
    void flush() {
        const uint32_t temp = c + a;
        c |= 0xFFFF;
        if (c >= temp) c -= 0x8000;
        c <<= ct;
        byte_out();
        c <<= ct;
        byte_out();
        if (out->back() == 0xFF) out->pop_back();
    }
    // predictable termination (OpenJPEG's opj_mqc_erterm_enc)
    void erterm() {
        int k = 11 - ct + 1;
        while (k > 0) {
            c <<= ct;
            ct = 0;
            byte_out();
            k -= ct;
        }
        if (out->back() != 0xFF) byte_out();
        out->pop_back();
    }
    void raw_init() {
        rc = 0;
        rct = 8;
    }
    void raw_bit(int d) {
        --rct;
        rc |= uint32_t(d) << rct;
        if (rct == 0) {
            out->push_back(uint8_t(rc));
            rct = out->back() == 0xFF ? 7 : 8;
            rc = 0;
        }
    }
    // pad a partial byte with 0, 1, 0, ...; a final 0xFF goes (the decoder
    // reads ones past the end)
    void raw_flush() {
        if (rct < 8 && !(rct == 7 && out->back() == 0xFF)) {
            int bitv = 0;
            while (rct > 0) {
                --rct;
                rc |= uint32_t(bitv) << rct;
                bitv = 1 - bitv;
            }
            out->push_back(uint8_t(rc));
        }
        if (out->size() > 1 && out->back() == 0xFF) out->pop_back();
        rc = 0;
        rct = 8;
    }
};

// -- tier 1 ------------------------------------------------------------------------

struct Pass {
    int64_t rate;    // bytes of the code-block up to the end of this pass
    bool term;       // the pass ends a codeword segment
};

struct CodeBlock {
    int x0, y0, x1, y1;  // band coordinates
    int numbps = 0;      // coded bit-planes
    std::vector<Pass> passes;
    std::vector<uint8_t> data;
    int first_layer = 0;
    int lblock = 3;
    bool included = false;
    int passes_done = 0;
};

struct BlockCoder {
    int w = 0, h = 0, stride = 0, orient = 0;
    bool vsc = false;
    std::vector<uint32_t> flags, mag;
    std::vector<uint8_t> neg;
    std::vector<uint8_t> buf;
    MqEncoder mq;
    const ContextTables* tables = &context_tables();

    uint32_t* fl(int x, int y) { return &flags[size_t(y + 1) * stride + x + 1]; }
    uint32_t seen(const uint32_t* f, int y) const { return (vsc && (y & 3) == 3) ? (*f & ~uint32_t(kBelow)) : *f; }
    void code(int bitv, int cx, bool raw) {
        if (raw) mq.raw_bit(bitv);
        else mq.encode(bitv, cx);
    }
    void sign(int x, int y, uint32_t s, bool raw) {
        const int negative = neg[size_t(y) * w + x];
        if (raw) mq.raw_bit(negative);
        else {
            const int sc = tables->sign[sign_index(s)];
            mq.encode(negative ^ (sc >> 8), sc & 0xFF);
        }
        set_significant(fl(x, y), stride, negative);
    }
    int bitat(int x, int y, int p) const { return (mag[size_t(y) * w + x] >> p) & 1; }

    void sig_pass(int p, bool raw) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < std::min(y0 + 4, h); ++y) {
                    uint32_t* f = fl(x, y);
                    const uint32_t s = seen(f, y);
                    if ((*f & kSig) || !(s & kNeighbours)) continue;
                    const int v = bitat(x, y, p);
                    code(v, tables->zero[orient][s & kNeighbours], raw);
                    if (v) sign(x, y, s, raw);
                    *f |= kVisited;
                }
    }
    void ref_pass(int p, bool raw) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < std::min(y0 + 4, h); ++y) {
                    uint32_t* f = fl(x, y);
                    if ((*f & (kSig | kVisited)) != kSig) continue;
                    code(bitat(x, y, p), refine_context(seen(f, y)), raw);
                    *f |= kRefined;
                }
    }
    void clean_pass(int p, bool segsym) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x) {
                int y = y0;
                const int y1 = std::min(y0 + 4, h);
                if (y1 - y0 == 4) {
                    bool run = true;
                    for (int k = y0; k < y1 && run; ++k) {
                        const uint32_t* f = fl(x, k);
                        run = !(*f & (kSig | kVisited)) && !(seen(f, k) & kNeighbours);
                    }
                    if (run) {
                        int first = 4;
                        for (int k = 0; k < 4; ++k)
                            if (bitat(x, y0 + k, p)) {
                                first = k;
                                break;
                            }
                        mq.encode(first < 4, kCtxRunLength);
                        if (first == 4) continue;
                        mq.encode(first >> 1, kCtxUniform);
                        mq.encode(first & 1, kCtxUniform);
                        y = y0 + first;
                        sign(x, y, seen(fl(x, y), y), false);
                        ++y;
                    }
                }
                for (; y < y1; ++y) {
                    uint32_t* f = fl(x, y);
                    if (*f & (kSig | kVisited)) continue;
                    const uint32_t s = seen(f, y);
                    const int v = bitat(x, y, p);
                    mq.encode(v, tables->zero[orient][s & kNeighbours]);
                    if (v) sign(x, y, s, false);
                }
                for (int k = y0; k < y1; ++k) *fl(x, k) &= ~uint32_t(kVisited);
            }
        if (segsym) {
            mq.encode(1, kCtxUniform);
            mq.encode(0, kCtxUniform);
            mq.encode(1, kCtxUniform);
            mq.encode(0, kCtxUniform);
        }
    }

    // Code the block's coefficients (`q`, w x h, quantised integers); `mb`
    // is its band's bit-plane count.
    void encode(CodeBlock& cb, const int32_t* q, int qstride, int orient_, int style, int mb) {
        w = cb.x1 - cb.x0;
        h = cb.y1 - cb.y0;
        stride = w + 2;
        orient = orient_;
        vsc = style & kStyleVertCausal;
        flags.assign(size_t(w + 2) * (h + 2), 0);
        mag.resize(size_t(w) * h);
        neg.resize(size_t(w) * h);
        uint32_t top = 0;
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                const int32_t v = q[size_t(y) * qstride + x];
                const uint32_t m = uint32_t(v < 0 ? -int64_t(v) : v);
                mag[size_t(y) * w + x] = m;
                neg[size_t(y) * w + x] = v < 0;
                top |= m;
            }
        cb.numbps = top ? floor_log2(top) + 1 : 0;
        if (cb.numbps > mb) throw EncodeError{"a coefficient needs more bit-planes than its band has guard bits for"};
        cb.passes.clear();
        cb.data.clear();
        if (cb.numbps == 0) return;
        buf.assign(1, 0);  // the byte before the data
        mq.out = &buf;
        reset_contexts(mq.ctx);
        mq.init();
        const int npasses = 1 + 3 * (cb.numbps - 1);
        int p = cb.numbps - 1, passtype = 2;
        bool raw_prev = false;
        for (int k = 0; k < npasses; ++k) {
            const bool raw = (style & kStyleBypass) && p < cb.numbps - 4 && passtype < 2;
            if (k > 0 && raw != raw_prev) {  // a coder change opens a segment
                if (raw) mq.raw_init();
                else mq.init();
            }
            if (passtype == 0) sig_pass(p, raw);
            else if (passtype == 1) ref_pass(p, raw);
            else clean_pass(p, style & kStyleSegSym);
            // does this pass end a segment?
            bool term = k == npasses - 1 || (style & kStyleTermAll);
            if (!term && (style & kStyleBypass)) {
                const int next_type = passtype == 2 ? 0 : passtype + 1;
                const int next_p = passtype == 2 ? p - 1 : p;
                const bool next_raw = next_p < cb.numbps - 4 && next_type < 2;
                term = next_raw != raw;
            }
            if (term) {
                if (raw) mq.raw_flush();
                else if (style & kStylePredTerm) mq.erterm();
                else mq.flush();
                cb.passes.push_back({int64_t(buf.size()) - 1, true});
                if (k + 1 < npasses) {
                    if (raw) mq.raw_init();
                    else mq.init();
                }
            } else {
                cb.passes.push_back({int64_t(buf.size()) - 1, false});
            }
            raw_prev = raw;
            if ((style & kStyleReset) && !raw) reset_contexts(mq.ctx);
            if (++passtype == 3) {
                passtype = 0;
                --p;
            }
        }
        cb.data.assign(buf.begin() + 1, buf.end());
        // a pass inside a segment ends where its bytes so far do, at most at
        // its segment's end; rates never decrease
        int64_t seg_end = int64_t(cb.data.size());
        for (int k = npasses - 1; k >= 0; --k) {
            if (cb.passes[k].term) seg_end = cb.passes[k].rate;
            else cb.passes[k].rate = std::min(cb.passes[k].rate, seg_end);
        }
        for (int k = 1; k < npasses; ++k) cb.passes[k].rate = std::max(cb.passes[k].rate, cb.passes[k - 1].rate);
    }
};

// -- forward transforms -------------------------------------------------------------

void fdwt53_line(int32_t* x, int32_t* tmp, int len, int cas) {
    if (len <= 0) return;
    if (len == 1) {
        if (cas) x[0] *= 2;
        return;
    }
    std::memcpy(tmp, x, sizeof(int32_t) * size_t(len));
    for (int p = 1 - cas; p < len; p += 2) {  // high-pass samples
        const int32_t l = p > 0 ? tmp[p - 1] : tmp[p + 1];
        const int32_t r = p + 1 < len ? tmp[p + 1] : tmp[p - 1];
        tmp[p] -= (l + r) >> 1;
    }
    for (int p = cas; p < len; p += 2) {  // low-pass samples
        const int32_t l = p > 0 ? tmp[p - 1] : tmp[p + 1];
        const int32_t r = p + 1 < len ? tmp[p + 1] : tmp[p - 1];
        tmp[p] += (l + r + 2) >> 2;
    }
    int k = 0;
    for (int p = cas; p < len; p += 2) x[k++] = tmp[p];
    for (int p = 1 - cas; p < len; p += 2) x[k++] = tmp[p];
}

void fdwt97_line(float* x, float* tmp, int len, int cas) {
    if (len <= 1) return;
    std::memcpy(tmp, x, sizeof(float) * size_t(len));
    lift97(tmp, len, 1 - cas, kAlpha);
    lift97(tmp, len, cas, kBeta);
    lift97(tmp, len, 1 - cas, kGamma);
    lift97(tmp, len, cas, kDelta);
    int k = 0;
    for (int p = cas; p < len; p += 2) x[k++] = tmp[p] / kK;
    for (int p = 1 - cas; p < len; p += 2) x[k++] = tmp[p] / kTwoInvK;
}

// Forward transform of a tile component held in `buf` (stride `stride`),
// columns then rows at each level, the finest first.
template <typename T, typename Line>
void fdwt_2d(T* buf, int stride, const ComponentGeometry& g, Line line) {
    std::vector<T> col(std::max(g.x1 - g.x0, g.y1 - g.y0) + 1), tmp(col.size());
    for (int r = int(g.res.size()) - 1; r >= 1; --r) {
        const ResolutionGeometry& res = g.res[r];
        const int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
        const int casx = res.x0 & 1, casy = res.y0 & 1;
        for (int x = 0; x < rw; ++x) {
            for (int y = 0; y < rh; ++y) col[y] = buf[size_t(y) * stride + x];
            line(col.data(), tmp.data(), rh, casy);
            for (int y = 0; y < rh; ++y) buf[size_t(y) * stride + x] = col[y];
        }
        for (int y = 0; y < rh; ++y) line(buf + size_t(y) * stride, tmp.data(), rw, casx);
    }
}

// -- tile structure and tier 2 --------------------------------------------------------

void tag_encode(BitWriter& bw, TagTree& tree, int leaf, int threshold) {
    int stack[32], depth = 0, node = leaf;
    while (tree.nodes[node].parent >= 0) {
        stack[depth++] = node;
        node = tree.nodes[node].parent;
    }
    int low = 0;
    while (true) {
        TagTree::Node& nd = tree.nodes[node];
        if (low > nd.low) nd.low = low;
        else low = nd.low;
        while (low < threshold) {
            if (low >= nd.value) {
                if (!nd.known) {
                    bw.bit(1);
                    nd.known = true;
                }
                break;
            }
            bw.bit(0);
            ++low;
        }
        nd.low = low;
        if (depth == 0) break;
        node = stack[--depth];
    }
}

struct TagPair {  // one band of one precinct
    TagTree incl, zbp;
};

struct Component {
    const ComponentGeometry* geom;
    std::vector<std::vector<std::vector<CodeBlock>>> blocks;  // [resolution][band][k]
    std::vector<std::vector<std::vector<TagPair>>> trees;     // [resolution][precinct][band]
    std::vector<int32_t> q;  // quantised coefficients, deinterleaved, tile width stride
};

void write_packet(Component& comp, int r, int prec, int layer, const Options& o, int seq, Bytes& out) {
    const std::vector<PrecinctGeometry>& pgs = comp.geom->res[r].precincts[prec];
    std::vector<TagPair>& trees = comp.trees[r][prec];
    if (o.sop) {
        out.u16(kSOP);
        out.u16(4);
        out.u16(seq & 0xFFFF);
    }
    struct Contribution {
        CodeBlock* cb;
        int from, to;
    };
    std::vector<Contribution> contribs;
    for (size_t b = 0; b < pgs.size(); ++b)
        for (int k : pgs[b].blocks) {
            CodeBlock& cb = comp.blocks[r][b][k];
            const int n = int(cb.passes.size());
            const int from = int(int64_t(n) * layer / o.layers), to = int(int64_t(n) * (layer + 1) / o.layers);
            if (to > from) contribs.push_back({&cb, from, to});
        }
    std::vector<uint8_t> head;
    BitWriter bw(head);
    if (contribs.empty()) {
        bw.bit(0);
    } else {
        bw.bit(1);
        for (size_t b = 0; b < pgs.size(); ++b) {
            for (size_t k = 0; k < pgs[b].blocks.size(); ++k) {
                CodeBlock& cb = comp.blocks[r][b][pgs[b].blocks[k]];
                const int n = int(cb.passes.size());
                const int from = int(int64_t(n) * layer / o.layers), to = int(int64_t(n) * (layer + 1) / o.layers);
                const bool inc = to > from;
                if (!cb.included) tag_encode(bw, trees[b].incl, int(k), layer + 1);
                else bw.bit(inc);
                if (!inc) continue;
                if (!cb.included) {
                    tag_encode(bw, trees[b].zbp, int(k), 999);
                    cb.included = true;
                }
                const int np = to - from;
                if (np == 1) bw.bit(0);
                else if (np == 2) bw.bits(2, 2);
                else if (np <= 5) bw.bits(0xC | (np - 3), 4);
                else if (np <= 36) bw.bits(0x1E0 | (np - 6), 9);
                else bw.bits((0x1FF << 7) | (np - 37), 16);
                // segments touched by passes [from, to): each ends at a
                // terminated pass or at `to`
                std::vector<std::pair<int, int64_t>> segs;  // passes, bytes
                int seg_index = 0, seg_max = 0, in_seg = 0;
                {
                    // walk the segments from the block's first pass to know where `from` falls
                    int pass = 0;
                    seg_max = segment_max_passes(o.cblk_style, 0, 0);
                    while (pass < from) {
                        ++in_seg;
                        ++pass;
                        if (in_seg == seg_max) {
                            ++seg_index;
                            seg_max = segment_max_passes(o.cblk_style, seg_index, seg_max);
                            in_seg = 0;
                        }
                    }
                }
                int64_t start = from > 0 ? cb.passes[from - 1].rate : 0;
                int count = 0;
                for (int pass = from; pass < to; ++pass) {
                    ++count;
                    ++in_seg;
                    const bool seg_end = in_seg == seg_max;
                    if (seg_end || pass == to - 1) {
                        segs.push_back({count, cb.passes[pass].rate - start});
                        start = cb.passes[pass].rate;
                        count = 0;
                    }
                    if (seg_end) {
                        ++seg_index;
                        seg_max = segment_max_passes(o.cblk_style, seg_index, seg_max);
                        in_seg = 0;
                    }
                }
                int lblock = cb.lblock;
                for (const auto& s : segs) {
                    int need = 1;
                    while ((s.second >> need) != 0) ++need;
                    lblock = std::max(lblock, need - floor_log2(s.first));
                }
                for (int i = cb.lblock; i < lblock; ++i) bw.bit(1);
                bw.bit(0);
                cb.lblock = lblock;
                for (const auto& s : segs) bw.bits(uint32_t(s.second), lblock + floor_log2(s.first));
            }
        }
    }
    bw.flush();
    out.put(head);
    if (o.eph) out.u16(kEPH);
    for (const auto& c : contribs) {
        const int64_t a = c.from > 0 ? c.cb->passes[c.from - 1].rate : 0;
        const int64_t b = c.cb->passes[c.to - 1].rate;
        out.v.insert(out.v.end(), c.cb->data.begin() + a, c.cb->data.begin() + b);
    }
}

// Encode tile t's pixels (`img`, h x w x nc) into its tile-parts.
std::vector<uint8_t> encode_tile(const uint8_t* img, int W, int H, int nc, const Options& o, int t, int ntx,
                                 const std::vector<Step>& steps) {
    const int i = t % ntx, j = t / ntx;
    const int tx0 = i * o.tile_w, ty0 = j * o.tile_h;
    const int tx1 = std::min(W, tx0 + o.tile_w), ty1 = std::min(H, ty0 + o.tile_h);
    const int tw = tx1 - tx0, th = ty1 - ty0;
    const size_t npix = size_t(tw) * th;
    const bool mct = nc == 3 && o.mct;
    int ppx[33], ppy[33];
    for (int r = 0; r < 33; ++r) {
        ppx[r] = o.precincts ? o.ppx[r] : 15;
        ppy[r] = o.precincts ? o.ppy[r] : 15;
    }
    const ComponentGeometry geom = component_geometry(tx0, ty0, tx1, ty1, o.levels, o.xcb, o.ycb, ppx, ppy);
    std::vector<Component> comps(nc);
    // colour transform and level shift, then the forward transform
    if (!o.irreversible) {
        std::vector<std::vector<int32_t>> plane(nc, std::vector<int32_t>(npix));
        for (int y = 0; y < th; ++y)
            for (int x = 0; x < tw; ++x) {
                const uint8_t* px = img + (size_t(ty0 + y) * W + tx0 + x) * nc;
                const size_t k = size_t(y) * tw + x;
                if (mct) {
                    const int r = px[0] - 128, g = px[1] - 128, b = px[2] - 128;
                    plane[0][k] = (r + 2 * g + b) >> 2;
                    plane[1][k] = b - g;
                    plane[2][k] = r - g;
                } else {
                    for (int c = 0; c < nc; ++c) plane[c][k] = px[c] - 128;
                }
            }
        for (int c = 0; c < nc; ++c) {
            fdwt_2d(plane[c].data(), tw, geom, fdwt53_line);
            comps[c].q = std::move(plane[c]);
        }
    } else {
        std::vector<std::vector<float>> plane(nc, std::vector<float>(npix));
        for (int y = 0; y < th; ++y)
            for (int x = 0; x < tw; ++x) {
                const uint8_t* px = img + (size_t(ty0 + y) * W + tx0 + x) * nc;
                const size_t k = size_t(y) * tw + x;
                if (mct) {
                    const float r = float(px[0] - 128), g = float(px[1] - 128), b = float(px[2] - 128);
                    plane[0][k] = r * 0.299f + g * 0.587f + b * 0.114f;
                    plane[1][k] = -r * 0.16875f - g * 0.331260f + b * 0.5f;
                    plane[2][k] = r * 0.5f - g * 0.41869f - b * 0.08131f;
                } else {
                    for (int c = 0; c < nc; ++c) plane[c][k] = float(px[c] - 128);
                }
            }
        // forward transform, then each band quantised with its step
        for (int c = 0; c < nc; ++c) {
            fdwt_2d(plane[c].data(), tw, geom, fdwt97_line);
            comps[c].q.assign(npix, 0);
            for (size_t r = 0; r < geom.res.size(); ++r)
                for (size_t b = 0; b < geom.res[r].bands.size(); ++b) {
                    const BandGeometry& band = geom.res[r].bands[b];
                    const float delta = step_value(steps[r == 0 ? 0 : 3 * (r - 1) + b + 1]);
                    for (int y = 0; y < band.y1 - band.y0; ++y)
                        for (int x = 0; x < band.x1 - band.x0; ++x) {
                            const size_t k = size_t(band.py + y) * tw + band.px + x;
                            const float v = plane[c][k];
                            const int32_t m = int32_t(std::floor(std::fabs(v) / delta));
                            comps[c].q[k] = v < 0 ? -m : m;
                        }
                }
        }
    }
    // tier 1, then the precincts' tag trees
    BlockCoder coder;
    const int guard = 2;
    for (int c = 0; c < nc; ++c) {
        Component& comp = comps[c];
        comp.geom = &geom;
        comp.blocks.resize(geom.res.size());
        comp.trees.resize(geom.res.size());
        for (size_t r = 0; r < geom.res.size(); ++r) {
            const ResolutionGeometry& res = geom.res[r];
            std::vector<int> mb(res.bands.size());
            comp.blocks[r].resize(res.bands.size());
            for (size_t b = 0; b < res.bands.size(); ++b) {
                const BandGeometry& band = res.bands[b];
                const int index = r == 0 ? 0 : 3 * (int(r) - 1) + int(b) + 1;
                mb[b] = (o.irreversible ? steps[index].expn : 8 + band_gain(band.orient)) + guard - 1;
                std::vector<CodeBlock>& blocks = comp.blocks[r][b];
                blocks.resize(size_t(band.gw) * band.gh);
                for (int k = 0; k < int(blocks.size()); ++k) {
                    int rect[4];
                    band.block(k, rect);
                    CodeBlock& cb = blocks[k];
                    cb.x0 = rect[0];
                    cb.y0 = rect[1];
                    cb.x1 = rect[2];
                    cb.y1 = rect[3];
                    const int32_t* q = comp.q.data() + size_t(band.py + cb.y0 - band.y0) * tw + band.px + cb.x0 - band.x0;
                    coder.encode(cb, q, tw, band.orient, o.cblk_style, mb[b]);
                }
            }
            comp.trees[r].resize(res.precincts.size());
            for (size_t p = 0; p < res.precincts.size(); ++p) {
                comp.trees[r][p].resize(res.bands.size());
                for (size_t b = 0; b < res.bands.size(); ++b) {
                    const PrecinctGeometry& pg = res.precincts[p][b];
                    std::vector<int> incl, zbp;
                    for (int k : pg.blocks) {
                        const CodeBlock& cb = comp.blocks[r][b][k];
                        const int n = int(cb.passes.size());
                        int first = o.layers;  // never, for a block with no pass
                        for (int l = 0; l < o.layers; ++l)
                            if (int64_t(n) * (l + 1) / o.layers > int64_t(n) * l / o.layers) {
                                first = l;
                                break;
                            }
                        incl.push_back(first);
                        zbp.push_back(mb[b] - cb.numbps);
                    }
                    comp.trees[r][p][b].incl.init(pg.cw, pg.ch, incl);
                    comp.trees[r][p][b].zbp.init(pg.cw, pg.ch, zbp);
                }
            }
        }
    }
    // tier 2: packets, then tile-parts
    std::vector<std::vector<uint8_t>> packets;
    int seq = 0;
    const std::vector<const ComponentGeometry*> geoms(nc, &geom);
    for (const PacketId& id : packet_order(geoms, o.prog, o.layers, tx0, ty0)) {
        Bytes pk;
        write_packet(comps[id.comp], id.res, id.prec, id.layer, o, seq++, pk);
        packets.push_back(std::move(pk.v));
    }
    const int per_part = o.packets_per_part > 0 ? o.packets_per_part : int(packets.size()) + 1;
    const int nparts = std::max(1, (int(packets.size()) + per_part - 1) / per_part);
    Bytes out;
    for (int part = 0; part < nparts; ++part) {
        Bytes body;
        for (int k = part * per_part; k < std::min<int>(int(packets.size()), (part + 1) * per_part); ++k) body.put(packets[k]);
        out.u16(kSOT);
        out.u16(10);
        out.u16(t);
        out.u32(uint32_t(12 + 2 + body.v.size()));
        out.u8(part);
        out.u8(nparts);
        out.u16(kSOD);
        out.put(body.v);
    }
    return out.v;
}

std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int nc, Options o, int threads) {
    if (W <= 0 || H <= 0) throw EncodeError{"empty image"};
    if (nc != 1 && nc != 3) throw EncodeError{"1 or 3 components expected"};
    if (o.mct && nc != 3) throw EncodeError{"a colour transform needs 3 components"};
    if (o.tile_w <= 0) o.tile_w = W;
    if (o.tile_h <= 0) o.tile_h = H;
    if (o.levels < 0 || o.levels > 32) throw EncodeError{"decomposition levels must be 0-32"};
    if (o.layers < 1 || o.layers > 65535) throw EncodeError{"layers must be 1-65535"};
    if (o.prog < 0 || o.prog > 4) throw EncodeError{"unknown progression order"};
    if (o.xcb < 2 || o.ycb < 2 || o.xcb > 10 || o.ycb > 10 || o.xcb + o.ycb > 12)
        throw EncodeError{"code-block size out of range"};
    if (o.cblk_style & ~0x3F) throw EncodeError{"unknown code-block style bits"};
    if (o.precincts)
        for (int r = 0; r <= o.levels; ++r)
            if (o.ppx[r] < 0 || o.ppx[r] > 15 || o.ppy[r] < 0 || o.ppy[r] > 15 || (r > 0 && (o.ppx[r] < 1 || o.ppy[r] < 1)))
                throw EncodeError{"precinct size out of range"};
    const int ntx = (W + o.tile_w - 1) / o.tile_w, nty = (H + o.tile_h - 1) / o.tile_h;
    if (int64_t(ntx) * nty > 65535) throw EncodeError{"more than 65535 tiles"};
    std::vector<Step> steps;
    if (o.irreversible)
        for (int b = 0; b < 3 * o.levels + 1; ++b) steps.push_back(step97(b, o.levels, o.step));
    Bytes head;
    head.u16(kSOC);
    head.u16(kSIZ);
    head.u16(38 + 3 * nc);
    head.u16(0);
    head.u32(W);
    head.u32(H);
    head.u32(0);
    head.u32(0);
    head.u32(o.tile_w);
    head.u32(o.tile_h);
    head.u32(0);
    head.u32(0);
    head.u16(nc);
    for (int c = 0; c < nc; ++c) {
        head.u8(7);
        head.u8(1);
        head.u8(1);
    }
    head.u16(kCOD);
    head.u16(12 + (o.precincts ? o.levels + 1 : 0));
    head.u8((o.precincts ? 1 : 0) | (o.sop ? 2 : 0) | (o.eph ? 4 : 0));
    head.u8(o.prog);
    head.u16(o.layers);
    head.u8(nc == 3 && o.mct ? 1 : 0);
    head.u8(o.levels);
    head.u8(o.xcb - 2);
    head.u8(o.ycb - 2);
    head.u8(o.cblk_style);
    head.u8(o.irreversible ? 0 : 1);
    if (o.precincts)
        for (int r = 0; r <= o.levels; ++r) head.u8(o.ppy[r] << 4 | o.ppx[r]);
    const int nbands = 3 * o.levels + 1;
    head.u16(kQCD);
    if (o.irreversible) {
        head.u16(3 + 2 * nbands);
        head.u8(2 << 5 | 2);
        for (const Step& s : steps) head.u16(s.expn << 11 | s.mant);
    } else {
        head.u16(3 + nbands);
        head.u8(2 << 5);
        for (int b = 0; b < nbands; ++b) head.u8((8 + band_gain(b == 0 ? 0 : (b - 1) % 3 + 1)) << 3);
    }
    const int ntiles = ntx * nty;
    std::vector<std::vector<uint8_t>> tiles(ntiles);
    std::atomic<int> next{0};
    std::mutex mu;
    std::string err;
    auto work = [&] {
        try {
            for (int t; (t = next.fetch_add(1)) < ntiles;) tiles[t] = encode_tile(img, W, H, nc, o, t, ntx, steps);
        } catch (const EncodeError& e) {
            std::lock_guard<std::mutex> lock(mu);
            if (err.empty()) err = e.message;
            next.store(ntiles);
        } catch (const std::exception& e) {  // bad_alloc, length_error
            std::lock_guard<std::mutex> lock(mu);
            if (err.empty()) err = std::string("out of memory: ") + e.what();
            next.store(ntiles);
        }
    };
    const int n = std::max(1, std::min(threads, ntiles));
    if (n == 1) work();
    else {
        std::vector<std::thread> pool;
        for (int k = 0; k < n; ++k) pool.emplace_back(work);
        for (auto& th : pool) th.join();
    }
    if (!err.empty()) throw EncodeError{err};
    for (auto& t : tiles) head.put(t);
    head.u16(kEOC);
    return head.v;
}

}  // namespace

extern "C" {

// opts: 14 + 66 int32 in Options' order (ppx[33] then ppy[33] last);
// step: the 9/7 base step. Returns a handle to the codestream, or null with
// a message in err.
void* j2k_encode(const uint8_t* img, int32_t h, int32_t w, int32_t nc, const int32_t* opts, double step,
                 int32_t n_threads, int64_t* size, char* err, int32_t err_len) {
    try {
        Options o;
        o.tile_w = opts[0];
        o.tile_h = opts[1];
        o.levels = opts[2];
        o.irreversible = opts[3];
        o.layers = opts[4];
        o.prog = opts[5];
        o.cblk_style = opts[6];
        o.sop = opts[7];
        o.eph = opts[8];
        o.xcb = opts[9];
        o.ycb = opts[10];
        o.packets_per_part = opts[11];
        o.precincts = opts[12];
        o.mct = opts[13];
        for (int r = 0; r < 33; ++r) {
            o.ppx[r] = opts[14 + r];
            o.ppy[r] = opts[14 + 33 + r];
        }
        o.step = step;
        auto* out = new std::vector<uint8_t>(encode(img, h, w, nc, o, n_threads));
        *size = int64_t(out->size());
        return out;
    } catch (const EncodeError& e) {
        if (err && err_len > 0) {
            const size_t n = std::min<size_t>(e.message.size(), size_t(err_len) - 1);
            std::memcpy(err, e.message.data(), n);
            err[n] = 0;
        }
    } catch (const std::exception& e) {  // bad_alloc, length_error
        if (err && err_len > 0) std::snprintf(err, size_t(err_len), "out of memory: %s", e.what());
    }
    return nullptr;
}

void j2k_encoded_copy(const void* handle, uint8_t* out) {
    const auto* v = static_cast<const std::vector<uint8_t>*>(handle);
    std::memcpy(out, v->data(), v->size());
}

void j2k_encoded_free(void* handle) { delete static_cast<std::vector<uint8_t>*>(handle); }

}  // extern "C"

// A JPEG 2000 (ITU-T T.800 | ISO/IEC 15444-1) codestream decoder: the
// samples OpenJPEG 2.5.4 gives Pillow's JPEG 2000 plugin, tile by tile,
// before Pillow's unpacking (data/jpeg2000.py does that in numpy, and
// native/imgdec.cpp's j2k_subsampled for sub-sampled components).
//
// Covered: the main and tile-part headers (SIZ, COD/COC, QCD/QCC, RGN,
// POC, COM, TLM, PLM, PLT, CRG, PPM/PPT, SOP/EPH, CAP and CPF, Part 2's
// MCT, MCC, MCO and CBD, SOT/SOD, EOC; unknown markers skipped two bytes
// at a time, as OpenJPEG does), image and tile offsets, sub-sampled
// components, any number of tiles and tile-parts, the five progression
// orders and POC changes, precincts, quality layers, tag-tree packet
// headers with a codeword segment list a code-block, the MQ and raw
// (bypass) decoders with the significance, refinement and cleanup passes of
// EBCOT tier 1 at any code-block size and under every code-block style but
// HT (bypass, context reset, termination on each pass, vertically causal
// contexts, predictable termination, segmentation symbols), ROI max-shift,
// no / scalar derived / scalar expounded quantization, the integer 5/3 and
// the float 9/7 inverse wavelets, RCT and ICT, the DC level shift and
// clamping.
//
// Where OpenJPEG's arithmetic sets bits, it is followed:
// * tier 1 keeps one fractional bit: a coefficient that becomes
//   significant at bit-plane p holds 3 << (p - 1) (in units of half the
//   bit-plane's weight) and a refinement adds or takes half a step; the
//   reversible path divides by 2 (C division), the irreversible one
//   multiplies by 0.5f * step in float;
// * the irreversible step Delta_b = (1 + mu / 2048) * 2^(R_b - eps) is
//   computed in double with R_b = precision (no sub-band gain: OpenJPEG
//   puts the gain into the wavelet's 2/K, its "BUG_WEIRD_TWO_INVK"), then
//   rounded to float;
// * the 9/7 lifting is opj_v8dwt_decode's: low * K, high * 1.625732422f,
//   then x += (left + right) * c for c = -delta, -gamma, -beta, -alpha,
//   mirrored at the ends; a one-sample signal is left as it is; rows
//   first, then columns, one resolution at a time;
// * the ICT is opj_mct_decode_real's (1.402f, 0.34413f, 0.71414f,
//   1.772f), the DC shift rounds floats with lrintf and clamps in 64 bits;
// * each codeword segment is decoded on its own bytes followed by two
//   0xFF bytes (opj_mqc_init_dec's artificial marker), so a segment that
//   runs dry reads 1 bits; a bypass segment is raw when its first pass is a
//   significance or refinement pass and bpno_plus_one <= numbps - 4, with
//   numbps the bit-planes below the ROI shift; the segmentation symbols are
//   decoded and not checked; an ROI coefficient is one whose magnitude,
//   with the fractional bit, is at least 2^SPrgn, and is shifted down before
//   the dequantization;
// * the DC level shift is SIZ's 2^(prec - 1) unless an MCO segment set it
//   (zero, or an MCC offset array's values); a CBD segment changes the
//   precision and sign the clamp and the 9/7 steps use, not the shift; the
//   colour transform of components with different wavelets reads each
//   one's words as component 0's type, as OpenJPEG's single buffer does.
// Build with -ffp-contract=off (utils/native.py does) so that no FMA joins
// a multiply and an add, and -pthread: tiles, or else a tile's code-blocks
// and components, decode on a pool of threads kept for the process; each
// job writes its own samples, so the bits do not depend on the threads.
//
// Not ported (it raises "not ported"): HT (Part 15) code-blocks, for want
// of Part 15's VLC tables.
//
// C interface (ctypes):
//   int64_t j2k_info(const uint8_t *cs, int64_t n, int64_t *info,
//                    int64_t cap, char *err, int64_t errlen)
//     reads the main header; info = [X0, Y0, X1, Y1, ncomp, then per
//     component prec, signed, dx, dy (after CBD), as many as cap holds];
//     returns ncomp, or -1 (malformed: OpenJPEG refuses it) / -2 (not
//     ported) with a message in err.
//   int64_t j2k_decode_tiles(const uint8_t *cs, int64_t n, int32_t *out,
//                            int32_t *order, char *err, int64_t errlen)
//     decodes every tile into out: per component, in order, a plane of
//     (ceil(Y1 / dy) - ceil(Y0 / dy)) x (ceil(X1 / dx) - ceil(X0 / dx))
//     int32 samples (after the DC shift and clamp); order (one int32 a
//     tile of the grid) gets the tiles' indices in the order of their last
//     tile-part, then -1s; 0, -1 or -2 as above.
//   int64_t j2k_decode(const uint8_t *cs, int64_t n, int32_t *out,
//                      char *err, int64_t errlen)
//     j2k_decode_tiles without the order.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <memory>
#include <mutex>
#include <condition_variable>
#include <functional>
#include <string>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>
#include <unistd.h>
#if defined(__x86_64__)
#include <xmmintrin.h>
#endif

namespace {

struct Error {
    int kind;  // 1: malformed, 2: not ported
    std::string msg;
};

[[noreturn]] void bad(const std::string &m) { throw Error{1, m}; }
[[noreturn]] void todo(const std::string &m) { throw Error{2, m}; }

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
int64_t floordivpow2(int64_t a, int b) { return a >> b; }
int floorlog2(uint32_t v) {
    int l = 0;
    while (v > 1) { v >>= 1; ++l; }
    return l;
}

struct Reader {
    const uint8_t *d;
    int64_t n, pos;
    void need(int64_t k) const {
        if (pos + k > n) bad("JPEG 2000 codestream ends inside a marker segment");
    }
    uint32_t u8() { need(1); return d[pos++]; }
    uint32_t u16() { need(2); uint32_t v = (d[pos] << 8) | d[pos + 1]; pos += 2; return v; }
    uint32_t u32() { uint32_t a = u16(); return (a << 16) | u16(); }
};

// ------------------------------------------------------------ parameters
struct Coding {
    int levels = 0, xcb = 6, ycb = 6, style = 0, qmfbid = 1;
    int ppx[33], ppy[33];
    Coding() { for (int i = 0; i < 33; ++i) ppx[i] = ppy[i] = 15; }
};

struct Quant {
    int style = 0, guard = 0, n = 0;
    int expn[97] = {0}, mant[97] = {0};
};

struct Poc {
    int rs, cs, lye, re, ce, prg;
};

// Part 2's MCT records (Imct, element type, payload) and MCC records
// (opj_simple_mcc_decorrelation_data_t: the decorrelation and offset
// arrays as indices into the MCT records, or -1)
struct MctRecord {
    int index, etype;
    std::vector<uint8_t> data;
};
struct MccRecord {
    int index = 0, ncomp = 0, deco = -1, offset = -1;
};

struct Params {
    int prog = 0, layers = 1, mct = 0, csty = 0;
    std::vector<Coding> cod;
    std::vector<Quant> q;
    std::vector<Poc> poc;
    std::vector<int> roi;          // RGN's SPrgn a component
    std::vector<int64_t> dc;       // the DC level shift a component
    std::vector<MctRecord> mcts;
    std::vector<MccRecord> mccs;
};

struct Header {
    int64_t X1, Y1, X0, Y0, TW, TH, TX0, TY0;
    int nc;
    std::vector<int> prec, sgnd, dx, dy;  // after CBD
    int ntx, nty;
    Params main;
    bool has_cod = false, has_qcd = false;
    bool has_ppm = false;
    std::vector<uint8_t> ppm;  // the PPM segments' Ippm, in order
};

const char *kNotPorted = " (not ported: ROADMAP A6 (j) 1)";

void read_spcod(Reader &r, Coding &c, bool precincts) {
    c.levels = r.u8();
    if (c.levels > 32) bad("JPEG 2000 COD/COC: more than 32 decomposition levels");
    c.xcb = r.u8() + 2;
    c.ycb = r.u8() + 2;
    if (c.xcb > 10 || c.ycb > 10 || c.xcb + c.ycb > 12)
        bad("JPEG 2000 COD/COC: code-block size out of range");
    c.style = r.u8();
    if (c.style & 0x80) bad("JPEG 2000 COD/COC: mixed HT code-block style");
    c.qmfbid = r.u8();
    if (c.qmfbid > 1) bad("JPEG 2000 COD/COC: wavelet kernel other than 9/7 and 5/3");
    for (int i = 0; i <= c.levels; ++i) {
        if (precincts) {
            int v = r.u8();
            c.ppx[i] = v & 15;
            c.ppy[i] = v >> 4;
            if (i && (!c.ppx[i] || !c.ppy[i])) bad("JPEG 2000 COD/COC: invalid precinct size");
        } else {
            c.ppx[i] = c.ppy[i] = 15;
        }
    }
    if (c.style & 0x40)
        todo(std::string("JPEG 2000 HT (Part 15) code-blocks: this decoder has no Part 15 "
                         "VLC tables") + kNotPorted);
}

void read_sqcd(Reader &r, int64_t len, Quant &q) {
    int s = r.u8();
    --len;
    q.style = s & 0x1f;
    q.guard = s >> 5;
    int n;
    if (q.style == 0) n = int(len);
    else if (q.style == 1) n = 1;
    else if (q.style == 2) n = int(len / 2);
    else bad("JPEG 2000 QCD/QCC: unknown quantization style");
    if (q.style == 1 && len < 2) bad("JPEG 2000 QCD/QCC: too short");
    q.n = n < 97 ? n : 97;
    for (int i = 0; i < n; ++i) {
        int e, m;
        if (q.style == 0) { int v = r.u8(); e = v >> 3; m = 0; }
        else { int v = r.u16(); e = v >> 11; m = v & 0x7ff; }
        if (i < 97) { q.expn[i] = e; q.mant[i] = m; }
    }
    if (q.style == 1)
        for (int b = 1; b < 97; ++b) {
            int e = q.expn[0] - (b - 1) / 3;
            q.expn[b] = e > 0 ? e : 0;
            q.mant[b] = q.mant[0];
        }
}

int comp_index(Reader &r, int nc) {
    int c = nc < 257 ? int(r.u8()) : int(r.u16());
    if (c >= nc) bad("JPEG 2000 COC/QCC/RGN: component index out of range");
    return c;
}

void read_poc(Reader &r, int64_t len, int nc, std::vector<Poc> &out) {
    int sz = nc < 257 ? 7 : 9;
    if (len % sz) bad("JPEG 2000 POC: bad length");
    for (int64_t i = 0; i < len / sz; ++i) {
        Poc p;
        p.rs = r.u8();
        p.cs = nc < 257 ? int(r.u8()) : int(r.u16());
        p.lye = r.u16();
        p.re = r.u8();
        p.ce = nc < 257 ? int(r.u8()) : int(r.u16());
        p.prg = r.u8();
        if (p.prg > 4) bad("JPEG 2000 POC: unknown progression order");
        if (p.ce > nc) p.ce = nc;
        out.push_back(p);
    }
}

bool known_marker(uint32_t m) {
    switch (m) {
    case 0xff4f: case 0xff51: case 0xff52: case 0xff53: case 0xff5c: case 0xff5d:
    case 0xff5e: case 0xff5f: case 0xff60: case 0xff61: case 0xff55: case 0xff57:
    case 0xff58: case 0xff63: case 0xff64: case 0xff90: case 0xff93: case 0xffd9:
    case 0xff91: case 0xff92: case 0xff50: case 0xff59: case 0xff74: case 0xff75:
    case 0xff77: case 0xff78:
        return true;
    }
    return false;
}

// ------------------------------------------------------ Part 2 markers
// OpenJPEG's readers (opj_j2k_read_mct/mcc/mco/cbd): what they refuse is
// malformed, what they "cannot take in charge" they skip; the one effect
// on a codestream whose COD allows no Part 2 transform is on the DC level
// shift (MCO) and on the components' precision and sign (CBD).
const int kMctElementSize[4] = {2, 4, 4, 8};

void read_mct(Reader &r, int64_t len, Params &p) {
    if (len < 2) bad("JPEG 2000 MCT: too short");
    if (r.u16() != 0) return;  // Zmct: multiple MCT records
    if (len <= 6) bad("JPEG 2000 MCT: too short");
    uint32_t imct = r.u16();
    int index = int(imct & 0xff);
    MctRecord *rec = nullptr;
    for (auto &m : p.mcts)
        if (m.index == index) { rec = &m; break; }
    if (!rec) { p.mcts.push_back(MctRecord{index, 0, {}}); rec = &p.mcts.back(); }
    rec->etype = int((imct >> 10) & 3);
    rec->data.clear();
    if (r.u16() != 0) return;  // Ymct: multiple MCT markers
    rec->data.assign(r.d + r.pos, r.d + r.pos + (len - 6));
}

void read_mcc(Reader &r, int64_t len, Params &p) {
    if (len < 2) bad("JPEG 2000 MCC: too short");
    if (r.u16() != 0) return;  // Zmcc: data spanning several MCC
    if (len < 7) bad("JPEG 2000 MCC: too short");
    int index = int(r.u8());
    size_t at = p.mccs.size();
    for (size_t i = 0; i < p.mccs.size(); ++i)
        if (p.mccs[i].index == index) { at = i; break; }
    bool fresh = at == p.mccs.size();
    MccRecord rec = fresh ? MccRecord() : p.mccs[at];
    rec.index = index;
    auto keep = [&]() {  // the record as OpenJPEG leaves it on a warning
        if (!fresh) p.mccs[at] = rec;
    };
    if (r.u16() != 0) { keep(); return; }  // Ymcc
    uint32_t ncoll = r.u16();
    if (ncoll > 1) { keep(); return; }
    int64_t left = len - 7;
    for (uint32_t k = 0; k < ncoll; ++k) {
        if (left < 3) bad("JPEG 2000 MCC: too short");
        if (r.u8() != 1) { keep(); return; }  // not an array decorrelation
        uint32_t n = r.u16();
        left -= 3;
        int nb = 1 + int(n >> 15);
        rec.ncomp = int(n & 0x7fff);
        if (left < int64_t(nb) * rec.ncomp + 2) bad("JPEG 2000 MCC: too short");
        left -= int64_t(nb) * rec.ncomp + 2;
        for (int j = 0; j < rec.ncomp; ++j)
            if ((nb == 1 ? r.u8() : r.u16()) != uint32_t(j)) { keep(); return; }
        uint32_t n2 = r.u16();
        nb = 1 + int(n2 >> 15);
        if (int(n2 & 0x7fff) != rec.ncomp) { keep(); return; }
        if (left < int64_t(nb) * rec.ncomp + 3) bad("JPEG 2000 MCC: too short");
        left -= int64_t(nb) * rec.ncomp + 3;
        for (int j = 0; j < rec.ncomp; ++j)
            if ((nb == 1 ? r.u8() : r.u16()) != uint32_t(j)) { keep(); return; }
        uint32_t t = r.u8() << 16;
        t |= r.u16();
        rec.deco = rec.offset = -1;
        auto find = [&](int idx) {
            for (size_t i = 0; i < p.mcts.size(); ++i)
                if (p.mcts[i].index == idx) return int(i);
            bad("JPEG 2000 MCC: no MCT record of its index");
        };
        if (t & 0xff) rec.deco = find(int(t & 0xff));
        if ((t >> 8) & 0xff) rec.offset = find(int((t >> 8) & 0xff));
    }
    if (left != 0) bad("JPEG 2000 MCC: bad length");
    if (fresh) p.mccs.push_back(rec);
    else p.mccs[at] = rec;
}

// an MCT record's elements as int32 (j2k_mct_read_functions_to_int32:
// int16 read unsigned, floats truncated as x86's cvttss2si)
int32_t mct_element(const MctRecord &m, size_t i) {
    const uint8_t *b = m.data.data() + i * kMctElementSize[m.etype];
    uint64_t v = 0;
    for (int k = 0; k < kMctElementSize[m.etype]; ++k) v = (v << 8) | b[k];
    auto trunc = [](double x) -> int32_t {
        if (!(x > -2147483649.0 && x < 2147483648.0)) return INT32_MIN;
        return int32_t(x);
    };
    switch (m.etype) {
    case 0: return int32_t(v);
    case 1: return int32_t(uint32_t(v));
    case 2: { uint32_t u = uint32_t(v); float f; memcpy(&f, &u, 4); return trunc(f); }
    default: { double d; memcpy(&d, &v, 8); return trunc(d); }
    }
}

void read_mco(Reader &r, int64_t len, const Header &h, Params &p) {
    if (len < 1) bad("JPEG 2000 MCO: too short");
    int stages = int(r.u8());
    if (stages > 1) return;
    if (len != stages + 1) bad("JPEG 2000 MCO: bad length");
    std::fill(p.dc.begin(), p.dc.end(), 0);
    for (int i = 0; i < stages; ++i) {
        int index = int(r.u8());
        // opj_j2k_add_mct compares the first MCC record's index only
        if (p.mccs.empty() || p.mccs[0].index != index) continue;
        const MccRecord &rec = p.mccs[0];
        if (rec.ncomp != h.nc) continue;
        if (rec.deco >= 0 && p.mcts[rec.deco].data.size() !=
                                 size_t(kMctElementSize[p.mcts[rec.deco].etype]) * h.nc * h.nc)
            bad("JPEG 2000 MCO: decorrelation array of the wrong size");
        if (rec.offset >= 0) {
            const MctRecord &m = p.mcts[rec.offset];
            if (m.data.size() != size_t(kMctElementSize[m.etype]) * h.nc)
                bad("JPEG 2000 MCO: offset array of the wrong size");
            for (int c = 0; c < h.nc; ++c) p.dc[c] = mct_element(m, c);
        }
    }
}

void read_cbd(Reader &r, int64_t len, Header &h) {
    if (len != h.nc + 2 || int(r.u16()) != h.nc) bad("JPEG 2000 CBD: bad length or count");
    for (int c = 0; c < h.nc; ++c) {
        int v = r.u8();
        h.sgnd[c] = v >> 7;
        h.prec[c] = (v & 0x7f) + 1;
        if (h.prec[c] > 31) bad("JPEG 2000 CBD: precision above 31 bits");
    }
}

// Marker segments allowed in a main or a tile-part header. `first`: the
// tile's first tile-part (COD, COC, QCD, QCC, RGN only there).
void header_segment(Reader &r, uint32_t m, Header &h, Params &p, bool tile,
                    bool first, std::vector<char> &coc_set, std::vector<char> &qcc_set,
                    bool &poc_seen) {
    int64_t len = r.u16();
    if (len < 2) bad("JPEG 2000 marker segment shorter than its length field");
    r.need(len - 2);
    int64_t end = r.pos + len - 2;
    if (tile && !first && (m == 0xff52 || m == 0xff53 || m == 0xff5c || m == 0xff5d))
        bad("JPEG 2000 COD/COC/QCD/QCC in a tile-part after the first");
    switch (m) {
    case 0xff52: {  // COD
        int scod = r.u8();
        p.prog = r.u8();
        if (p.prog > 4) bad("JPEG 2000 COD: unknown progression order");
        p.layers = r.u16();
        if (p.layers == 0) bad("JPEG 2000 COD: no quality layers");
        p.mct = r.u8();
        if (p.mct > 1) bad("JPEG 2000 COD: invalid multiple component transformation");
        p.csty = scod & 6;  // SOP, EPH
        Coding c;
        read_spcod(r, c, scod & 1);
        for (int i = 0; i < h.nc; ++i)
            if (!coc_set[i]) p.cod[i] = c;
        if (!tile) h.has_cod = true;
        break;
    }
    case 0xff53: {  // COC
        int ci = comp_index(r, h.nc);
        int scoc = r.u8();
        read_spcod(r, p.cod[ci], scoc & 1);
        coc_set[ci] = 1;
        break;
    }
    case 0xff5c: {  // QCD
        Quant q;
        read_sqcd(r, len - 2, q);
        for (int i = 0; i < h.nc; ++i)
            if (!qcc_set[i]) p.q[i] = q;
        if (!tile) h.has_qcd = true;
        break;
    }
    case 0xff5d: {  // QCC
        int64_t start = r.pos;
        int ci = comp_index(r, h.nc);
        read_sqcd(r, len - 2 - (r.pos - start), p.q[ci]);
        qcc_set[ci] = 1;
        break;
    }
    case 0xff5f:  // POC
        if (tile && !poc_seen) p.poc.clear();
        poc_seen = true;
        read_poc(r, len - 2, h.nc, p.poc);
        break;
    case 0xff5e: {  // RGN: Crgn, Srgn, SPrgn
        if (len - 2 != (h.nc < 257 ? 3 : 4)) bad("JPEG 2000 RGN: bad length");
        int ci = comp_index(r, h.nc);
        r.u8();
        p.roi[ci] = r.u8();
        break;
    }
    case 0xff60:  // PPM: Zppm, then (Nppm, the headers) a tile-part
        if (tile) bad("JPEG 2000 PPM in a tile-part header");
        r.u8();
        h.ppm.insert(h.ppm.end(), r.d + r.pos, r.d + end);
        h.has_ppm = true;
        break;
    case 0xff50: case 0xff59:  // CAP, CPF: read and not used
        if (tile) bad("JPEG 2000 CAP/CPF in a tile-part header");
        break;
    case 0xff74:
        read_mct(r, len - 2, p);
        break;
    case 0xff75:
        read_mcc(r, len - 2, p);
        break;
    case 0xff77:
        read_mco(r, len - 2, h, p);
        break;
    case 0xff78:
        if (tile) bad("JPEG 2000 CBD in a tile-part header");
        read_cbd(r, len - 2, h);
        break;
    default:  // TLM, PLM, PLT, CRG, COM: informative
        break;
    }
    r.pos = end;
}

// OpenJPEG's reading of an unknown marker: two bytes at a time until a
// known marker.
uint32_t skip_unknown(Reader &r) {
    for (;;) {
        uint32_t m = r.u16();
        if (m >= 0xff00 && known_marker(m)) return m;
    }
}

void read_main_header(const uint8_t *d, int64_t n, Header &h, int64_t &pos) {
    Reader r{d, n, 0};
    if (r.u16() != 0xff4f || r.u16() != 0xff51) bad("not a JPEG 2000 codestream");
    int64_t lsiz = r.u16();
    r.need(lsiz - 2);
    r.u16();  // Rsiz
    h.X1 = r.u32(); h.Y1 = r.u32(); h.X0 = r.u32(); h.Y0 = r.u32();
    h.TW = r.u32(); h.TH = r.u32(); h.TX0 = r.u32(); h.TY0 = r.u32();
    h.nc = r.u16();
    if (h.nc < 1 || h.nc > 16384 || lsiz != 38 + 3 * h.nc) bad("JPEG 2000 SIZ: bad component count or length");
    if (h.X0 >= h.X1 || h.Y0 >= h.Y1 || !h.TW || !h.TH || h.TX0 > h.X0 || h.TY0 > h.Y0 ||
        h.TX0 + h.TW <= h.X0 || h.TY0 + h.TH <= h.Y0)
        bad("JPEG 2000 SIZ: inconsistent image and tile geometry");
    for (int i = 0; i < h.nc; ++i) {
        int s = r.u8();
        h.prec.push_back((s & 0x7f) + 1);
        h.sgnd.push_back(s >> 7);
        h.dx.push_back(r.u8());
        h.dy.push_back(r.u8());
        if (h.prec.back() > 31) bad("JPEG 2000 SIZ: precision above 31 bits");
        if (!h.dx.back() || !h.dy.back()) bad("JPEG 2000 SIZ: zero sub-sampling");
    }
    h.ntx = int(ceildiv(h.X1 - h.TX0, h.TW));
    h.nty = int(ceildiv(h.Y1 - h.TY0, h.TH));
    if (int64_t(h.ntx) * h.nty > 65535) bad("JPEG 2000 SIZ: more than 65535 tiles");
    h.main.cod.assign(h.nc, Coding());
    h.main.q.assign(h.nc, Quant());
    h.main.roi.assign(h.nc, 0);
    for (int i = 0; i < h.nc; ++i)  // SIZ's shift: a CBD after it leaves it
        h.main.dc.push_back(h.sgnd[i] ? 0 : int64_t(1) << (h.prec[i] - 1));
    std::vector<char> coc(h.nc, 0), qcc(h.nc, 0);
    bool poc_seen = false;
    uint32_t m = r.u16();
    for (;;) {
        if (m == 0xff90) break;
        if (m < 0xff00) bad("JPEG 2000 main header: expected a marker");
        if (!known_marker(m)) { m = skip_unknown(r); continue; }
        if (m == 0xff4f || m == 0xff51 || m == 0xff93 || m == 0xffd9 || m == 0xff91 || m == 0xff92)
            bad("JPEG 2000 main header: marker out of place");
        header_segment(r, m, h, h.main, false, true, coc, qcc, poc_seen);
        m = r.u16();
    }
    if (!h.has_cod) bad("JPEG 2000: no COD marker in the main header");
    if (!h.has_qcd) bad("JPEG 2000: no QCD marker in the main header");
    pos = r.pos - 2;  // at the first SOT
}

// ----------------------------------------------------------- tile layout
struct TagTree {
    std::vector<int> val, low, parent;
    void init(int w, int h) {
        val.clear(); low.clear(); parent.clear();
        if (w <= 0 || h <= 0) return;
        std::vector<int> lw{w}, lh{h};
        while (lw.back() * lh.back() > 1) {
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        int total = 0;
        std::vector<int> base;
        for (size_t i = 0; i < lw.size(); ++i) { base.push_back(total); total += lw[i] * lh[i]; }
        val.assign(total, 999);
        low.assign(total, 0);
        parent.assign(total, -1);
        for (size_t i = 0; i + 1 < lw.size(); ++i)
            for (int y = 0; y < lh[i]; ++y)
                for (int x = 0; x < lw[i]; ++x)
                    parent[base[i] + y * lw[i] + x] = base[i + 1] + (y / 2) * lw[i + 1] + x / 2;
    }
};

struct Bio {
    const uint8_t *start, *p, *end;
    uint32_t buf = 0;
    int ct = 0;
    bool bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (p >= end) return false;
        buf |= *p++;
        return true;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; --i) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff && !bytein()) bad("JPEG 2000 packet header runs past the data");
        ct = 0;
    }
};

int tgt_decode(Bio &bio, TagTree &t, int leaf, int threshold) {
    int stk[40], sp = 0;
    int node = leaf;
    while (t.parent[node] >= 0) { stk[sp++] = node; node = t.parent[node]; }
    int low = 0;
    for (;;) {
        if (low > t.low[node]) t.low[node] = low;
        else low = t.low[node];
        while (low < threshold && low < t.val[node]) {
            if (bio.bit()) t.val[node] = low;
            else ++low;
        }
        t.low[node] = low;
        if (!sp) break;
        node = stk[--sp];
    }
    return t.val[node] < threshold;
}

// a codeword segment: passes at most (opj_t2_init_seg), and so far
struct Seg {
    int maxpasses = 0, numpasses = 0, newpasses = 0;
    uint32_t len = 0, newlen = 0;
};

struct Cblk {
    int64_t x0, y0, x1, y1;
    int numbps = 0, lblock = 3, npasses = 0, newpasses = 0;
    bool seen = false;
    std::vector<Seg> segs;   // segs.size() is OpenJPEG's numsegs
    std::vector<Seg> head;   // the segments this packet's header opened
    int headseg = 0;         // the index of head[0]
    std::vector<std::pair<int64_t, uint32_t>> chunks;
};

// opj_t2_init_seg: one pass a segment under termall; under bypass 10,
// then 2 and 1 by turns; else 109
Seg new_seg(int style, const Seg *prev) {
    Seg s;
    if (style & 4) s.maxpasses = 1;
    else if (style & 1) s.maxpasses = !prev ? 10 : (prev->maxpasses == 1 || prev->maxpasses == 10) ? 2 : 1;
    else s.maxpasses = 109;
    return s;
}

struct Precinct {
    int cw = 0, ch = 0;
    int first = 0;  // index of its first code-block in the band
    TagTree incl, imsb;
};

struct Band {
    int bandno;
    int64_t x0, y0, x1, y1;
    float step;
    int Mb;
    std::vector<Precinct> prec;
    std::vector<Cblk> cblks;
    bool empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Res {
    int64_t x0, y0, x1, y1;
    int pdx, pdy, pw, ph;
    std::vector<Band> bands;
};

struct TileComp {
    int64_t x0, y0, x1, y1;
    int nres;
    bool rev;
    std::vector<Res> res;
    // the samples: every one is written by its code-block's tier-1 job
    std::unique_ptr<int32_t[]> idata;
    std::unique_ptr<float[]> fdata;
};

// ---------------------------------------------------------------- tier 1
// MQ decoder (T.800 Annex C, with OpenJPEG's two 0xFF bytes after the data)
const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// the MQ states with their MPS: Qe, the MPS and the next states (2 *
// state + MPS) after an MPS and after an LPS (the switch folded in)
struct MqState {
    uint16_t qe;
    uint8_t mps, nmps, nlps;
};
MqState kMq[94];

// neighbour flags of a coefficient
constexpr uint32_t F_NW = 1, F_N = 2, F_NE = 4, F_W = 8, F_E = 16, F_SW = 32, F_S = 64,
                   F_SE = 128, F_NSGN = 256, F_SSGN = 512, F_WSGN = 1024, F_ESGN = 2048,
                   F_SIG = 4096, F_VISIT = 8192, F_REFINE = 16384;

uint8_t kZc[4][256];
uint8_t kSc[256];  // context (low 5 bits) | xor bit << 7

void init_luts() {
    for (int o = 0; o < 4; ++o)
        for (int f = 0; f < 256; ++f) {
            int h = !!(f & F_W) + !!(f & F_E);
            int v = !!(f & F_N) + !!(f & F_S);
            int d = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
            int n;
            if (o == 1) std::swap(h, v);
            if (o != 3) {
                if (!h) n = !v ? (!d ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
                else if (h == 1) n = !v ? (!d ? 5 : 6) : 7;
                else n = 8;
            } else {
                int hv = h + v;
                if (!d) n = !hv ? 0 : hv == 1 ? 1 : 2;
                else if (d == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
                else if (d == 2) n = !hv ? 6 : 7;
                else n = 8;
            }
            kZc[o][f] = uint8_t(n);
        }
    for (int i = 0; i < 256; ++i) {
        auto contrib = [&](int sig, int neg) { return sig ? (neg ? -1 : 1) : 0; };
        int h = contrib(i & 4, i & 64) + contrib(i & 8, i & 128);
        int v = contrib(i & 1, i & 16) + contrib(i & 2, i & 32);
        h = h < -1 ? -1 : h > 1 ? 1 : h;
        v = v < -1 ? -1 : v > 1 ? 1 : v;
        int cx, x = 0;
        if (h < 0) { h = -h; v = -v; x = 1; }
        if (h == 0 && v < 0) { v = -v; x = 1; }
        if (h == 1) cx = v == 1 ? 13 : v == 0 ? 12 : 11;
        else cx = v == 1 ? 10 : 9;
        kSc[i] = uint8_t(cx | (x << 7));
    }
    for (int st = 0; st < 47; ++st)
        for (int m = 0; m < 2; ++m)
            kMq[2 * st + m] = MqState{kQe[st], uint8_t(m), uint8_t(2 * kNmps[st] + m),
                                      uint8_t(2 * kNlps[st] + (kSwitch[st] ? 1 - m : m))};
}

inline int sc_index(uint32_t f) {
    return ((f & F_N) ? 1 : 0) | ((f & F_S) ? 2 : 0) | ((f & F_W) ? 4 : 0) | ((f & F_E) ? 8 : 0) |
           ((f & F_NSGN) ? 16 : 0) | ((f & F_SSGN) ? 32 : 0) | ((f & F_WSGN) ? 64 : 0) |
           ((f & F_ESGN) ? 128 : 0);
}

// The MQ decoder's registers (T.800 Annex C; the data is followed by two
// 0xff bytes, as OpenJPEG appends them).  Each pass works on a local copy.
struct MqRegs {
    const uint8_t *bp;
    uint32_t a, c;
    int ct;
};

#if defined(__GNUC__)
#define J2K_INLINE inline __attribute__((always_inline))
#else
#define J2K_INLINE inline
#endif

J2K_INLINE void mq_bytein(MqRegs &m) {
    if (*m.bp == 0xff) {
        if (m.bp[1] > 0x8f) {
            m.c += 0xff00;
            m.ct = 8;
        } else {
            ++m.bp;
            m.c += uint32_t(*m.bp) << 9;
            m.ct = 7;
        }
    } else {
        ++m.bp;
        m.c += uint32_t(*m.bp) << 8;
        m.ct = 8;
    }
}

// DECODE (C.3.2), with RENORMD
J2K_INLINE int mq_decode(MqRegs &m, uint8_t &sx) {
    const MqState e = kMq[sx];
    const uint32_t qe = e.qe;
    int d;
    m.a -= qe;
    if ((m.c >> 16) < qe) {  // LPS_EXCHANGE
        if (m.a < qe) { d = e.mps; sx = e.nmps; }
        else { d = 1 - e.mps; sx = e.nlps; }
        m.a = qe;
    } else {
        m.c -= qe << 16;
        if (m.a & 0x8000) return e.mps;
        if (m.a < qe) { d = 1 - e.mps; sx = e.nlps; }  // MPS_EXCHANGE
        else { d = e.mps; sx = e.nmps; }
    }
    do {
        if (m.ct == 0) mq_bytein(m);
        m.a <<= 1;
        m.c <<= 1;
        --m.ct;
    } while (!(m.a & 0x8000));
    return d;
}

// The raw (bypass) decoder's registers: opj_mqc_raw_decode, whose
// segment is also followed by two 0xFF bytes
struct RawRegs {
    const uint8_t *bp;
    uint32_t c;
    int ct;
};

J2K_INLINE uint32_t raw_decode(RawRegs &m) {
    if (m.ct == 0) {
        if (m.c == 0xff) {
            if (*m.bp > 0x8f) {
                m.c = 0xff;
                m.ct = 8;
            } else {
                m.c = *m.bp++;
                m.ct = 7;
            }
        } else {
            m.c = *m.bp++;
            m.ct = 8;
        }
    }
    --m.ct;
    return (m.c >> m.ct) & 1;
}

// a code-block's codeword segments: their bytes one after another
struct SegSpan {
    uint32_t len;
    int passes;
};

struct T1 {
    int w, h, stride;  // the flags' and the columns' rows: w and a border
    bool vsc = false;  // vertically causal: a stripe's last row sees no row below
    std::vector<uint32_t> flags;
    std::vector<int32_t> data;
    // per stripe column (with a border all round): bit 0 when one of its
    // four coefficients is significant or has a significant neighbour,
    // bit 1 when one is significant
    std::vector<uint8_t> cols;
    uint8_t ctx[19];  // 2 * state + MPS, an index into kMq
    MqRegs mq;
    RawRegs raw;

    uint32_t *flag(int x, int y) { return &flags[size_t(y + 1) * stride + x + 1]; }
    uint8_t *col(int x, int y) { return &cols[size_t((y >> 2) + 1) * stride + x + 1]; }

    void reset_contexts() {
        memset(ctx, 0, sizeof ctx);
        ctx[18] = 2 * 46;  // uniform
        ctx[17] = 2 * 3;   // run length
        ctx[0] = 2 * 4;    // zero coding, no significant neighbour
    }

    // makes the coefficient at (x, y) significant with magnitude oph and
    // sign neg; under vsc the first row of a stripe leaves the row above
    // (the previous stripe's last) unaware of it
    J2K_INLINE void set_sig(int x, int y, uint32_t *p, int32_t *d, int32_t oph, int neg) {
        const int st = stride;
        *d = neg ? -oph : oph;
        *p |= F_SIG;
        p[-1] |= F_E | (neg ? F_ESGN : 0);
        p[1] |= F_W | (neg ? F_WSGN : 0);
        p[st - 1] |= F_NE;
        p[st] |= F_N | (neg ? F_NSGN : 0);
        p[st + 1] |= F_NW;
        uint8_t *c1 = col(x, y + 1);
        c1[-1] |= 1; c1[0] |= 1; c1[1] |= 1;
        if (!(vsc && (y & 3) == 0)) {
            p[-st - 1] |= F_SE;
            p[-st] |= F_S | (neg ? F_SSGN : 0);
            p[-st + 1] |= F_SW;
            uint8_t *c0 = col(x, y - 1);
            c0[-1] |= 1; c0[0] |= 1; c0[1] |= 1;
        }
        *col(x, y) |= 3;
    }

    // decodes the sign of the coefficient at (x, y) and makes it
    // significant with magnitude oph
    J2K_INLINE void sign(MqRegs &m, int x, int y, uint32_t *p, int32_t *d, int32_t oph) {
        int lu = kSc[sc_index(*p)];
        set_sig(x, y, p, d, oph, mq_decode(m, ctx[lu & 31]) ^ (lu >> 7));
    }

    void sigpass(int bp1, const uint8_t *zc) {
        MqRegs m = mq;
        const int32_t oph = (1 << bp1) | ((1 << bp1) >> 1);
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int y1 = std::min(y0 + 4, h);
            const uint8_t *crow = col(0, y0);
            for (int x = 0; x < w; ++x) {
                if (!(crow[x] & 1)) continue;
                uint32_t *p = flag(x, y0);
                int32_t *d = &data[size_t(y0) * w + x];
                for (int y = y0; y < y1; ++y, p += stride, d += w) {
                    if ((*p & F_SIG) || !(*p & 0xff)) continue;
                    if (mq_decode(m, ctx[zc[*p & 0xff]])) sign(m, x, y, p, d, oph);
                    *p |= F_VISIT;
                }
            }
        }
        mq = m;
    }

    void sigpass_raw(int bp1) {
        const int32_t oph = (1 << bp1) | ((1 << bp1) >> 1);
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int y1 = std::min(y0 + 4, h);
            const uint8_t *crow = col(0, y0);
            for (int x = 0; x < w; ++x) {
                if (!(crow[x] & 1)) continue;
                uint32_t *p = flag(x, y0);
                int32_t *d = &data[size_t(y0) * w + x];
                for (int y = y0; y < y1; ++y, p += stride, d += w) {
                    if ((*p & F_SIG) || !(*p & 0xff)) continue;
                    if (raw_decode(raw)) set_sig(x, y, p, d, oph, int(raw_decode(raw)));
                    *p |= F_VISIT;
                }
            }
        }
    }

    template <bool Raw>
    void refpass(int bp1) {
        MqRegs m = mq;
        const int32_t half = (1 << bp1) >> 1;
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int y1 = std::min(y0 + 4, h);
            const uint8_t *crow = col(0, y0);
            for (int x = 0; x < w; ++x) {
                if (!(crow[x] & 2)) continue;
                uint32_t *p = flag(x, y0);
                int32_t *d = &data[size_t(y0) * w + x];
                for (int y = y0; y < y1; ++y, p += stride, d += w) {
                    if ((*p & (F_SIG | F_VISIT)) != F_SIG) continue;
                    int v;
                    if (Raw) {
                        v = int(raw_decode(raw));
                    } else {
                        int cx = (*p & F_REFINE) ? 16 : (*p & 0xff) ? 15 : 14;
                        v = mq_decode(m, ctx[cx]);
                    }
                    *d += (v ^ (*d < 0)) ? half : -half;
                    *p |= F_REFINE;
                }
            }
        }
        mq = m;
    }

    // cleanup, with run-length coding of quiet columns (no significant
    // coefficient or neighbour, so none visited either)
    void clnpass(int bp1, const uint8_t *zc) {
        MqRegs m = mq;
        const int32_t oph = (1 << bp1) | ((1 << bp1) >> 1);
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int y1 = std::min(y0 + 4, h);
            const uint8_t *crow = col(0, y0);
            for (int x = 0; x < w; ++x) {
                uint32_t *p = flag(x, y0);
                int32_t *d = &data[size_t(y0) * w + x];
                int y = y0;
                if (y1 - y0 == 4 && !(crow[x] & 1)) {
                    if (!mq_decode(m, ctx[17])) continue;
                    int run = mq_decode(m, ctx[18]) << 1;
                    run |= mq_decode(m, ctx[18]);
                    y += run;
                    p += size_t(run) * stride;
                    d += size_t(run) * w;
                    sign(m, x, y, p, d, oph);
                    ++y; p += stride; d += w;
                }
                for (; y < y1; ++y, p += stride, d += w) {
                    if (!(*p & (F_SIG | F_VISIT)) && mq_decode(m, ctx[zc[*p & 0xff]]))
                        sign(m, x, y, p, d, oph);
                    *p &= ~F_VISIT;
                }
            }
        }
        mq = m;
    }

    // decodes a code-block's segments (opj_t1_decode_cblk): bytes holds
    // them one after another, with two bytes of room after the last;
    // bpno_plus_one starts at roishift + numbps, one more than the top
    // coded bit-plane's index (OpenJPEG's extra fractional bit)
    void decode(uint8_t *bytes, const std::vector<SegSpan> &segs, int cw, int chh, int orient,
                int numbps, int roishift, int style) {
        w = cw; h = chh; stride = w + 2;
        vsc = (style & 8) != 0;
        flags.assign(size_t(stride) * (h + 2), 0);
        data.assign(size_t(w) * h, 0);
        cols.assign(size_t(stride) * ((h + 3) / 4 + 2), 0);
        reset_contexts();
        const uint8_t *zc = kZc[orient];
        int bpno_plus_one = roishift + numbps;
        int passtype = 2;
        uint8_t *at = bytes;
        for (const SegSpan &sg : segs) {
            const bool is_raw = bpno_plus_one <= numbps - 4 && passtype < 2 && (style & 1);
            // opj_mqc_init_dec_common's artificial 0xFF 0xFF after the
            // segment, over the next one's first bytes while it decodes
            uint8_t *end = at + sg.len, backup[2] = {end[0], end[1]};
            end[0] = end[1] = 0xff;
            if (is_raw) {
                raw = RawRegs{at, 0, 0};
            } else {
                mq.bp = at;
                mq.c = sg.len == 0 ? 0xffu << 16 : uint32_t(*at) << 16;
                mq_bytein(mq);
                mq.c <<= 7;
                mq.ct -= 7;
                mq.a = 0x8000;
            }
            for (int pass = 0; pass < sg.passes && bpno_plus_one >= 1; ++pass) {
                if (passtype == 0) {
                    if (is_raw) sigpass_raw(bpno_plus_one);
                    else sigpass(bpno_plus_one, zc);
                } else if (passtype == 1) {
                    if (is_raw) refpass<true>(bpno_plus_one);
                    else refpass<false>(bpno_plus_one);
                } else {
                    clnpass(bpno_plus_one, zc);
                    if (style & 32)  // segmentation symbols: read, not checked
                        for (int k = 0; k < 4; ++k) mq_decode(mq, ctx[18]);
                }
                if ((style & 2) && !is_raw) reset_contexts();
                if (++passtype == 3) { passtype = 0; --bpno_plus_one; }
            }
            end[0] = backup[0];
            end[1] = backup[1];
            at = end;
        }
        if (roishift >= 31) {
            std::fill(data.begin(), data.end(), 0);
        } else if (roishift) {  // ROI max-shift: magnitudes at or above 2^roishift
            const int32_t thresh = int32_t(1) << roishift;
            for (int32_t &v : data) {
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= roishift;
                    v = v < 0 ? -mag : mag;
                }
            }
        }
    }
};

// ---------------------------------------------------------------- wavelet
const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
            kDelta = 0.443506852f;

// The lines of a resolution are transformed kLanes at a time, gathered
// into t[len][kLanes] in interleaved order (low samples at the parity of
// the first coordinate, cas): the same operations on every lane, as
// OpenJPEG's 8-wide opj_v8dwt.
constexpr int kLanes = 16;

// x[i] = op(x[i], x[i - 1], x[i + 1]) on the samples of parity `start`,
// mirrored at both ends (len >= 2)
template <class T, class Op>
inline void lift(T *t, int len, int start, Op op) {
    int i = start;
    if (i == 0) {
        T *x = t, *r = t + kLanes;
        for (int k = 0; k < kLanes; ++k) x[k] = op(x[k], r[k], r[k]);
        i = 2;
    }
    for (; i + 1 < len; i += 2) {
        T *x = t + size_t(i) * kLanes, *l = x - kLanes, *r = x + kLanes;
        for (int k = 0; k < kLanes; ++k) x[k] = op(x[k], l[k], r[k]);
    }
    if (i < len) {
        T *x = t + size_t(i) * kLanes, *l = x - kLanes;
        for (int k = 0; k < kLanes; ++k) x[k] = op(x[k], l[k], l[k]);
    }
}

// `lanes` lines of `len` samples, sample i of lane l at x[l * lane + i *
// step]: sn low samples then the high ones, inverse-transformed in place
template <class T>
void idwt_lines(T *x, int64_t lane, int64_t step, int lanes, int len, int sn, int cas,
                std::vector<T> &t) {
    if (len < 1) return;
    if (len == 1) {  // OpenJPEG: the 5/3 halves a lone odd sample, the 9/7 keeps it
        if constexpr (std::is_integral<T>::value) {
            if (cas)
                for (int l = 0; l < lanes; ++l) x[l * lane] /= 2;
        }
        return;
    }
    t.resize(size_t(len) * kLanes);
    for (int i = 0; i < len; ++i) {
        int row = i < sn ? cas + 2 * i : 1 - cas + 2 * (i - sn);
        T *dst = &t[size_t(row) * kLanes];
        const T *src = x + i * step;
        for (int l = 0; l < lanes; ++l) dst[l] = src[l * lane];
        for (int l = lanes; l < kLanes; ++l) dst[l] = T(0);  // unused lanes
    }
    T *tp = t.data();
    if constexpr (std::is_integral<T>::value) {
        lift(tp, len, cas, [](T v, T l, T r) { return T(v - ((l + r + 2) >> 2)); });
        lift(tp, len, 1 - cas, [](T v, T l, T r) { return T(v + ((l + r) >> 1)); });
    } else {
        for (int i = 0; i < len; ++i) {
            T k = (i & 1) == cas ? T(kK) : T(kTwoInvK);
            T *v = tp + size_t(i) * kLanes;
            for (int l = 0; l < kLanes; ++l) v[l] = v[l] * k;
        }
        const float c[4] = {-kDelta, -kGamma, -kBeta, -kAlpha};
        for (int st = 0; st < 4; ++st) {
            const T cc = T(c[st]);
            lift(tp, len, (st & 1) ? 1 - cas : cas,
                 [cc](T v, T l, T r) { return T(v + (l + r) * cc); });
        }
    }
    for (int i = 0; i < len; ++i) {
        const T *src = &t[size_t(i) * kLanes];
        T *dst = x + i * step;
        for (int l = 0; l < lanes; ++l) dst[l * lane] = src[l];
    }
}

// lrintf (OpenJPEG's opj_lrintf with GCC): round to nearest even, inline
inline int64_t round_float(float f) {
#if defined(__x86_64__)
    return _mm_cvtss_si64(_mm_set_ss(f));
#else
    return lrintf(f);
#endif
}

// ------------------------------------------------------------ threads
struct Scratch {
    T1 t1;
    std::vector<uint8_t> buf;
    std::vector<SegSpan> segs;
};

// A pool of kThreads - 1 workers started at first use and kept (never
// destroyed: the process's exit ends them); a process forked from one that
// had a pool starts its own.  One parallel run at a time: a caller that
// finds the pool busy (another thread decoding) runs its jobs serially.
constexpr int kThreads = 8;
constexpr int64_t kWorkPerThread = 8000;
thread_local bool t_nested = false;

struct Pool {
    std::mutex run_lock, m;
    std::condition_variable wake, idle;
    std::function<void()> task;
    uint64_t generation = 0;
    int wanted = 0, running = 0;
    pid_t pid = getpid();

    Pool() {
        for (int k = 1; k < kThreads; ++k) std::thread([this] { loop(); }).detach();
    }
    void loop() {
        t_nested = true;
        uint64_t seen = 0;
        for (;;) {
            std::function<void()> job;
            {
                std::unique_lock<std::mutex> g(m);
                wake.wait(g, [&] { return generation != seen; });
                seen = generation;
                if (wanted <= 0) continue;
                --wanted;
                ++running;
                job = task;
            }
            job();
            std::lock_guard<std::mutex> g(m);
            if (--running == 0) idle.notify_all();
        }
    }
    // runs job on `helpers` pool threads and on the caller, and waits
    void run(int helpers, const std::function<void()> &job) {
        {
            std::lock_guard<std::mutex> g(m);
            task = job;
            wanted = helpers;
            ++generation;
        }
        wake.notify_all();
        job();
        std::unique_lock<std::mutex> g(m);
        wanted = 0;  // helpers that did not start in time are not waited for
        idle.wait(g, [&] { return running == 0; });
    }
};

Pool *pool_for_this_process() {
    static std::mutex lock;
    static Pool *pool = nullptr;
    std::lock_guard<std::mutex> g(lock);
    if (!pool || pool->pid != getpid()) pool = new Pool();
    return pool;
}

// Runs fn(i, scratch) for i < n, on up to kThreads threads when the work
// (about one unit a coefficient a pass) pays for waking them; serially
// inside another parallel() (tiles decoded in parallel decode their insides
// serially).  The first exception a job throws is rethrown.
template <class Fn>
void parallel(size_t n, int64_t work, Fn fn) {
    int nt = int(std::min<int64_t>({int64_t(kThreads), int64_t(n), work / kWorkPerThread}));
    unsigned hc = std::thread::hardware_concurrency();
    if (hc) nt = std::min(nt, int(hc));
    Pool *pool = nt > 1 && !t_nested ? pool_for_this_process() : nullptr;
    std::unique_lock<std::mutex> busy;
    if (pool) busy = std::unique_lock<std::mutex>(pool->run_lock, std::try_to_lock);
    if (!pool || !busy.owns_lock()) {
        Scratch sc;
        for (size_t i = 0; i < n; ++i) fn(i, sc);
        return;
    }
    std::atomic<size_t> next{0};
    std::exception_ptr error;
    std::mutex error_lock;
    pool->run(nt - 1, [&]() {
        bool outer = t_nested;
        t_nested = true;
        try {
            Scratch sc;
            for (size_t i; (i = next.fetch_add(1)) < n;) fn(i, sc);
        } catch (...) {
            std::lock_guard<std::mutex> g(error_lock);
            if (!error) error = std::current_exception();
            next = n;
        }
        t_nested = outer;
    });
    if (error) std::rethrow_exception(error);
}

// ------------------------------------------------------------ the decoder
struct Decoder {
    const uint8_t *d;
    int64_t n;
    Header h;
    int32_t *out;
    int32_t *order = nullptr;            // the tiles by their last tile-part
    std::vector<int64_t> plane_offset;   // each component's plane in out

    struct TileData {
        bool seen = false;
        Params p;
        std::vector<uint8_t> bytes;
        std::vector<uint8_t> headers;  // packet headers from PPM/PPT
        bool packed = false;
        int last_tp = -1;
    };
    std::vector<TileData> tiles;

    void run() {
        int64_t pos;
        read_main_header(d, n, h, pos);
        int64_t at = 0;
        for (int c = 0; c < h.nc; ++c) {
            plane_offset.push_back(at);
            at += (ceildiv(h.X1, h.dx[c]) - ceildiv(h.X0, h.dx[c])) *
                  (ceildiv(h.Y1, h.dy[c]) - ceildiv(h.Y0, h.dy[c]));
        }
        std::vector<int> last_part;  // tile indices, one a tile-part
        tiles.resize(size_t(h.ntx) * h.nty);
        Reader r{d, n, pos};
        size_t ppm_pos = 0;
        for (;;) {
            if (r.pos + 2 > n) break;  // no EOC: OpenJPEG decodes what it read
            uint32_t m = r.u16();
            if (m == 0xffd9) break;
            if (m != 0xff90) bad("JPEG 2000: expected SOT or EOC");
            int64_t sot = r.pos - 2;
            if (r.u16() != 10) bad("JPEG 2000 SOT: bad length");
            int isot = r.u16();
            int64_t psot = r.u32();
            int tpsot = r.u8();
            r.u8();  // TNsot
            if (isot >= int(tiles.size())) bad("JPEG 2000 SOT: tile index out of range");
            TileData &t = tiles[isot];
            bool first = !t.seen;
            if (first) {
                t.seen = true;
                t.p = h.main;
            } else if (tpsot != t.last_tp + 1) {
                bad("JPEG 2000 SOT: tile-parts out of order");
            }
            t.last_tp = tpsot;
            last_part.push_back(isot);
            std::vector<char> coc(h.nc, 0), qcc(h.nc, 0);
            bool poc_seen = false;
            if (h.has_ppm) {  // this tile-part's packet headers
                if (ppm_pos + 4 > h.ppm.size()) bad("JPEG 2000 PPM: no headers for a tile-part");
                size_t nppm = (size_t(h.ppm[ppm_pos]) << 24) | (size_t(h.ppm[ppm_pos + 1]) << 16) |
                              (size_t(h.ppm[ppm_pos + 2]) << 8) | h.ppm[ppm_pos + 3];
                ppm_pos += 4;
                if (nppm > h.ppm.size() - ppm_pos) bad("JPEG 2000 PPM: headers run past their segments");
                t.headers.insert(t.headers.end(), h.ppm.begin() + ppm_pos, h.ppm.begin() + ppm_pos + nppm);
                t.packed = true;
                ppm_pos += nppm;
            }
            int64_t end;
            if (psot == 0) {
                end = n;
                if (n >= 2 && d[n - 2] == 0xff && d[n - 1] == 0xd9) end = n - 2;
            } else {
                end = sot + psot;
                if (end > n) bad("JPEG 2000 tile-part runs past the end of the data");
            }
            uint32_t mk = r.u16();
            while (mk != 0xff93) {
                if (mk < 0xff00) bad("JPEG 2000 tile-part header: expected a marker");
                if (!known_marker(mk)) { mk = skip_unknown(r); continue; }
                if (mk == 0xff4f || mk == 0xff51 || mk == 0xff90 || mk == 0xffd9 ||
                    mk == 0xff91 || mk == 0xff92)
                    bad("JPEG 2000 tile-part header: marker out of place");
                if (mk == 0xff61) {  // PPT: Zppt, then this tile's packet headers
                    if (h.has_ppm) bad("JPEG 2000 PPT in a codestream with PPM");
                    int64_t len = r.u16();
                    if (len < 3) bad("JPEG 2000 PPT: too short");
                    r.need(len - 2);
                    r.u8();
                    t.headers.insert(t.headers.end(), d + r.pos, d + r.pos + len - 3);
                    t.packed = true;
                    r.pos += len - 3;
                } else {
                    header_segment(r, mk, h, t.p, true, first, coc, qcc, poc_seen);
                }
                if (r.pos > end) bad("JPEG 2000 tile-part header runs past its tile-part");
                mk = r.u16();
            }
            if (r.pos > end) bad("JPEG 2000 SOD past its tile-part");
            t.bytes.insert(t.bytes.end(), d + r.pos, d + end);
            r.pos = end;
        }
        if (order) {
            std::vector<char> done(tiles.size(), 0);
            size_t k = 0;
            for (size_t i = last_part.size(); i-- > 0;)  // each tile's last, in order
                if (!done[last_part[i]]) { done[last_part[i]] = 1; order[k++] = last_part[i]; }
            std::reverse(order, order + k);
            for (; k < tiles.size(); ++k) order[k] = -1;
        }
        std::vector<int> seen;
        int64_t work = 0;
        for (size_t i = 0; i < tiles.size(); ++i)
            if (tiles[i].seen) {
                seen.push_back(int(i));
                work += int64_t(tiles[i].bytes.size()) * 64;
            }
        if (seen.size() == 1) work = 0;  // one tile: parallel inside it
        parallel(seen.size(), work, [&](size_t k, Scratch &) {
            decode_tile(seen[k], tiles[seen[k]]);
        });
    }

    void build(TileComp &tc, const Coding &c, const Quant &q, int ci) {
        tc.nres = c.levels + 1;
        tc.res.resize(tc.nres);
        for (int r = 0; r < tc.nres; ++r) {
            Res &R = tc.res[r];
            int level = c.levels - r;
            R.x0 = ceildivpow2(tc.x0, level); R.y0 = ceildivpow2(tc.y0, level);
            R.x1 = ceildivpow2(tc.x1, level); R.y1 = ceildivpow2(tc.y1, level);
            R.pdx = c.ppx[r]; R.pdy = c.ppy[r];
            int64_t tlx = floordivpow2(R.x0, R.pdx) << R.pdx, tly = floordivpow2(R.y0, R.pdy) << R.pdy;
            int64_t brx = ceildivpow2(R.x1, R.pdx) << R.pdx, bry = ceildivpow2(R.y1, R.pdy) << R.pdy;
            R.pw = R.x0 == R.x1 ? 0 : int((brx - tlx) >> R.pdx);
            R.ph = R.y0 == R.y1 ? 0 : int((bry - tly) >> R.pdy);
            if (int64_t(R.pw) * R.ph > (1 << 24)) bad("JPEG 2000: too many precincts");
            int64_t cbgx0, cbgy0;
            int cbgw, cbgh;
            if (r == 0) { cbgx0 = tlx; cbgy0 = tly; cbgw = R.pdx; cbgh = R.pdy; }
            else { cbgx0 = ceildivpow2(tlx, 1); cbgy0 = ceildivpow2(tly, 1); cbgw = R.pdx - 1; cbgh = R.pdy - 1; }
            int cbw = std::min(c.xcb, cbgw), cbh = std::min(c.ycb, cbgh);
            int nb = r == 0 ? 1 : 3;
            R.bands.resize(nb);
            for (int b = 0; b < nb; ++b) {
                Band &B = R.bands[b];
                B.bandno = r == 0 ? 0 : b + 1;
                if (r == 0) {
                    B.x0 = R.x0; B.y0 = R.y0; B.x1 = R.x1; B.y1 = R.y1;
                } else {
                    int x0b = B.bandno & 1, y0b = B.bandno >> 1;
                    B.x0 = ceildivpow2(tc.x0 - (int64_t(x0b) << level), level + 1);
                    B.y0 = ceildivpow2(tc.y0 - (int64_t(y0b) << level), level + 1);
                    B.x1 = ceildivpow2(tc.x1 - (int64_t(x0b) << level), level + 1);
                    B.y1 = ceildivpow2(tc.y1 - (int64_t(y0b) << level), level + 1);
                }
                int qi = r == 0 ? 0 : 3 * (r - 1) + B.bandno;
                int expn = qi < 97 ? q.expn[qi] : 0, mant = qi < 97 ? q.mant[qi] : 0;
                int gain = c.qmfbid == 0 ? 0 : B.bandno == 0 ? 0 : B.bandno == 3 ? 2 : 1;
                int Rb = h.prec[ci] + gain;
                B.step = float((1.0 + mant / 2048.0) * pow(2.0, Rb - expn));
                B.Mb = expn + q.guard - 1;
                B.prec.resize(size_t(R.pw) * R.ph);
                for (int pi = 0; pi < R.pw * R.ph; ++pi) {
                    Precinct &P = B.prec[pi];
                    int64_t px0 = cbgx0 + (int64_t(pi % R.pw) << cbgw);
                    int64_t py0 = cbgy0 + (int64_t(pi / R.pw) << cbgh);
                    int64_t x0 = std::max(px0, B.x0), y0 = std::max(py0, B.y0);
                    int64_t x1 = std::min(px0 + (int64_t(1) << cbgw), B.x1);
                    int64_t y1 = std::min(py0 + (int64_t(1) << cbgh), B.y1);
                    int64_t tbx = floordivpow2(x0, cbw) << cbw, tby = floordivpow2(y0, cbh) << cbh;
                    int64_t bbx = ceildivpow2(x1, cbw) << cbw, bby = ceildivpow2(y1, cbh) << cbh;
                    P.cw = bbx > tbx ? int((bbx - tbx) >> cbw) : 0;
                    P.ch = bby > tby ? int((bby - tby) >> cbh) : 0;
                    if (B.empty()) P.cw = P.ch = 0;
                    P.first = int(B.cblks.size());
                    for (int k = 0; k < P.cw * P.ch; ++k) {
                        Cblk cb;
                        int64_t cx = tbx + (int64_t(k % P.cw) << cbw), cy = tby + (int64_t(k / P.cw) << cbh);
                        cb.x0 = std::max(cx, x0); cb.y0 = std::max(cy, y0);
                        cb.x1 = std::min(cx + (int64_t(1) << cbw), x1);
                        cb.y1 = std::min(cy + (int64_t(1) << cbh), y1);
                        B.cblks.push_back(cb);
                    }
                    P.incl.init(P.cw, P.ch);
                    P.imsb.init(P.cw, P.ch);
                }
            }
        }
    }

    struct Packet { int l, r, c, p; };

    // the packets of a tile in codestream order (OpenJPEG's pi.c, with its
    // include table for POC changes)
    std::vector<Packet> packet_order(const Params &p, int64_t tx0, int64_t ty0, int64_t tx1,
                                     int64_t ty1, std::vector<TileComp> &tc) {
        int nc = h.nc, maxres = 0, maxprec = 0;
        for (auto &t : tc) {
            maxres = std::max(maxres, t.nres);
            for (auto &R : t.res) maxprec = std::max(maxprec, R.pw * R.ph);
        }
        std::vector<Poc> pocs = p.poc;
        if (pocs.empty()) pocs.push_back(Poc{0, 0, p.layers, maxres, nc, p.prog});
        int64_t nl = p.layers;
        std::vector<char> inc(size_t(nl) * maxres * nc * std::max(maxprec, 1), 0);
        std::vector<Packet> out;
        auto emit = [&](int l0, int l1, int r, int c, int pr) {
            for (int l = l0; l < l1; ++l) {
                size_t idx = ((size_t(l) * maxres + r) * nc + c) * std::max(maxprec, 1) + pr;
                if (!inc[idx]) { inc[idx] = 1; out.push_back(Packet{l, r, c, pr}); }
            }
        };
        for (const Poc &q : pocs) {
            int r0 = q.rs, r1 = std::min(q.re, maxres), c0 = q.cs, c1 = std::min(q.ce, nc);
            int l1 = std::min(q.lye, p.layers);
            auto position = [&](int c, int r, int64_t x, int64_t y) -> int {
                // the precinct of (c, r) that starts at reference (x, y), or -1
                TileComp &t = tc[c];
                if (r >= t.nres) return -1;
                Res &R = t.res[r];
                int level = t.nres - 1 - r;
                int64_t trx0 = ceildivpow2(tx0, level), try0 = ceildivpow2(ty0, level);
                int64_t trx1 = ceildivpow2(tx1, level), try1 = ceildivpow2(ty1, level);
                int rpx = R.pdx + level, rpy = R.pdy + level;
                if (rpx >= 62 || rpy >= 62) return -1;
                if (!((y % (int64_t(1) << rpy)) == 0 ||
                      (y == ty0 && ((try0 << level) % (int64_t(1) << rpy)))))
                    return -1;
                if (!((x % (int64_t(1) << rpx)) == 0 ||
                      (x == tx0 && ((trx0 << level) % (int64_t(1) << rpx)))))
                    return -1;
                if (!R.pw || !R.ph || trx0 == trx1 || try0 == try1) return -1;
                int64_t prci = floordivpow2(ceildivpow2(x, level), R.pdx) - floordivpow2(trx0, R.pdx);
                int64_t prcj = floordivpow2(ceildivpow2(y, level), R.pdy) - floordivpow2(try0, R.pdy);
                return int(prci + prcj * R.pw);
            };
            auto steps = [&](int cfrom, int cto, int64_t &sx, int64_t &sy) {
                sx = sy = 0;
                for (int c = cfrom; c < cto; ++c)
                    for (int r = 0; r < tc[c].nres; ++r) {
                        int level = tc[c].nres - 1 - r;
                        int ex = tc[c].res[r].pdx + level, ey = tc[c].res[r].pdy + level;
                        if (ex < 32) sx = !sx ? (int64_t(1) << ex) : std::min(sx, int64_t(1) << ex);
                        if (ey < 32) sy = !sy ? (int64_t(1) << ey) : std::min(sy, int64_t(1) << ey);
                    }
            };
            switch (q.prg) {
            case 0:  // LRCP
                for (int l = 0; l < l1; ++l)
                    for (int r = r0; r < r1; ++r)
                        for (int c = c0; c < c1; ++c) {
                            if (r >= tc[c].nres) continue;
                            int np = tc[c].res[r].pw * tc[c].res[r].ph;
                            for (int pr = 0; pr < np; ++pr) emit(l, l + 1, r, c, pr);
                        }
                break;
            case 1:  // RLCP
                for (int r = r0; r < r1; ++r)
                    for (int l = 0; l < l1; ++l)
                        for (int c = c0; c < c1; ++c) {
                            if (r >= tc[c].nres) continue;
                            int np = tc[c].res[r].pw * tc[c].res[r].ph;
                            for (int pr = 0; pr < np; ++pr) emit(l, l + 1, r, c, pr);
                        }
                break;
            case 2: {  // RPCL
                int64_t sx, sy;
                steps(0, nc, sx, sy);
                if (!sx || !sy) break;
                for (int r = r0; r < r1; ++r)
                    for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
                        for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
                            for (int c = c0; c < c1; ++c) {
                                int pr = position(c, r, x, y);
                                if (pr >= 0) emit(0, l1, r, c, pr);
                            }
                break;
            }
            case 3: {  // PCRL
                int64_t sx, sy;
                steps(0, nc, sx, sy);
                if (!sx || !sy) break;
                for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
                    for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
                        for (int c = c0; c < c1; ++c)
                            for (int r = r0; r < std::min(r1, tc[c].nres); ++r) {
                                int pr = position(c, r, x, y);
                                if (pr >= 0) emit(0, l1, r, c, pr);
                            }
                break;
            }
            case 4:  // CPRL
                for (int c = c0; c < c1; ++c) {
                    int64_t sx, sy;
                    steps(c, c + 1, sx, sy);
                    if (!sx || !sy) break;
                    for (int64_t y = ty0; y < ty1; y += sy - (y % sy))
                        for (int64_t x = tx0; x < tx1; x += sx - (x % sx))
                            for (int r = r0; r < std::min(r1, tc[c].nres); ++r) {
                                int pr = position(c, r, x, y);
                                if (pr >= 0) emit(0, l1, r, c, pr);
                            }
                }
                break;
            }
        }
        return out;
    }

    // a packet: its header from hp (the tile's data, or its PPM/PPT
    // headers), its body (after an SOP marker, if any) from bp; without
    // packed headers hp and bp are one pointer
    void read_packet(const Params &p, TileComp &t, const Packet &pk, const uint8_t *base,
                     const uint8_t *&hp, const uint8_t *hend, const uint8_t *&bp,
                     const uint8_t *bend) {
        Res &R = t.res[pk.r];
        if ((p.csty & 2) && bend - bp >= 6 && bp[0] == 0xff && bp[1] == 0x91) bp += 6;
        Bio bio{hp, hp, hend};
        auto end_header = [&]() {
            bio.inalign();
            hp = bio.p;
            if ((p.csty & 4) && hend - hp >= 2 && hp[0] == 0xff && hp[1] == 0x92) hp += 2;
        };
        if (!bio.read(1)) {
            end_header();
            return;
        }
        for (Band &B : R.bands) {
            if (B.empty()) continue;
            Precinct &P = B.prec[pk.p];
            for (int k = 0; k < P.cw * P.ch; ++k) {
                Cblk &cb = B.cblks[P.first + k];
                int included = cb.seen ? int(bio.read(1)) : tgt_decode(bio, P.incl, k, pk.l + 1);
                if (!included) { cb.newpasses = 0; continue; }
                if (!cb.seen) {
                    int i = 0;
                    while (!tgt_decode(bio, P.imsb, k, i)) {
                        if (++i > 74) bad("JPEG 2000 packet header: too many zero bit-planes");
                    }
                    cb.numbps = B.Mb + 1 - i;
                    cb.lblock = 3;
                    cb.seen = true;
                }
                int np;
                if (!bio.read(1)) np = 1;
                else if (!bio.read(1)) np = 2;
                else if ((np = int(bio.read(2))) != 3) np += 3;
                else if ((np = int(bio.read(5))) != 31) np += 6;
                else np = 37 + int(bio.read(7));
                while (bio.read(1)) ++cb.lblock;
                // the segments these passes fall in: the last one while it
                // has room, then new ones (OpenJPEG's header loop)
                const int style = p.cod[pk.c].style;
                cb.head.clear();
                if (!cb.segs.empty() && cb.segs.back().numpasses < cb.segs.back().maxpasses) {
                    cb.headseg = int(cb.segs.size()) - 1;
                    cb.head.push_back(cb.segs.back());
                } else {
                    cb.headseg = int(cb.segs.size());
                    cb.head.push_back(new_seg(style, cb.segs.empty() ? nullptr : &cb.segs.back()));
                }
                for (int n = np;;) {
                    Seg &sg = cb.head.back();
                    sg.newpasses = std::min(sg.maxpasses - sg.numpasses, n);
                    int bits = cb.lblock + floorlog2(uint32_t(sg.newpasses));
                    if (bits > 32) bad("JPEG 2000 packet header: code-word length too long");
                    sg.newlen = bio.read(bits);
                    n -= sg.newpasses;
                    if (n <= 0) break;
                    Seg prev = sg;
                    cb.head.push_back(new_seg(style, &prev));
                }
                cb.newpasses = np;
            }
        }
        end_header();
        for (Band &B : R.bands) {
            if (B.empty()) continue;
            Precinct &P = B.prec[pk.p];
            for (int k = 0; k < P.cw * P.ch; ++k) {
                Cblk &cb = B.cblks[P.first + k];
                if (!cb.newpasses) continue;
                for (size_t i = 0; i < cb.head.size(); ++i) {
                    const Seg &sg = cb.head[i];
                    if (int64_t(sg.newlen) > bend - bp) bad("JPEG 2000 packet data runs past its tile");
                    if (sg.newlen) cb.chunks.push_back({bp - base, sg.newlen});
                    bp += sg.newlen;
                    size_t at = size_t(cb.headseg) + i;
                    if (at == cb.segs.size()) {
                        cb.segs.push_back(sg);
                        cb.segs.back().numpasses = 0;
                        cb.segs.back().len = 0;
                    }
                    cb.segs[at].numpasses += sg.newpasses;
                    cb.segs[at].len += sg.newlen;
                }
                cb.npasses += cb.newpasses;
                cb.newpasses = 0;
            }
        }
    }

    void decode_tile(int tileno, TileData &td) {
        const Params &p = td.p;
        int tp = tileno % h.ntx, tq = tileno / h.ntx;
        int64_t tx0 = std::max(h.TX0 + tp * h.TW, h.X0), ty0 = std::max(h.TY0 + tq * h.TH, h.Y0);
        int64_t tx1 = std::min(h.TX0 + (tp + 1) * h.TW, h.X1), ty1 = std::min(h.TY0 + (tq + 1) * h.TH, h.Y1);
        std::vector<TileComp> tc(h.nc);
        for (int c = 0; c < h.nc; ++c) {
            tc[c].x0 = ceildiv(tx0, h.dx[c]); tc[c].y0 = ceildiv(ty0, h.dy[c]);
            tc[c].x1 = ceildiv(tx1, h.dx[c]); tc[c].y1 = ceildiv(ty1, h.dy[c]);
            build(tc[c], p.cod[c], p.q[c], c);
        }
        const uint8_t *base = td.bytes.data();
        const uint8_t *ptr = base, *end = base + td.bytes.size();
        const uint8_t *hp = td.headers.data(), *hend = hp + td.headers.size();
        for (const Packet &pk : packet_order(p, tx0, ty0, tx1, ty1, tc)) {
            // the tile's headers end: the rest of its packets are absent
            if (td.packed ? hp >= hend : ptr >= end) break;
            if (td.packed) read_packet(p, tc[pk.c], pk, base, hp, hend, ptr, end);
            else read_packet(p, tc[pk.c], pk, base, ptr, end, ptr, end);
        }
        // tier 1, one job a code-block, then the wavelet, one job a
        // component: jobs write disjoint samples, so any thread order
        // gives the same bits
        struct Job { TileComp *t; Band *B; Cblk *cb; int c; int64_t x, y; int64_t cost; };
        std::vector<Job> jobs;
        int64_t cost = 0;
        for (int c = 0; c < h.nc; ++c) {
            TileComp &t = tc[c];
            int64_t tw = t.x1 - t.x0, th = t.y1 - t.y0;
            t.rev = p.cod[c].qmfbid == 1;
            if (t.rev) t.idata.reset(new int32_t[size_t(tw * th)]);
            else t.fdata.reset(new float[size_t(tw * th)]);
            for (int r = 0; r < t.nres; ++r) {
                for (Band &B : t.res[r].bands) {
                    int64_t ox = 0, oy = 0;
                    if (B.bandno & 1) ox = t.res[r - 1].x1 - t.res[r - 1].x0;
                    if (B.bandno & 2) oy = t.res[r - 1].y1 - t.res[r - 1].y0;
                    for (Cblk &cb : B.cblks) {
                        if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
                        if (p.roi[c] + cb.numbps >= 31)
                            bad("JPEG 2000 code-block with 31 or more bit-planes");
                        int64_t work = (cb.x1 - cb.x0) * (cb.y1 - cb.y0) * (cb.npasses + 1);
                        jobs.push_back(Job{&t, &B, &cb, c, cb.x0 - B.x0 + ox, cb.y0 - B.y0 + oy, work});
                        cost += work;
                    }
                }
            }
        }
        parallel(jobs.size(), cost, [&](size_t j, Scratch &sc) {
            const Job &jb = jobs[j];
            TileComp &t = *jb.t;
            const Cblk &cb = *jb.cb;
            int cw = int(cb.x1 - cb.x0), chh = int(cb.y1 - cb.y0);
            int64_t tw = t.x1 - t.x0;
            if (!cb.npasses) {  // never included: zeros
                for (int j2 = 0; j2 < chh; ++j2) {
                    size_t at = size_t((jb.y + j2) * tw + jb.x);
                    if (t.rev) std::fill(&t.idata[at], &t.idata[at] + cw, 0);
                    else std::fill(&t.fdata[at], &t.fdata[at] + cw, 0.0f);
                }
                return;
            }
            size_t len = 0;
            for (auto &ch : cb.chunks) len += ch.second;
            sc.buf.resize(len + 2);
            size_t o = 0;
            for (auto &ch : cb.chunks) { memcpy(&sc.buf[o], base + ch.first, ch.second); o += ch.second; }
            sc.segs.clear();
            for (const Seg &sg : cb.segs) sc.segs.push_back(SegSpan{sg.len, sg.numpasses});
            sc.t1.decode(sc.buf.data(), sc.segs, cw, chh, jb.B->bandno, cb.numbps, p.roi[jb.c],
                         p.cod[jb.c].style);
            const int32_t *v = sc.t1.data.data();
            if (t.rev) {
                for (int j2 = 0; j2 < chh; ++j2)
                    for (int i = 0; i < cw; ++i)
                        t.idata[size_t((jb.y + j2) * tw + jb.x + i)] = v[size_t(j2) * cw + i] / 2;
            } else {
                const float s = 0.5f * jb.B->step;
                for (int j2 = 0; j2 < chh; ++j2)
                    for (int i = 0; i < cw; ++i)
                        t.fdata[size_t((jb.y + j2) * tw + jb.x + i)] = float(v[size_t(j2) * cw + i]) * s;
            }
        });
        int64_t work = 0;
        for (auto &t : tc) work += (t.x1 - t.x0) * (t.y1 - t.y0);
        parallel(size_t(h.nc), work * 8, [&](size_t c, Scratch &) {
            TileComp &t = tc[c];
            int64_t tw = t.x1 - t.x0;
            if (t.rev) inverse_dwt(t, t.idata.get(), tw);
            else inverse_dwt(t, t.fdata.get(), tw);
        });
        if (p.mct && h.nc >= 3) colour_transform(tc);
        parallel(size_t(h.nc), work, [&](size_t c, Scratch &) {
            TileComp &t = tc[c];
            int prec = h.prec[c];
            int64_t lo, hi, shift = p.dc[c];
            if (h.sgnd[c]) { lo = -(int64_t(1) << (prec - 1)); hi = (int64_t(1) << (prec - 1)) - 1; }
            else { lo = 0; hi = (int64_t(1) << prec) - 1; }
            int64_t tw = t.x1 - t.x0, th = t.y1 - t.y0;
            int64_t cx0 = ceildiv(h.X0, h.dx[c]), cy0 = ceildiv(h.Y0, h.dy[c]);
            int64_t cw = ceildiv(h.X1, h.dx[c]) - cx0;
            int32_t *plane = out + plane_offset[c];
            for (int64_t j = 0; j < th; ++j) {
                int32_t *row = plane + (t.y0 - cy0 + j) * cw + (t.x0 - cx0);
                if (t.rev) {
                    const int32_t *src = &t.idata[size_t(j * tw)];
                    for (int64_t i = 0; i < tw; ++i) {
                        int64_t v = int32_t(uint32_t(src[i]) + uint32_t(shift));
                        row[i] = int32_t(v < lo ? lo : v > hi ? hi : v);
                    }
                } else {
                    // OpenJPEG: above INT_MAX -> hi, below INT_MIN or NaN
                    // (lrintf gives INT64_MIN) -> lo, else the rounded
                    // value plus the shift, clamped; the same here without
                    // branches (the min keeps NaN and +inf in range)
                    const float *src = &t.fdata[size_t(j * tw)];
                    for (int64_t i = 0; i < tw; ++i) {
                        int64_t v = round_float(std::min(src[i], 0x1p62f)) + shift;
                        row[i] = int32_t(v < lo ? lo : v > hi ? hi : v);
                    }
                }
            }
        });
    }

    // the RCT or ICT of the first three components (opj_tcd_mct_decode):
    // they must have as many resolutions and samples; component 0's
    // wavelet chooses the transform, which reads each buffer's 32-bit
    // words as its type (OpenJPEG keeps every component in one int32 array)
    void colour_transform(std::vector<TileComp> &tc) {
        size_t ns = size_t((tc[0].x1 - tc[0].x0) * (tc[0].y1 - tc[0].y0));
        for (int c = 1; c < 3; ++c)
            if (tc[c].nres != tc[0].nres ||
                size_t((tc[c].x1 - tc[c].x0) * (tc[c].y1 - tc[c].y0)) != ns)
                bad("JPEG 2000: components of different dimensions under a colour transform");
        bool rev = tc[0].rev;
        if (tc[1].rev == rev && tc[2].rev == rev) {
            if (rev) {
                int32_t *c0 = tc[0].idata.get(), *c1 = tc[1].idata.get(), *c2 = tc[2].idata.get();
                for (size_t i = 0; i < ns; ++i) rct(c0[i], c1[i], c2[i]);
            } else {
                float *c0 = tc[0].fdata.get(), *c1 = tc[1].fdata.get(), *c2 = tc[2].fdata.get();
                for (size_t i = 0; i < ns; ++i) ict(c0[i], c1[i], c2[i]);
            }
            return;
        }
        void *buf[3];
        for (int c = 0; c < 3; ++c)
            buf[c] = tc[c].rev ? static_cast<void *>(tc[c].idata.get()) : static_cast<void *>(tc[c].fdata.get());
        for (size_t i = 0; i < ns; ++i) {
            uint32_t w[3];
            for (int c = 0; c < 3; ++c) memcpy(&w[c], static_cast<uint8_t *>(buf[c]) + 4 * i, 4);
            if (rev) {
                int32_t v[3];
                memcpy(v, w, sizeof v);
                rct(v[0], v[1], v[2]);
                memcpy(w, v, sizeof v);
            } else {
                float v[3];
                memcpy(v, w, sizeof v);
                ict(v[0], v[1], v[2]);
                memcpy(w, v, sizeof v);
            }
            for (int c = 0; c < 3; ++c) memcpy(static_cast<uint8_t *>(buf[c]) + 4 * i, &w[c], 4);
        }
    }

    static void rct(int32_t &c0, int32_t &c1, int32_t &c2) {
        int32_t y = c0, u = c1, v = c2;
        int32_t g = y - ((u + v) >> 2);
        c0 = v + g; c1 = g; c2 = u + g;
    }

    static void ict(float &c0, float &c1, float &c2) {
        float y = c0, u = c1, v = c2;
        float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f) - (v * 0.71414f);
        float b = y + (u * 1.772f);
        c0 = r; c1 = g; c2 = b;
    }

    // OpenJPEG's order: one resolution at a time, its rows, then its columns
    template <class T>
    void inverse_dwt(TileComp &t, T *data, int64_t stride) {
        std::vector<T> tmp;
        for (int r = 1; r < t.nres; ++r) {
            Res &R = t.res[r], &P = t.res[r - 1];
            int rw = int(R.x1 - R.x0), rh = int(R.y1 - R.y0);
            int snw = int(P.x1 - P.x0), snh = int(P.y1 - P.y0);
            int casx = int(R.x0 & 1), casy = int(R.y0 & 1);
            for (int j = 0; j < rh; j += kLanes)
                idwt_lines(data + j * stride, stride, 1, std::min(kLanes, rh - j), rw, snw, casx, tmp);
            for (int i = 0; i < rw; i += kLanes)
                idwt_lines(data + i, 1, stride, std::min(kLanes, rw - i), rh, snh, casy, tmp);
        }
    }
};

void set_error(const Error &e, char *err, int64_t errlen) {
    if (err && errlen > 0) {
        size_t k = std::min<size_t>(e.msg.size(), size_t(errlen - 1));
        memcpy(err, e.msg.data(), k);
        err[k] = 0;
    }
}

}  // namespace

extern "C" int64_t j2k_info(const uint8_t *cs, int64_t n, int64_t *info, int64_t cap, char *err,
                            int64_t errlen) {
    try {
        Header h;
        int64_t pos;
        read_main_header(cs, n, h, pos);
        if (cap < 5) bad("JPEG 2000: no room for the header's fields");
        info[0] = h.X0; info[1] = h.Y0; info[2] = h.X1; info[3] = h.Y1; info[4] = h.nc;
        for (int i = 0; i < h.nc && 8 + 4 * i < cap; ++i) {
            info[5 + 4 * i] = h.prec[i];
            info[6 + 4 * i] = h.sgnd[i];
            info[7 + 4 * i] = h.dx[i];
            info[8 + 4 * i] = h.dy[i];
        }
        return h.nc;
    } catch (const Error &e) {
        set_error(e, err, errlen);
        return -e.kind;
    } catch (const std::bad_alloc &) {
        set_error(Error{1, "JPEG 2000: out of memory"}, err, errlen);
        return -1;
    }
}

extern "C" int64_t j2k_decode_tiles(const uint8_t *cs, int64_t n, int32_t *out, int32_t *order,
                                    char *err, int64_t errlen) {
    try {
        static std::once_flag luts;
        std::call_once(luts, init_luts);
        Decoder dec;
        dec.d = cs;
        dec.n = n;
        dec.out = out;
        dec.order = order;
        dec.run();
        return 0;
    } catch (const Error &e) {
        set_error(e, err, errlen);
        return -e.kind;
    } catch (const std::bad_alloc &) {
        set_error(Error{1, "JPEG 2000: out of memory"}, err, errlen);
        return -1;
    }
}

extern "C" int64_t j2k_decode(const uint8_t *cs, int64_t n, int32_t *out, char *err,
                              int64_t errlen) {
    return j2k_decode_tiles(cs, n, out, nullptr, err, errlen);
}

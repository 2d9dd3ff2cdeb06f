"""A JPEG 2000 codestream writer for the coding modes Pillow reads but
does not write: the test side of data/jpeg2000.py's decoder
(tests/test_torch_jpeg2000_modes.py and its committed fixtures), never used
by ``main``.

``encode(planes, ...)`` writes a raw codestream (T.800 Annex A markers
SOC, SIZ, COD, COC, QCD, QCC, RGN, SOT, SOD, EOC) of one to four 8-bit
components, each coded at its own size, ceil(X1 / dx) - ceil(X0 / dx) by
ceil(Y1 / dy) - ceil(Y0 / dy), with:

* the reversible 5/3 wavelet with the RCT, or the 9/7 wavelet with the ICT
  and scalar expounded quantization, at any number of levels, image and
  tile offsets and tiles;
* EBCOT tier 1 (Annex D): the MQ coder of Annex C (its 47 states are the
  decoder's ``kQe``/``kNmps``/``kNlps``/``kSwitch``, copied), the
  significance, refinement and cleanup passes with the standard's
  contexts, and every code-block style bit but HT: selective arithmetic
  coding bypass (raw passes with the bit stuffing after 0xFF, segments of
  10, then 2 and 1 passes), context reset, termination on each pass,
  vertically causal contexts, predictable termination and segmentation
  symbols, in any combination;
* ROI max-shift (Annex H): the coefficients of a rectangle shifted up by
  SPrgn bits, written with an RGN segment;
* tier 2 (Annex B): tag trees, pass counts, Lblock and one length a
  codeword segment, several quality layers (a code-block's passes split
  evenly across them, so segments run on across packets), precincts and
  the LRCP, RLCP, RPCL and CPRL progressions.

OpenJPEG 2.5.4 (Pillow's decoder) differs from the standard in two places
this writer follows, so that a lossless stream reads back equal through
Pillow: it counts the 4 bit-planes a bypass code-block codes with the MQ
coder from the top of the unshifted magnitudes, not from the top coded
bit-plane, under an ROI shift (``raw_offset``), and it shifts an ROI
coefficient down when its decoded magnitude, with one fractional bit, is
at least 2^SPrgn, so SPrgn is one more than the background needs.
Everything is numpy and plain Python.
"""

from __future__ import annotations

import math
import struct

import numpy as np

# T.800 Table C.2, as native/j2kdec.cpp holds it (a test holds the copies
# equal)
QE = [
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601]
NMPS = [
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46]
NLPS = [
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46]
SWITCH = [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
          0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]

PREC = 8          # the samples' bits
# code-block style bits (Table A.19)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "CPRL": 4}

# contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run, 18 uniform
_AGG, _UNI = 17, 18
_K97 = 1.230174105
_ALPHA, _BETA, _GAMMA, _DELTA = (-1.586134342, -0.052980118, 0.882911075,
                                 0.443506852)


def _zc_table(orient: int) -> list:
    """Zero-coding context of (h, v, d) significant neighbours at h * 15 +
    v * 5 + d (Table D.1; HL swaps h and v, HH reads the diagonals)."""
    out = [0] * 45
    for h in range(3):
        for v in range(3):
            for d in range(5):
                hh, vv = (v, h) if orient == 1 else (h, v)
                if orient != 3:
                    if not hh:
                        n = (0 if not d else 1 if d == 1 else 2) if not vv \
                            else 3 if vv == 1 else 4
                    elif hh == 1:
                        n = (5 if not d else 6) if not vv else 7
                    else:
                        n = 8
                else:
                    hv = hh + vv
                    n = ((0 if not hv else 1 if hv == 1 else 2) if not d else
                         (3 if not hv else 4 if hv == 1 else 5) if d == 1 else
                         (6 if not hv else 7) if d == 2 else 8)
                out[h * 15 + v * 5 + d] = n
    return out


_ZC = [_zc_table(o) for o in range(4)]


def _sc(hc: int, vc: int) -> tuple:
    """(context, XOR bit) of the sign from the clamped horizontal and
    vertical contributions (Table D.3)."""
    hc, vc = max(-1, min(1, hc)), max(-1, min(1, vc))
    x = 0
    if hc < 0:
        hc, vc, x = -hc, -vc, 1
    if hc == 0 and vc < 0:
        vc, x = -vc, 1
    return (13 if vc == 1 else 12 if vc == 0 else 11) if hc == 1 else \
        (10 if vc == 1 else 9), x


_SC = {(h, v): _sc(h, v) for h in range(-2, 3) for v in range(-2, 3)}


# ------------------------------------------------------------- the coders
class MQEncoder:
    """The MQ coder of T.800 Annex C (OpenJPEG's byte-out and flush);
    the contexts outlive a restart, the registers do not."""

    def __init__(self):
        self.reset_contexts()
        self.restart()

    def reset_contexts(self) -> None:
        self.st = [0] * 19
        self.mps = [0] * 19
        self.st[_UNI], self.st[_AGG], self.st[0] = 46, 3, 4

    def restart(self) -> None:
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray(b"\0")        # out[0]: the byte before the start

    def _byteout(self) -> None:
        out = self.out
        if out[-1] == 0xFF:
            out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            out[-1] += 1
            if out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, cx: int, d: int) -> None:
        st = self.st[cx]
        qe = QE[st]
        a = self.a - qe
        if d == self.mps[cx]:
            if a & 0x8000:
                self.a = a
                self.c += qe
                return
            if a < qe:
                a = qe
            else:
                self.c += qe
            self.st[cx] = NMPS[st]
        else:
            if a < qe:
                self.c += qe
            else:
                a = qe
            if SWITCH[st]:
                self.mps[cx] ^= 1
            self.st[cx] = NLPS[st]
        while True:
            a <<= 1
            self.c <<= 1
            self.ct -= 1
            if not self.ct:
                self._byteout()
            if a & 0x8000:
                break
        self.a = a

    def _bytes(self) -> bytes:
        out = self.out
        return bytes(out[1:] if out[-1] != 0xFF else out[1:-1])

    def flush(self) -> bytes:
        """C.2.9: SETBITS, two byte-outs; a final 0xFF is dropped."""
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        return self._bytes()

    def erterm(self) -> bytes:
        """Predictable termination (D.4.2), as opj_mqc_erterm_enc."""
        k = 12 - self.ct
        while k > 0:
            self.c <<= self.ct
            self.ct = 0
            self._byteout()
            k -= self.ct
        return self._bytes()

    def pending(self) -> int:
        return len(self.out) - 1


class RawEncoder:
    """Raw (bypass) bits, a 0 bit stuffed after each 0xFF byte; the flush
    of opj_mqc_bypass_flush_enc."""

    def __init__(self, before: int):
        self.out = bytearray()
        self.before = before              # the segment's preceding byte
        self.c, self.ct, self.any = 0, 8, False

    def bit(self, d: int) -> None:
        self.any = True
        self.ct -= 1
        self.c += d << self.ct
        if not self.ct:
            self.out.append(self.c)
            self.ct = 7 if self.c == 0xFF else 8
            self.c = 0

    def _last(self) -> int:
        return self.out[-1] if self.out else self.before

    def flush(self, erterm: bool) -> bytes:
        if not self.any:
            return b""
        if self.ct < 7 or (self.ct == 7 and (erterm or self._last() != 0xFF)):
            bit = 0
            while self.ct > 0:
                self.ct -= 1
                self.c += bit << self.ct
                bit ^= 1
            self.out.append(self.c)
        elif self.ct == 7 and self._last() == 0xFF:
            self.out.pop()
        elif self.ct == 8 and not erterm and len(self.out) >= 2 and \
                self.out[-1] == 0x7F and self.out[-2] == 0xFF:
            del self.out[-2:]
        return bytes(self.out)

    def pending(self) -> int:
        return len(self.out)


# ---------------------------------------------------------------- tier 1
def _pass_plane(k: int, j: int) -> tuple:
    """(bit-plane, pass type: 0 significance, 1 refinement, 2 cleanup) of
    pass j of a code-block of k bit-planes."""
    if j == 0:
        return k - 1, 2
    return k - 2 - (j - 1) // 3, (j - 1) % 3


def segment_lengths(style: int, npasses: int) -> list:
    """The passes of each codeword segment: one a pass under termall,
    10, then 2 and 1 under bypass, else up to 109 (opj_t2_init_seg)."""
    out = []
    while sum(out) < npasses:
        if style & TERMALL:
            n = 1
        elif style & BYPASS:
            n = 10 if not out else 2 if out[-1] in (1, 10) else 1
        else:
            n = 109
        out.append(min(n, npasses - sum(out)))
    return out


def encode_block(mag: np.ndarray, neg: np.ndarray, orient: int, style: int,
                 raw_offset: int = 0) -> tuple:
    """EBCOT tier 1 of one code-block: (bit-planes, [segment bytes],
    [(segment, its bytes up to the pass's end)] a pass). ``raw_offset``:
    a bypass segment is raw when its first pass is a significance or
    refinement pass at a bit-plane of index below bit-planes - 4 -
    raw_offset (OpenJPEG's rule under an ROI shift of raw_offset)."""
    h, w = mag.shape
    nbits = int(mag.max()).bit_length() if mag.size else 0
    if nbits == 0:
        return 0, [], []
    S = w + 2
    size = (h + 2) * S
    M, N = [0] * size, [0] * size
    for y in range(h):
        base = (y + 1) * S + 1
        M[base:base + w] = mag[y].tolist()
        N[base:base + w] = neg[y].astype(int).tolist()
    sig, vis, ref = [0] * size, [0] * size, [0] * size
    vsc = bool(style & VSC)
    cols = []       # per stripe column: (full, [(index, sees its south)])
    for y0 in range(0, h, 4):
        rows = range(y0, min(y0 + 4, h))
        for x in range(w):
            cols.append((len(rows) == 4, [
                ((y + 1) * S + x + 1, not (vsc and (y & 3) == 3))
                for y in rows]))
    zc = _ZC[orient]

    def zctx(i, south):
        h_ = sig[i - 1] + sig[i + 1]
        if south:
            v_ = sig[i - S] + sig[i + S]
            d_ = sig[i - S - 1] + sig[i - S + 1] + sig[i + S - 1] + \
                sig[i + S + 1]
        else:
            v_ = sig[i - S]
            d_ = sig[i - S - 1] + sig[i - S + 1]
        return zc[h_ * 15 + v_ * 5 + d_]

    def sctx(i, south):
        hc = (sig[i - 1] and 1 - 2 * N[i - 1]) + (sig[i + 1] and
                                                  1 - 2 * N[i + 1])
        vc = sig[i - S] and 1 - 2 * N[i - S]
        if south:
            vc += sig[i + S] and 1 - 2 * N[i + S]
        return _SC[hc, vc]

    mq = MQEncoder()
    segs, passes = [], []
    npasses = 3 * nbits - 2
    start = 0
    for count in segment_lengths(style, npasses):
        p0, t0 = _pass_plane(nbits, start)
        raw = bool(style & BYPASS) and t0 < 2 and \
            p0 + 1 <= nbits - raw_offset - 4
        if raw:
            coder = RawEncoder(segs[-1][-1] if segs and segs[-1] else 0)
            put = coder.bit
        else:
            mq.restart()
            coder = mq
            enc = mq.encode
        for j in range(start, start + count):
            p, kind = _pass_plane(nbits, j)
            if kind == 0:
                for _, column in cols:
                    for i, south in column:
                        if sig[i]:
                            continue
                        cx = zctx(i, south)
                        if not cx:
                            continue
                        bit = (M[i] >> p) & 1
                        if raw:
                            put(bit)
                            if bit:
                                put(N[i])
                        else:
                            enc(cx, bit)
                            if bit:
                                c, x = sctx(i, south)
                                enc(c, N[i] ^ x)
                        if bit:
                            sig[i] = 1
                        vis[i] = 1
            elif kind == 1:
                for _, column in cols:
                    for i, south in column:
                        if not sig[i] or vis[i]:
                            continue
                        bit = (M[i] >> p) & 1
                        if raw:
                            put(bit)
                        else:
                            if ref[i]:
                                cx = 16
                            elif sig[i - 1] or sig[i + 1] or sig[i - S] or \
                                    sig[i - S - 1] or sig[i - S + 1] or (
                                        south and (sig[i + S] or sig[i + S - 1]
                                                   or sig[i + S + 1])):
                                cx = 15
                            else:
                                cx = 14
                            enc(cx, bit)
                        ref[i] = 1
            else:
                for full, column in cols:
                    k = 0
                    if full and not any(sig[i] or vis[i] or zctx(i, s)
                                        for i, s in column):
                        bits = [(M[i] >> p) & 1 for i, _ in column]
                        if not any(bits):
                            enc(_AGG, 0)
                            continue
                        enc(_AGG, 1)
                        r = bits.index(1)
                        enc(_UNI, r >> 1)
                        enc(_UNI, r & 1)
                        i, s = column[r]
                        c, x = sctx(i, s)
                        enc(c, N[i] ^ x)
                        sig[i] = 1
                        k = r + 1
                    for i, s in column[k:]:
                        if not (sig[i] or vis[i]):
                            bit = (M[i] >> p) & 1
                            enc(zctx(i, s), bit)
                            if bit:
                                c, x = sctx(i, s)
                                enc(c, N[i] ^ x)
                                sig[i] = 1
                    for i, _ in column:
                        vis[i] = 0
                if style & SEGSYM:
                    for b in (1, 0, 1, 0):
                        enc(_UNI, b)
            if style & RESET and not raw:
                mq.reset_contexts()
            passes.append([len(segs), coder.pending()])
        if raw:
            data = coder.flush(bool(style & PTERM))
        else:
            data = mq.erterm() if style & PTERM else mq.flush()
        for pr in passes[start:]:
            pr[1] = min(pr[1], len(data))
        passes[-1][1] = len(data)
        segs.append(data)
        start += count
    return nbits, segs, passes


# ---------------------------------------------------------------- wavelets
def _neighbours(idx: np.ndarray, n: int) -> tuple:
    """Left and right neighbours of idx, mirrored at 0 and n - 1."""
    left, right = idx - 1, idx + 1
    left[left < 0] = 1
    right[right >= n] = n - 2
    return left, right


def _forward_1d(x: np.ndarray, cas: int, reversible: bool) -> tuple:
    """One level of the forward wavelet along axis 0 of x, whose first
    sample sits at a coordinate of parity cas: (low, high)."""
    n = x.shape[0]
    if n == 1:
        if cas:
            return x[:0], (x * 2 if reversible else x.copy())
        return x.copy(), x[:0]
    x = x.copy()
    hi, lo = np.arange(1 - cas, n, 2), np.arange(cas, n, 2)
    lh, rh = _neighbours(hi, n)
    ll, rl = _neighbours(lo, n)
    if reversible:
        x[hi] -= (x[lh] + x[rh]) >> 1
        x[lo] += (x[ll] + x[rl] + 2) >> 2
    else:
        x[hi] += _ALPHA * (x[lh] + x[rh])
        x[lo] += _BETA * (x[ll] + x[rl])
        x[hi] += _GAMMA * (x[lh] + x[rh])
        x[lo] += _DELTA * (x[ll] + x[rl])
        x[lo] /= _K97
        x[hi] *= _K97 / 2
    return x[lo], x[hi]


def forward_dwt(a: np.ndarray, x0: int, y0: int, levels: int,
                reversible: bool) -> dict:
    """{(resolution, band): coefficients} of a tile-component at (x0, y0):
    the columns of each level first, then its rows (the inverse of
    OpenJPEG's rows-then-columns)."""
    a = a.astype(np.int64 if reversible else np.float64)
    out = {}
    for lev in range(levels):
        r = levels - lev
        rx0, ry0 = -(-x0 >> lev), -(-y0 >> lev)
        low, high = _forward_1d(a, ry0 & 1, reversible)
        ll, hl = (t.T for t in _forward_1d(low.T, rx0 & 1, reversible))
        lh, hh = (t.T for t in _forward_1d(high.T, rx0 & 1, reversible))
        out[r, 1], out[r, 2], out[r, 3] = hl, lh, hh
        a = ll
    out[0, 0] = a
    return out


# ---------------------------------------------------------------- tier 2
class _Bits:
    """Packet-header bits (opj_bio): a 0 bit stuffed after each 0xFF."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def _byteout(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def put(self, b: int) -> None:
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= b << self.ct

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTree:
    """opj_tgt's encoder: leaves in raster order, a node's value the least
    of its children's."""

    def __init__(self, w: int, h: int, values):
        self.parent, lw, lh = [], [w], [h]
        while lw[-1] * lh[-1] > 1:
            lw.append((lw[-1] + 1) // 2)
            lh.append((lh[-1] + 1) // 2)
        base = [0]
        for a, b in zip(lw, lh):
            base.append(base[-1] + a * b)
        n = base[-1] if w * h else 0
        self.value, self.low, self.known = [999] * n, [0] * n, [0] * n
        self.parent = [-1] * n
        for lev in range(len(lw) - 1):
            for y in range(lh[lev]):
                for x in range(lw[lev]):
                    self.parent[base[lev] + y * lw[lev] + x] = \
                        base[lev + 1] + (y // 2) * lw[lev + 1] + x // 2
        for i, v in enumerate(values):
            node = i
            while node >= 0 and self.value[node] > v:
                self.value[node] = v
                node = self.parent[node]

    def encode(self, bio: _Bits, leaf: int, threshold: int) -> None:
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bio.put(1)
                        self.known[node] = 1
                    break
                bio.put(0)
                low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()


def _cdp(a: int, b: int) -> int:
    return -(-a >> b)


def _cd(a: int, b: int) -> int:
    return -(-a // b)


class _Cblk:
    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.nbits, self.segs, self.passes = 0, [], []
        self.zero_planes, self.first_layer, self.cum = 0, 999, []
        self.lblock = 3


def build_geometry(tc: tuple, levels: int, xcb: int, ycb: int, ppx, ppy):
    """The resolutions of a tile-component (j2kdec.cpp's build): each
    (x0, y0, x1, y1, pw, ph, pdx, pdy, [(bandno, (bx0, by0, bx1, by1),
    [precinct: (cw, ch, [cblks])])])."""
    x0, y0, x1, y1 = tc
    out = []
    for r in range(levels + 1):
        level = levels - r
        rx0, ry0, rx1, ry1 = (_cdp(v, level) for v in (x0, y0, x1, y1))
        pdx, pdy = ppx[r], ppy[r]
        tlx, tly = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        brx, bry = _cdp(rx1, pdx) << pdx, _cdp(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (brx - tlx) >> pdx
        ph = 0 if ry0 == ry1 else (bry - tly) >> pdy
        if r == 0:
            cbgx0, cbgy0, cbgw, cbgh = tlx, tly, pdx, pdy
        else:
            cbgx0, cbgy0 = _cdp(tlx, 1), _cdp(tly, 1)
            cbgw, cbgh = pdx - 1, pdy - 1
        cbw, cbh = min(xcb, cbgw), min(ycb, cbgh)
        bands = []
        for b in ([0] if r == 0 else [1, 2, 3]):
            if r == 0:
                bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
            else:
                ox, oy = (b & 1) << level, (b >> 1) << level
                bx0, bx1 = _cdp(x0 - ox, level + 1), _cdp(x1 - ox, level + 1)
                by0, by1 = _cdp(y0 - oy, level + 1), _cdp(y1 - oy, level + 1)
            empty = bx0 >= bx1 or by0 >= by1
            precs = []
            for pi in range(pw * ph):
                px0 = cbgx0 + ((pi % pw) << cbgw)
                py0 = cbgy0 + ((pi // pw) << cbgh)
                qx0, qy0 = max(px0, bx0), max(py0, by0)
                qx1 = min(px0 + (1 << cbgw), bx1)
                qy1 = min(py0 + (1 << cbgh), by1)
                tbx, tby = (qx0 >> cbw) << cbw, (qy0 >> cbh) << cbh
                bbx, bby = _cdp(qx1, cbw) << cbw, _cdp(qy1, cbh) << cbh
                cw = (bbx - tbx) >> cbw if bbx > tbx else 0
                ch = (bby - tby) >> cbh if bby > tby else 0
                if empty:
                    cw = ch = 0
                cbs = []
                for k in range(cw * ch):
                    cx = tbx + ((k % cw) << cbw)
                    cy = tby + ((k // cw) << cbh)
                    cbs.append(_Cblk(max(cx, qx0), max(cy, qy0),
                                     min(cx + (1 << cbw), qx1),
                                     min(cy + (1 << cbh), qy1)))
                precs.append((cw, ch, cbs))
            bands.append((b, (bx0, by0, bx1, by1), precs))
        out.append((rx0, ry0, rx1, ry1, pw, ph, pdx, pdy, bands))
    return out


def packet_order(prog: int, layers: int, tile: tuple, comps: list) -> list:
    """(layer, resolution, component, precinct) of a tile's packets in
    progression order (j2kdec.cpp's packet_order without POC, and without
    PCRL); comps: each component's (geometry, dx, dy)."""
    tx0, ty0, tx1, ty1 = tile
    out = []
    nc = len(comps)
    maxres = max(len(g) for g, _, _ in comps)

    def nprec(c, r):
        g = comps[c][0]
        return g[r][4] * g[r][5] if r < len(g) else 0

    def position(c, r, x, y):
        g, dx, dy = comps[c]
        if r >= len(g):
            return -1
        rx0, ry0, rx1, ry1, pw, ph, pdx, pdy, _ = g[r]
        level = len(g) - 1 - r
        cx0, cy0 = _cd(tx0, dx), _cd(ty0, dy)
        cx1, cy1 = _cd(tx1, dx), _cd(ty1, dy)
        trx0, try0 = _cdp(cx0, level), _cdp(cy0, level)
        trx1, try1 = _cdp(cx1, level), _cdp(cy1, level)
        rpx, rpy = pdx + level, pdy + level
        if not (y % (dy << rpy) == 0 or (y == ty0 and
                                         ((try0 << level) % (1 << rpy)))):
            return -1
        if not (x % (dx << rpx) == 0 or (x == tx0 and
                                         ((trx0 << level) % (1 << rpx)))):
            return -1
        if not pw or not ph or trx0 == trx1 or try0 == try1:
            return -1
        prci = (_cd(x, dx << level) >> pdx) - (trx0 >> pdx)
        prcj = (_cd(y, dy << level) >> pdy) - (try0 >> pdy)
        return prci + prcj * pw

    def steps(cs):
        sx = sy = 0
        for c in cs:
            g, dx, dy = comps[c]
            for r in range(len(g)):
                level = len(g) - 1 - r
                ex = dx << (g[r][6] + level)
                ey = dy << (g[r][7] + level)
                sx = ex if not sx else min(sx, ex)
                sy = ey if not sy else min(sy, ey)
        return sx, sy

    def grid(cs):
        sx, sy = steps(cs)
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += sx - x % sx
            y += sy - y % sy

    if prog == 0:
        for l in range(layers):
            for r in range(maxres):
                for c in range(nc):
                    out += [(l, r, c, p) for p in range(nprec(c, r))]
    elif prog == 1:
        for r in range(maxres):
            for l in range(layers):
                for c in range(nc):
                    out += [(l, r, c, p) for p in range(nprec(c, r))]
    elif prog == 2:
        for r in range(maxres):
            for x, y in grid(range(nc)):
                for c in range(nc):
                    p = position(c, r, x, y)
                    if p >= 0:
                        out += [(l, r, c, p) for l in range(layers)]
    else:
        for c in range(nc):
            for x, y in grid([c]):
                for r in range(len(comps[c][0])):
                    p = position(c, r, x, y)
                    if p >= 0:
                        out += [(l, r, c, p) for l in range(layers)]
    seen, order = set(), []
    for pk in out:
        if pk not in seen:
            seen.add(pk)
            order.append(pk)
    return order


def _numpasses(bio: _Bits, n: int) -> None:
    if n == 1:
        bio.put(0)
    elif n == 2:
        bio.bits(2, 2)
    elif n <= 5:
        bio.bits(3, 2)
        bio.bits(n - 3, 2)
    elif n <= 36:
        bio.bits(15, 4)
        bio.bits(n - 6, 5)
    else:
        bio.bits(511, 9)
        bio.bits(n - 37, 7)


def _parts(cb: _Cblk, first: int, last: int) -> list:
    """(passes, bytes) of each codeword segment's share of passes
    [first, last) of a code-block."""
    out = []
    j = first
    while j < last:
        s = cb.passes[j][0]
        k = j
        while k < last and cb.passes[k][0] == s:
            k += 1
        before = cb.passes[j - 1][1] if j and cb.passes[j - 1][0] == s else 0
        out.append((k - j, cb.passes[k - 1][1] - before, s, before))
        j = k
    return out


def _packet(layer: int, bands: list, prec: int, trees: dict) -> bytes:
    """One packet of a precinct: its header and its body."""
    bio, body = _Bits(), []
    cblks = [cb for _, _, precs in bands for cb in precs[prec][2]]
    if not any(cb.cum and cb.cum[layer] > (cb.cum[layer - 1] if layer else 0)
               for cb in cblks):
        bio.put(0)
        return bio.flush()
    bio.put(1)
    for bi, (_, (bx0, by0, bx1, by1), precs) in enumerate(bands):
        if bx0 >= bx1 or by0 >= by1:
            continue
        cw, ch, cbs = precs[prec]
        incl, imsb = trees[bi, prec]
        for k, cb in enumerate(cbs):
            before = cb.cum[layer - 1] if cb.cum and layer else 0
            now = cb.cum[layer] if cb.cum else 0
            if cb.first_layer >= layer:
                incl.encode(bio, k, layer + 1)
            else:
                bio.put(int(now > before))
            if now <= before:
                continue
            if cb.first_layer == layer:
                imsb.encode(bio, k, 999)
            _numpasses(bio, now - before)
            parts = _parts(cb, before, now)
            need = max(n.bit_length() - (np_.bit_length() - 1)
                       for np_, n, _, _ in parts)
            inc = max(0, need - cb.lblock)
            for _ in range(inc):
                bio.put(1)
            bio.put(0)
            cb.lblock += inc
            for np_, n, s, at in parts:
                bio.bits(n, cb.lblock + np_.bit_length() - 1)
                body.append(cb.segs[s][at:at + n])
    return bio.flush() + b"".join(body)


# ------------------------------------------------------------ the writer
class Component:
    """A component's coding: sub-sampling, levels, code-block exponents,
    style, wavelet, precinct exponents (one (ppx, ppy) a resolution, or
    None), and for the 9/7 the quantization step."""

    def __init__(self, dx=1, dy=1, levels=5, cblk=(6, 6), style=0,
                 reversible=True, precincts=None, step=1.0):
        self.dx, self.dy, self.levels = dx, dy, levels
        self.xcb, self.ycb = cblk
        self.style, self.reversible = style, reversible
        self.precincts, self.step = precincts, step

    def cod_key(self):
        return (self.levels, self.xcb, self.ycb, self.style,
                self.reversible, tuple(self.precincts or ()))

    def spcod(self) -> bytes:
        b = bytes([self.levels, self.xcb - 2, self.ycb - 2, self.style,
                   int(self.reversible)])
        if self.precincts:
            b += bytes(px | (py << 4) for px, py in self.precincts)
        return b

    def pp(self):
        if self.precincts:
            return [p[0] for p in self.precincts], [p[1] for p in self.precincts]
        return [15] * (self.levels + 1), [15] * (self.levels + 1)


def _gain(b: int) -> int:
    return 0 if b == 0 else 2 if b == 3 else 1


def _step_fields(step: float) -> tuple:
    """(exponent, mantissa) whose (1 + mu / 2048) 2^(PREC - eps) is the
    step OpenJPEG reconstructs with, nearest to `step`."""
    eps = PREC - math.floor(math.log2(step))
    mu = int(round((step / 2.0 ** (PREC - eps) - 1) * 2048))
    if mu == 2048:
        eps, mu = eps - 1, 0
    if not (0 <= eps < 32 and 0 <= mu < 2048):
        raise ValueError(f"step {step} out of range")
    return eps, mu


def encode(planes, *, size=None, offset=(0, 0), tiles=None,
           tile_offset=(0, 0), comps=None, mct: bool = False, layers: int = 1,
           progression: str = "LRCP", roi=None, raw_offset=None) -> bytes:
    """A codestream of `planes` (each component's unsigned 8-bit samples
    at its own size) on an image of `size` (W, H; default the first
    plane's). comps: a Component a plane
    (default: one with the defaults). tiles: (XTsiz, YTsiz) or None for one
    tile. roi: {component: (x0, y0, x1, y1)} in the component's
    coordinates: the coefficients whose decomposition-level footprint
    falls there are shifted up by one more than the background's bits.
    raw_offset: OpenJPEG's bypass rule under that shift (default), or 0
    for the standard's."""
    nc = len(planes)
    comps = comps or [Component() for _ in range(nc)]
    X0, Y0 = offset
    W, H = size or (planes[0].shape[1], planes[0].shape[0])
    X1, Y1 = X0 + W, Y0 + H
    for c, p in zip(comps, planes):
        want = (_cd(Y1, c.dy) - _cd(Y0, c.dy), _cd(X1, c.dx) - _cd(X0, c.dx))
        if p.shape != want:
            raise ValueError(f"plane {p.shape} for {want} at sub-sampling "
                             f"({c.dx}, {c.dy})")
    TX0, TY0 = tile_offset
    TW, TH = tiles or (X1 - TX0, Y1 - TY0)
    ntx, nty = _cd(X1 - TX0, TW), _cd(Y1 - TY0, TH)
    prog = PROGRESSIONS[progression]
    roi = roi or {}
    # every tile's coefficients first: the ROI shift and the guard bits
    # depend on them all
    tiles_out = []
    for t in range(ntx * nty):
        tpx, tpy = t % ntx, t // ntx
        tx0, ty0 = max(TX0 + tpx * TW, X0), max(TY0 + tpy * TH, Y0)
        tx1, ty1 = min(TX0 + (tpx + 1) * TW, X1), min(TY0 + (tpy + 1) * TH, Y1)
        data = []
        for c, (cp, p) in enumerate(zip(comps, planes)):
            cx0, cy0 = _cd(X0, cp.dx), _cd(Y0, cp.dy)
            tc = (_cd(tx0, cp.dx), _cd(ty0, cp.dy), _cd(tx1, cp.dx),
                  _cd(ty1, cp.dy))
            a = p[tc[1] - cy0:tc[3] - cy0, tc[0] - cx0:tc[2] - cx0].astype(
                np.int64) - (1 << (PREC - 1))
            data.append((tc, a))
        if mct:
            (tc0, a0), (_, a1), (_, a2) = data[:3]
            if comps[0].reversible:
                y = (a0 + 2 * a1 + a2) >> 2
                data[:3] = [(tc0, y), (tc0, a2 - a1), (tc0, a0 - a1)]
            else:
                r, g, b = (v.astype(np.float64) for v in (a0, a1, a2))
                data[:3] = [(tc0, 0.299 * r + 0.587 * g + 0.114 * b),
                            (tc0, -0.16875 * r - 0.33126 * g + 0.5 * b),
                            (tc0, 0.5 * r - 0.41869 * g - 0.08131 * b)]
        coeffs = []
        for c, (tc, a) in enumerate(data):
            cp = comps[c]
            bands = forward_dwt(a, tc[0], tc[1], cp.levels, cp.reversible)
            q = {}
            for (r, b), v in bands.items():
                if cp.reversible:
                    q[r, b] = v.astype(np.int64)
                else:
                    eps, mu = _step_fields(cp.step)
                    step = (1 + mu / 2048.0) * 2.0 ** (PREC - eps)
                    q[r, b] = (np.sign(v) * np.floor(np.abs(v) / step)
                               ).astype(np.int64)
            coeffs.append((tc, q))
        tiles_out.append(((tx0, ty0, tx1, ty1), coeffs))
    # ROI masks and shifts
    shifts = [0] * nc
    masks = {}
    for c, rect in roi.items():
        cp = comps[c]
        bg = 0
        for t, (_, coeffs) in enumerate(tiles_out):
            tc, q = coeffs[c]
            for (r, b), v in q.items():
                lev = cp.levels if r == 0 else cp.levels - r + 1
                bx0 = _cdp(tc[0] - ((b & 1) << (lev - 1)), lev) if r else \
                    _cdp(tc[0], lev)
                by0 = _cdp(tc[1] - ((b >> 1) << (lev - 1)), lev) if r else \
                    _cdp(tc[1], lev)
                ys = np.arange(v.shape[0]) + by0
                xs = np.arange(v.shape[1]) + bx0
                m = ((ys[:, None] >= rect[1] >> lev) &
                     (ys[:, None] < _cdp(rect[3], lev)) &
                     (xs[None] >= rect[0] >> lev) &
                     (xs[None] < _cdp(rect[2], lev)))
                masks[t, c, r, b] = m
                if (~m).any():
                    bg = max(bg, int(np.abs(v[~m]).max()))
        shifts[c] = bg.bit_length() + 1
    # tier 1
    tile_geo = []
    for t, (tile, coeffs) in enumerate(tiles_out):
        geo = []
        for c, (tc, q) in enumerate(coeffs):
            cp = comps[c]
            ppx, ppy = cp.pp()
            g = build_geometry(tc, cp.levels, cp.xcb, cp.ycb, ppx, ppy)
            ro = shifts[c] if raw_offset is None else raw_offset
            for r, res in enumerate(g):
                for b, (bx0, by0, _, _), precs in res[8]:
                    v = q[r, b]
                    m = masks.get((t, c, r, b))
                    for _, _, cbs in precs:
                        for cb in cbs:
                            if cb.x1 <= cb.x0 or cb.y1 <= cb.y0:
                                continue
                            blk = v[cb.y0 - by0:cb.y1 - by0,
                                    cb.x0 - bx0:cb.x1 - bx0]
                            mag = np.abs(blk)
                            if m is not None:
                                mm = m[cb.y0 - by0:cb.y1 - by0,
                                       cb.x0 - bx0:cb.x1 - bx0]
                                mag = np.where(mm, mag << shifts[c], mag)
                            cb.nbits, cb.segs, cb.passes = encode_block(
                                mag, blk < 0, b, cp.style, ro if shifts[c] else 0)
            geo.append(g)
        tile_geo.append(geo)
    # guard bits and zero bit-planes: bit-planes = eps + G - 1 - P + shift
    eps_of = []
    for c, cp in enumerate(comps):
        eps = []
        for r in range(cp.levels + 1):
            for b in ([0] if r == 0 else [1, 2, 3]):
                eps.append(PREC + _gain(b) if cp.reversible else
                           _step_fields(cp.step)[0])
        eps_of.append(eps)
    guards = [2] * nc       # raised where a code-block needs more
    for geo in tile_geo:
        for c, g in enumerate(geo):
            for r, res in enumerate(g):
                for bi, (b, _, precs) in enumerate(res[8]):
                    e = eps_of[c][0 if r == 0 else 3 * (r - 1) + b]
                    for _, _, cbs in precs:
                        for cb in cbs:
                            guards[c] = max(guards[c],
                                            cb.nbits - shifts[c] - e + 1)
    if max(guards) > 7:
        raise ValueError(f"guard bits {guards} above 7")
    for geo in tile_geo:
        for c, g in enumerate(geo):
            for r, res in enumerate(g):
                for b, _, precs in res[8]:
                    e = eps_of[c][0 if r == 0 else 3 * (r - 1) + b]
                    for _, _, cbs in precs:
                        for cb in cbs:
                            if not cb.nbits:
                                continue
                            cb.zero_planes = e + guards[c] - 1 + shifts[c] - cb.nbits
                            n = len(cb.passes)
                            cb.cum = [n * (l + 1) // layers for l in range(layers)]
                            cb.first_layer = next(l for l in range(layers)
                                                  if cb.cum[l])
    # markers
    def seg(marker, body):
        return struct.pack(">HH", marker, len(body) + 2) + body

    def comp_byte(c):
        return struct.pack(">B" if nc < 257 else ">H", c)

    siz = struct.pack(">HIIIIIIIIH", 0, X1, Y1, X0, Y0, TW, TH, TX0, TY0, nc)
    siz += b"".join(struct.pack(">BBB", PREC - 1, cp.dx, cp.dy)
                    for cp in comps)
    main = [seg(0xFF51, siz)]
    c0 = comps[0]
    main.append(seg(0xFF52, struct.pack(">BBHB", int(bool(c0.precincts)),
                                        prog, layers, int(mct)) + c0.spcod()))
    for c, cp in enumerate(comps[1:], 1):
        if cp.cod_key() != c0.cod_key():
            main.append(seg(0xFF53, comp_byte(c) + bytes(
                [int(bool(cp.precincts))]) + cp.spcod()))

    def sqcd(c):
        cp = comps[c]
        if cp.reversible:
            return bytes([guards[c] << 5]) + bytes(e << 3 for e in eps_of[c])
        eps, mu = _step_fields(cp.step)
        return bytes([(guards[c] << 5) | 2]) + b"".join(
            struct.pack(">H", (e << 11) | mu) for e in eps_of[c])

    main.append(seg(0xFF5C, sqcd(0)))
    for c in range(1, nc):
        if sqcd(c) != sqcd(0):
            main.append(seg(0xFF5D, comp_byte(c) + sqcd(c)))
    for c in range(nc):
        if shifts[c]:
            main.append(seg(0xFF5E, comp_byte(c) + bytes([0, shifts[c]])))
    out = [b"\xff\x4f"] + main
    for t, geo in enumerate(tile_geo):
        tile = tiles_out[t][0]
        trees = {}
        for c, g in enumerate(geo):
            for r, res in enumerate(g):
                for bi, (_, _, precs) in enumerate(res[8]):
                    for p, (cw, ch, cbs) in enumerate(precs):
                        trees[c, r, bi, p] = (
                            _TagTree(cw, ch, [cb.first_layer for cb in cbs]),
                            _TagTree(cw, ch, [cb.zero_planes for cb in cbs]))
        order = packet_order(prog, layers, tile, [
            (g, comps[c].dx, comps[c].dy) for c, g in enumerate(geo)])
        body = []
        for l, r, c, p in order:
            bands = geo[c][r][8]
            body.append(_packet(l, bands, p, {
                (bi, p): trees[c, r, bi, p] for bi in range(len(bands))}))
        data = b"".join(body)
        out.append(struct.pack(">HHHIBB", 0xFF90, 10, t, 14 + len(data), 0, 1)
                   + b"\xff\x93" + data)
    out.append(b"\xff\xd9")
    return b"".join(out)

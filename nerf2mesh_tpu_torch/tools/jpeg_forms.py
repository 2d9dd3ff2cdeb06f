"""A JPEG writer for the forms Pillow reads but does not write: the test
side of data/jpeg.py's decoder (tests/test_torch_imageforms.py and its
committed fixtures), never used by ``main``.

``encode_forms(planes, ...)`` writes a file of any number of components at
any sampling factors, and:

* ``coding="huffman"``: a baseline sequential scan (the standard tables of
  data/jpeg.py's encoder);
* ``coding="arith"``: an arithmetic-coded sequential (SOF9) or progressive
  (SOF10, libjpeg's ``jpeg_simple_progression`` script: DC first and
  refine, AC first and refine) file, through the QM encoder of ITU T.81
  Annex D as jcarith.c runs it, with restart intervals and DAC conditioning
  values;
* ``coding="lossless"``: a lossless file (SOF3): Huffman-coded differences
  of predictor 1-7 with a point transform and restarts every few MCU rows;
* headers alone for the forms a decoder refuses (``precision``,
  ``sof``): 12-bit samples, hierarchical frames.

``abbreviated(...)`` splits a file into the tables-only stream and the image
stream that a JPEG-compressed TIFF stores.  Every writer is numpy and
plain Python.
"""

from __future__ import annotations

import struct

import numpy as np

from ..data.jpeg import (_AC_CHROMA, _AC_LUMA, _DC_CHROMA, _DC_LUMA, _ZIGZAG,
                         _dct_matrix, _dht, _entropy_code, _huff_lookup,
                         _pack_bits, _segment, quant_tables)

# jaricom.c: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) of Table D.2,
# and the fixed 0.5 estimate at 113
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
_FIXED = 113


class QMEncoder:
    """jcarith.c's arith_encode and finish_pass: statistics bins are lists
    of states (bit 7 the MPS); ``out`` collects the stuffed bytes."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, bins, i, val):
        sv = bins[i]
        qe, nl, nm, sw = _QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):                     # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ (nl | (sw << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ nm
        while True:                              # renormalization, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:                  # a carry over stacked 0xFF
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        self.reset()


class _ArithScan:
    """One arithmetic-coded scan: jcarith.c's encode_mcu (sequential) and
    encode_mcu_DC_first / DC_refine / AC_first / AC_refine, with their
    statistics reset at each restart."""

    def __init__(self, comps, dac, progressive, ss, se, ah, al):
        self.comps, self.dac = comps, dac
        self.progressive = progressive
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.enc = QMEncoder()
        self.fixed = [_FIXED]
        self.reset_stats()

    def reset_stats(self):
        # bins belong to a table (0 luma, 1 chroma), shared by components
        self.dc_stats = {min(c, 1): [0] * 64 for c in self.comps}
        self.ac_stats = {min(c, 1): [0] * 256 for c in self.comps}
        self.last_dc = {c: 0 for c in self.comps}
        self.dc_context = {c: 0 for c in self.comps}

    def _dc(self, c, m):
        """Figures F.4-F.9: the DC value m (after the point transform)."""
        enc, st, L, U = self.enc, self.dc_stats[min(c, 1)], *self.dac[0]
        s0 = self.dc_context[c]
        v = m - self.last_dc[c]
        if v == 0:
            enc.encode(st, s0, 0)
            self.dc_context[c] = 0
            return
        self.last_dc[c] = m
        enc.encode(st, s0, 1)
        if v > 0:
            enc.encode(st, s0 + 1, 0)
            i = s0 + 2
            self.dc_context[c] = 4
        else:
            v = -v
            enc.encode(st, s0 + 1, 1)
            i = s0 + 3
            self.dc_context[c] = 8
        m = 0
        v -= 1
        if v:
            enc.encode(st, i, 1)
            m = 1
            v2 = v
            i = 20
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        enc.encode(st, i, 0)
        if m < (1 << L) >> 1:
            self.dc_context[c] = 0
        elif m > (1 << U) >> 1:
            self.dc_context[c] += 8
        i += 14
        m >>= 1
        while m:
            enc.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def _magnitude(self, st, i, v, k):
        """Figures F.8-F.9 for an AC value v >= 1 at zigzag index k."""
        enc, K = self.enc, self.dac[1]
        m = 0
        v -= 1
        if v:
            enc.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= K else 217
                v2 >>= 1
                while v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        enc.encode(st, i, 0)
        i += 14
        m >>= 1
        while m:
            enc.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def _ac_first(self, c, zz, ss, se, al):
        """jcarith.c encode_mcu_AC_first (and the AC part of encode_mcu
        with ss = 1, al = 0): zz the block's 64 coefficients in zigzag
        order."""
        enc, st = self.enc, self.ac_stats[min(c, 1)]
        t = [(abs(int(x)) >> al) * (1 if x >= 0 else -1) for x in zz]
        ke = se
        while ke >= ss and t[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            enc.encode(st, i, 0)                 # not the end of block
            while t[k] == 0:
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            enc.encode(st, i + 1, 1)
            enc.encode(self.fixed, 0, 1 if t[k] < 0 else 0)
            self._magnitude(st, i + 2, abs(t[k]), k)
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)       # end of block

    def _ac_refine(self, c, zz, ss, se, ah, al):
        enc, st = self.enc, self.ac_stats[min(c, 1)]
        a = [abs(int(x)) for x in zz]
        ke = se
        while ke > 0 and (a[ke] >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (a[kex] >> ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc.encode(st, i, 0)
            while True:
                v = a[k] >> al
                if v:
                    if v >> 1:                   # previously nonzero
                        enc.encode(st, i + 2, v & 1)
                    else:                        # newly nonzero
                        enc.encode(st, i + 1, 1)
                        enc.encode(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def block(self, c, zz):
        if not self.progressive:
            self._dc(c, int(zz[0]))
            self._ac_first(c, zz, 1, 63, 0)
        elif self.ss == 0 and self.ah == 0:
            self._dc(c, int(zz[0]) >> self.al)
        elif self.ss == 0:
            self.enc.encode(self.fixed, 0, (int(zz[0]) >> self.al) & 1)
        elif self.ah == 0:
            self._ac_first(c, zz, self.ss, self.se, self.al)
        else:
            self._ac_refine(c, zz, self.ss, self.se, self.ah, self.al)


def _progression(nc):
    """libjpeg's jpeg_simple_progression: (components, Ss, Se, Ah, Al)."""
    if nc == 1:
        return [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]
    allc = tuple(range(nc))
    script = [(allc, 0, 0, 0, 1), ((0,), 1, 5, 0, 2)]
    script += [((c,), 1, 63, 0, 1) for c in range(nc - 1, 0, -1)]
    script += [((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), (allc, 0, 0, 1, 0)]
    script += [((c,), 1, 63, 1, 0) for c in range(nc - 1, 0, -1)]
    script += [((0,), 1, 63, 1, 0)]
    return script


def _mcu_blocks(blocks, real, sampling, comps):
    """The (component, block row, block column) sequence of a scan over
    `comps`, MCU by MCU (a one-component scan: one block an MCU, over the
    component's real blocks)."""
    if len(comps) == 1:
        c = comps[0]
        rows, cols = -(-real[c][0] // 8), -(-real[c][1] // 8)
        return [[(c, y, x)] for y in range(rows) for x in range(cols)]
    my = blocks[comps[0]].shape[0] // sampling[comps[0]][1]
    mx = blocks[comps[0]].shape[1] // sampling[comps[0]][0]
    out = []
    for y in range(my):
        for x in range(mx):
            mcu = []
            for c in comps:
                h, v = sampling[c]
                mcu += [(c, y * v + yy, x * h + xx) for yy in range(v)
                        for xx in range(h)]
            out.append(mcu)
    return out


def _downsampled(planes, sampling, unit):
    """Each component edge-padded to whole MCUs of `unit`-sample data units
    and averaged down to its sampling, rounded; and its real size."""
    H, W = planes[0].shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    my, mx = -(-H // (unit * vmax)), -(-W // (unit * hmax))
    out, real = [], []
    for p, (h, v) in zip(planes, sampling):
        fy, fx = vmax // v, hmax // h
        full = np.pad(p.astype(np.float64), ((0, my * unit * vmax - H),
                                             (0, mx * unit * hmax - W)),
                      mode="edge")
        out.append(np.rint(full.reshape(full.shape[0] // fy, fy,
                                        full.shape[1] // fx, fx)
                           .mean(axis=(1, 3))).astype(np.int64))
        real.append((-(-H * v // vmax), -(-W * h // hmax)))
    return out, real


def _component_blocks(planes, sampling, quality):
    """Each component's quantized zigzag blocks [by, bx, 64] over its
    MCU-padded plane, the components' real sizes and the quantization
    tables (luma for component 0, chroma for the rest)."""
    ql, qc = quant_tables(quality)
    A = _dct_matrix()
    down, real = _downsampled(planes, sampling, 8)
    out = []
    for c, d in enumerate(down):
        bh, bw = d.shape[0] // 8, d.shape[1] // 8
        blk = d.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
        coef = A @ blk @ A.T
        q = ql if c == 0 else qc
        coef = np.rint(coef.reshape(bh, bw, 64) / q).astype(np.int64)
        out.append(coef[..., _ZIGZAG])
    return out, real, (ql, qc)


def _arith_scans(blocks, real, sampling, progressive, restart, dac):
    nc = len(blocks)
    script = (_progression(nc) if progressive
              else [(tuple(range(nc)), 0, 63, 0, 0)])
    scans = []
    for comps, ss, se, ah, al in script:
        sc = _ArithScan(comps, dac, progressive, ss, se, ah, al)
        data = bytearray()
        for m, mcu in enumerate(_mcu_blocks(blocks, real, sampling, comps)):
            if restart and m and m % restart == 0:
                sc.enc.finish()
                data += sc.enc.out + bytes([0xFF, 0xD0 + (m // restart - 1)
                                            % 8])
                sc.enc.out = bytearray()
                sc.reset_stats()
            for c, y, x in mcu:
                sc.block(c, blocks[c][y, x])
        sc.enc.finish()
        data += sc.enc.out
        sos = bytes([len(comps)])
        for c in comps:
            sos += bytes([c + 1, (min(c, 1) << 4) | min(c, 1)])
        sos += bytes([ss, se, (ah << 4) | al])
        scans.append(_segment(0xFFDA, sos) + bytes(data))
    return scans


def _lossless_scan(planes, sampling, predictor, pt, restart_rows):
    """One interleaved lossless scan of Huffman-coded differences (the
    standard DC tables: luma for component 0, chroma for the rest), a
    restart every `restart_rows` MCU rows; returns it and the MCUs a row."""
    comps, real = _downsampled(planes, sampling, 1)
    comps = [x >> pt for x in comps]
    my = comps[0].shape[0] // sampling[0][1]
    mx = comps[0].shape[1] // sampling[0][0]
    diffs = []           # every sample's difference, as jdpred.c predicts
    for c, x in enumerate(comps):
        (rh, rw), v = real[c], sampling[c][1]
        d = np.zeros_like(x)
        for r in range(rh):              # dummy rows: difference 0
            row = x[r]
            if r % v == 0 and (r // v) % (restart_rows or my) == 0:
                pred = np.concatenate([[1 << (8 - pt - 1)], row[:-1]])
            else:
                up = x[r - 1]
                ra, rb, rc = row[:-1], up[1:], up[:-1]
                p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                     5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                     7: (ra + rb) >> 1}[predictor]
                pred = np.concatenate([[up[0]], p])
            dd = (row - pred) & 0xFFFF
            dd = np.where(dd >= 0x8000, dd - 0x10000, dd)
            dd[rw:] = 0                  # dummy columns
            d[r] = dd
        diffs.append(d)
    tables = [_huff_lookup(_DC_LUMA), _huff_lookup(_DC_CHROMA)]
    segments, codes, lengths = [], [], []
    for yy in range(my):
        if restart_rows and yy and yy % restart_rows == 0:
            segments.append((codes, lengths))
            codes, lengths = [], []
        for xx in range(mx):
            for c, d in enumerate(diffs):
                h, v = sampling[c]
                code_of, len_of = tables[min(c, 1)]
                for a in range(v):
                    for b in range(h):
                        val = int(d[yy * v + a, xx * h + b])
                        s = abs(val).bit_length()
                        extra = val if val >= 0 else val + (1 << s) - 1
                        codes.append((int(code_of[s]) << s) | extra)
                        lengths.append(int(len_of[s]) + s)
    segments.append((codes, lengths))
    data = bytearray()
    for i, (cd, ln) in enumerate(segments):
        if i:
            data += bytes([0xFF, 0xD0 + (i - 1) % 8])
        data += _pack_bits(np.array(cd, np.int64), np.array(ln, np.int64))
    sos = bytes([len(planes)])
    for c in range(len(planes)):
        sos += bytes([c + 1, min(c, 1) << 4])
    sos += bytes([predictor, 0, pt])
    return _segment(0xFFDA, sos) + bytes(data), mx


def encode_forms(planes, sampling=None, *, coding="huffman",
                 progressive=False, restart=0, quality=75, marker="jfif",
                 dac=None, predictor=1, pt=0, precision=8, sof=None) -> bytes:
    """A JPEG of the components `planes` ([H, W] uint8 each, at full size:
    the encoder averages them down to their sampling) at the sampling
    factors `sampling` [(h, v) per component; default 1x1 each].

    coding: "huffman" (baseline, one interleaved scan), "arith" (SOF9, or
    SOF10 with progressive=True) or "lossless" (SOF3, `predictor` 1-7,
    point transform `pt`); restart: MCUs a restart interval ("lossless":
    MCU rows); marker: "jfif" (APP0), "adobe0" / "adobe1" / "adobe2" (APP14
    with that transform) or None; dac: ((L, U), Kx) written in a DAC
    segment for each table (without it the decoder's defaults ((0, 1), 5)
    hold); precision / sof: the SOF's sample precision and marker, for the
    headers of files a decoder must refuse."""
    planes = [np.asarray(p) for p in planes]
    nc = len(planes)
    sampling = list(sampling or [(1, 1)] * nc)
    H, W = planes[0].shape
    out = [b"\xff\xd8"]
    if marker == "jfif":
        out.append(_segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                    b"\x00\x00"))
    elif marker:
        out.append(_segment(0xFFEE, b"Adobe" + struct.pack(
            ">HHHB", 100, 0, 0, int(marker[len("adobe"):]))))
    sofb = struct.pack(">BHHB", precision, H, W, nc)
    for c, (h, v) in enumerate(sampling):
        sofb += bytes([c + 1, (h << 4) | v, min(c, 1)])
    if coding == "lossless":
        scan, mx = _lossless_scan(planes, sampling, predictor, pt, restart)
        out.append(_segment(0xFFC4, _dht(0x00, _DC_LUMA) + (
            _dht(0x01, _DC_CHROMA) if nc > 1 else b"")))
        if restart:
            out.append(_segment(0xFFDD, struct.pack(">H", restart * mx)))
        out += [_segment(sof or 0xFFC3, sofb), scan, b"\xff\xd9"]
        return b"".join(out)
    blocks, real, (ql, qc) = _component_blocks(planes, sampling, quality)
    dqt = bytes([0]) + bytes(ql[_ZIGZAG].astype(np.uint8))
    if nc > 1:
        dqt += bytes([1]) + bytes(qc[_ZIGZAG].astype(np.uint8))
    out.append(_segment(0xFFDB, dqt))
    if coding == "arith":
        code = sof or (0xFFCA if progressive else 0xFFC9)
    else:
        code = sof or 0xFFC0
    out.append(_segment(code, sofb))
    if restart:
        out.append(_segment(0xFFDD, struct.pack(">H", restart)))
    if coding == "arith":
        if dac is not None:
            (lo, up), kx = dac
            out.append(_segment(0xFFCC, b"".join(
                bytes([t, (up << 4) | lo, 16 + t, kx])
                for t in range(min(nc, 2)))))
        out += _arith_scans(blocks, real, sampling, progressive, restart,
                            dac or ((0, 1), 5))
    else:
        dht = _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
        if nc > 1:
            dht += _dht(0x01, _DC_CHROMA) + _dht(0x11, _AC_CHROMA)
        out.append(_segment(0xFFC4, dht))
        seq = [blk for mcu in _mcu_blocks(blocks, real, sampling,
                                          list(range(nc))) for blk in mcu]
        coef = np.stack([blocks[c][y, x] for c, y, x in seq])
        comp = np.array([c for c, _, _ in seq])
        sos = bytes([nc])
        for c in range(nc):
            sos += bytes([c + 1, 0x00 if c == 0 else 0x11])
        sos += bytes([0, 63, 0])
        out.append(_segment(0xFFDA, sos) + _entropy_code(coef, comp))
    out.append(b"\xff\xd9")
    return b"".join(out)


def abbreviated(jpeg: bytes) -> tuple:
    """(tables-only stream, image stream) of a file: its DQT, DHT and DAC
    segments moved into a stream of their own between SOI and EOI, as a
    JPEG-compressed TIFF stores them (tag 347, JPEGTables)."""
    assert jpeg[:2] == b"\xff\xd8"
    pos, tables, image = 2, [], [b"\xff\xd8"]
    while jpeg[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        seg = jpeg[pos:pos + 2 + n]
        (tables if jpeg[pos + 1] in (0xDB, 0xC4, 0xCC) else image).append(seg)
        pos += 2 + n
    image.append(jpeg[pos:])
    return b"\xff\xd8" + b"".join(tables) + b"\xff\xd9", b"".join(image)

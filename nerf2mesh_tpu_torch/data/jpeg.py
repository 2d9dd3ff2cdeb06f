"""A baseline JPEG codec and a bilinear downscale for machines without Pillow.

The stage-1 export writes its feature textures as JPEG (the web viewer loads
``feat0_{cas}.jpg`` and ``feat1_{cas}.jpg``), after downscaling them by the
supersampling factor, and COLMAP captures come as JPEG frames.
``encode_jpeg`` writes baseline sequential JPEG/JFIF: YCbCr at 4:4:4, 4:2:2
or 4:2:0 (chroma averaged over 2x1 or 2x2 pixels), the standard
quantization tables scaled to the quality as libjpeg scales them, and the
standard Huffman tables of the JPEG specification (Annex K).  Every stage
is vectorized numpy: the colour transform, an 8x8 DCT as two matrix
products over all blocks, quantization, and the entropy coder, which lists
every Huffman symbol of the image with its extra bits as one (code, length)
pair, orders them by block and position, and packs the bits with a
cumulative sum.  ``downscale`` is the antialiased bilinear reduce of
``F.interpolate`` (PyTorch's, modeled on Pillow's BILINEAR resize), rounded
to uint8.

``decode_jpeg`` is the C++ decoder ``native/jpegdec.cpp`` (built with g++
at first use into the package's build/, see utils/native.py): every file
Pillow reads through libjpeg-turbo, so it gives what Pillow's decode gives.
Sequential and progressive files with Huffman or arithmetic coding (the QM
decoder of ITU T.81 Annex D), lossless files (SOF3: predictors 1-7, the
point transform, restarts), restart intervals; grey, YCbCr at any integral
sampling ratio (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), RGB, CMYK and YCCK;
libjpeg's integer IDCT, its upsampler choice per component (fancy 2h1v,
1h2v and 2h2v filters, replication otherwise) and its fixed-point colour
conversion.  What Pillow refuses raises ValueError: 12- and 16-bit
precision, hierarchical frames, arithmetic-coded lossless files, a height
given by a DNL marker, a non-integral sampling ratio.
``decode_jpeg_tables`` decodes an abbreviated stream after a tables-only
one with a chosen colour conversion, as libtiff feeds the strips of a
JPEG-compressed TIFF to libjpeg (data/tiff.py).

``read_jpeg`` is ``decode_jpeg`` of a file.  ``save_jpeg`` and
``resize_bilinear`` use Pillow where it is importable and this code
otherwise, as data/png.py's ``write_image`` does for PNG.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

# JPEG Annex K.1 quantization tables, natural (row-major) order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] +
    [99] * 32, np.int64)

# zigzag scan: _ZIGZAG[k] = natural index of the k-th coefficient
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# Annex K.3 Huffman tables: (code counts by length 1..16, symbol values)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
    "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _huff_lookup(spec):
    """(code[256], length[256]) of a canonical Huffman table."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quant_tables(quality: int):
    """The luma and chroma tables at `quality` (1-100), libjpeg's scaling,
    in natural order."""
    q = int(min(max(quality, 1), 100))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_Q_LUMA, _Q_CHROMA))


def _dct_matrix() -> np.ndarray:
    x = np.arange(8)
    a = np.cos((2 * x[None, :] + 1) * x[:, None] * np.pi / 16)
    a *= np.where(x[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return a                               # orthonormal DCT-II = JPEG FDCT


def _bit_size(v: np.ndarray) -> np.ndarray:
    """JPEG magnitude category: bits of |v| (0 for 0)."""
    a = np.abs(v)
    s = np.zeros(a.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << size) - 1)


def _pack_bits(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate the codes MSB first, pad with 1-bits, stuff 0x00 after
    every 0xFF byte."""
    total = int(lengths.sum())
    nbytes = (total + 7) // 8
    starts = np.cumsum(lengths) - lengths
    bits = np.ones(nbytes * 8, np.uint8)     # the pad bits are 1
    rep = np.repeat(np.arange(len(codes)), lengths)
    pos = np.arange(total) - starts[rep]
    shift = lengths[rep] - 1 - pos
    bits[:total] = (codes[rep] >> shift) & 1
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _entropy_code(coef: np.ndarray, comp: np.ndarray) -> bytes:
    """coef [B, 64] quantized zigzag coefficients of the blocks in scan
    order (MCU by MCU, component by component); comp [B] the component
    (0 luma, 1 and 2 chroma).  Returns the entropy-coded segment."""
    B = coef.shape[0]
    dc_l, ac_l = _huff_lookup(_DC_LUMA), _huff_lookup(_AC_LUMA)
    dc_c, ac_c = _huff_lookup(_DC_CHROMA), _huff_lookup(_AC_CHROMA)
    chroma = comp > 0

    def table(luma, chrm, sym, is_chroma):
        code = np.where(is_chroma, chrm[0][sym], luma[0][sym])
        length = np.where(is_chroma, chrm[1][sym], luma[1][sym])
        return code, length

    # DC: differences along each component's own block sequence
    dc = coef[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        d = dc[idx]
        diff[idx] = np.diff(d, prepend=0)
    s = _bit_size(diff)
    hc, hl = table(dc_l, dc_c, s, chroma)
    ev_block = [np.arange(B)]
    ev_key = [np.zeros(B, np.int64)]
    ev_code = [(hc << s) | _extra_bits(diff, s)]
    ev_len = [hl + s]

    # AC: each nonzero coefficient with its zero run; ZRLs before long runs
    ac = coef[:, 1:]
    blk, k = np.nonzero(ac)
    k = k + 1                                # zigzag position 1..63
    v = ac[blk, k - 1]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    s = _bit_size(v)
    sym = ((run % 16) << 4) | s
    hc, hl = table(ac_l, ac_c, sym, chroma[blk])
    ev_block.append(blk)
    ev_key.append(k * 4)
    ev_code.append((hc << s) | _extra_bits(v, s))
    ev_len.append(hl + s)
    n_zrl = run // 16
    if n_zrl.any():
        zb = np.repeat(blk, n_zrl)
        zk = np.repeat(k, n_zrl)
        j = np.arange(len(zb)) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
        hc, hl = table(ac_l, ac_c, np.full(len(zb), 0xF0), chroma[zb])
        ev_block.append(zb)
        ev_key.append(zk * 4 - 3 + j)
        ev_code.append(hc)
        ev_len.append(hl)
    # EOB unless the block's last coefficient is nonzero
    last = np.zeros(B, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.nonzero(last < 63)[0]
    hc, hl = table(ac_l, ac_c, np.zeros(len(eob), np.int64), chroma[eob])
    ev_block.append(eob)
    ev_key.append(np.full(len(eob), 64 * 4))
    ev_code.append(hc)
    ev_len.append(hl)

    block = np.concatenate(ev_block)
    key = np.concatenate(ev_key)
    order = np.lexsort((key, block))
    return _pack_bits(np.concatenate(ev_code)[order],
                      np.concatenate(ev_len)[order])


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def _dht(cls_id: int, spec) -> bytes:
    counts, symbols = spec
    return bytes([cls_id]) + bytes(counts) + bytes(symbols)


# sampling factors (h, v) of the luma plane; chroma is 1x1
_SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}


def _blocks(p: np.ndarray) -> np.ndarray:
    """[h, w] plane (multiples of 8) -> [h/8, w/8, 8, 8] blocks."""
    h, w = p.shape
    return p.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def encode_jpeg(img: np.ndarray, quality: int = 95,
                subsampling: str = "4:4:4") -> bytes:
    """Baseline JPEG of an [H, W, 3] (or [H, W] gray) uint8 image: standard
    tables scaled to `quality`; colour at `subsampling` "4:4:4", "4:2:2"
    or "4:2:0" (Pillow's default)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"encode_jpeg: need [H, W] or [H, W, 3] uint8, got "
                         f"{img.shape} {img.dtype}")
    if subsampling not in _SAMPLING:
        raise ValueError(f"encode_jpeg: subsampling {subsampling!r}, not one "
                         f"of {sorted(_SAMPLING)}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in (1, 3):
        raise ValueError(f"encode_jpeg: {C} channels")
    hs, vs = _SAMPLING[subsampling] if C == 3 else (1, 1)
    # the planes edge-padded to whole MCUs
    Hp, Wp = -(-H // (8 * vs)) * 8 * vs, -(-W // (8 * hs)) * 8 * hs
    x = np.pad(img.astype(np.float64), ((0, Hp - H), (0, Wp - W), (0, 0)),
               mode="edge")
    if C == 3:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
        planes[1:] = [p.reshape(Hp // vs, vs, Wp // hs, hs).mean(axis=(1, 3))
                      for p in planes[1:]]
    else:
        planes = [x[..., 0]]
    ql, qc = quant_tables(quality)
    A = _dct_matrix()
    my, mx = Hp // (8 * vs), Wp // (8 * hs)
    mcu = []                    # per component [my, mx, blocks in MCU, 64]
    for c, p in enumerate(planes):
        d = A @ _blocks(p - 128.0) @ A.T                   # [by, bx, 8, 8]
        q = ql if c == 0 else qc
        d = np.rint(d.reshape(d.shape[:2] + (64,)) / q).astype(np.int64)
        d = d[..., _ZIGZAG]
        h, v = (hs, vs) if c == 0 else (1, 1)
        mcu.append(d.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
                   .reshape(my, mx, v * h, 64))
    coef = np.concatenate(mcu, axis=2)             # scan order: MCU by MCU
    comp = np.concatenate([np.full(m.shape[2], c)
                           for c, m in enumerate(mcu)])
    scan = _entropy_code(coef.reshape(-1, 64), np.tile(comp, my * mx))

    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    dqt = bytes([0]) + bytes(ql[_ZIGZAG].astype(np.uint8))
    if C == 3:
        dqt += bytes([1]) + bytes(qc[_ZIGZAG].astype(np.uint8))
    out.append(_segment(0xFFDB, dqt))
    sof = struct.pack(">BHHB", 8, H, W, C)
    for c in range(C):
        samp = (hs << 4) | vs if c == 0 else 0x11
        sof += bytes([c + 1, samp, 0 if c == 0 else 1])
    out.append(_segment(0xFFC0, sof))
    dht = _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
    if C == 3:
        dht += _dht(0x01, _DC_CHROMA) + _dht(0x11, _AC_CHROMA)
    out.append(_segment(0xFFC4, dht))
    sos = bytes([C])
    for c in range(C):
        sos += bytes([c + 1, 0x00 if c == 0 else 0x11])
    sos += bytes([0, 63, 0])
    out.append(_segment(0xFFDA, sos))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


def downscale(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 by the antialiased bilinear reduce
    of F.interpolate, rounded half up."""
    import torch
    import torch.nn.functional as F
    t = torch.from_numpy(np.array(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t.float(), size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    out = torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)
    return out[0].permute(1, 2, 0).numpy()


def resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Image.resize((w, h), BILINEAR) with Pillow, else ``downscale``."""
    try:
        from PIL import Image
    except ImportError:
        return downscale(img, w, h)
    return np.asarray(Image.fromarray(np.asarray(img)).resize(
        (w, h), Image.BILINEAR))


def save_jpeg(path: str, img: np.ndarray, quality: int = 95,
              subsampling: str = "4:2:0") -> None:
    """Image.fromarray(img).save(path, quality=quality,
    subsampling=subsampling) with Pillow, else ``encode_jpeg``; the default
    subsampling is Pillow's."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "wb") as f:
            f.write(encode_jpeg(img, quality, subsampling))
        return
    Image.fromarray(np.asarray(img)).save(path, quality=quality,
                                          subsampling=subsampling)


_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..utils.native import BUILD_DIR, build_library
        lib = ctypes.CDLL(build_library("jpegdec", BUILD_DIR))
        lib.jpeg_decode_tables.restype = ctypes.c_int
        lib.jpeg_decode_tables.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def _decode_call(lib, tables: bytes, data: bytes, colour: int,
                 out) -> tuple:
    dims = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(256)
    ptr, cap = (None, 0) if out is None else (out.ctypes.data, out.size)
    rc = lib.jpeg_decode_tables(tables, len(tables), data, len(data), colour,
                                ptr, cap, dims, err, len(err))
    msg = err.value.decode(errors="replace")
    if rc == 2:
        raise ValueError(f"{msg}: not a JPEG Pillow reads")
    if rc:
        raise ValueError(f"JPEG decode failed: {msg}")
    return tuple(dims)


# decode_jpeg_tables' colour conversions (jpegdec.cpp's `colour`)
COLOUR_AUTO, COLOUR_NONE, COLOUR_YCBCR, COLOUR_RAW = 0, 1, 2, 3


def decode_jpeg_tables(tables: bytes, data: bytes,
                       colour: int = COLOUR_AUTO) -> np.ndarray:
    """The abbreviated JPEG stream `data` decoded after the tables-only
    stream `tables` (b"" for none): [H, W, C] (or [H, W] grey) uint8.
    `colour`: COLOUR_AUTO converts as the file's markers say (libjpeg's
    default), COLOUR_NONE gives the components as stored (libjpeg's
    JCS_UNKNOWN; CMYK not inverted), COLOUR_YCBCR converts YCbCr to RGB,
    COLOUR_RAW gives the components as stored, each replicated to full size
    without the fancy upsampling filters (libjpeg's raw planes)."""
    lib = _load()
    tables, data = bytes(tables), bytes(data)
    H, W, C = _decode_call(lib, tables, data, colour, None)
    out = np.empty((H, W, C) if C > 1 else (H, W), np.uint8)
    _decode_call(lib, tables, data, colour, out)
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG -> [H, W, 3|4] (or [H, W] grey) uint8, the array
    np.asarray(Image.open(...)) gives."""
    return decode_jpeg_tables(b"", data)


def read_jpeg(path: str) -> np.ndarray:
    """np.asarray(Image.open(path)) of a JPEG, by ``decode_jpeg``."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())

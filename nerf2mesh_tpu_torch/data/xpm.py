"""An X pixmap (XPM) reader without Pillow: ``np.asarray(Image.open(
path))`` of the files Pillow 12.1's XpmImagePlugin reads.

Pillow takes a file that starts "/* XPM */", reads lines up to the first
that starts '"W H N C' (the size, the colour count and the characters a
pixel), then N colour lines: the key is the C characters after the line's
first, and of the words between it and the line's last two characters the
first "c" is followed by "#rrggbb" (any number of hex digits, read as one
number) or "None" (the transparent key, which gets no palette entry).  N
above 256 makes mode "RGB" (uint8 [H, W, 3], the keys' colours), else "P"
(uint8 [H, W], each key's place among the colour lines' distinct keys).
The pixels are read line by line from there, an optional "/* pixels */"
line skipped: the text between a line's first and last '"', cut into keys
of C characters, until the image's pixels are read.  Every key is looked
up at once with numpy (the colour codes sorted and searched), so a
pixel costs no Python.

A file that ends before the size line, or a size not above 0, hands it on
(Image.open passes over the plugin); a colour other than "#..." or "None",
a colour line without "c", a size that is not a number, a key that is not
a colour's (the transparent one among them: Pillow has no index for it)
and pixels that end first raise ValueError, as Pillow raises there.
"""

from __future__ import annotations

import re

import numpy as np

from . import imgdec

_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
_HEX = np.full(256, 255, np.uint8)
for _c in b"0123456789abcdefABCDEF":
    _HEX[_c] = int(chr(_c), 16)
del _c


def accepts_xpm(data: bytes) -> bool:
    return data[:9] == b"/* XPM */"


class _Lines:
    """readline() over bytes."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        line, self.pos = self.data[self.pos:end], end
        return line


def _fast_colours(data: bytes, pos: int, n: int, cpp: int):
    """The n colour lines at `pos` when every one is '"<key> c #rrggbb",'
    with distinct keys free of newlines (what writers make): ([n, cpp]
    keys, [n, 3] colours, the position after them) read with numpy; else
    None, and the lines are read one by one as Pillow reads them."""
    width = cpp + 14
    if n <= 0 or pos + n * width > len(data):
        return None
    a = np.frombuffer(data, np.uint8, n * width, pos).reshape(n, width)
    form = np.frombuffer(b'"' + b"?" * cpp + b" c #??????\",\n", np.uint8)
    fixed = form != ord("?")
    if not (a[:, fixed] == form[fixed]).all():
        return None
    digits = _HEX[a[:, cpp + 5:cpp + 11]]
    keys = a[:, 1:cpp + 1]
    if (digits > 15).any() or (keys == 10).any() or len(
            np.unique(_codes(keys))) != n:
        return None
    rgb = (digits[:, 0::2] << 4 | digits[:, 1::2]).astype(np.uint8)
    return keys, rgb, pos + n * width


def _header(data: bytes):
    """XpmImageFile._open: (W, H, colour count, C, the colour keys in their
    first places' order, their colours [k, 3], the lines after the colour
    lines)."""
    fp = _Lines(data, 9)
    while True:
        line = fp.readline()
        if not line:
            raise imgdec.NotThisFormat("broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    W, H, n, cpp = (int(g) for g in m.groups())
    fast = _fast_colours(data, fp.pos, n, cpp)
    if fast is not None:
        keys, rgb, fp.pos = fast
        return W, H, n, cpp, [bytes(k) for k in keys], rgb, fp
    palette = {}
    for _ in range(n):
        line = fp.readline().rstrip()
        c = line[1:cpp + 1]
        s = line[cpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                try:
                    rgb = s[i + 1]
                except IndexError as e:
                    raise imgdec.NotThisFormat("XPM colour line ends after "
                                               "'c'") from e
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = bytes([(v >> 16) & 255, (v >> 8) & 255,
                                        v & 255])
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    colours = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(
        -1, 3)
    return W, H, n, cpp, list(palette), colours, fp


def _codes(keys: np.ndarray) -> np.ndarray:
    """[n, cpp] uint8 keys -> comparable codes ([n] uint64 up to 8 bytes,
    else [n] void records)."""
    n, cpp = keys.shape
    if cpp <= 8:
        padded = np.zeros((n, 8), np.uint8)
        padded[:, :cpp] = keys
        return padded.view("<u8")[:, 0]
    return np.ascontiguousarray(keys).view(f"V{cpp}")[:, 0]


def _lookup(text: bytes, cpp: int, full: list, lookup: dict) -> np.ndarray:
    """The places of text's keys of cpp characters among the colour keys,
    all at once: the keys' codes searched in the colours' sorted codes."""
    n = len(text) // cpp
    if not n:
        return np.zeros(0, np.int64)
    if not full:
        raise ValueError("XPM pixel key with no colour")
    colour_codes = _codes(np.frombuffer(b"".join(full), np.uint8).reshape(
        -1, cpp))
    order = np.argsort(colour_codes, kind="stable")
    ranked = colour_codes[order]
    codes = _codes(np.frombuffer(text, np.uint8, n * cpp).reshape(n, cpp))
    at = np.minimum(np.searchsorted(ranked, codes), len(ranked) - 1)
    if not np.array_equal(ranked[at], codes):
        raise ValueError("XPM pixel key with no colour")
    return np.array([lookup[k] for k in full])[order][at]


def decode_xpm(data: bytes) -> np.ndarray:
    if not accepts_xpm(data):
        raise imgdec.NotThisFormat("not an XPM file")
    W, H, n, cpp, keys, colours, fp = _header(data)
    if W <= 0 or H <= 0:
        raise imgdec.NotThisFormat("XPM size not above 0")
    imgdec.check_size(W, H, "XPM")
    rgb_mode = n > 256
    # the value a key gives: its colour (RGB) or its place (P)
    values = colours if rgb_mode else np.arange(
        len(keys), dtype=np.uint8)[:, None]
    need = W * H
    # the pixel lines, as the decoder's readline() loop takes them
    texts, got, header_seen = [], 0, False
    for line in data[fp.pos:].split(b"\n"):
        if got >= need:
            break
        if line.rstrip() == b"/* pixels */" and not header_seen:
            header_seen = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        if text:
            if cpp <= 0:
                raise ValueError("XPM: 0 characters a pixel (range() arg 3 "
                                 "must not be zero)")
            texts.append(text)
            got += -(-len(text) // cpp)
    if got < need:
        raise ValueError("XPM pixels cut short (not enough image data)")
    lookup = {k: i for i, k in enumerate(keys)}
    full = [k for k in keys if len(k) == cpp]
    if all(len(t) % cpp == 0 for t in texts):
        segments = [_lookup(b"".join(texts), cpp, full, lookup)]
    else:                                    # a short key ends a line
        segments = []
        for text in texts:
            whole = len(text) // cpp * cpp
            segments.append(_lookup(text[:whole], cpp, full, lookup))
            if whole < len(text):
                if text[whole:] not in lookup:
                    raise ValueError("XPM pixel key with no colour")
                segments.append(np.array([lookup[text[whole:]]]))
    px = values[np.concatenate(segments)[:need]]
    return np.ascontiguousarray(px.reshape((H, W, 3) if rgb_mode else
                                           (H, W)))

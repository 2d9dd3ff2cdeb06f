"""The JPEG 2000 coding modes Pillow reads but does not write, against
Pillow 12.1.0 and its OpenJPEG 2.5.4, on the CPU: the port's reader
(nerf2mesh_tpu_torch/data/jpeg2000.py and native/j2kdec.cpp) and the
test-side writer nerf2mesh_tpu_torch/tools/j2k_forms.py.

The writer makes streams really coded in each mode: the six code-block
styles (selective bypass, context reset, termination on each pass,
vertically causal contexts, predictable termination, segmentation symbols)
alone and combined, on one and several quality layers, ROI max-shift at
5/3 and 9/7, components sub-sampled 1, 2 and 4 times, and COC edits of
wavelet, style and levels.  Its self-checks keep it from being graded by
the decoder it tests: a lossless 5/3 stream reads back through Pillow
equal to its source, or, sub-sampled at even sizes, to Pillow's
nearest-neighbour replication of it.  The oracle is ``np.asarray(
Image.open(p))``: the port, with Pillow blocked, gives its dtype, shape and
bytes exactly, on every case, on the header-flipped streams of
test_torch_jpeg2000.py's Pillow codestreams (a mode bit set on a stream not
coded in it: OpenJPEG's behaviour when a segment runs dry), on CAP, CPF and
Part 2's MCT, MCC, MCO and CBD segments, and it refuses with ValueError
what Pillow refuses.  The committed files under
fixtures/formats/jpeg2000_modes (``PYTHONPATH=. python
tests/test_torch_jpeg2000_modes.py`` writes them) hash to Pillow's arrays
in fixtures/formats.json; the 512^2 one is a frame of an archival profile
(bypass, RPCL, precincts, 9/7) that chip_smoke.py's phase 14 (c) times.
"""

import json
import os
import re
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerf2mesh_tpu_torch.tools import j2k_forms as jf
from test_torch_jpeg2000 import (BASE, FIXTURES, FORMAT_HASHES, REPO, cod_style,
                                 edit_main, ext, join_codestream, jp2_file,
                                 picture, pillow_array, port_array,
                                 replace_segment, segment, sha,
                                 split_codestream)

FORMAT_DIR = "formats/jpeg2000_modes"
STYLES = {"bypass": jf.BYPASS, "reset": jf.RESET, "termall": jf.TERMALL,
          "vsc": jf.VSC, "pterm": jf.PTERM, "segsym": jf.SEGSYM}
COMBOS = {"bypass_termall": jf.BYPASS | jf.TERMALL,
          "bypass_reset_pterm": jf.BYPASS | jf.RESET | jf.PTERM,
          "vsc_segsym_reset": jf.VSC | jf.SEGSYM | jf.RESET,
          "termall_pterm_segsym": jf.TERMALL | jf.PTERM | jf.SEGSYM,
          "all_six": 63}


def rgb(h=37, w=29, seed=0) -> np.ndarray:
    return picture(h, w, seed)["RGB"]


def planes(a: np.ndarray) -> list:
    return [a[..., i] for i in range(a.shape[-1])]


def comps(n=3, **kw) -> list:
    return [jf.Component(**kw) for _ in range(n)]


def replicate(p: np.ndarray, dx: int, dy: int) -> np.ndarray:
    return np.repeat(np.repeat(p, dy, 0), dx, 1)


def ycc_to_rgb(ycc: np.ndarray) -> np.ndarray:
    return np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))


# ------------------------------------------------------------- the cases
def lossless_cases() -> dict:
    """name -> (stream, the array Pillow must read back): 5/3 encodes whose
    reading is known without a decoder."""
    src, c = rgb(), {}
    for name, style in {**STYLES, **COMBOS}.items():
        c[f"style_{name}"] = (jf.encode(planes(src), comps=comps(
            levels=3, cblk=(4, 4), style=style)), src)
    # a code-block's passes split over layers: segments run across packets
    for name, style, layers in (("bypass", jf.BYPASS, 4),
                                ("termall", jf.TERMALL, 3),
                                ("bypass_termall", jf.BYPASS | jf.TERMALL, 5),
                                ("all_six", 63, 3)):
        c[f"layers_{name}"] = (jf.encode(planes(src), comps=comps(
            levels=3, cblk=(5, 4), style=style), layers=layers, mct=True), src)
    c["rpcl_precincts_bypass"] = (jf.encode(planes(src), comps=comps(
        levels=3, cblk=(3, 3), style=jf.BYPASS | jf.SEGSYM,
        precincts=[(3, 3), (3, 3), (4, 4), (4, 4)]), layers=2,
        progression="RPCL"), src)
    c["tiles_vsc_reset"] = (jf.encode(planes(src), offset=(3, 2), tiles=(13, 11),
                                      tile_offset=(1, 1), comps=comps(
        levels=2, cblk=(3, 3), style=jf.VSC | jf.RESET), layers=2,
        progression="CPRL"), src)
    c["roi_53"] = (jf.encode(planes(src), comps=comps(levels=3), roi={
        0: (8, 10, 20, 30), 2: (0, 0, 9, 9)}, layers=2), src)
    c["roi_53_bypass"] = (jf.encode(planes(src), comps=comps(
        levels=3, style=jf.BYPASS | jf.TERMALL), roi={1: (4, 4, 25, 33)},
        mct=True), src)
    c["roi_53_all_six"] = (jf.encode(planes(src), comps=comps(
        levels=3, cblk=(4, 4), style=63), roi={0: (0, 0, 29, 20)}), src)
    # sub-sampled at even sizes: Pillow replicates each sample
    even = rgb(32, 48, 3)
    for ci in range(3):
        for dx, dy in ((2, 1), (2, 2), (4, 4)):
            ps = planes(even)
            ps[ci] = ps[ci][::dy, ::dx]
            cc = comps(levels=3)
            cc[ci] = jf.Component(levels=2, dx=dx, dy=dy)
            want = even.copy()
            want[..., ci] = replicate(ps[ci], dx, dy)
            cs = jf.encode(ps, comps=cc, size=(48, 32))
            # an sRGB JP2: Pillow would take a raw codestream with chroma
            # sub-sampled as sYCC
            c[f"sub_c{ci}_{dx}x{dy}_jp2"] = (jp2_file(cs, 16), want)
    ycc = np.asarray(Image.fromarray(even).convert("YCbCr"))
    for name, (dx, dy) in (("420", (2, 2)), ("422", (2, 1))):
        ps = [ycc[..., 0], ycc[::dy, ::dx, 1], ycc[::dy, ::dx, 2]]
        cs = jf.encode(ps, comps=[jf.Component(levels=3)] + comps(
            2, levels=3, dx=dx, dy=dy), size=(48, 32))
        want = ycc_to_rgb(np.stack([ps[0]] + [replicate(p, dx, dy)
                                              for p in ps[1:]], -1))
        c[f"sycc{name}_jp2"] = (jp2_file(cs, 18), want)
        c[f"sycc{name}_j2k"] = (cs, want)     # the sYCC guess
    rgba = picture(32, 48, 4)["RGBA"]
    ps = planes(rgba)
    ps[3] = ps[3][::2, ::2]
    want = rgba.copy()
    want[..., 3] = replicate(ps[3], 2, 2)
    c["sub_alpha_rgba"] = (jf.encode(ps, comps=comps(3, levels=3) + [
        jf.Component(levels=3, dx=2, dy=2)]), want)
    return c


def reads_cases() -> dict:
    """Streams whose reading only Pillow knows: 9/7, the odd geometries
    of sub-sampling that Pillow misreads, and COC mixes."""
    src, c = rgb(), {}
    for name, style in (("bypass", jf.BYPASS), ("all_six", 63),
                        ("vsc_pterm", jf.VSC | jf.PTERM)):
        c[f"irreversible_{name}"] = jf.encode(planes(src), comps=comps(
            levels=3, cblk=(4, 4), style=style, reversible=False, step=1.5),
            mct=True, layers=2)
    c["irreversible_rpcl_precincts"] = jf.encode(planes(src), comps=comps(
        levels=4, style=jf.BYPASS | jf.RESET, reversible=False, step=2.0,
        precincts=[(4, 4)] * 5), layers=3, progression="RPCL")
    c["roi_97"] = jf.encode(planes(src), comps=comps(
        levels=3, reversible=False, step=1.0), roi={0: (8, 10, 20, 30)},
        mct=True)
    c["roi_97_bypass"] = jf.encode(planes(src), comps=comps(
        levels=3, style=jf.BYPASS, reversible=False, step=0.5),
        roi={0: (0, 0, 15, 15)})
    # bypass under ROI as the standard counts bit-planes: OpenJPEG decodes
    # a raw segment with the MQ decoder
    c["roi_53_bypass_standard"] = jf.encode(planes(src), comps=comps(
        levels=3, style=jf.BYPASS), roi={0: (8, 10, 20, 30)}, raw_offset=0)
    rng = np.random.default_rng(7)
    for name, (w, h, x0, y0, tiles, subs) in {
            "sub_odd_size": (29, 37, 0, 0, None, [(1, 1), (2, 2), (2, 2)]),
            "sub_odd_offset": (28, 36, 3, 5, None, [(1, 1), (2, 1), (2, 1)]),
            "sub_c0_odd": (31, 21, 1, 0, None, [(2, 2), (1, 1), (1, 1)]),
            "sub_4x4_odd": (30, 30, 2, 1, None, [(1, 1), (1, 1), (4, 4)]),
            "sub_3x2_mixed": (25, 19, 0, 1, None, [(3, 2), (1, 1), (2, 3)]),
            "sub_tiles": (37, 29, 3, 2, (13, 11), [(1, 1), (2, 2), (2, 2)]),
            "sub_tiles_rgba": (33, 27, 1, 1, (16, 16),
                               [(1, 1), (2, 2), (2, 2), (2, 1)])}.items():
        ps = [rng.integers(0, 256, (-(-(y0 + h) // dy) - -(-y0 // dy),
                                    -(-(x0 + w) // dx) - -(-x0 // dx))
                           ).astype(np.uint8) for dx, dy in subs]
        cs = jf.encode(ps, size=(w, h), offset=(x0, y0), tiles=tiles,
                       tile_offset=(x0 and x0 - 1, y0 and y0 - 1), comps=[
                           jf.Component(levels=2, cblk=(3, 3), dx=dx, dy=dy)
                           for dx, dy in subs], layers=2)
        c[name] = cs
        c[name + "_sycc_jp2"] = jp2_file(cs, 18)
    cmyk = picture(32, 24, 5)["RGBA"]
    ps = planes(cmyk)
    ps[1] = ps[1][::2, ::2]
    c["sub_cmyk_jp2"] = jp2_file(jf.encode(ps, comps=[jf.Component(levels=2),
                                                      jf.Component(levels=2,
                                                                   dx=2, dy=2),
                                                      jf.Component(levels=2),
                                                      jf.Component(levels=2)]),
                                 12)
    # COC: another wavelet, style or depth for one component
    for name, cc in (
            ("coc_mixed_wavelets_mct", [jf.Component(levels=2),
                                        jf.Component(levels=2, reversible=False),
                                        jf.Component(levels=2)]),
            ("coc_mixed_wavelets_ict", [jf.Component(levels=2, reversible=False),
                                        jf.Component(levels=2),
                                        jf.Component(levels=2)]),
            ("coc_styles", [jf.Component(levels=2, style=0),
                            jf.Component(levels=2, style=jf.BYPASS | jf.TERMALL),
                            jf.Component(levels=3, style=jf.VSC | jf.SEGSYM)])):
        c[name] = jf.encode(planes(src), comps=cc, mct="mct" in name or
                            "ict" in name, layers=2)
    return c


def archival_frame() -> bytes:
    """A 512^2 frame in an archival profile: bypass, RPCL, precincts of
    128 and 256, three layers, 9/7 with the ICT."""
    src = picture(512, 512, 1)["RGB"]
    return jf.encode(planes(src), comps=comps(
        levels=5, style=jf.BYPASS, reversible=False, step=8.0,
        precincts=[(7, 7)] * 4 + [(8, 8)] * 2), mct=True, layers=3,
        progression="RPCL")


LOSSLESS = lossless_cases()
CASES = {**{k: v[0] for k, v in LOSSLESS.items()}, **reads_cases()}
FRAME = "archival_512_bypass_rpcl_97"


def header_flips() -> dict:
    """Test_torch_jpeg2000.py's RGB codestream with one header field set to
    a mode its data was not coded in."""
    cs, c = BASE["rgb_j2k"], {}
    for name, bit in (("bypass", 1), ("reset", 2), ("termall", 4),
                      ("vertically_causal", 8), ("predictable", 16),
                      ("segmentation_symbols", 32)):
        c[f"cblk_{name}"] = cod_style(cs, bit)
    c["part2_mct"] = edit_main(cs, lambda m: replace_segment(
        m, 0xFF52, segment(m, 0xFF52)[:4] + b"\x02" + segment(m, 0xFF52)[5:]))
    c["rgn"] = edit_main(cs, lambda m: m + [(0xFF5E, bytes([0, 0, 3]))])
    c["cap"] = edit_main(cs, lambda m: m + [(0xFF50, bytes(4))])

    def subsampled(m):
        siz = bytearray(segment(m, 0xFF51))
        siz[37 + 3] = 2
        return replace_segment(m, 0xFF51, bytes(siz))
    c["subsampled"] = edit_main(cs, subsampled)
    return c


def _mct(index, array, element, data, z=0, y=0):
    return (0xFF74, struct.pack(">HHH", z, index | (array << 8) | (element << 10),
                                y) + data)


def _mcc(index, deco, offset, nc=3, collections=1, kind=1):
    body = struct.pack(">HBHH", 0, index, 0, collections)
    if collections:
        body += bytes([kind]) + struct.pack(">H", nc) + bytes(range(nc)) + \
            struct.pack(">H", nc) + bytes(range(nc)) + bytes([0, offset, deco])
    return (0xFF75, body)


def _mco(*index):
    return (0xFF77, bytes([len(index)]) + bytes(index))


def marker_cases() -> dict:
    """CAP, CPF, RGN and Part 2's MCT, MCC, MCO and CBD segments added to
    Pillow's codestreams, read or refused as Pillow does."""
    cs, c = BASE["rgb_j2k"], {}

    def main(*segs, base=cs):
        return edit_main(base, lambda m: m + list(segs))

    def tile(*segs, base=cs):
        m, parts = split_codestream(base)
        parts[0][3] = parts[0][3] + list(segs)
        return join_codestream(m, parts)

    ident = struct.pack(">9f", 1, 0, 0, 0, 1, 0, 0, 0, 1)
    c.update({
        "cap_part15": main((0xFF50, struct.pack(">IH", 1 << 17, 0))),
        "cap_empty": main((0xFF50, b"")),
        "cpf": main((0xFF59, bytes(2))),
        "cap_in_tile": tile((0xFF50, bytes(4))),
        "cpf_in_tile": tile((0xFF59, bytes(2))),
        "mct_alone": main(_mct(1, 1, 2, ident)),
        "mct_first_of_several": main(_mct(1, 1, 2, ident, z=1)),
        "mct_short": main((0xFF74, bytes(4))),
        "mct_mcc": main(_mct(1, 1, 2, ident), _mcc(1, 1, 0)),
        "mcc_without_mct": main(_mcc(1, 1, 0)),
        "mcc_no_collection": main(_mcc(1, 0, 0, collections=0), _mco(1)),
        "mcc_not_array": main(_mcc(1, 0, 0, kind=0), _mco(1)),
        "mco_alone": main(_mco(1)),
        "mco_no_stage": main(_mco()),
        "mco_two_stages": main(_mco(1, 2)),
        "mco_decorrelation": main(_mct(1, 1, 2, ident), _mcc(1, 1, 0), _mco(1)),
        "mco_decorrelation_wrong_size": main(
            _mct(1, 1, 3, ident), _mcc(1, 1, 0), _mco(1)),
        "mco_offsets_int32": main(_mct(2, 2, 1, struct.pack(">3i", 128, 128, 128)),
                                  _mcc(1, 0, 2), _mco(1)),
        "mco_offsets_int16": main(_mct(2, 2, 0, struct.pack(">3h", 100, 128, 160)),
                                  _mcc(1, 0, 2), _mco(1)),
        "mco_offsets_float64": main(_mct(2, 2, 3, struct.pack(
            ">3d", 127.9, 128.5, -3.7)), _mcc(1, 0, 2), _mco(1)),
        "mco_offsets_two_components": main(
            _mct(2, 2, 1, struct.pack(">2i", 128, 128)), _mcc(1, 0, 2, nc=2),
            _mco(1)),
        "mco_second_record": main(_mct(2, 2, 1, struct.pack(">3i", 9, 9, 9)),
                                  _mcc(3, 0, 2), _mcc(1, 0, 2), _mco(1)),
        "mco_in_tile": tile(_mco(1)),
        "mct_mcc_mco_in_tile": tile(_mct(2, 2, 1, struct.pack(">3i", 64, 0, 9)),
                                    _mcc(1, 0, 2), _mco(1)),
        "part2_mct_with_markers": main(_mct(1, 1, 2, ident), _mcc(1, 1, 0),
                                       _mco(1), base=FLIPS["part2_mct"]),
        "cbd_same": main((0xFF78, struct.pack(">H", 3) + bytes([7, 7, 7]))),
        "cbd_precision_10": main((0xFF78, struct.pack(">H", 3) + bytes([9] * 3))),
        "cbd_signed": main((0xFF78, struct.pack(">H", 3) + bytes([0x87, 7, 7]))),
        "cbd_precision_4": main((0xFF78, struct.pack(">H", 3) + bytes([3] * 3))),
        "cbd_bad_count": main((0xFF78, struct.pack(">H", 2) + bytes([7, 7]))),
        "cbd_in_tile": tile((0xFF78, struct.pack(">H", 3) + bytes([7, 7, 7]))),
        "cbd_i16": main((0xFF78, struct.pack(">H", 1) + bytes([11])),
                        base=BASE["i16_j2k"]),
        "cbd_irreversible": main((0xFF78, struct.pack(">H", 3) + bytes([10] * 3)),
                                 base=BASE["rgb_irreversible_mct"]),
        "rgn_30": main((0xFF5E, bytes([0, 0, 30]))),
        "rgn_31": main((0xFF5E, bytes([0, 0, 31]))),
        "rgn_in_tile": tile((0xFF5E, bytes([2, 0, 4]))),
        "rgn_irreversible": main((0xFF5E, bytes([1, 0, 6])),
                                 base=BASE["rgb_irreversible_mct"]),
        "rgn_bad_length": main((0xFF5E, bytes([0, 0, 3, 0]))),
        "style_mixed_ht": cod_style(cs, 0x80),
        "style_ht_mixed_and_bypass": cod_style(cs, 0x81),
        "wavelet_kernel_2": edit_main(cs, lambda m: replace_segment(
            m, 0xFF52, segment(m, 0xFF52)[:9] + b"\x02" + segment(m, 0xFF52)[10:])),
    })
    return c


def refused_cases() -> dict:
    """Streams of the writer that Pillow refuses: sub-sampled components
    under an unpacker that takes none, or under the RCT."""
    c = {}
    rng = np.random.default_rng(9)
    for name, subs, wrap in (("sub_grey", [(2, 2)], None),
                             ("sub_grey_alpha", [(1, 1), (2, 2)], None),
                             ("sub_grey_first_of_two", [(2, 1), (1, 1)], None),
                             ("sub_grey_jp2", [(1, 2)], 17),
                             ("sub_rgb_grey_space", [(1, 1), (2, 2), (2, 2)], 17)):
        ps = [rng.integers(0, 256, (16 // dy, 16 // dx)).astype(np.uint8)
              for dx, dy in subs]
        cs = jf.encode(ps, size=(16, 16), comps=[
            jf.Component(levels=2, dx=dx, dy=dy) for dx, dy in subs])
        c[name] = cs if wrap is None else jp2_file(cs, wrap)
    src = rgb(16, 16)
    cs = jf.encode([src[..., 0], src[::2, ::2, 1], src[..., 2]], comps=[
        jf.Component(levels=2), jf.Component(levels=2, dx=2, dy=2),
        jf.Component(levels=2)])
    c["sub_under_rct"] = edit_main(cs, lambda m: replace_segment(
        m, 0xFF52, segment(m, 0xFF52)[:4] + b"\x01" + segment(m, 0xFF52)[5:]))
    c["levels_differ_under_rct"] = jf.encode(planes(src), comps=[
        jf.Component(levels=2), jf.Component(levels=3),
        jf.Component(levels=2)], mct=True)
    return c


FLIPS = header_flips()
MARKERS = marker_cases()
REFUSED = refused_cases()


def fixture_name(name: str) -> str:
    return f"{FORMAT_DIR}/{name}.{ext(CASES[name])}"


# ----------------------------------------------------------------- tests
def _table(name: str) -> list:
    src = (REPO / "nerf2mesh_tpu_torch" / "native" / "j2kdec.cpp").read_text()
    body = re.search(rf"{name}\[47\] = \{{(.*?)\}};", src, re.S).group(1)
    return [int(v, 0) for v in body.replace("\n", " ").split(",")]


def test_mq_tables_are_the_decoders():
    """The writer's MQ states are a copy of the decoder's kQe, kNmps,
    kNlps and kSwitch."""
    for name, table in (("kQe", jf.QE), ("kNmps", jf.NMPS),
                        ("kNlps", jf.NLPS), ("kSwitch", jf.SWITCH)):
        assert _table(name) == table, name


@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_writer_self_check(name):
    """A lossless stream reads back through Pillow equal to its source (a
    sub-sampled component replicated, sYCC through Pillow's conversion)."""
    data, want = LOSSLESS[name]
    np.testing.assert_array_equal(pillow_array(data), want)


def test_writer_codes_each_mode():
    """The styles change the bytes (each mode really is coded), bypass puts
    raw segments in a code-block and a segment spans layers."""
    streams = {v for k, v in CASES.items() if k.startswith("style_")}
    assert len(streams) == len(STYLES) + len(COMBOS)
    mag = np.abs(np.random.default_rng(3).normal(0, 400, (16, 16))).astype(
        np.int64)
    nbits, segs, passes = jf.encode_block(mag, mag < 0, 0, jf.BYPASS)
    assert nbits >= 8 and [len(s) > 0 for s in segs].count(True) > 3
    assert jf.segment_lengths(jf.BYPASS, len(passes))[:4] == [10, 2, 1, 2]
    assert jf.segment_lengths(jf.TERMALL, 7) == [1] * 7
    assert jf.segment_lengths(0, 28) == [28]


@pytest.mark.parametrize("name", sorted(CASES))
def test_reads_as_pillow(name, tmp_path):
    data = CASES[name]
    got = port_array(data, tmp_path, f"{name}.{ext(data)}")
    assert sha(got) == sha(pillow_array(data)), name


@pytest.mark.parametrize("name", sorted(FLIPS))
def test_header_flips_read_as_pillow(name, tmp_path):
    """A mode bit, RGN, CAP, sub-sampling or Part 2's MCT set on a stream
    not coded in it: the port reads what Pillow reads (a segment that runs
    dry reads 1 bits) or raises ValueError where Pillow raises."""
    _held_to_pillow(FLIPS[name], tmp_path, name)


@pytest.mark.parametrize("name", sorted(MARKERS))
def test_markers_read_as_pillow(name, tmp_path):
    _held_to_pillow(MARKERS[name], tmp_path, name)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_as_pillow_refuses(name, tmp_path):
    data = REFUSED[name]
    with pytest.raises(Exception):
        pillow_array(data)
    with pytest.raises(ValueError):
        port_array(data, tmp_path, f"{name}.{ext(data)}")


def _held_to_pillow(data: bytes, tmp_path, name: str) -> None:
    try:
        want = pillow_array(data)
    except Exception:
        with pytest.raises(ValueError):
            port_array(data, tmp_path, f"{name}.{ext(data)}")
        return
    assert sha(port_array(data, tmp_path, f"{name}.{ext(data)}")) == sha(want)


def test_case_sizes():
    """Each variant is at most 64^2, and the committed set stays small."""
    for name, data in CASES.items():
        h, w = pillow_array(data).shape[:2]
        assert h * w <= 64 * 64, name
    assert sum(len(d) for d in CASES.values()) < 200_000


# ------------------------------------------------------- committed fixtures
def committed() -> dict:
    """fixture path -> its bytes, the 512^2 frame among them."""
    out = {fixture_name(n): CASES[n] for n in sorted(CASES)}
    out[f"{FORMAT_DIR}/{FRAME}.j2k"] = (FIXTURES / FORMAT_DIR /
                                        f"{FRAME}.j2k").read_bytes()
    return out


def write_fixtures() -> None:
    """Writes fixtures/formats/jpeg2000_modes/ and its entries in
    fixtures/formats.json; the other modules' entries stay."""
    hashes = json.loads(FORMAT_HASHES.read_text())
    for k in [k for k in hashes if k.startswith(FORMAT_DIR + "/")]:
        del hashes[k]
    shutil.rmtree(FIXTURES / FORMAT_DIR, ignore_errors=True)
    (FIXTURES / FORMAT_DIR).mkdir(parents=True)
    files = {fixture_name(n): CASES[n] for n in sorted(CASES)}
    files[f"{FORMAT_DIR}/{FRAME}.j2k"] = archival_frame()
    for rel, data in files.items():
        (FIXTURES / rel).write_bytes(data)
        hashes[rel] = sha(pillow_array(data))
    FORMAT_HASHES.write_text(json.dumps(dict(sorted(hashes.items())),
                                        indent=1) + "\n")


def test_committed_files_hash_to_pillow(tmp_path):
    """Every committed file hashes to Pillow's array in formats.json, and
    the port reads each to the same hash."""
    want = json.loads(FORMAT_HASHES.read_text())
    files = committed()
    assert set(files) == {k for k in want if k.startswith(FORMAT_DIR + "/")}
    for rel, data in files.items():
        assert sha(pillow_array(data)) == want[rel], rel
        assert sha(port_array(data, tmp_path, rel.replace("/", "_"))) == \
            want[rel], rel


def test_writer_reproduces_the_committed_bytes():
    """Every case, and the 512^2 frame, written again equals its
    committed file."""
    for rel, data in committed().items():
        if rel.endswith(f"{FRAME}.j2k"):
            data = archival_frame()
        assert (FIXTURES / rel).read_bytes() == data, rel


def _decode_in_child(path: str, want: str, out) -> None:
    from nerf2mesh_tpu_torch.data.jpeg2000 import decode_jpeg2000
    out.put(sha(decode_jpeg2000(Path(path).read_bytes()))["sha256"] == want)


@pytest.mark.filterwarnings(
    "ignore:This process .* is multi-threaded:DeprecationWarning")
def test_concurrent_and_forked_decodes_agree():
    """The modes on the decoder's thread pool: 12 Python threads decode
    four files 6 times each, every result equal to its serial decode; then
    a process forked after the pool started decodes the 512^2 frame."""
    import concurrent.futures
    import multiprocessing
    from nerf2mesh_tpu_torch.data.jpeg2000 import decode_jpeg2000
    frame = FIXTURES / FORMAT_DIR / f"{FRAME}.j2k"
    datas = [frame.read_bytes(), CASES["layers_all_six"],
             CASES["sub_tiles_rgba"], CASES["roi_97_bypass"]]
    want = [sha(decode_jpeg2000(d)) for d in datas]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(12) as ex:
            futs = [(i, ex.submit(decode_jpeg2000, datas[i]))
                    for _ in range(6) for i in range(len(datas))]
            for i, f in futs:
                assert sha(f.result(timeout=120)) == want[i], i
    finally:
        sys.setswitchinterval(switch)
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    proc = ctx.Process(target=_decode_in_child,
                       args=(str(frame), want[0]["sha256"], q))
    proc.start()
    ok = q.get(timeout=120)          # drained before the join
    proc.join(timeout=120)
    assert not proc.is_alive() and proc.exitcode == 0 and ok


def test_reader_imports_no_pillow():
    """The modes decode in a process where Pillow cannot be imported."""
    paths = [str(FIXTURES / fixture_name(n))
             for n in ("sycc420_jp2", "layers_all_six", "roi_97")]
    code = f"""
import sys
sys.modules["PIL"] = None
from nerf2mesh_tpu_torch.data import png
for p in {paths!r}:
    assert png.read_image(p).size > 0, p
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout[-2000:] + res.stderr[-3000:]


if __name__ == "__main__":
    write_fixtures()

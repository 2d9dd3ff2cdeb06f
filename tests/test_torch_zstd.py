"""The port's zstd codec (utils/zstd.py, native/zstd.cpp) against the
zstandard module (libzstd), on the CPU.

The decoder must give zstandard's input back byte for byte from frames that
libzstd writes at levels 1, 3, 9 and 19 (and a negative, fast level), with
and without the content checksum and the content size, one frame or
several (streamed, with skippable frames between them), on inputs from 0
bytes to 4 MiB: float32 tables, source text, small-alphabet bytes, constant
runs.  zstandard must read the encoder's frames back.  Truncated, corrupt
and foreign input raises ValueError.  XXH64 and CRC-32C hold their
published check values.
"""

import sys

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from nerf2mesh_tpu_torch.utils import zstd

RNG = np.random.default_rng(0)
INPUTS = {
    "empty": b"",
    "one": b"a",
    "text": open(__file__, "rb").read() * 3,
    "zeros": bytes(100_000),
    "floats": RNG.standard_normal(1 << 18).astype(np.float32).tobytes(),
    "grid": np.repeat(RNG.random(4096).astype(np.float32), 64).tobytes(),
    "alphabet": RNG.integers(0, 4, 300_000, dtype=np.uint8).tobytes(),
    "cycle": (np.arange(1 << 20) % 251).astype(np.uint8).tobytes(),
}
BIG = np.tile(RNG.standard_normal(1 << 18).astype(np.float32), 4).tobytes()


@pytest.mark.parametrize("level", [1, 3, 9, 19, -5])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("size", [True, False])
def test_decoder_matches_libzstd(level, checksum, size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=size)
    for name, data in INPUTS.items():
        assert zstd.decompress(c.compress(data)) == data, name


@pytest.mark.parametrize("level", [1, 19])
def test_decoder_reads_4_mib_and_streams(level):
    c = zstandard.ZstdCompressor(level=level, write_checksum=True)
    assert zstd.decompress(c.compress(BIG)) == BIG
    # a stream without the content size, in several frames, with a
    # skippable frame between them
    obj = c.compressobj()
    streamed = obj.compress(BIG[:3_000_000]) + obj.flush()
    skip = b"\x5a\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"12345"
    frames = streamed + skip + c.compress(INPUTS["text"]) + c.compress(b"")
    assert zstd.decompress(frames) == BIG[:3_000_000] + INPUTS["text"]


def test_libzstd_reads_the_encoder():
    for name, data in list(INPUTS.items()) + [("big", BIG)]:
        for checksum in (True, False):
            frame = zstd.compress(data, checksum=checksum)
            d = zstandard.ZstdDecompressor()
            assert d.decompress(frame, max_output_size=len(data) + 1) == data \
                or len(data) == 0, name
            assert zstd.decompress(frame) == data, name
    # runs shrink to RLE blocks
    assert len(zstd.compress(INPUTS["zeros"])) < 100


@settings(max_examples=25, deadline=None)
@given(st.binary(max_size=4096), st.integers(min_value=1, max_value=19))
def test_round_trips(data, level):
    c = zstandard.ZstdCompressor(level=level, write_checksum=True)
    assert zstd.decompress(c.compress(data)) == data
    assert zstandard.ZstdDecompressor().decompress(
        zstd.compress(data), max_output_size=len(data) + 1) == data or not data


def test_corrupt_input_raises():
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        INPUTS["text"])
    for bad in (b"", b"garbage!", frame[:-1], frame[:len(frame) // 2],
                frame[:8], frame + b"\x00"):
        with pytest.raises(ValueError):
            zstd.decompress(bad)
    flipped = bytearray(frame)
    flipped[len(frame) - 2] ^= 0xFF          # the checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(flipped))
    rng = np.random.default_rng(1)
    for _ in range(200):                     # never a crash, only ValueError
        noisy = bytearray(frame)
        for i in rng.integers(4, len(frame), 3):
            noisy[i] = int(rng.integers(0, 256))
        try:
            zstd.decompress(bytes(noisy))
        except ValueError:
            pass
    dict_frame = bytearray(frame)
    dict_frame[4] |= 1                       # names a dictionary
    with pytest.raises(ValueError):
        zstd.decompress(bytes(dict_frame))


def test_check_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(bytes(32)) == 0x8A9136AA


def test_no_library_is_imported():
    """The port reaches none of libzstd's, tensorstore's or Orbax's Python
    packages, in any module."""
    import re
    from pathlib import Path
    pkg = Path(zstd.__file__).resolve().parent.parent
    pat = re.compile(r"^\s*(import|from)\s+(zstandard|tensorstore|orbax)\b")
    bad = [f"{f}:{i}" for f in sorted(pkg.rglob("*.py"))
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.search(line)]
    assert not bad, bad
    assert sys.modules["nerf2mesh_tpu_torch.utils.zstd"] is zstd

"""The port's PNG decode (``data/csrc/dataloader.cpp``: its own inflate and
a per-row unfilter) through ``native_loader.decode_png``, on PNGs written
here.

Every decode must equal zlib's inflate of the same IDAT stream followed
by the PNG unfilter, bit for bit: streams from Python's zlib at every
level and strategy, streams of hand-written DEFLATE blocks (overlapping
matches, distance 32768, length 258), IDAT split at odd offsets, the five
row filters at 1, 3 and 4 bytes a pixel. Every malformed stream must be
refused with a nonzero code, never read or written out of bounds.
"""

import struct
import zlib

import numpy as np
import pytest

from depthvo_tpu_torch.data import native_loader

COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
INFLATE_FAILED, BAD_FILTER = 9, 10  # dataloader.cpp's codes

LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67, 83, 99,
            115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769, 1025,
             1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577)


# --------------------------------------------------------------------------
# Writing PNGs.
# --------------------------------------------------------------------------


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, stream: bytes, w: int, h: int, channels: int, split=None):
    """A PNG of the zlib ``stream``; ``split``, IDAT chunk sizes (the rest
    in a last chunk)."""
    parts, pos = [], 0
    for n in split or ():
        parts.append(stream[pos:pos + n])
        pos += n
    parts.append(stream[pos:])
    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + b"".join(_chunk(b"IDAT", p) for p in parts) + _chunk(b"IEND", b""))
    return str(path)


def filter_rows(pixels: np.ndarray, filters) -> bytes:
    """The PNG encoder's side: (H, W, C) uint8 pixels with row ``y``
    filtered by ``filters[y]`` (0 None, 1 Sub, 2 Up, 3 Avg, 4 Paeth)."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    for y in range(h):
        x = rows[y]
        b = rows[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(c, np.int32), x[:-c]])
        cc = np.concatenate([np.zeros(c, np.int32), b[:-c]])
        kind = int(filters[y])
        if kind == 0:
            pred = np.zeros_like(x)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        out.append(kind)
        out += ((x - pred) & 255).astype(np.uint8).tobytes()
    return bytes(out)


def unfilter_reference(raw: bytes, w: int, h: int, c: int) -> np.ndarray:
    """The PNG decoder's side, byte by byte (None where a filter byte is
    not 0-4)."""
    stride = w * c
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1).astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    for y in range(h):
        kind, src = rows[y, 0], rows[y, 1:]
        if kind > 4:
            return None
        up = out[y - 1] if y else np.zeros(stride, np.int32)
        for i in range(stride):
            a = out[y, i - c] if i >= c else 0
            cc = up[i - c] if i >= c else 0
            b = up[i]
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out[y, i] = (src[i] + pred) & 255
    return out.astype(np.uint8).reshape(h, w, c)


def smooth_image(h, w, c, seed):
    """Gradients with a little noise: zlib codes it with dynamic blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * xx + 2 * yy)[..., None] + 40 * np.arange(c)
    return ((base + rng.integers(0, 3, size=(h, w, c))) % 256).astype(np.uint8)


def first_block_type(stream: bytes) -> int:
    return (stream[2] >> 1) & 3


def decode(path):
    return native_loader.decode_png(str(path))


def expect_zlib(path, stream: bytes, w: int, h: int, c: int):
    """The decode of ``path`` equals zlib's inflate of ``stream`` then the
    unfilter; for rows of filter 0, the inflated rows less their filter
    bytes."""
    raw = zlib.decompress(stream)
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * c + 1)
    if (rows[:, 0] == 0).all():
        expected = rows[:, 1:].reshape(h, w, c)
    else:
        expected = unfilter_reference(raw, w, h, c)
    np.testing.assert_array_equal(decode(path), expected)


# --------------------------------------------------------------------------
# Hand-written DEFLATE: fixed Huffman codes, symbols chosen by the test.
# --------------------------------------------------------------------------


class BitWriter:
    def __init__(self):
        self.value, self.n = 0, 0

    def bits(self, v: int, n: int):  # least significant bit first
        self.value |= (v & ((1 << n) - 1)) << self.n
        self.n += n

    def code(self, code: int, n: int):  # a Huffman code, most significant bit first
        self.bits(int(format(code, f"0{n}b")[::-1], 2), n)

    def tobytes(self) -> bytes:
        return self.value.to_bytes((self.n + 7) // 8, "little")


def fixed_litlen(bw: BitWriter, sym: int):
    if sym < 144:
        bw.code(0x30 + sym, 8)
    elif sym < 256:
        bw.code(0x190 + sym - 144, 9)
    elif sym < 280:
        bw.code(sym - 256, 7)
    else:
        bw.code(0xC0 + sym - 280, 8)


def fixed_block(bw: BitWriter, ops, final=True):
    """One fixed-code block of ``ops``: byte values (literals) and
    (length, distance) matches."""
    bw.bits(int(final), 1)
    bw.bits(1, 2)
    for op in ops:
        if isinstance(op, tuple):
            length, dist = op
            i = max(k for k, base in enumerate(LEN_BASE) if base <= length)
            fixed_litlen(bw, 257 + i)
            bw.bits(length - LEN_BASE[i], LEN_EXTRA[i])
            j = max(k for k, base in enumerate(DIST_BASE) if base <= dist)
            bw.code(j, 5)
            bw.bits(dist - DIST_BASE[j], max(0, j // 2 - 1))
        else:
            fixed_litlen(bw, op)
    fixed_litlen(bw, 256)


def zlib_stream(deflate: bytes, data: bytes) -> bytes:
    return b"\x78\x01" + deflate + struct.pack(">I", zlib.adler32(data))


def expand(ops) -> bytes:
    out = bytearray()
    for op in ops:
        if isinstance(op, tuple):
            length, dist = op
            for _ in range(length):
                out.append(out[-dist])
        else:
            out.append(op)
    return bytes(out)


def crafted(ops, data=None) -> bytes:
    """A zlib stream of one fixed-code block of ``ops``, with the checksum
    of ``data`` (by default, what the ops expand to)."""
    bw = BitWriter()
    fixed_block(bw, ops)
    return zlib_stream(bw.tobytes(), expand(ops) if data is None else data)


# --------------------------------------------------------------------------
# Inflate against zlib.
# --------------------------------------------------------------------------

LEVELS = [(level, zlib.Z_DEFAULT_STRATEGY) for level in range(10)] + [
    (6, zlib.Z_FILTERED), (6, zlib.Z_HUFFMAN_ONLY), (6, zlib.Z_RLE), (6, zlib.Z_FIXED),
    (1, zlib.Z_RLE), (9, zlib.Z_FIXED)]


@pytest.mark.parametrize("level,strategy", LEVELS)
@pytest.mark.parametrize("channels,w,h", [(1, 5, 9), (3, 7, 6), (4, 13, 5), (3, 333, 120)])
def test_zlib_levels_and_strategies(tmp_path, level, strategy, channels, w, h):
    img = smooth_image(h, w, channels, seed=level)
    img[h // 2:, : w // 2] = np.random.default_rng(1).integers(0, 256, (h - h // 2, w // 2,
                                                                        channels))
    raw = filter_rows(img, np.zeros(h, int))
    co = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    stream = co.compress(raw) + co.flush()
    path = write_png(tmp_path / "a.png", stream, w, h, channels)
    expect_zlib(path, stream, w, h, channels)


@pytest.mark.parametrize("kind,level,strategy", [
    ("stored", 0, zlib.Z_DEFAULT_STRATEGY), ("fixed", 6, zlib.Z_FIXED),
    ("dynamic", 6, zlib.Z_DEFAULT_STRATEGY)])
def test_each_block_type(tmp_path, kind, level, strategy):
    w, h = 240, 100  # 72,100 bytes: more than one stored block's 65,535
    img = smooth_image(h, w, 3, seed=5)
    raw = filter_rows(img, np.zeros(h, int))
    co = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    stream = co.compress(raw) + co.flush()
    assert first_block_type(stream) == {"stored": 0, "fixed": 1, "dynamic": 2}[kind]
    path = write_png(tmp_path / "a.png", stream, w, h, 3)
    expect_zlib(path, stream, w, h, 3)


def test_blocks_of_every_type_in_one_stream(tmp_path):
    """Sync flushes (empty stored blocks) at odd offsets between dynamic,
    fixed and stored blocks of one stream."""
    w, h = 101, 40
    img = smooth_image(h, w, 3, seed=6)
    raw = filter_rows(img, np.zeros(h, int))
    stream, pos = b"", 0
    for level, strategy, n in [(6, zlib.Z_DEFAULT_STRATEGY, 3001), (6, zlib.Z_FIXED, 1777),
                               (0, zlib.Z_DEFAULT_STRATEGY, 999), (9, zlib.Z_RLE, 10**9)]:
        part = raw[pos:pos + n]
        pos += len(part)
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
        body = co.compress(part) + co.flush(zlib.Z_SYNC_FLUSH if pos < len(raw) else zlib.Z_FINISH)
        stream += body
    stream = zlib_stream(stream, raw)
    path = write_png(tmp_path / "a.png", stream, w, h, 3)
    expect_zlib(path, stream, w, h, 3)


def _rows_of_matches(dists, lengths, seed):
    """One gray row per (distance, length): filter 0, ``dist`` random
    literals, the match, literals to the row's end."""
    rng = np.random.default_rng(seed)
    stride = max(dists) + max(lengths) + 2
    ops = []
    for d in dists:
        for n in lengths:
            row = [0] + rng.integers(0, 256, d).tolist() + [(n, d)]
            row += rng.integers(0, 256, stride - d - n).tolist()
            ops += row
    return ops, stride, len(dists) * len(lengths)


@pytest.mark.parametrize("dist", range(1, 9))
def test_overlapping_matches(tmp_path, dist):
    ops, w, h = _rows_of_matches([dist], [3, 4, 7, 8, 9, 15, 16, 17, 100, 257, 258], seed=dist)
    stream = crafted(ops)
    path = write_png(tmp_path / "a.png", stream, w, h, 1)
    expect_zlib(path, stream, w, h, 1)


def test_distance_32768_and_length_258(tmp_path):
    """Eight gray rows of 4,096 bytes (with the filter byte) as literals,
    then eight rows copied from 32,768 bytes back in matches of 258."""
    rng = np.random.default_rng(7)
    w, row = 4095, 4096
    ops = []
    for _ in range(8):
        ops += [0] + rng.integers(0, 256, w).tolist()
    for _ in range(8):
        ops += [(258, 32768)] * (row // 258) + [(row % 258, 32768)]
    stream = crafted(ops)
    path = write_png(tmp_path / "a.png", stream, w, 16, 1)
    expect_zlib(path, stream, w, 16, 1)


@pytest.mark.parametrize("split", ["one_byte", "odd", "tiny_first"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_idat_split(tmp_path, split, channels):
    w, h = 37, 11
    img = smooth_image(h, w, channels, seed=channels)
    stream = zlib.compress(filter_rows(img, np.arange(h) % 5), 9)
    sizes = {"one_byte": [1] * (len(stream) - 1),
             "odd": [1, 2, 3, 5, 7, 11, 13, 1, 1, 17, 19, 3] * 4,
             "tiny_first": [1, 1, 1, 1]}[split]
    path = write_png(tmp_path / "a.png", stream, w, h, channels, split=sizes)
    expect_zlib(path, stream, w, h, channels)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("w", [1, 2, 3, 5, 7, 11, 21])
def test_widths_off_the_vector_lanes(tmp_path, channels, w):
    h = 6
    img = np.random.default_rng(w).integers(0, 256, (h, w, channels)).astype(np.uint8)
    stream = zlib.compress(filter_rows(img, np.arange(h) % 5), 6)
    path = write_png(tmp_path / "a.png", stream, w, h, channels)
    expect_zlib(path, stream, w, h, channels)
    np.testing.assert_array_equal(decode(path), img)


# --------------------------------------------------------------------------
# Unfilter.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "random"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_each_row_filter(tmp_path, channels, filt):
    rng = np.random.default_rng(11 * channels)
    # Values of 0-7 on the widest image: Paeth's ties between its three
    # predictors come often.
    for w, h, top in [(1, 3, 256), (6, 5, 256), (33, 17, 256), (64, 24, 8)]:
        img = rng.integers(0, top, (h, w, channels)).astype(np.uint8)
        img[h // 2] = img[h // 2 - 1]  # equal neighbours
        filters = rng.integers(0, 5, h) if filt == "random" else np.full(h, filt)
        stream = zlib.compress(filter_rows(img, filters), 6)
        path = write_png(tmp_path / f"{w}.png", stream, w, h, channels)
        np.testing.assert_array_equal(decode(path), img)


def test_real_encoder_adaptive_filters(tmp_path):
    """PIL's own encoder (adaptive filters, zlib level 6) on a smooth image."""
    from PIL import Image

    img = smooth_image(64, 90, 3, seed=3)
    path = tmp_path / "pil.png"
    Image.fromarray(img).save(path, compress_level=6)
    np.testing.assert_array_equal(decode(path), img)


# --------------------------------------------------------------------------
# Malformed streams.
# --------------------------------------------------------------------------


def _good(w=24, h=16, c=3):
    img = smooth_image(h, w, c, seed=2)
    raw = filter_rows(img, np.zeros(h, int))
    return raw, zlib.compress(raw, 6)


def _dynamic_header(precode_lens, nlit=257, ndist=1):
    """A dynamic block's header up to its precode lengths (19 given)."""
    bw = BitWriter()
    bw.bits(1, 1)
    bw.bits(2, 2)
    bw.bits(nlit - 257, 5)
    bw.bits(ndist - 1, 5)
    bw.bits(19 - 4, 4)
    order = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
    for sym in order:
        bw.bits(precode_lens.get(sym, 0), 3)
    return bw


def _malformed(name):
    w, h, c = 24, 16, 3
    raw, good = _good(w, h, c)
    if name == "truncated_half":
        return good[:len(good) // 2]
    if name == "truncated_in_trailer":
        return good[:-2]
    if name == "truncated_before_trailer":
        return good[:-5]
    if name == "wrong_adler":
        return good[:-1] + bytes([good[-1] ^ 1])
    if name == "too_short":
        return zlib.compress(raw[:-1], 6)
    if name == "too_long":
        return zlib.compress(raw + b"\0", 6)
    if name == "bad_method":
        return bytes([0x79]) + good[1:]
    if name == "preset_dictionary":
        cmf = 0x78
        flg = 0x20 + (31 - ((cmf * 256 + 0x20) % 31)) % 31
        return bytes([cmf, flg]) + good[2:]
    if name == "block_type_3":
        bw = BitWriter()
        bw.bits(1, 1)
        bw.bits(3, 2)
        return zlib_stream(bw.tobytes() + b"\0" * 16, raw)
    if name == "stored_length_mismatch":
        body = b"\x01" + struct.pack("<HH", len(raw), 0x1234) + raw
        return zlib_stream(body, raw)
    if name == "precode_oversubscribed":
        bw = _dynamic_header({s: 1 for s in range(19)})
        return zlib_stream(bw.tobytes() + b"\0" * 64, raw)
    if name == "precode_incomplete":
        bw = _dynamic_header({1: 2, 2: 2})
        return zlib_stream(bw.tobytes() + b"\0" * 64, raw)
    if name in ("litlen_oversubscribed", "no_end_of_block", "repeat_with_no_previous"):
        # A complete precode: four symbols of two bits, coded in symbol order.
        syms = (0, 1, 8, 16)
        bw = _dynamic_header(dict.fromkeys(syms, 2))
        code = {s: i for i, s in enumerate(syms)}
        if name == "repeat_with_no_previous":
            bw.code(code[16], 2)
            bw.bits(0, 2)
        elif name == "litlen_oversubscribed":  # 257 litlen codes of one bit
            for _ in range(258):
                bw.code(code[1], 2)
        else:  # 256 literals of 8 bits (a complete code) and no end of block
            for _ in range(256):
                bw.code(code[8], 2)
            bw.code(code[0], 2)
            bw.code(code[1], 2)
        return zlib_stream(bw.tobytes() + b"\0" * 64, raw)
    if name == "litlen_incomplete":
        # 257 litlen codes of 9 bits (half the code space) and one 1-bit
        # distance code, then the image in those codes: all it lacks is a
        # complete code.
        syms = (0, 1, 9, 16)
        bw = _dynamic_header(dict.fromkeys(syms, 2))
        code = {s: i for i, s in enumerate(syms)}
        for _ in range(257):
            bw.code(code[9], 2)
        bw.code(code[1], 2)
        for byte in raw:
            bw.code(byte, 9)
        bw.code(256, 9)
        return zlib_stream(bw.tobytes(), raw)
    if name == "distance_before_start":
        return crafted([0, 1, 2, (3, 4)] + [0] * 100, data=raw)
    if name == "distance_first":
        return crafted([(3, 1)] + [0] * 100, data=raw)
    if name == "distance_symbol_30":
        bw = BitWriter()
        bw.bits(1, 1)
        bw.bits(1, 2)
        fixed_litlen(bw, 0)
        fixed_litlen(bw, 257)
        bw.code(30, 5)
        return zlib_stream(bw.tobytes() + b"\0" * 8, raw)
    if name == "litlen_symbol_286":
        bw = BitWriter()
        bw.bits(1, 1)
        bw.bits(1, 2)
        fixed_litlen(bw, 286)
        return zlib_stream(bw.tobytes() + b"\0" * 8, raw)
    raise KeyError(name)


MALFORMED = ["truncated_half", "truncated_in_trailer", "truncated_before_trailer",
             "wrong_adler", "too_short", "too_long", "bad_method", "preset_dictionary",
             "block_type_3", "stored_length_mismatch", "precode_oversubscribed",
             "precode_incomplete", "litlen_oversubscribed", "no_end_of_block",
             "repeat_with_no_previous", "litlen_incomplete", "distance_before_start", "distance_first",
             "distance_symbol_30", "litlen_symbol_286"]


@pytest.mark.parametrize("name", MALFORMED)
def test_malformed_stream_is_refused(tmp_path, name):
    stream = _malformed(name)
    path = write_png(tmp_path / "bad.png", stream, 24, 16, 3)
    with pytest.raises(ValueError, match=rf"failed \({INFLATE_FAILED}\)"):
        decode(path)


def test_unknown_row_filter_is_refused(tmp_path):
    w, h = 9, 4
    raw = bytearray(filter_rows(smooth_image(h, w, 3, seed=4), np.zeros(h, int)))
    raw[2 * (3 * w + 1)] = 5
    path = write_png(tmp_path / "bad.png", zlib.compress(bytes(raw)), w, h, 3)
    with pytest.raises(ValueError, match=rf"failed \({BAD_FILTER}\)"):
        decode(path)


def test_header_larger_than_the_stream_is_refused(tmp_path):
    """A 2^31-1 square header over a small stream: refused before any
    buffer is sized for it."""
    _, good = _good()
    path = write_png(tmp_path / "bad.png", good, 24, 16, 3)
    data = bytearray(open(path, "rb").read())
    data[16:24] = struct.pack(">II", 2**31 - 1, 2**31 - 1)
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match=rf"failed \({INFLATE_FAILED}\)"):
        decode(path)


@pytest.mark.parametrize("seed", range(4))
def test_corrupted_streams_agree_with_zlib(tmp_path, seed):
    """Random byte changes in a dynamic and a fixed stream: where zlib
    inflates the right number of bytes with valid filter bytes, the decode
    equals its inflate and unfilter; elsewhere the decode is refused."""
    rng = np.random.default_rng(seed)
    w, h, c = 12, 8, 3
    raw = filter_rows(smooth_image(h, w, c, seed=seed), rng.integers(0, 5, h))
    for strategy in (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED):
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, strategy)
        good = co.compress(raw) + co.flush()
        for k in range(40):
            bad = bytearray(good)
            for _ in range(1 + k % 3):
                bad[rng.integers(2, len(bad))] ^= int(rng.integers(1, 256))
            bad = bytes(bad)
            path = write_png(tmp_path / f"{strategy}_{k}.png", bad, w, h, c)
            try:
                ref = zlib.decompress(bad)
            except zlib.error:
                ref = None
            if ref is not None and len(ref) == h * (w * c + 1):
                expected = unfilter_reference(ref, w, h, c)
            else:
                expected = None
            if expected is None:
                with pytest.raises(ValueError, match="native PNG decode failed"):
                    decode(path)
            else:
                np.testing.assert_array_equal(decode(path), expected)

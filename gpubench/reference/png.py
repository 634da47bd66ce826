"""PNG decode and the data path's resize, in NumPy.

The decode reads 8-bit RGB PNGs without interlace (zlib and the five
row filters of the PNG standard). The resize is the system loader's:
separable triangle-filter resampling whose support widens with the
reduction (Pillow's ``BILINEAR``), weights normalised per output pixel and
rounded to float32, a horizontal pass then a vertical one accumulated in
float32 in tap order, then ``floor(acc + 0.5)`` clipped to [0, 255].
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def decode(path: str) -> np.ndarray:
    """An 8-bit RGB PNG -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color != 2 or interlace:
        raise ValueError(f"{path}: only 8-bit RGB without interlace is read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = row
        elif kind == 2:
            cur = (row + prev) & 255
        elif kind in (1, 3, 4):
            cur = np.zeros(3 * w, np.int32)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                c = prev[x - 3] if x >= 3 else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + prev[x]) // 2
                else:
                    p = a + prev[x] - c
                    pa, pb, pc = abs(p - a), abs(p - prev[x]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (prev[x] if pb <= pc else c)
                cur[x] = (row[x] + pred) & 255
        else:
            raise ValueError(f"{path}: unknown row filter {kind}")
        out[y], prev = cur, cur
    return out.reshape(h, w, 3).astype(np.uint8)


def _axis(in_size: int, out_size: int):
    """Per output pixel: first tap and float32 weights (Pillow's BILINEAR)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = fscale
    rows = []
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        x = (np.arange(lo, hi) - center + 0.5) / fscale
        wts = np.where(x < 0, np.where(x <= -1, 0.0, 1.0 + x), np.where(x >= 1, 0.0, 1.0 - x))
        total = wts.sum()
        wts = wts.astype(np.float32)
        if total > 0:
            wts = (wts.astype(np.float64) / total).astype(np.float32)
        rows.append((lo, wts))
    return rows


def resize_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (out_h, out_w, 3) uint8, the loader's resize."""
    h, w, _ = img.shape
    src = img.astype(np.float32)
    ax_x, ax_y = _axis(w, out_w), _axis(h, out_h)
    taps = max(len(t) for _, t in ax_x)
    tmp = np.zeros((h, out_w, 3), np.float32)
    for k in range(taps):
        cols = np.array([lo + k if k < len(t) else 0 for lo, t in ax_x])
        wk = np.array([t[k] if k < len(t) else 0.0 for _, t in ax_x], np.float32)
        tmp += wk[None, :, None] * src[:, cols]
    taps = max(len(t) for _, t in ax_y)
    acc = np.zeros((out_h, out_w, 3), np.float32)
    for k in range(taps):
        rows = np.array([lo + k if k < len(t) else 0 for lo, t in ax_y])
        wk = np.array([t[k] if k < len(t) else 0.0 for _, t in ax_y], np.float32)
        acc += wk[:, None, None] * tmp[rows]
    r = acc + np.float32(0.5)
    return np.where(r <= 0, 0, np.where(r >= 255, 255, np.floor(r))).astype(np.uint8)

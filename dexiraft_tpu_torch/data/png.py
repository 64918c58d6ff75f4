"""PNG codec in numpy and the standard library's zlib.

The datasets on the evaluation path store their frames and sparse ground
truth as PNG (Sintel and KITTI frames, KITTI and HD1K 16-bit flow), and a
KITTI submission is 16-bit PNG. This module reads and writes those files
without an image library:

  read_png(path)          non-interlaced PNG at bit depth 8 or 16: gray,
                          RGB, palette (8-bit), gray+alpha, RGBA
  write_png(path, array)  8- or 16-bit gray (H, W) or RGB (H, W, 3)

Channels come back in file order (R, G, B[, A]); 16-bit samples as native
uint16, palette images expanded to RGB. Interlaced files and bit depths
below 8 are refused with one ValueError that names the file.

Decoding undoes the five row filters (None, Sub, Up, Average, Paeth) for
the whole image at once. Every filter predicts a pixel from its left, up
and up-left neighbours only, so all pixels on one anti-diagonal
(x + y = d) are independent of each other: the image is skewed so that
each anti-diagonal is one contiguous slice, and the H + W - 1 diagonals
are decoded in order, each as a handful of vector operations over its
pixels, every row's own filter type selected per row.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

PathLike = Union[str, os.PathLike]


def _chunks(path: PathLike, data: bytes):
    """Yield (type, payload) of each chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        payload = data[pos + 8:end]
        if len(payload) != length or end + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{path}: PNG without IEND")


def _skew(a: np.ndarray) -> np.ndarray:
    """(H, W, n) -> (H + W - 1, H, n) with out[x + y, y] = a[y, x] and
    zeros elsewhere: each anti-diagonal of ``a`` becomes one row."""
    h, w, n = a.shape
    d = h + w - 1
    buf = np.zeros((h, d + 1, n), a.dtype)
    # row y of ``a`` lands shifted right by y: a row stride of (d + 2) n
    view = np.lib.stride_tricks.as_strided(
        buf, shape=(h, w, n),
        strides=((d + 2) * n * a.itemsize, n * a.itemsize, a.itemsize))
    view[...] = a
    return np.ascontiguousarray(buf[:, :d].transpose(1, 0, 2))


def _unskew(t: np.ndarray, h: int, w: int) -> np.ndarray:
    """Inverse of :func:`_skew`: (H + W - 1, H, n) -> (H, W, n)."""
    d, _, n = t.shape
    buf = np.zeros((h, d + 1, n), t.dtype)
    buf[:, :d] = t.transpose(1, 0, 2)
    return np.lib.stride_tricks.as_strided(
        buf, shape=(h, w, n),
        strides=((d + 2) * n * t.itemsize, n * t.itemsize,
                 t.itemsize)).copy()


def unfilter(filters: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters.

    ``filters``: (H,) filter type per row (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth); ``rows``: (H, stride) filtered bytes; ``bpp``: bytes per
    pixel. Returns the (H, stride) uint8 scanlines."""
    h, stride = rows.shape
    if filters.size and int(filters.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(filters.max())}")
    if not np.isin(filters, (3, 4)).any():
        # no Average/Paeth row: Sub is a per-channel cumulative sum and Up
        # an add of the previous row, both mod 256, one row at a time
        out = np.empty((h, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        for y in range(h):
            row, f = rows[y], filters[y]
            if f == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0,
                                dtype=np.uint8).reshape(-1)
            elif f == 2:
                row = row + prev
            out[y] = row
            prev = out[y]
        return out
    w = stride // bpp
    raw = _skew(rows.reshape(h, w, bpp).astype(np.int16))
    d = h + w - 1
    # decoded diagonals; index k + 2 holds diagonal k, index y + 1 row y,
    # so the neighbours outside the image read as the zeros around it
    t = np.zeros((d + 2, h + 1, bpp), np.int16)
    kinds = filters.astype(np.intp)[:, None]
    zero = np.zeros((h, 1), np.int16)
    # rows y0..y1 share one filter type iff run[y0] == run[y1]
    run = np.concatenate([[0], np.cumsum(filters[1:] != filters[:-1])])
    for k in range(d):
        y0, y1 = max(0, k - w + 1), min(h - 1, k)
        a = t[k + 1, y0 + 1:y1 + 2]   # left:    (y, x - 1)
        b = t[k + 1, y0:y1 + 1]       # up:      (y - 1, x)
        c = t[k, y0:y1 + 1]           # up-left: (y - 1, x - 1)
        kind = int(filters[y0]) if run[y0] == run[y1] else -1
        if kind in (-1, 4):
            p, q = b - c, a - c
            pa, pb, pc = np.abs(p), np.abs(q), np.abs(p + q)
            paeth = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
        if kind == -1:
            pred = np.choose(kinds[y0:y1 + 1],
                             (zero[y0:y1 + 1], a, b, (a + b) >> 1, paeth))
        else:
            pred = (0, a, b, None, None)[kind] if kind < 3 else (
                (a + b) >> 1 if kind == 3 else paeth)
        t[k + 2, y0 + 1:y1 + 2] = (raw[k, y0:y1 + 1] + pred) & 255
    return _unskew(t[2:, 1:], h, w).astype(np.uint8).reshape(h, stride)


def read_png(path: PathLike) -> np.ndarray:
    """Decode a PNG file (module docstring): (H, W) for gray, (H, W, C)
    otherwise; uint8 at bit depth 8, uint16 at 16."""
    with open(path, "rb") as f:
        data = f.read()
    header = palette = None
    idat = []
    for kind, payload in _chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype not in _CHANNELS or compression or filtering:
        raise ValueError(f"{path}: unsupported PNG header (colour type "
                         f"{ctype}, compression {compression}, filter "
                         f"method {filtering})")
    if interlace or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(
            f"{path}: only non-interlaced PNGs of bit depth 8 or 16 (8 for "
            f"palette images) are supported, got interlace {interlace}, "
            f"bit depth {depth}, colour type {ctype}")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    lines = unfilter(raw[:, 0], raw[:, 1:], bpp)
    if depth == 16:
        img = lines.view(">u2").astype(np.uint16).reshape(h, w, channels)
    else:
        img = lines.reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[img[..., 0]]
    return img[..., 0] if channels == 1 else img


def filter_rows(lines: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Apply PNG row filters: ``lines`` (H, stride) uint8 scanlines,
    ``filters`` one type for every row or an (H,) sequence. Returns (H,
    stride + 1) bytes, each row led by its filter type. Every predictor
    reads the unfiltered neighbours, so all rows are filtered at once."""
    h, stride = lines.shape
    kinds = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                    # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                              # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]                 # up-left
    p, q = b - c, a - c
    pa, pb, pc = np.abs(p), np.abs(q), np.abs(p + q)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.choose(kinds.astype(np.intp)[:, None],
                     (np.zeros_like(x), a, b, (a + b) >> 1, paeth))
    out = np.empty((h, stride + 1), np.uint8)
    out[:, 0] = kinds
    out[:, 1:] = (x - pred) & 255
    return out


def write_png(path: PathLike, array: np.ndarray, filters=2) -> None:
    """Encode (H, W) or (H, W, 1) gray or (H, W, 3) RGB, uint8 or uint16,
    as a PNG at that bit depth. ``filters``: the row filter type of every
    row (default 2, Up) or one per row."""
    img = np.asarray(array)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    if img.dtype == np.uint8:
        depth = 8
    elif img.dtype == np.uint16:
        depth = 16
        img = img.astype(">u2")
    else:
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
    h, w = img.shape[:2]
    lines = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    filtered = filter_rows(lines, _CHANNELS[ctype] * depth // 8, filters)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(filtered.tobytes())))
        f.write(chunk(b"IEND", b""))

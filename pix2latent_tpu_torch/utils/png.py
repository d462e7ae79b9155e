"""A small PNG codec on ``zlib``, ``struct`` and numpy, so that reading and
writing PNG images needs no imaging library.

It reads 8-bit grayscale, grayscale + alpha, RGB and RGBA images without
interlacing (every filter type of the PNG specification, section 9), and
writes 8-bit grayscale, RGB and RGBA. PNG is lossless, so the pixels are
those any other decoder gives. Other PNGs raise :class:`UnsupportedPNG`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, for bit depth 8
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A PNG this codec does not read (bit depth, palette, interlacing)."""


def is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def _chunks(data):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw, h, w, bpp):
    """The image bytes ``[h, w * bpp]`` from the filtered scanlines."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data has {rows.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:                                   # None
            cur = line.copy()
        elif kind == 1:                                 # Sub
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:                                 # Up
            cur = line + prior
        elif kind in (3, 4):                            # Average, Paeth
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind} is not defined")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path) -> np.ndarray:
    """The pixels of a PNG: uint8 ``[H, W]`` (gray) or ``[H, W, C]`` with C
    2 (gray + alpha), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path!r} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path!r}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise UnsupportedPNG(
            f"{path!r}: bit depth {depth}, color type {color}, interlace "
            f"{interlace}; this codec reads 8-bit gray, gray + alpha, RGB "
            "and RGBA without interlacing")
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    return pixels.reshape(h, w) if ch == 1 else pixels.reshape(h, w, ch)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, im) -> None:
    """Write uint8 ``[H, W]``, ``[H, W, 1]``, ``[H, W, 3]`` or ``[H, W, 4]``
    as an 8-bit PNG (gray, RGB or RGBA), every scanline unfiltered."""
    im = np.asarray(im)
    if im.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {im.dtype}")
    if im.ndim == 3 and im.shape[2] == 1:
        im = im[..., 0]
    if im.ndim == 2:
        color = 0
    elif im.ndim == 3 and im.shape[2] in (3, 4):
        color = 2 if im.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png: cannot write shape {im.shape}")
    h, w = im.shape[:2]
    rows = np.ascontiguousarray(im).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    data = (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)

"""8-bit PNG encode/decode in numpy + zlib.

Covers what the renderer writes and what its own assets carry: 8-bit
greyscale, grey+alpha, RGB, RGBA and palette images, non-interlaced, all
five row filters.  Anything else (16-bit, interlaced) raises
`UnsupportedPNG`, so a caller can hand the bytes to a general image library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples/pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}         # channels -> colour type


class UnsupportedPNG(ValueError):
    """A valid PNG this codec does not decode (16-bit, interlaced, ...)."""


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1..4) -> PNG bytes (filter None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encode needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw [h, 1 + stride] -> [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:                                  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 1:                                  # Sub
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype in (3, 4):                             # Average, Paeth
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] with C = 1, 2, 3 or 4 (palette -> 3/4)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, trns = 8, [], None, None
    width = height = depth = ctype = interlace = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if width is None:
        raise ValueError("PNG has no IHDR chunk")
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise UnsupportedPNG(f"PNG with bit depth {depth}, colour type "
                             f"{ctype}, interlace {interlace}")
    c = _CHANNELS[ctype]
    stride = width * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(height, stride + 1), height, stride, c)
    img = img.reshape(height, width, c)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE chunk")
        rgb = palette[img[..., 0]]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = trns[:len(palette)]
        return np.concatenate([rgb, alpha[img[..., 0]][..., None]], axis=-1)
    return img


def to_rgba(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> [H, W, 4] (grey broadcast, opaque alpha added)."""
    c = img.shape[-1]
    if c in (1, 2):
        rgb = np.repeat(img[..., :1], 3, axis=-1)
        alpha = img[..., 1:2] if c == 2 else None
    else:
        rgb = img[..., :3]
        alpha = img[..., 3:4] if c == 4 else None
    if alpha is None:
        alpha = np.full(img.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def write(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))


def read(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())

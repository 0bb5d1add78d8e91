"""PNG reading and writing with the stdlib and numpy.

The JAX package reads and writes its images through PIL, which the card's
machine does not have. This module decodes what the driver meets: 8-bit,
non-interlaced greyscale, RGB and RGBA, with all five row filter types, to
(H, W, 3) uint8 as ``np.asarray(PIL.Image.open(p).convert("RGB"))`` gives
it (greyscale replicated, alpha dropped). It encodes (H, W, 3) uint8 RGB
with filter type 0 on every row and ``zlib``. Anything else (other bit
depths, palettes, interlacing, greyscale with alpha, a bad CRC) raises
``ValueError`` naming the file.
"""
from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> samples per pixel
_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale+alpha", 6: "RGBA"}


def _unfilter(raw: bytes, height: int, width: int, bpp: int, name: str) -> np.ndarray:
    """Undo the per-row filters; returns (height, width * bpp) uint8."""
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{name}: image data holds {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        ftype = int(rows[r, 0])
        cur = rows[r, 1:]
        if ftype == 0:
            rec = cur.copy()
        elif ftype == 1:      # Sub: a running sum per channel, mod 256
            rec = np.cumsum(cur.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            rec = cur + prior
        elif ftype in (3, 4):
            line = cur.tolist()
            up = prior.tolist()
            if ftype == 3:    # Average
                for i in range(bpp):
                    line[i] = (line[i] + (up[i] >> 1)) & 0xFF
                for i in range(bpp, stride):
                    line[i] = (line[i] + ((line[i - bpp] + up[i]) >> 1)) & 0xFF
            else:             # Paeth
                for i in range(bpp):
                    line[i] = (line[i] + up[i]) & 0xFF
                for i in range(bpp, stride):
                    a, b, c = line[i - bpp], up[i], up[i - bpp]
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    line[i] = (line[i] + pred) & 0xFF
            rec = np.asarray(line, np.uint8)
        else:
            raise ValueError(f"{name}: row {r} has unknown filter type {ftype}")
        out[r] = rec
        prior = rec
    return out


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {ctype!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: bad CRC in the {ctype!r} chunk")
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{name}: {depth}-bit {_NAMES.get(color, f'colour type {color}')}"
            f"{', interlaced' if interlace else ''} PNG is not supported (8-bit "
            f"non-interlaced greyscale, RGB or RGBA only)")
    bpp = _CHANNELS[color]
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, width, bpp, name)
    pix = pix.reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(pix, 3, axis=2)
    return np.ascontiguousarray(pix[:, :, :3])


def read_png(f: Union[str, BinaryIO], name: str = None) -> np.ndarray:
    """Read a PNG from a path or an open binary file -> (H, W, 3) uint8."""
    if isinstance(f, str):
        with open(f, "rb") as fh:
            return decode_png(fh.read(), name or f)
    return decode_png(f.read(), name or getattr(f, "name", "<png>"))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (filter type 0, zlib ``level``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))

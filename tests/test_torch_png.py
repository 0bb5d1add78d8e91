"""The port's PNG codec (``free_hunch_tpu_torch/data/png.py``) against PIL,
which the JAX package reads and writes its images with: decoding is held
bit for bit to ``np.asarray(PIL.Image.open(p).convert("RGB"))``, and what
the port writes reads back bit for bit through PIL."""
import glob
import io
import os
import struct
import zlib

import numpy as np
import PIL.Image
import pytest

from free_hunch_tpu_torch.data import png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLED = sorted(glob.glob(os.path.join(ROOT, "data", "imagenet", "00000", "*.png")))


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_png(arr: np.ndarray, **save) -> bytes:
    """PIL's PNG of ``arr``, its mode inferred from the shape and dtype."""
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, "PNG", **save)
    return buf.getvalue()


def test_the_bundled_images_are_there():
    assert len(BUNDLED) == 10


@pytest.mark.parametrize("path", BUNDLED, ids=os.path.basename)
def test_bundled_png_decodes_like_pil(path):
    with open(path, "rb") as f:
        data = f.read()
    got = png.decode_png(data, path)
    assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
    assert np.array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("mode,channels", [("RGB", 3), ("RGBA", 4), ("L", 1)])
@pytest.mark.parametrize("optimize", [False, True])
def test_pil_written_modes_decode_like_pil(mode, channels, optimize):
    rng = np.random.default_rng(channels)
    # a smooth gradient plus noise, so PIL's adaptive filtering picks
    # several filter types
    yy, xx = np.mgrid[0:37, 0:53]
    base = (yy * 3 + xx * 2)[..., None] + rng.integers(0, 40, (37, 53, channels))
    arr = (base % 256).astype(np.uint8)
    if channels == 1:
        arr = arr[..., 0]
    data = _pil_png(arr, optimize=optimize)
    assert PIL.Image.open(io.BytesIO(data)).mode == mode
    assert np.array_equal(png.decode_png(data), _pil_rgb(data))


def _png_with_filter(arr: np.ndarray, ftype: int) -> bytes:
    """An RGB PNG whose every row uses filter ``ftype``, built by hand with
    the PNG standard's definitions (PIL picks filters itself)."""
    h, w, c = arr.shape
    bpp, a = c, arr.astype(np.int64).reshape(h, w * c)
    rows = []
    for r in range(h):
        cur = a[r]
        prior = a[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prior
        elif ftype == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
            f = cur - pred
        rows.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
    raw = zlib.compress(b"".join(rows))
    return (png._SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + png._chunk(b"IDAT", raw) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_every_filter_type_decodes_like_pil(ftype):
    arr = np.random.default_rng(ftype).integers(0, 256, (19, 23, 3), dtype=np.uint8)
    data = _png_with_filter(arr, ftype)
    assert np.array_equal(_pil_rgb(data), arr)
    assert np.array_equal(png.decode_png(data), arr)


def test_written_png_reads_back_through_pil(tmp_path):
    arr = np.random.default_rng(0).integers(0, 256, (31, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, arr)
    im = PIL.Image.open(path)
    assert im.mode == "RGB" and im.size == (17, 31)
    assert np.array_equal(np.asarray(im), arr)
    assert np.array_equal(png.read_png(path), arr)


@pytest.mark.parametrize("kind", ["16-bit", "palette", "interlaced", "grey+alpha"])
def test_unsupported_pngs_raise_naming_the_file(kind):
    rng = np.random.default_rng(1)
    if kind == "16-bit":
        data = _pil_png(rng.integers(0, 65535, (8, 8)).astype(np.uint16))
    elif kind == "palette":
        im = PIL.Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).convert("P")
        buf = io.BytesIO()
        im.save(buf, "PNG")
        data = buf.getvalue()
    elif kind == "interlaced":
        buf = io.BytesIO()
        PIL.Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
            buf, "PNG", interlace=1)
        data = buf.getvalue()
        # PIL does not write interlaced PNGs: set the flag in the header
        if data[28] == 0:
            ihdr = bytearray(data[16:29])
            ihdr[12] = 1
            data = data[:8] + png._chunk(b"IHDR", bytes(ihdr)) + data[33:]
    else:
        data = _pil_png(rng.integers(0, 256, (8, 8, 2), dtype=np.uint8))
    with pytest.raises(ValueError, match="odd.png"):
        png.decode_png(data, "odd.png")


def test_a_corrupt_chunk_raises():
    data = bytearray(png.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data), "bad.png")

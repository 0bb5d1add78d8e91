"""The inputs of a run, made from ``--seed``: the clean images, the
operator and what it draws (an inpainting mask), the measurement and its
noise, the initial noise.

The clean images are the repository's bundled 256 px PNGs
(``data/imagenet/00000``), decoded here with zlib and numpy (once a
checkout: the pixels are cached beside the other caches); each run takes
``batch`` of them, chosen and ordered by (seed, run), at the
configuration's resolution: average-pooled below 256 px, bilinearly
upsampled (``F.interpolate``, ``align_corners=False``) above it. Everything else is
drawn from a generator seeded by (seed, run, purpose), so one seed gives
the same run inputs every time, and every run of the window fresh ones.
"""
from __future__ import annotations

import hashlib
import struct
import zlib
from pathlib import Path
import numpy as np
import torch

import spec
from spec import ROOT

IMAGES = ROOT / "data" / "imagenet" / "00000"
ASSETS = ROOT / "free_hunch_tpu" / "assets"
_PURPOSE = {"images": 1, "noise": 2, "measure": 3, "mask": 4, "check": 6}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit non-interlaced RGB or RGBA PNG bytes -> (H, W, 3) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = head
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {color}")
    bpp = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * bpp + 1)
    out = np.zeros((h, w * bpp), np.int32)
    prior = np.zeros(w * bpp, np.int32)
    for r in range(h):
        f, cur = raw[r, 0], raw[r, 1:].astype(np.int32)
        if f == 0:
            line = cur
        elif f == 1:
            line = np.cumsum(cur.reshape(w, bpp), axis=0).reshape(-1) % 256
        elif f == 2:
            line = (cur + prior) % 256
        else:
            line, up = cur.tolist(), prior.tolist()
            for i in range(w * bpp):
                a = line[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                pred = (a + up[i]) >> 1 if f == 3 else _paeth(a, up[i], c)
                line[i] = (line[i] + pred) & 0xFF
            line = np.asarray(line, np.int32)
        out[r] = line
        prior = out[r]
    return out.reshape(h, w, bpp)[..., :3].astype(np.uint8)


def bundled_images(cache_dir: Path) -> np.ndarray:
    """The ten bundled images, (10, 3, 256, 256) float32 in [-1, 1]. The
    decoded pixels are kept in ``cache_dir`` under the hash of the files'
    bytes, so only a checkout's first run decodes them."""
    blobs = [p.read_bytes() for p in sorted(IMAGES.glob("*.png"))]
    key = hashlib.sha1(b"".join(blobs)).hexdigest()[:16]
    path = Path(cache_dir) / f"images-{key}.npy"
    if path.exists():
        ims = np.load(path)
    else:
        ims = np.stack([decode_png(b) for b in blobs])
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npy")
        np.save(tmp, ims)
        tmp.replace(path)
    return ims.transpose(0, 3, 1, 2).astype(np.float32) / 127.5 - 1.0


def generator(seed: int, run: int, purpose: str, device="cpu") -> torch.Generator:
    """A generator for one purpose of one run of one seed (a purpose not
    named here, an operator's own, is keyed by its name's CRC)."""
    key = _PURPOSE.get(purpose, 100 + zlib.crc32(purpose.encode()) % 1_000_000)
    mixed = (int(seed) * 1_000_003 + run * 7919 + key) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


class Run:
    """The inputs of run ``run`` of ``seed`` at ``res`` px: ``clean`` (the
    bundled images pooled down or bilinearly upsampled to ``res``), ``y``,
    ``noise`` (the sampler's initial noise, unscaled) and ``op``, the
    reference's operator of the run (``reference/operators/<name>.py``),
    whose ``program`` holds what the program's operator is built from."""

    def __init__(self, seed: int, run: int, traffic: dict, images: np.ndarray, device,
                 res: int = 256):
        b = traffic["batch"]
        g = generator(seed, run, "images")
        pick = torch.randperm(images.shape[0], generator=g)[:b].tolist()
        if len(pick) < b:
            raise ValueError(f"batch {b} needs {b} images; {images.shape[0]} are bundled")
        clean = torch.as_tensor(images[pick])
        if res < clean.shape[-1]:
            clean = torch.nn.functional.avg_pool2d(clean, clean.shape[-1] // res)
        elif res > clean.shape[-1]:
            clean = torch.nn.functional.interpolate(clean, size=(res, res), mode="bilinear",
                                                    align_corners=False)
        self.clean = clean.to(device)
        self.noise = torch.randn((b, 3, res, res), generator=generator(seed, run, "noise", device),
                                 device=device)
        op = traffic["operator"]
        self.op = spec.operator(op["name"]).make(
            op, b, res, lambda purpose: generator(seed, run, purpose), device)
        n = torch.randn((b, 3, res, res), generator=generator(seed, run, "measure", device),
                        device=device)
        with torch.no_grad():
            self.y = self.op.measure(self.clean, n)

"""Dataset preparation: image collections into the framework's folder or
zip layout, and SD-VAE latents.

Counterpart of the repository's ``dataset_tool.py``: ``convert`` with the
transforms center-crop, center-crop-wide and center-crop-dhariwal (the ADM
preprocessing), writing ``<idx // 1000>/img<idx>.png`` files and
``dataset.json`` into a directory or a zip; ``encode`` / ``decode`` between
images and latents with the port's ``StabilityVAEEncoder`` (weights from an
explicit npz, ``--vae-weights``). PNGs are read and written through
``data/png.py``; PIL is imported only where it is needed, for a JPEG source
and for the resampling of the transforms.

Usage:
  python -m free_hunch_tpu_torch.tools.dataset_tool convert --source=in_dir \\
      --dest=out.zip --resolution=256x256 --transform=center-crop-dhariwal
  python -m free_hunch_tpu_torch.tools.dataset_tool encode --source=in_dir \\
      --dest=latents/ --vae-weights=sd-vae-ft-mse.npz
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import zipfile
from typing import Optional

import numpy as np

from free_hunch_tpu_torch.data import png
from free_hunch_tpu_torch.data.dataset import _pil

_EXTS = {".png", ".jpg", ".jpeg"}


def _resize(img: np.ndarray, size, resample: str) -> np.ndarray:
    """PIL's resize of an (H, W, 3) uint8 image to ``size`` (width, height)."""
    pil = _pil("dataset_tool", "resample an image")
    return np.array(pil.fromarray(img, "RGB").resize(tuple(size),
                                                     getattr(pil.Resampling, resample)))


def _scale(width, height, img):
    width, height = width or img.shape[1], height or img.shape[0]
    if img.shape[1] == width and img.shape[0] == height:
        return img
    return _resize(img, (width, height), "LANCZOS")


def _center_crop(width, height, img):
    crop = min(img.shape[:2])
    img = img[(img.shape[0] - crop) // 2:(img.shape[0] + crop) // 2,
              (img.shape[1] - crop) // 2:(img.shape[1] + crop) // 2]
    return _resize(img, (width, height), "LANCZOS")


def _center_crop_wide(width, height, img):
    ch = int(np.round(width * img.shape[0] / img.shape[1]))
    if img.shape[1] < width or ch < height:
        return None
    img = _resize(img[(img.shape[0] - ch) // 2:(img.shape[0] + ch) // 2], (width, height),
                  "LANCZOS")
    canvas = np.zeros([width, width, 3], np.uint8)
    canvas[(width - height) // 2:(width + height) // 2, :] = img
    return canvas


def _center_crop_dhariwal(image_size, img):
    """ADM preprocessing: halve with BOX while the short side is at least
    twice the target, BICUBIC to the target on the short side, centre crop."""
    pil = _pil("dataset_tool", "resample an image")
    im = pil.fromarray(img)
    while min(*im.size) >= 2 * image_size:
        im = im.resize(tuple(x // 2 for x in im.size), pil.Resampling.BOX)
    scale = image_size / min(*im.size)
    im = im.resize(tuple(round(x * scale) for x in im.size), pil.Resampling.BICUBIC)
    arr = np.array(im)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return arr[cy:cy + image_size, cx:cx + image_size]


def make_transform(transform: Optional[str], width: Optional[int], height: Optional[int]):
    if transform is None:
        return functools.partial(_scale, width, height)
    if transform == "center-crop":
        return functools.partial(_center_crop, width, height)
    if transform == "center-crop-wide":
        return functools.partial(_center_crop_wide, width, height)
    if transform == "center-crop-dhariwal":
        if width != height:
            raise ValueError("the dhariwal transform needs a square resolution")
        return functools.partial(_center_crop_dhariwal, width)
    raise ValueError(f"unknown transform {transform!r}")


def _read_image(f, name: str) -> np.ndarray:
    """An (H, W, 3) uint8 RGB image from an open binary file."""
    if os.path.splitext(name)[1].lower() == ".png":
        return png.read_png(f, name=name)
    return np.array(_pil(name, "decode").open(f).convert("RGB"))


def _iter_source(source: str, max_images: Optional[int] = None):
    """(image, label) of each image of a directory (recursively) or a zip,
    in sorted name order; labels from its ``dataset.json``."""
    if os.path.isdir(source):
        files = sorted(os.path.join(r, f) for r, _d, fs in os.walk(source)
                       for f in fs if os.path.splitext(f)[1].lower() in _EXTS)
        labels = {}
        lp = os.path.join(source, "dataset.json")
        if os.path.exists(lp):
            with open(lp) as fh:
                labels = {os.path.join(source, a): b for a, b in json.load(fh).get("labels") or []}
        for f in files[:max_images]:
            with open(f, "rb") as fh:
                yield _read_image(fh, f), labels.get(f)
    elif zipfile.is_zipfile(source):
        with zipfile.ZipFile(source) as z:
            names = [n for n in sorted(z.namelist()) if os.path.splitext(n)[1].lower() in _EXTS]
            labels = {}
            if "dataset.json" in z.namelist():
                labels = dict(json.loads(z.read("dataset.json")).get("labels") or [])
            for n in names[:max_images]:
                with z.open(n) as fh:
                    yield _read_image(fh, n), labels.get(n)
    else:
        raise SystemExit(f"missing input file or directory: {source}")


class _Dest:
    """PNG + dataset.json writer for a directory or a zip destination."""

    def __init__(self, dest: str):
        self.dest = dest
        self.zip = None
        if dest.endswith(".zip"):
            os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            self.zip = zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED)
        else:
            os.makedirs(dest, exist_ok=True)
        self.labels = []

    def write(self, idx: int, img: np.ndarray, label):
        name = f"{idx // 1000:05d}/img{idx:08d}.png"
        if self.zip is not None:
            self.zip.writestr(name, png.encode_png(img, level=0))
        else:
            path = os.path.join(self.dest, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            png.write_png(path, img)
        if label is not None:
            self.labels.append([name, label])

    def close(self):
        meta = json.dumps({"labels": self.labels or None})
        if self.zip is not None:
            self.zip.writestr("dataset.json", meta)
            self.zip.close()
        else:
            with open(os.path.join(self.dest, "dataset.json"), "w") as f:
                f.write(meta)


def convert(source, dest, resolution=None, transform=None, max_images=None) -> int:
    """Write the images of ``source`` through ``transform`` at
    ``resolution`` ("WxH") into ``dest``; returns the count written."""
    width = height = None
    if resolution:
        width, height = (int(v) for v in resolution.split("x"))
    tf = make_transform(transform, width, height)
    out = _Dest(dest)
    n = 0
    for img, label in _iter_source(source, max_images):
        img = tf(img)
        if img is None:
            continue
        out.write(n, img, label)
        n += 1
    out.close()
    print(f"wrote {n} images to {dest}")
    return n


def _encoder(vae_weights: str, device=None):
    from free_hunch_tpu_torch.data.encoders import StabilityVAEEncoder
    enc = StabilityVAEEncoder(weights=vae_weights)
    enc.init(device=device)
    return enc


def encode(source, dest, vae_weights: str, max_images=None, device=None):
    """Images -> SD-VAE latent ``latent<idx>.npy`` files (the latent draws
    from the encoder's own seeded generator)."""
    enc = _encoder(vae_weights, device)
    os.makedirs(dest, exist_ok=True)
    for i, (img, _label) in enumerate(_iter_source(source, max_images)):
        z = enc.encode(img.transpose(2, 0, 1)[None])
        np.save(os.path.join(dest, f"latent{i:08d}.npy"), z.cpu().numpy())
    print(f"encoded latents to {dest}")


def decode(source, dest, vae_weights: str, device=None):
    """Latent .npy files -> PNGs."""
    enc = _encoder(vae_weights, device)
    os.makedirs(dest, exist_ok=True)
    for f in sorted(os.listdir(source)):
        if f.endswith(".npy"):
            x = enc.decode(np.load(os.path.join(source, f)))
            png.write_png(os.path.join(dest, f.replace(".npy", ".png")),
                          x[0].permute(1, 2, 0).cpu().numpy())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("--source", required=True)
    c.add_argument("--dest", required=True)
    c.add_argument("--resolution")
    c.add_argument("--transform", choices=["center-crop", "center-crop-wide",
                                           "center-crop-dhariwal"])
    c.add_argument("--max-images", type=int)
    for name in ("encode", "decode"):
        e = sub.add_parser(name)
        e.add_argument("--source", required=True)
        e.add_argument("--dest", required=True)
        e.add_argument("--vae-weights", required=True,
                       help="the converted sd-vae-ft-mse weights (npz)")
        e.add_argument("--device", default=None, help="default cuda")
        if name == "encode":
            e.add_argument("--max-images", type=int)
    args = p.parse_args(argv)
    if args.cmd == "convert":
        convert(args.source, args.dest, args.resolution, args.transform, args.max_images)
    elif args.cmd == "encode":
        encode(args.source, args.dest, args.vae_weights, args.max_images, args.device)
    else:
        decode(args.source, args.dest, args.vae_weights, args.device)


if __name__ == "__main__":
    main()

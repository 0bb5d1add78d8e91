"""Image datasets (directory or zip) with optional labels.

Counterpart of ``free_hunch_tpu/data/dataset.py``: recursive png/jpg
listing, zip archives, ``dataset.json`` labels, ``max_size`` truncation,
``xflip`` doubling, ``cache`` and ``return_idx``; items are uint8 CHW numpy
arrays, equal to the JAX package's. PNGs decode through ``data/png.py``.
PIL is imported only for what that module does not do, a JPEG decode or a
LANCZOS resize to a ``resolution`` other than the file's, and its absence
then raises an ``ImportError`` that says why.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Optional, Tuple

import numpy as np

from free_hunch_tpu_torch.data import png


def _pil(fname: str, why: str):
    try:
        import PIL.Image
    except ImportError as e:
        raise ImportError(f"{fname}: PIL is needed to {why} (data/png.py decodes "
                          f"8-bit PNGs at their own size without it)") from e
    return PIL.Image


_EXTS = {".png", ".jpg", ".jpeg"}


class ImageFolderDataset:
    def __init__(self, path: str, resolution: Optional[int] = None,
                 use_labels: bool = False, max_size: Optional[int] = None,
                 xflip: bool = False, random_seed: int = 0, cache: bool = False,
                 return_idx: bool = False, **kwargs):
        self.path = path
        self.resolution = resolution
        self.use_labels = use_labels
        self.return_idx = return_idx
        self.xflip = xflip
        self._cache = {} if cache else None
        self._zip = None

        if os.path.isdir(path):
            self._type = "dir"
            files = []
            for root, _dirs, names in os.walk(path):
                for n in names:
                    if os.path.splitext(n)[1].lower() in _EXTS:
                        files.append(os.path.relpath(os.path.join(root, n), path))
            self._files = sorted(files)
        elif zipfile.is_zipfile(path):
            self._type = "zip"
            self._files = sorted(n for n in self._zipfile().namelist()
                                 if os.path.splitext(n)[1].lower() in _EXTS)
        else:
            raise IOError(f"dataset path must be a directory or zip: {path}")
        if not self._files:
            raise IOError(f"no image files found in {path}")

        self._labels = self._load_labels() if use_labels else None

        size = len(self._files)
        raw_idx = np.arange(size, dtype=np.int64)
        if max_size is not None and size > max_size:
            rnd = np.random.RandomState(random_seed)
            rnd.shuffle(raw_idx)
            raw_idx = np.sort(raw_idx[:max_size])
        self._raw_idx = raw_idx
        self._xflip_mask = np.zeros(len(raw_idx), np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip_mask = np.concatenate(
                [self._xflip_mask, np.ones_like(self._xflip_mask)])

    # -- IO -------------------------------------------------------------------

    def _zipfile(self):
        if self._zip is None:
            self._zip = zipfile.ZipFile(self.path)
        return self._zip

    def _open(self, fname: str):
        if self._type == "dir":
            return open(os.path.join(self.path, fname), "rb")
        return self._zipfile().open(fname, "r")

    def _load_labels(self):
        try:
            with self._open("dataset.json") as f:
                labels = json.load(f).get("labels")
        except Exception:
            return None
        if labels is None:
            return None
        table = dict(labels)
        return np.asarray([table.get(fn.replace("\\", "/"), 0)
                           for fn in self._files])

    def _load_image(self, raw_idx: int) -> np.ndarray:
        if self._cache is not None and raw_idx in self._cache:
            return self._cache[raw_idx]
        fname = self._files[raw_idx]
        with self._open(fname) as f:
            if os.path.splitext(fname)[1].lower() == ".png":
                img = png.read_png(f, name=fname)
            else:
                img = np.array(_pil(fname, "decode").open(f).convert("RGB"))
        if self.resolution is not None and (img.shape[0] != self.resolution
                                            or img.shape[1] != self.resolution):
            pil = _pil(fname, f"resize {img.shape[0]}x{img.shape[1]} to "
                              f"{self.resolution}x{self.resolution}")
            img = np.array(pil.fromarray(img).resize(
                (self.resolution, self.resolution), pil.LANCZOS))
        chw = img.transpose(2, 0, 1)  # HWC -> CHW uint8
        if self._cache is not None:
            self._cache[raw_idx] = chw
        return chw

    # -- dataset protocol -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._raw_idx)

    def __getitem__(self, idx: int):
        raw = int(self._raw_idx[idx])
        img = self._load_image(raw)
        if self._xflip_mask[idx]:
            img = img[:, :, ::-1].copy()
        label = self.get_label(idx)
        if self.return_idx:
            return idx, img, label
        return img, label

    def get_label(self, idx: int):
        if self._labels is None:
            return np.zeros((0,), np.float32)
        lab = self._labels[int(self._raw_idx[idx])]
        if np.ndim(lab) == 0:  # class index -> onehot like the reference
            onehot = np.zeros(int(self._labels.max()) + 1, np.float32)
            onehot[int(lab)] = 1
            return onehot
        return np.asarray(lab, np.float32)

    @property
    def name(self) -> str:
        return os.path.splitext(os.path.basename(self.path.rstrip("/")))[0]

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self._load_image(int(self._raw_idx[0])).shape)

    @property
    def label_dim(self) -> int:
        return len(self.get_label(0))


def shard_indices(n_total: int, num_shards: int, shard: int,
                  drop_remainder: bool = False) -> np.ndarray:
    """Deterministic strided sharding of dataset indices across processes."""
    idx = np.arange(n_total)
    if drop_remainder:
        idx = idx[: (n_total // num_shards) * num_shards]
    return idx[shard::num_shards]

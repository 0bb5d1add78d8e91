"""A comparison grid of method results.

Counterpart of the repository's ``create_image_visualisation.py``: the
rows are the ground truth (``cond_images/``) and the measurement
(``forward_images/``) of the first run directory, where present, then each
run's ``images/`` (the driver's output layout); the columns the first
``num_images`` image names of the first run. Images are read and the grid
written through ``data/png.py``; PIL is imported only to resize an image
whose size differs from the first one's.

Usage:
  python -m free_hunch_tpu_torch.tools.image_visualisation \\
      --runs out/dps out/freehunch --num_images 6 --out grid.png
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from free_hunch_tpu_torch.data import png
from free_hunch_tpu_torch.data.dataset import _pil


def _load_row(run_dir: str, sub: str, names):
    row = []
    for n in names:
        p = os.path.join(run_dir, sub, n)
        row.append(png.read_png(p) if os.path.exists(p) else None)
    return row


def build_grid(runs, num_images: int = 6, include_cond: bool = True,
               include_forward: bool = True, pad: int = 4):
    """(canvas (H, W, 3) uint8 on a white ground, row labels)."""
    first = runs[0]
    names = sorted(os.listdir(os.path.join(first, "images")))[:num_images]
    rows, labels = [], []
    if include_cond and os.path.isdir(os.path.join(first, "cond_images")):
        rows.append(_load_row(first, "cond_images", names))
        labels.append("ground truth")
    if include_forward and os.path.isdir(os.path.join(first, "forward_images")):
        rows.append(_load_row(first, "forward_images", names))
        labels.append("measurement")
    for r in runs:
        rows.append(_load_row(r, "images", names))
        labels.append(os.path.basename(os.path.normpath(r)))

    res = next(im.shape[0] for row in rows for im in row if im is not None)
    canvas = np.full((len(rows) * (res + pad) + pad, len(names) * (res + pad) + pad, 3), 255,
                     np.uint8)
    for i, row in enumerate(rows):
        for j, im in enumerate(row):
            if im is None:
                continue
            if im.shape[0] != res:
                pil = _pil(names[j], "resize an image to the grid's cell")
                im = np.array(pil.fromarray(im).resize((res, res)))
            y = pad + i * (res + pad)
            x = pad + j * (res + pad)
            canvas[y:y + res, x:x + res] = im
    return canvas, labels


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", nargs="+", required=True)
    p.add_argument("--num_images", type=int, default=6)
    p.add_argument("--out", default="visualisation.png")
    args = p.parse_args(argv)
    canvas, labels = build_grid(args.runs, args.num_images)
    png.write_png(args.out, canvas)
    print(f"rows: {labels}\nwrote {args.out}")


if __name__ == "__main__":
    main()

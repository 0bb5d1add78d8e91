"""FID reference statistics (mu, sigma) of a dataset.

Counterpart of the repository's ``scripts/compute_fid_stats.py``: every
image (or the first ``total_images``) of ``dataset_path`` through the
port's InceptionV3 features (``metrics/fid.py``; the converted pytorch-fid
weights from ``--fid_weights``, else the seeded random-feature proxy, and
then the statistics carry ``is_proxy=True``), accumulated in float64 and
saved as the npz that the driver's ``--fid_ref_stats`` reads.

Usage:
  python -m free_hunch_tpu_torch.tools.compute_fid_stats \\
      --dataset_path=data/imagenet/ --out=data/imagenet_fid_stats.npz \\
      [--total_images=N] [--batch=16] [--fid_weights=pt_inception.npz]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np


def compute_fid_stats(dataset_path: str, out: str, total_images: Optional[int] = None,
                      batch: int = 16, resolution: Optional[int] = None,
                      fid_weights: Optional[str] = None, device=None):
    """Write the statistics of the dataset's features to ``out``; returns
    (the FeatureStats, is_proxy)."""
    from free_hunch_tpu_torch.data.dataset import ImageFolderDataset
    from free_hunch_tpu_torch.metrics import fid
    ds = ImageFolderDataset(dataset_path, resolution=resolution, return_idx=True)
    n = min(total_images or len(ds), len(ds))
    extract, is_proxy = fid.make_extractor(fid_weights, device=device)
    stats = fid.FeatureStats()
    for start in range(0, n, batch):
        imgs = np.stack([ds[i][1] for i in range(start, min(start + batch, n))])
        stats.add(extract(imgs.astype(np.float32) / 127.5 - 1.0))
        print(f"\r{stats.n}/{n}", end="", file=sys.stderr, flush=True)
    print(file=sys.stderr)
    stats.save(out, is_proxy=is_proxy)
    print(f"wrote {out}: n={stats.n}, dim={stats.dim}, is_proxy={is_proxy}")
    return stats, is_proxy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--total_images", type=int, default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--resolution", type=int, default=None)
    ap.add_argument("--fid_weights", default=None,
                    help="converted pytorch-fid InceptionV3 weights (npz)")
    ap.add_argument("--device", default=None, help="default cuda")
    args = ap.parse_args(argv)
    compute_fid_stats(args.dataset_path, args.out, args.total_images, args.batch,
                      args.resolution, args.fid_weights, args.device)


if __name__ == "__main__":
    main()

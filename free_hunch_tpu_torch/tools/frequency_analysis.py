"""The per-DCT-coefficient variance prior of a dataset.

Counterpart of the repository's ``do_frequency_analysis.py``: stream N
images through the orthonormal 2-D DCT (``ops/dct.py``, batched on the
device) and accumulate each coefficient's mean and variance (Welford, one
sample at a time, float64 on the host); save ``dct_variance.npz``
(``dct_variance``, ``dct_mean``), the Free Hunch DCT-basis prior that
``FreeHunch(data_dir=...)`` reads, and ``dct_variance.pt``.

Usage:
  python -m free_hunch_tpu_torch.tools.frequency_analysis \\
      --dataset_path data/imagenet/ --num_images 500
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from free_hunch_tpu_torch import resolve_device, use_full_f32


def compute_dct_variance(dataset_path: str, num_images: int = 500, resolution: int = 256,
                         batch_size: int = 16, device=None):
    """(mean, variance) of the DCT coefficients of the first
    ``num_images`` images of ``dataset_path`` at ``resolution``, each
    (3, resolution, resolution) float32; the DCT runs on ``device``
    (default CUDA)."""
    from free_hunch_tpu_torch.data.dataset import ImageFolderDataset
    from free_hunch_tpu_torch.data.encoders import StandardRGBEncoder
    from free_hunch_tpu_torch.ops.dct import dct_2d
    use_full_f32()
    dev = resolve_device(device)
    ds = ImageFolderDataset(dataset_path, resolution=resolution)
    enc = StandardRGBEncoder()
    n_total = min(num_images, len(ds))
    count = 0
    mean = np.zeros((3, resolution, resolution), np.float64)
    m2 = np.zeros((3, resolution, resolution), np.float64)
    for start in range(0, n_total, batch_size):
        batch = np.stack([ds[i][0] for i in range(start, min(start + batch_size, n_total))])
        coeffs = dct_2d(enc.encode(batch).to(dev)).double().cpu().numpy()
        for c in coeffs:  # Welford update per sample
            count += 1
            delta = c - mean
            mean += delta / count
            m2 += delta * (c - mean)
    var = m2 / max(count - 1, 1)
    return mean.astype(np.float32), var.astype(np.float32)


def output_dir(dataset_path: str, out=None) -> str:
    """``out``, else the dataset's directory; for a zip dataset a directory
    named after the archive beside it."""
    out_dir = out or dataset_path
    if os.path.isfile(out_dir):
        out_dir = os.path.join(os.path.dirname(os.path.abspath(out_dir)),
                               os.path.splitext(os.path.basename(out_dir))[0])
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_path", default="data/imagenet/")
    p.add_argument("--num_images", type=int, default=500)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, help="default cuda")
    args = p.parse_args(argv)
    mean, var = compute_dct_variance(args.dataset_path, args.num_images, args.resolution,
                                     args.batch_size, args.device)
    out_dir = output_dir(args.dataset_path, args.out)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "dct_variance.npz"), dct_variance=var,
                        dct_mean=mean)
    torch.save(torch.from_numpy(var), os.path.join(out_dir, "dct_variance.pt"))
    print(f"saved DCT variance ({var.shape}) to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()

"""Upstream LPIPS weights to the npz that ``metrics/lpips.py`` reads.

Counterpart of the repository's ``scripts/convert_lpips_weights.py``, over
the port's ``metrics/lpips.py::convert_torch_weights``. Both inputs are
plain torch state dicts (torchvision is not needed):
  --vgg   a torchvision vgg16 checkpoint (e.g. vgg16-397923af.pth); only
          the ``features.*`` conv weights are read
  --lins  the official LPIPS linear heads (PerceptualSimilarity
          lpips/weights/v0.1/vgg.pth), keys ``lin<i>.model.1.weight``

Usage:
  python -m free_hunch_tpu_torch.tools.convert_lpips_weights --vgg vgg16.pth \\
      --lins vgg.pth --out models/lpips_vgg.npz
and pass ``lpips_weights=models/lpips_vgg.npz`` to the port's evaluator.
"""
from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from free_hunch_tpu_torch.metrics.lpips import convert_torch_weights


def convert(vgg: str, lins: str, out: str) -> dict:
    """Read both state dicts, convert, write ``out``; returns the arrays."""
    vgg_sd = torch.load(vgg, map_location="cpu", weights_only=True)
    lins_sd = torch.load(lins, map_location="cpu", weights_only=True)
    vgg_np = {k: v.numpy() for k, v in vgg_sd.items() if k.startswith("features.")}
    # the official head files name 'lin0.model.1.weight': 'lins.0.model.1.weight' here
    lins_np = {re.sub(r"^lin([0-4])", r"lins.\1", k): v.numpy() for k, v in lins_sd.items()}
    params = convert_torch_weights(vgg_np, lins_np)
    np.savez(out, **params)
    print(f"wrote {out}: {len(params)} arrays, "
          f"{sum(a.nbytes for a in params.values()) / 1e6:.1f} MB")
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vgg", required=True)
    ap.add_argument("--lins", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    convert(args.vgg, args.lins, args.out)


if __name__ == "__main__":
    main()

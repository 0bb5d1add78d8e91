"""The gaussian blur: circular convolution by the repository's kernel file
(``free_hunch_tpu/assets/kernels/<kernel_file>``, a raw asset both sides
read), y = A x + sigma_y n. The program builds the same kernel from its
size and intensity."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from reference.freehunch import Blur

KERNELS = Path(__file__).resolve().parents[3] / "free_hunch_tpu" / "assets" / "kernels"


def make(op: dict, batch: int, res: int, gen, device) -> Blur:
    ref = Blur(np.load(KERNELS / op["kernel_file"]), res, res, op["sigma_y"], device)
    ref.program = dict(kernel_size=op["kernel_size"], intensity=op["intensity"])
    return ref

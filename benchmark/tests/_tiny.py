"""Shared pieces of the benchmark's CPU tests: a cell cut to a tiny UNet
at 32 px (two images, eight Heun steps), the same code paths as the
committed cells."""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

import spec  # noqa: E402

ADM = spec.reference({})     # the adm family's reference module

TINY_MODEL = dict(image_size=32, num_channels=32, num_res_blocks=1, channel_mult="1,2",
                  attention_resolutions="16", num_head_channels=16)


def tiny_cell(name: str = "imagenet256-blur-vjp", steps: int = 8, batch: int = 2,
              torso: str = "bfloat16") -> dict:
    """The cell cut to a tiny UNet; ``torso`` "float32" runs the program's
    torso in the reference's type, so that only a fault reads off."""
    c = spec.cell(name)
    c["config"]["model"].update(TINY_MODEL)
    c["config"]["precision"]["torso"] = torso
    c["traffic"].update(batch=batch, steps=steps, trace={"first_call": 2, "calls": 3})
    return c


def one_thread():
    torch.set_num_threads(1)

"""FIR 2x resampling: score_sde's ``upsample_2d`` and ``downsample_2d``.

The FIR filter of NCSN++ (``models/ncsnpp.py``; score_sde's
``models/up_or_down_sampling.py``, after StyleGAN2's ``upfirdn2d``): a 1-D
tap list k (NCSN++'s [1, 3, 3, 1]) makes the 2-D kernel outer(k, k) /
sum(outer(k, k)); ``upsample_2d`` inserts a zero after every sample, pads
(2, 1) and convolves with 4 times that kernel; ``downsample_2d`` pads
(1, 1), convolves and keeps every second sample. Here the same maps are a
depthwise convolution (``groups=C``) and its transpose with the 4x4
kernel:

* down: ``conv2d(x, flip(K), stride=2, padding=1)``: an H x W input gives
  floor(H / 2) x floor(W / 2);
* up: ``conv_transpose2d(x, 4 K, stride=2, padding=1)``: 2H x 2W.

Both run in the input's type and layout (the bf16 channels-last torso of
NCSN++, or its float32 output pyramid). ``fir_resample`` is an autograd
function whose backward is the other map's adjoint, so the guidance
pullback goes through it: a down's pullback is the transposed convolution
(with the output padding an odd size needs), an up's the strided one.

Tracing (``utils/profiling.py``): each call is a ``fir.resample`` span,
each pullback a ``fir.resample_backward`` span opened in the backward,
both timed on the device by the tracer's event pair (folded by its
``snapshot``: nothing synchronises inside the model), and the counter
``fir_calls`` counts the calls. Off, each costs the tracer's flag read.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from free_hunch_tpu_torch.utils import profiling

_KERNELS: dict = {}


def fir_kernel_2d(taps: Sequence[float]) -> np.ndarray:
    """The normalised 2-D kernel of a 1-D tap list: outer(k, k) / its sum."""
    k = np.asarray(taps, np.float64)
    k2 = np.outer(k, k)
    return k2 / k2.sum()


def _weight(taps: Tuple[float, ...], up: bool, c: int, dtype, device) -> torch.Tensor:
    """The (C, 1, kh, kw) depthwise weight of one map, built once per
    (taps, map, C, type, device)."""
    key = (taps, up, c, dtype, device)
    w = _KERNELS.get(key)
    if w is None:
        k = fir_kernel_2d(taps)
        k = 4.0 * k if up else k[::-1, ::-1]
        w = torch.as_tensor(np.ascontiguousarray(k), dtype=torch.float32, device=device)
        w = w.to(dtype)[None, None].expand(c, 1, *k.shape).contiguous()
        _KERNELS[key] = w
    return w


def _down(x, w):
    return F.conv2d(x, w, stride=2, padding=1, groups=x.shape[1])


def _up(x, w, out_hw=None):
    op = (0, 0) if out_hw is None else (out_hw[0] - 2 * x.shape[2], out_hw[1] - 2 * x.shape[3])
    return F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=op, groups=x.shape[1])


class _FIR(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, taps, up):
        w = _weight(taps, up, x.shape[1], x.dtype, x.device)
        ctx.cfg = (taps, up, tuple(x.shape[2:]))
        y = _up(x, w) if up else _down(x, w)
        return y.contiguous(memory_format=_layout(x))

    @staticmethod
    def backward(ctx, g):
        taps, up, hw = ctx.cfg
        with profiling.span("fir.resample_backward", device=g.device):
            w = _weight(taps, up, g.shape[1], g.dtype, g.device)
            # each map's adjoint is the other, back to x's size
            dx = _down(g, w) if up else _up(g, w, hw)
            dx = dx.contiguous(memory_format=_layout(g))
        return dx, None, None


def _layout(x):
    return torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) and \
        not x.is_contiguous() else torch.contiguous_format


def fir_resample(x: torch.Tensor, taps: Sequence[float] = (1, 3, 3, 1),
                 up: bool = False) -> torch.Tensor:
    """score_sde's ``upsample_2d`` (``up``) or ``downsample_2d`` of an
    (N, C, H, W) tensor with the FIR taps ``taps``, factor 2, gain 1, in
    x's type and memory layout. Four taps, as score_sde's padding takes."""
    if len(taps) != 4:
        raise ValueError(f"FIR resampling takes four taps, got {len(taps)}")
    with profiling.span("fir.resample", device=x.device):
        profiling.count("fir_calls")
        return _FIR.apply(x, tuple(float(t) for t in taps), bool(up))


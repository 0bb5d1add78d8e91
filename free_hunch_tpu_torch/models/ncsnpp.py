"""score_sde's NCSN++ (``models/ncsnpp.py::NCSNpp``) as an ``nn.Module``.

The network of github.com/yang-song/score_sde (and EDM's ``SongUNet``),
built from the keys of a score_sde config's ``model`` block and the data
keys ``image_size``, ``num_channels`` and ``centered``
(``create_model(**settings)``; ``configs/ve/ffhq_ncsnpp_continuous.py`` is
``models/ffhq_ncsnpp_continuous_setup.json`` at the repository's root). The
forward and the block order follow ``NCSNpp.forward`` and ``layerspp.py``'s
``ResnetBlockBigGANpp``, ``AttnBlockpp``, ``Combine`` and the FIR
``Upsample``/``Downsample`` of the pyramids:

* a Gaussian Fourier embedding of log(sigma) (``W`` held as N(0, 1) draws,
  multiplied by ``fourier_scale`` in the forward; score_sde stores it
  already scaled, ``models/convert.py`` divides) and two dense layers;
* per level (``image_size / 2^l``, channels ``nf * ch_mult[l]``):
  ``num_res_blocks`` BigGAN blocks (attention after each at
  ``attn_resolutions``), then a BigGAN down block whose FIR downsamples
  both paths and whose 1x1 conv takes the skip; the input pyramid
  (``input_skip``): the input, FIR-downsampled a level at a time, through a
  1x1 conv summed onto the down block's output (``Combine``, ``sum``);
* the middle: block, attention, block at the deepest level;
* per level up: ``num_res_blocks + 1`` blocks on the concatenation with
  the skips, attention at ``attn_resolutions``, the output pyramid
  (``output_skip``): GroupNorm, swish and a 3x3 conv to the image's
  channels, summed onto the FIR-upsampled pyramid of the level below; then
  a BigGAN up block;
* every block's sum with its skip divided by sqrt(2) (``skip_rescale``);
  GroupNorm with min(C / 4, 32) groups at eps 1e-6; the output divided by
  sigma (``scale_by_sigma``): the score in the network's data range.

Only the published variant is laid out (BigGAN blocks, FIR resampling,
``output_skip``, ``input_skip`` by ``sum``, ``ddpm`` attention, the
Fourier embedding, ``conditional``, ``skip_rescale``, ``scale_by_sigma``); anything
else raises.

Where it departs from the source, as ``models/unet.py`` does for the ADM
UNet (the port's torso policy):

* the torso (its convolutions, dense layers, attention's projections and
  weights @ v, the FIR resampling of its activations, the skips' sums) runs
  in ``dtype`` (bf16) and channels-last; the Fourier embedding and its dense
  layers, every GroupNorm's statistics and affine (``ops/groupnorm.py``, K1
  on the card), attention's logits and softmax, and the output pyramid (its
  norms, its final convs, its FIR upsampling and sums) run in float32;
* ``remat`` wraps every BigGAN block in ``torch.utils.checkpoint``;
* dropout is absent (evaluation only).

``forward(x, sigma)``: x (N, C, H, W) in the network's data range ([0, 1]
where ``centered`` is False; the network maps it to [-1, 1] first, as the
source does), sigma (N,) in that range's units; float32 out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from free_hunch_tpu_torch.ops.fir import fir_resample
from free_hunch_tpu_torch.ops.groupnorm import groupnorm_silu

_SQRT2 = math.sqrt(2.0)

# the score_sde ``model`` keys of the published variant: the only values
# this module lays out
_PUBLISHED = {"resblock_type": "biggan", "progressive": "output_skip",
              "progressive_input": "input_skip", "progressive_combine": "sum",
              "attention_type": "ddpm", "embedding_type": "fourier", "fir": True,
              "conditional": True, "resamp_with_conv": True, "normalization": "GroupNorm",
              "nonlinearity": "swish", "conv_size": 3, "skip_rescale": True,
              "scale_by_sigma": True}


@dataclasses.dataclass(frozen=True)
class NCSNppConfig:
    image_size: int = 1024
    num_channels: int = 3
    centered: bool = False
    nf: int = 16
    ch_mult: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 32, 32)
    num_res_blocks: int = 1
    attn_resolutions: Tuple[int, ...] = (16,)
    fir_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    fourier_scale: float = 16.0
    sigma_min: float = 0.01
    sigma_max: float = 1348.0
    dtype: torch.dtype = torch.bfloat16  # the torso's type
    remat: bool = True

    @property
    def levels(self) -> int:
        return len(self.ch_mult)

    def res(self, level: int) -> int:
        return self.image_size // 2 ** level

    def ch(self, level: int) -> int:
        return self.nf * self.ch_mult[level]


class GroupNormpp(nn.Module):
    """NCSN++'s GroupNorm: min(C / 4, 32) groups, eps 1e-6, f32 statistics
    and affine, optionally fused with the swish that follows it; NCHW in and
    out (ideally channels-last in memory), in the input's type."""

    def __init__(self, channels: int, apply_silu: bool):
        super().__init__()
        self.groups = min(channels // 4, 32)
        self.apply_silu = apply_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = groupnorm_silu(x.permute(0, 2, 3, 1), self.weight, self.bias, self.groups, 1e-6,
                           self.apply_silu)
        return y.permute(0, 3, 1, 2)


class GaussianFourier(nn.Module):
    """[sin, cos](2 pi scale W log_sigma): ``W`` (nf,) N(0, 1) draws."""

    def __init__(self, nf: int, scale: float):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.zeros(nf))

    def forward(self, t):
        proj = t.float()[:, None] * (self.W * self.scale)[None] * (2 * np.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class ResBlock(nn.Module):
    """``ResnetBlockBigGANpp``: norm0+swish, FIR up or down of both paths,
    conv0, plus the dense projection of swish(temb), norm1+swish, conv1,
    the 1x1 skip conv where the width changes or it resamples, (x + h) /
    sqrt(2)."""

    def __init__(self, cin: int, cout: int, temb_dim: int, cfg: NCSNppConfig,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down, self.cfg = up, down, cfg
        self.norm0 = GroupNormpp(cin, True)
        self.conv0 = nn.Conv2d(cin, cout, 3, padding=1)
        self.dense = nn.Linear(temb_dim, cout)
        self.norm1 = GroupNormpp(cout, True)
        self.conv1 = nn.Conv2d(cout, cout, 3, padding=1)
        self.skip = nn.Conv2d(cin, cout, 1) if (cin != cout or up or down) else None

    def _forward(self, x, temb):
        h = self.norm0(x)
        if self.up or self.down:
            taps = self.cfg.fir_kernel
            h, x = fir_resample(h, taps, self.up), fir_resample(x, taps, self.up)
        h = self.conv0(h)
        h = h + self.dense(F.silu(temb).to(self.dense.weight.dtype))[:, :, None, None]
        h = self.conv1(self.norm1(h))
        if self.skip is not None:
            x = self.skip(x)
        return (x + h) / _SQRT2

    def forward(self, x, temb):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, x, temb, use_reentrant=False)
        return self._forward(x, temb)


class AttnBlock(nn.Module):
    """``AttnBlockpp`` (one head): GroupNorm, the q, k, v projections
    (score_sde's ``NIN``, here (out, in) linear weights), f32 logits scaled
    by C^-1/2 and softmax, weights @ v in the torso's type, the output
    projection, (x + h) / sqrt(2)."""

    def __init__(self, channels: int, cfg: NCSNppConfig):
        super().__init__()
        self.cfg = cfg
        self.norm = GroupNormpp(channels, False)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x):
        n, c, hh, ww = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(n, hh * ww, c)
        q, k, v = self.q(y), self.k(y), self.v(y)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        h = self.proj(torch.matmul(w, v))
        h = h.reshape(n, hh, ww, c).permute(0, 3, 1, 2)
        return (x + h) / _SQRT2


class _Down(nn.Module):
    """A level of the encoder."""

    def __init__(self, level: int, cin: int, temb_dim: int, cfg: NCSNppConfig):
        super().__init__()
        ch = cfg.ch(level)
        attn = cfg.res(level) in cfg.attn_resolutions
        self.res = nn.ModuleList()
        self.attn = nn.ModuleList()
        for _ in range(cfg.num_res_blocks):
            self.res.append(ResBlock(cin, ch, temb_dim, cfg))
            if attn:
                self.attn.append(AttnBlock(ch, cfg))
            cin = ch
        if level != cfg.levels - 1:
            self.down = ResBlock(ch, ch, temb_dim, cfg, down=True)
            self.combine = nn.Conv2d(cfg.num_channels, ch, 1)


class _Up(nn.Module):
    """A level of the decoder, with its output-pyramid head."""

    def __init__(self, level: int, cin: int, skips, temb_dim: int, cfg: NCSNppConfig):
        super().__init__()
        ch = cfg.ch(level)
        self.res = nn.ModuleList()
        for _ in range(cfg.num_res_blocks + 1):
            self.res.append(ResBlock(cin + skips.pop(), ch, temb_dim, cfg))
            cin = ch
        if cfg.res(level) in cfg.attn_resolutions:
            self.attn = AttnBlock(ch, cfg)
        self.out_norm = GroupNormpp(ch, True)
        self.out_conv = nn.Conv2d(ch, cfg.num_channels, 3, padding=1)
        if level != 0:
            self.up = ResBlock(ch, ch, temb_dim, cfg, up=True)


class NCSNpp(nn.Module):
    """NCSN++: x in the data range and sigma (N,) in, the score (float32)
    out; see the module docstring."""

    def __init__(self, cfg: NCSNppConfig):
        super().__init__()
        self.cfg = cfg
        nf = cfg.nf
        temb_dim = 4 * nf
        self.fourier = GaussianFourier(nf, cfg.fourier_scale)
        self.temb = nn.ModuleList([nn.Linear(2 * nf, temb_dim), nn.Linear(temb_dim, temb_dim)])
        self.conv_in = nn.Conv2d(cfg.num_channels, nf, 3, padding=1)
        self.down = nn.ModuleList()
        skips, cin = [nf], nf
        for level in range(cfg.levels):
            self.down.append(_Down(level, cin, temb_dim, cfg))
            cin = cfg.ch(level)
            skips += [cin] * (cfg.num_res_blocks + (level != cfg.levels - 1))
        self.mid = nn.ModuleList([ResBlock(cin, cin, temb_dim, cfg), AttnBlock(cin, cfg),
                                  ResBlock(cin, cin, temb_dim, cfg)])
        self.up = nn.ModuleList()
        for level in reversed(range(cfg.levels)):
            self.up.append(_Up(level, cin, skips, temb_dim, cfg))
            cin = cfg.ch(level)
        self.cast_torso()

    def float32_modules(self):
        """The modules whose parameters stay f32: the embedding, every
        norm, the output pyramid's convs."""
        return [self.fourier, self.temb] + [m.out_conv for m in self.up] + \
            [m for m in self.modules() if isinstance(m, GroupNormpp)]

    def cast_torso(self):
        """The torso's parameters in ``cfg.dtype``, its convs channels-last."""
        f32 = {id(p) for m in self.float32_modules() for p in m.parameters()}
        for p in self.parameters():
            if id(p) not in f32:
                p.data = p.data.to(self.cfg.dtype)
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
        return self

    def forward(self, x, sigma):
        cfg = self.cfg
        sigma = sigma.float().reshape(-1)
        temb = self.temb[0](self.fourier(torch.log(sigma)))
        temb = self.temb[1](F.silu(temb))
        if not cfg.centered:
            x = 2 * x - 1.0
        x = x.to(cfg.dtype).contiguous(memory_format=torch.channels_last)
        taps = cfg.fir_kernel
        pyr_in, hs = x, [self.conv_in(x)]
        for level, blk in enumerate(self.down):
            for i, res in enumerate(blk.res):
                h = res(hs[-1], temb)
                if len(blk.attn):
                    h = blk.attn[i](h)
                hs.append(h)
            if level != cfg.levels - 1:
                h = blk.down(hs[-1], temb)
                pyr_in = fir_resample(pyr_in, taps)
                hs.append(blk.combine(pyr_in) + h)
        h = self.mid[0](hs[-1], temb)
        h = self.mid[2](self.mid[1](h), temb)
        pyramid = None
        for blk in self.up:
            for res in blk.res:
                h = res(torch.cat([h, hs.pop()], dim=1), temb)
            if hasattr(blk, "attn"):
                h = blk.attn(h)
            p = blk.out_conv(blk.out_norm(h.float()))
            pyramid = p if pyramid is None else fir_resample(pyramid, taps, up=True) + p
            if hasattr(blk, "up"):
                h = blk.up(h, temb)
        return pyramid.contiguous() / sigma[:, None, None, None]


def config_of(image_size: int = 1024, num_channels: int = 3, centered: bool = False,
              nf: int = 16, ch_mult=(1, 2, 4, 8, 16, 32, 32, 32), num_res_blocks: int = 1,
              attn_resolutions=(16,), fir_kernel=(1, 3, 3, 1), fourier_scale: float = 16.0,
              sigma_min: float = 0.01, sigma_max: float = 1348.0,
              dtype=torch.bfloat16, remat: bool = True, **settings) -> NCSNppConfig:
    """The ``NCSNppConfig`` of a score_sde ``model`` block (plus the data
    keys ``image_size``, ``num_channels``, ``centered``). Keys this module
    does not lay out must hold the published values; the rest of the block
    (``name``, ``ema_rate``, ``dropout``, ``num_scales``, ...) is ignored."""
    for k, v in _PUBLISHED.items():
        if k in settings and settings[k] != v:
            raise ValueError(f"NCSN++: only {k}={v!r} is laid out, got {settings[k]!r}")
    return NCSNppConfig(
        image_size=int(image_size), num_channels=int(num_channels), centered=bool(centered),
        nf=int(nf), ch_mult=tuple(int(m) for m in ch_mult),
        num_res_blocks=int(num_res_blocks),
        attn_resolutions=tuple(int(r) for r in attn_resolutions),
        fir_kernel=tuple(int(k) for k in fir_kernel), fourier_scale=float(fourier_scale),
        sigma_min=float(sigma_min), sigma_max=float(sigma_max), dtype=dtype, remat=bool(remat))


def create_model(dtype=torch.bfloat16, remat: bool = True, **settings) -> NCSNpp:
    """NCSN++ from a score_sde ``model`` block's keys (``config_of``)."""
    return NCSNpp(config_of(dtype=dtype, remat=remat, **settings))

"""The Stable-Diffusion AutoencoderKL (sd-vae-ft-mse) in PyTorch.

Counterpart of ``free_hunch_tpu/models/vae.py``: encoder = ``conv_in``, one
down block per entry of ``block_out_channels`` (``layers_per_block``
ResNet blocks, then a stride-2 convolution with asymmetric (0, 1) padding
between blocks), a mid block (ResNet, single-head attention, ResNet) and
GroupNorm/SiLU/``conv_out`` to 2 x ``latent_channels``, then the 1x1
``quant_conv``; the decoder mirrors it with ``layers_per_block + 1`` ResNet
blocks per up block and nearest-2x upsampling. Every GroupNorm has
``norm_num_groups`` groups and eps 1e-6 and runs on
``ops/groupnorm.py::groupnorm_silu``: the hand-written kernel K1 on a CUDA
tensor, its plain version on a CPU tensor. Attention is ``matmul`` plus an
f32 ``softmax``, as the JAX package writes it. Everything is float32 at
full precision (``use_full_f32``: no TF32).

The interior is channels-last, as the JAX package's is NHWC: the modules
and activations are in ``torch.channels_last`` memory format, so the
(N, H, W, C) view a norm hands to K1 is contiguous and no norm copies.
The public interface is NCHW.

Parameter names are diffusers' (``encoder.down_blocks.0.resnets.0.norm1.
weight``, ``...attentions.0.to_q.weight``), so a diffusers
``AutoencoderKL.state_dict()`` loads through ``load_diffusers_state_dict``
(the modern ``to_q``/``to_out`` and the legacy ``query``/``proj_attn``
attention naming); ``models/convert.py::vae_state_dict_from_flax`` carries
the JAX package's parameters across. No diffusers import.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from free_hunch_tpu_torch import check_full_f32, use_full_f32
from free_hunch_tpu_torch.ops.groupnorm import groupnorm_silu


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    norm_eps: float = 1e-6

    @property
    def downscale(self) -> int:
        """Pixels per latent along each side."""
        return 2 ** (len(self.block_out_channels) - 1)


class VAEGroupNorm(nn.Module):
    """GroupNorm(+SiLU) over an NCHW tensor through K1 on its NHWC view."""

    def __init__(self, channels: int, groups: int, eps: float, apply_silu: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.eps, self.apply_silu = groups, eps, apply_silu

    def forward(self, x):
        y = groupnorm_silu(x.permute(0, 2, 3, 1), self.weight, self.bias, self.groups,
                           self.eps, self.apply_silu)
        return y.permute(0, 3, 1, 2)


def _conv(cin: int, cout: int, kernel: int = 3, stride: int = 1, padding=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride,
                     padding=kernel // 2 if padding is None else padding)


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D: (GroupNorm-SiLU-conv) x 2 plus a 1x1
    shortcut where the width changes."""

    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int):
        super().__init__()
        g, e = cfg.norm_num_groups, cfg.norm_eps
        self.norm1 = VAEGroupNorm(in_ch, g, e, apply_silu=True)
        self.conv1 = _conv(in_ch, out_ch)
        self.norm2 = VAEGroupNorm(out_ch, g, e, apply_silu=True)
        self.conv2 = _conv(out_ch, out_ch)
        self.conv_shortcut = _conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H x W grid (diffusers
    ``Attention`` with one head of C channels)."""

    def __init__(self, cfg: VAEConfig, channels: int):
        super().__init__()
        self.group_norm = VAEGroupNorm(channels, cfg.norm_num_groups, cfg.norm_eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax((q @ k.transpose(1, 2)) / math.sqrt(c), dim=-1)
        out = self.to_out[0](attn @ v)
        return x + out.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class MidBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cfg, channels, channels),
                                      ResnetBlock(cfg, channels, channels)])
        self.attentions = nn.ModuleList([AttnBlock(cfg, channels)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    """The convolution of a diffusers Downsample2D (stride 2 after a (0, 1)
    pad of each spatial side) or Upsample2D (after nearest-2x)."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = _conv(channels, channels, stride=2, padding=0) if down else \
            _conv(channels, channels)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A down block (``downsamplers``) or an up block (``upsamplers``)."""

    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, n: int, down: bool,
                 sample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cfg, in_ch if j == 0 else out_ch, out_ch)
                                      for j in range(n)])
        samplers = nn.ModuleList([_Sampler(out_ch, down)]) if sample else None
        setattr(self, "downsamplers" if down else "upsamplers", samplers)
        self._samplers = "downsamplers" if down else "upsamplers"

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        samplers = getattr(self, self._samplers)
        return samplers[0](x) if samplers is not None else x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = _conv(cfg.in_channels, chans[0])
        self.down_blocks = nn.ModuleList([
            _Block(cfg, chans[max(i - 1, 0)], ch, cfg.layers_per_block, down=True,
                   sample=i != len(chans) - 1) for i, ch in enumerate(chans)])
        self.mid_block = MidBlock(cfg, chans[-1])
        self.conv_norm_out = VAEGroupNorm(chans[-1], cfg.norm_num_groups, cfg.norm_eps,
                                          apply_silu=True)
        self.conv_out = _conv(chans[-1], 2 * cfg.latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(self.mid_block(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = tuple(reversed(cfg.block_out_channels))
        self.conv_in = _conv(cfg.latent_channels, chans[0])
        self.mid_block = MidBlock(cfg, chans[0])
        self.up_blocks = nn.ModuleList([
            _Block(cfg, chans[max(i - 1, 0)], ch, cfg.layers_per_block + 1, down=False,
                   sample=i != len(chans) - 1) for i, ch in enumerate(chans)])
        self.conv_norm_out = VAEGroupNorm(chans[-1], cfg.norm_num_groups, cfg.norm_eps,
                                          apply_silu=True)
        self.conv_out = _conv(chans[-1], cfg.out_channels)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """``encode``: pixels (NCHW, in [0, 1]) -> (mean, std) of the diagonal
    Gaussian latent posterior (log-variance clamped to [-30, 20]);
    ``decode``: latents (NCHW) -> pixels. diffusers'
    ``encode().latent_dist`` and ``decode().sample``."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = _conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = _conv(cfg.latent_channels, cfg.latent_channels, 1)

    def to_device(self, device) -> "AutoencoderKL":
        """On ``device`` in channels-last memory format, full float32."""
        use_full_f32()
        return self.to(device=device, dtype=torch.float32, memory_format=torch.channels_last)

    def _in(self, x):
        x = x.float().contiguous(memory_format=torch.channels_last)
        check_full_f32(x)
        return x

    def encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(self._in(x)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean.contiguous(), torch.exp(0.5 * logvar.clamp(-30.0, 20.0)).contiguous()

    def decode(self, z) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(self._in(z))).contiguous()


_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0",
                "norm": "group_norm"}


def load_diffusers_state_dict(vae: AutoencoderKL, sd: Mapping[str, torch.Tensor]) -> AutoencoderKL:
    """Load a diffusers (or CompVis-era diffusers) ``AutoencoderKL``
    state dict into ``vae``: the legacy attention names ``query``/``key``/
    ``value``/``proj_attn`` (1x1 convolutions or linears) and ``norm``, and
    the legacy ``nin_shortcut``, become the modern ones. Strict: a missing
    or unknown tensor raises."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in sd.items():
        t = torch.as_tensor(t)
        parts = name.split(".")
        if "attentions" in parts:
            i = parts.index("attentions") + 2
            if parts[i] in _LEGACY_ATTN:
                parts[i:i + 1] = _LEGACY_ATTN[parts[i]].split(".")
                if parts[-1] == "weight" and t.dim() == 4:
                    t = t[:, :, 0, 0]
        parts = ["conv_shortcut" if p == "nin_shortcut" else p for p in parts]
        out[".".join(parts)] = t
    vae.load_state_dict(out, strict=True)
    return vae

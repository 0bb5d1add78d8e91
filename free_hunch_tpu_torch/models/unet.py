"""ADM (guided-diffusion) UNet denoiser as an ``nn.Module``.

Counterpart of ``free_hunch_tpu/models/unet.py`` (``UNetConfig``,
``timestep_embedding``, ``GroupNorm32``, ``ResBlock``, ``AttentionBlock``,
``Upsample``/``Downsample``, ``UNetModel``, ``create_model``, :31-516), with
the bf16 torso (``quant=None``) and the int8 torso. Parameters carry the reference torch
state-dict names (``input_blocks.1.0.in_layers.0.weight``, ...,
``out.2.bias``), so the upstream ``.pt`` loads with ``load_state_dict`` and
``models/convert.py`` maps them to and from the JAX package's flax tree.

* Public API: NCHW float32 in and out. The torso runs channels-last
  (``torch.channels_last``) in ``cfg.dtype`` (bf16 by default); every
  GroupNorm computes f32 statistics (``ops/groupnorm.py``, the Hopper kernel
  on CUDA), attention logits and softmax are f32, and the final norm and
  out conv run in f32.
* ``remat=True`` wraps every ResBlock in ``torch.utils.checkpoint``
  (non-reentrant): the guidance vjp then keeps only block boundaries alive.
  The backward recomputes each ResBlock forward, so a vjp launches the
  GroupNorm kernel twice more per ResBlock.
* Attention is written as ``matmul`` + ``softmax`` as the JAX package left it
  to XLA: legacy per-head [q|k|v] split, q and k scaled by ch**-0.25 before
  the f32 cast, weights cast back to v's dtype.
* ``quant`` in {"int8", "int8_static", "int8_calib"}: every ResBlock conv
  (3x3, and the 1x1 skips while ``quant_1x1``) is a ``QuantConv`` and the
  attention qkv and proj_out are ``QuantDense`` (``ops/quant.py``, K3 on
  the card), with f32 master weights; the first and last convs, the norms,
  softmax and the embeddings stay as in the bf16 torso. INFERENCE ONLY: the
  int8 layers give zero weight gradients.
* ``fused_gn_quant`` (the JAX package's ``FREE_HUNCH_FUSED_GN_QUANT=1``,
  read at ``unet.py:237``): with ``quant="int8"``, the non-resampling
  ResBlocks run GroupNorm(+FiLM)+SiLU+quantise as one kernel (K2,
  ``ops/gn_quant.py``) feeding the int8 conv; the FiLM scale and shift fold
  into a per-sample affine. ``quant_1x1`` stands for
  ``FREE_HUNCH_QUANT_1X1`` (``unet.py:124``, default on). Both are config
  fields: the port reads no environment.
* ``spatial_partition`` (JAX ``unet.py:51-63``, ``:399-406``,
  ``:477-485``) is the ``model_group`` of ``UNetModel(cfg, model_group=...)``
  (``parallel/mesh.py::make_model_groups``): a group of more than one rank
  shards the torso's activation HEIGHT over its ranks, where the JAX
  package pins it to ``P(data, model, None, None)`` over an ambient mesh
  and GSPMD inserts the collectives. Here they are written out
  (``parallel/collectives.py``): the replicated input is sliced to the
  rank's rows by the plan of ``parallel/mesh.py::plan_shards`` (any model
  size: shards may be uneven, and a rank may hold no rows, where GSPMD pads
  a ragged shard; every boundary before a stride-2 step is even); every
  3x3 conv (stride 1 and 2) gets a one-row halo from the nearest rank
  above and below that has rows, zeros at the image's edges as its padding
  has; ``avg_pool2d`` and the nearest upsample stay local; every
  ``GroupNorm32`` merges its statistics over the group, each shard's
  weighted by its count (``ops/groupnorm.py::groupnorm_silu_sharded``, K1's
  stats and apply entries on the card); attention gathers its keys and
  values; the output is gathered to whole images on every rank, as the JAX
  model hands the guidance algebra replicated H and W. The int8 torso
  shards too: its dynamic scales are the whole samples' (max-merged over
  the group), the fused route runs K2's shard entries, and a 3x3 site
  exchanges halos of its int8 codes and runs K3 on them
  (``ops/quant.py``). Every rank of the group must hold the same weights,
  input and timesteps. The gradient with respect to the input is whole;
  parameter gradients are each rank's part.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from free_hunch_tpu_torch.ops.groupnorm import groupnorm_silu, groupnorm_silu_sharded
from free_hunch_tpu_torch.ops.quant import QuantConv, QuantDense, _QuantSite
from free_hunch_tpu_torch.parallel import collectives as coll
from free_hunch_tpu_torch.parallel.mesh import plan_shards

QUANT_MODES = {"int8": "dynamic", "int8_static": "static", "int8_calib": "calib"}


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 256
    in_channels: int = 3
    model_channels: int = 256
    out_channels: int = 6
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (32, 16, 8)  # downsample rates (ds)
    dropout: float = 0.0
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    conv_resample: bool = True
    num_classes: Optional[int] = None
    num_heads: int = 4
    num_head_channels: int = 64
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    use_new_attention_order: bool = False
    dtype: torch.dtype = torch.bfloat16  # torso compute dtype
    remat: bool = True
    quant: Optional[str] = None     # None (bf16 torso) or a key of QUANT_MODES
    fused_gn_quant: bool = False    # JAX: FREE_HUNCH_FUSED_GN_QUANT=1
    quant_1x1: bool = True          # JAX: FREE_HUNCH_QUANT_1X1 (default "1")

    def __post_init__(self):
        if self.quant is not None and self.quant not in QUANT_MODES:
            raise ValueError(f"quant={self.quant!r} not in {sorted(QUANT_MODES)}")


class _Shard:
    """A height shard, shared by every module of the torso: the model group
    ``mg`` and ``plan``, the ranks' rows at every level
    (``parallel/mesh.py::plan_shards``) for the input height of the forward
    being run."""

    def __init__(self, mg):
        self.mg, self.plan = mg, None

    def rows(self, level: int):
        return self.plan.rows[level]

    def site(self, level: int):
        """What a quantised conv of this level takes: (mg, the ranks' rows)."""
        return self.mg, self.rows(level)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings, cos-first ordering."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """32-group GroupNorm with f32 statistics and f32 (C,) affine, optionally
    fused with the SiLU that follows it. Takes NCHW (ideally channels-last in
    memory) and returns the same layout in the input's dtype."""

    mg = None  # the model group of a height shard: statistics merged over it

    def __init__(self, channels: int, apply_silu: bool = False):
        super().__init__()
        self.apply_silu = apply_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        if self.mg is None:
            y = groupnorm_silu(x, self.weight, self.bias, 32, 1e-5, self.apply_silu)
        else:
            y = groupnorm_silu_sharded(x, self.weight, self.bias, 32, 1e-5, self.apply_silu,
                                       self.mg)
        return y.permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, conv: nn.Conv2d, shard: Optional[_Shard] = None,
          level: int = 0) -> torch.Tensor:
    """A torso conv of an input at ``level``; on a height shard a 3x3 one
    takes a one-row halo from the nearest ranks with rows in place of its
    padding in height, and a rank with no rows gives none."""
    if isinstance(conv, QuantConv):  # casts to the torso dtype itself
        return conv(x, shard=None if shard is None else shard.site(level))
    x = x.to(conv.weight.dtype)
    if shard is None:
        return conv(x)
    pad = conv.padding
    if conv.kernel_size[0] > 1:
        x = coll.halo_rows(x, shard.mg, 2, shard.rows(level)).contiguous(
            memory_format=torch.channels_last)
        pad = (0, pad[1])
    if x.shape[2] == 0:
        wo = (x.shape[3] + 2 * pad[1] - conv.kernel_size[1]) // conv.stride[1] + 1
        return _no_rows(x, (x.shape[0], conv.out_channels, 0, wo))
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, pad)


def _torso_conv(cin: int, cout: int, kernel: int, quant: Optional[str] = None,
                quant_1x1: bool = True, dtype: torch.dtype = torch.bfloat16) -> nn.Conv2d:
    """A ResBlock conv: int8 when the torso is quantised (1x1 ones only
    while ``quant_1x1``), else the plain conv."""
    if quant is not None and (kernel > 1 or quant_1x1):
        return QuantConv(cin, cout, kernel, mode=QUANT_MODES[quant], dtype=dtype)
    return nn.Conv2d(cin, cout, kernel, padding=kernel // 2)


def _no_rows(x, shape):
    """The output of ``shape`` (no rows) of an op on a rank with no rows,
    kept in ``x``'s graph, so that the rank's backward still reaches every
    collective before it."""
    return x.new_zeros(shape) + x.sum()


def _upsample(x):
    if x.shape[2] == 0:
        return _no_rows(x, x.shape[:3] + (2 * x.shape[3],))
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _pool(x):
    if x.shape[2] == 0:
        return _no_rows(x, x.shape[:3] + (x.shape[3] // 2,))
    return F.avg_pool2d(x, 2)


class Upsample(nn.Module):
    """Nearest x2 upsample + optional 3x3 conv. ``level``: its output's."""
    shard, level = None, 0

    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        if use_conv:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.use_conv = use_conv

    def forward(self, x):
        x = _upsample(x)
        return _conv(x, self.conv, self.shard, self.level) if self.use_conv else x


class Downsample(nn.Module):
    """Stride-2 3x3 conv with symmetric padding 1, or a 2x2 average pool.
    ``level``: its input's."""
    shard, level = None, 0

    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        if use_conv:
            self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        self.use_conv = use_conv

    def forward(self, x):
        return _conv(x, self.op, self.shard, self.level) if self.use_conv else _pool(x)


class ResBlock(nn.Module):
    """Residual block with FiLM (scale-shift) time conditioning and optional
    built-in up/down sampling. Layer indices follow the reference module:
    in_layers = [norm, SiLU, conv], emb_layers = [SiLU, linear],
    out_layers = [norm, SiLU, dropout, conv]; the SiLU sits in the norm.

    ``fused`` (int8 dynamic, no resampling, both widths multiples of 32)
    takes the fused route: each norm and conv pair is one
    ``QuantConv(x, gn=(gamma_nc, beta_nc))`` call, the norm's modules only
    holding its parameters. ``level``: its convs' (after any resampling)."""
    shard, level = None, 0

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool, up: bool = False, down: bool = False,
                 remat: bool = False, quant: Optional[str] = None,
                 fused_gn_quant: bool = False, quant_1x1: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down, self.remat = up, down, remat
        self.fused = (quant == "int8" and fused_gn_quant and not (up or down)
                      and channels % 32 == 0 and out_channels % 32 == 0)
        conv = dict(quant=quant, quant_1x1=quant_1x1, dtype=dtype)
        self.in_layers = nn.ModuleList([
            GroupNorm32(channels, apply_silu=True), nn.Identity(),
            _torso_conv(channels, out_channels, 3, **conv)])
        self.emb_layers = nn.ModuleList([
            nn.Identity(),
            nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm
                      else out_channels)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(out_channels, apply_silu=not use_scale_shift_norm),
            nn.Identity(), nn.Identity(),
            _torso_conv(out_channels, out_channels, 3, **conv)])
        if out_channels != channels:
            self.skip_connection = _torso_conv(channels, out_channels, 1, **conv)
        else:
            self.skip_connection = None

    def _emb_out(self, emb, dtype):
        lin = self.emb_layers[1]
        emb_out = lin(F.silu(emb).to(lin.weight.dtype))
        return emb_out[:, :, None, None].to(dtype)

    def _forward_fused(self, x, emb):
        """The fused route (JAX ``ResBlock`` :238-286): K2 -> K3 twice, the
        FiLM scale and shift folded into the second norm's per-sample
        affine in f32."""
        n = x.shape[0]
        site = None if self.shard is None else self.shard.site(self.level)
        norm_in, norm_out = self.in_layers[0], self.out_layers[0]
        h = self.in_layers[2](x, gn=(norm_in.weight[None].expand(n, -1),
                                     norm_in.bias[None].expand(n, -1)), shard=site)
        emb_out = self._emb_out(emb, h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out.reshape(n, -1).float(), 2, dim=1)
            gamma = norm_out.weight[None] * (1.0 + scale)
            beta = norm_out.bias[None] * (1.0 + scale) + shift
        else:
            h = h + emb_out
            gamma = norm_out.weight[None].expand(n, -1)
            beta = norm_out.bias[None].expand(n, -1)
        h = self.out_layers[3](h, gn=(gamma, beta), shard=site)
        skip = x if self.skip_connection is None else \
            _conv(x, self.skip_connection, self.shard, self.level)
        return skip + h

    def _forward(self, x, emb):
        if self.fused:
            return self._forward_fused(x, emb)
        h = self.in_layers[0](x)
        if self.up:
            h, x = _upsample(h), _upsample(x)
        elif self.down:
            h, x = _pool(h), _pool(x)
        h = _conv(h, self.in_layers[2], self.shard, self.level)
        emb_out = self._emb_out(emb, h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            h = F.silu(h)
        else:
            h = self.out_layers[0](h + emb_out)
        h = _conv(h, self.out_layers[3], self.shard, self.level)
        skip = x if self.skip_connection is None else \
            _conv(x, self.skip_connection, self.shard, self.level)
        return skip + h

    def forward(self, x, emb):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, x, emb, use_reentrant=False)
        return self._forward(x, emb)


class AttentionBlock(nn.Module):
    """Full self-attention over spatial positions. qkv/proj_out keep the
    reference's 1x1 conv1d weights (O, I, 1); on the int8 torso they are
    ``QuantDense`` layers. On a height shard each rank's queries attend to
    the keys and values of every rank (gathered over the model group)."""
    shard, level = None, 0

    def __init__(self, channels: int, num_heads: int, use_new_attention_order: bool,
                 quant: Optional[str] = None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.use_new_attention_order = use_new_attention_order
        self.norm = GroupNorm32(channels)
        if quant is None:
            self.qkv = nn.Conv1d(channels, 3 * channels, 1)
            self.proj_out = nn.Conv1d(channels, channels, 1)
        else:
            mode = QUANT_MODES[quant]
            self.qkv = QuantDense(channels, 3 * channels, mode=mode, dtype=dtype)
            self.proj_out = QuantDense(channels, channels, mode=mode, dtype=dtype)

    def _dense(self, lin, y):
        if isinstance(lin, QuantDense):
            return lin(y, mg=None if self.shard is None else self.shard.mg)
        return F.linear(y.to(lin.weight.dtype), lin.weight[..., 0], lin.bias)

    def forward(self, x):
        n, c, hh, ww = x.shape
        heads = self.num_heads
        ch = c // heads
        t = hh * ww
        y = self.norm(x).permute(0, 2, 3, 1).reshape(n, t, c)
        qkv = self._dense(self.qkv, y)                                  # (n, t, 3c)
        if self.use_new_attention_order:
            q, k, v = (a.reshape(n, t, heads, ch) for a in torch.chunk(qkv, 3, dim=-1))
        else:
            q, k, v = torch.chunk(qkv.reshape(n, t, heads, 3 * ch), 3, dim=-1)
        if self.shard is not None:
            sizes = [r * ww for r in self.shard.rows(self.level)]
            k = coll.gather_partial(k, 1, self.shard.mg, sizes)
            v = coll.gather_partial(v, 1, self.shard.mg, sizes)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        qf = (q * scale).float().permute(0, 2, 1, 3)                    # (n, h, t, c)
        kf = (k * scale).float().permute(0, 2, 3, 1)                    # (n, h, c, s)
        weights = torch.softmax(torch.matmul(qf, kf), dim=-1).to(v.dtype)
        a = torch.matmul(weights, v.permute(0, 2, 1, 3))                # (n, h, t, c)
        a = a.permute(0, 2, 1, 3).reshape(n, t, c)
        a = self._dense(self.proj_out, a)
        return x + a.reshape(n, hh, ww, c).permute(0, 3, 1, 2)


class _Block(nn.ModuleList):
    """The reference's TimestepEmbedSequential: ResBlocks take the embedding."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class UNetModel(nn.Module):
    """ADM UNet: NCHW float32 in, NCHW float32 out. ``model_group``: a
    ``parallel.mesh.ModelGroup``; one of more than one rank shards the
    torso's height over its ranks (see the module docstring)."""

    def __init__(self, cfg: UNetConfig, model_group=None):
        super().__init__()
        self.cfg = cfg
        self.mg = model_group if model_group is not None and model_group.sharded else None
        mc = cfg.model_channels
        ted = mc * 4
        heads_up = cfg.num_heads_upsample if cfg.num_heads_upsample != -1 else cfg.num_heads

        def n_heads(ch, heads):
            return heads if cfg.num_head_channels == -1 else ch // cfg.num_head_channels

        def at(module, level):
            module.level = level
            return module

        def res(cin, cout, level, **kw):
            return at(ResBlock(cin, ted, cout, cfg.use_scale_shift_norm, remat=cfg.remat,
                               quant=cfg.quant, fused_gn_quant=cfg.fused_gn_quant,
                               quant_1x1=cfg.quant_1x1, dtype=cfg.dtype, **kw), level)

        def attn(ch, heads, level):
            return at(AttentionBlock(ch, heads, cfg.use_new_attention_order, quant=cfg.quant,
                                     dtype=cfg.dtype), level)

        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, ted)

        ch = int(cfg.channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList([_Block([nn.Conv2d(cfg.in_channels, ch, 3, padding=1)])])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, int(mult * mc), level)]
                ch = int(mult * mc)
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch, n_heads(ch, cfg.num_heads), level))
                self.input_blocks.append(_Block(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(_Block(
                    [res(ch, ch, level + 1, down=True)] if cfg.resblock_updown
                    else [at(Downsample(ch, cfg.conv_resample), level)]))
                chans.append(ch)
                ds *= 2

        deepest = len(cfg.channel_mult) - 1
        self.middle_block = _Block([
            res(ch, ch, deepest),
            attn(ch, n_heads(ch, cfg.num_heads), deepest),
            res(ch, ch, deepest)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                ich = chans.pop()
                layers = [res(ch + ich, int(mult * mc), level)]
                ch = int(mult * mc)
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch, n_heads(ch, heads_up), level))
                if level and i == cfg.num_res_blocks:
                    layers.append(res(ch, ch, level - 1, up=True) if cfg.resblock_updown
                                  else at(Upsample(ch, cfg.conv_resample), level - 1))
                    ds //= 2
                self.output_blocks.append(_Block(layers))

        self.out = nn.ModuleList([GroupNorm32(ch, apply_silu=True), nn.Identity(),
                                  nn.Conv2d(ch, cfg.out_channels, 3, padding=1)])
        self._shard = None if self.mg is None else _Shard(self.mg)
        if self.mg is not None:
            for m in self.modules():
                if isinstance(m, GroupNorm32):
                    m.mg = self.mg
                elif isinstance(m, (ResBlock, AttentionBlock, Upsample, Downsample)):
                    m.shard = self._shard
        self.cast_torso()

    def cast_torso(self):
        """Torso convs and linears in ``cfg.dtype`` and channels-last; the
        time and label embeddings, every GroupNorm affine and the final out
        conv stay f32 (the JAX package's ``dtype``/``param_dtype`` split).
        Casting once here gives the values the JAX package's per-call cast
        gives. The int8 sites keep their f32 master weights, from which the
        JAX package quantises (``quant.py:288-289``)."""
        keep = [self.time_embed, self.out[2]]
        if self.cfg.num_classes is not None:
            keep.append(self.label_emb)
        f32 = {id(p) for m in keep for p in m.parameters()}
        f32 |= {id(p) for m in self.modules() if isinstance(m, (GroupNorm32, _QuantSite))
                for p in m.parameters()}
        for p in self.parameters():
            if id(p) not in f32:
                p.data = p.data.to(self.cfg.dtype)
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
        return self

    def forward(self, x, timesteps, y=None):
        cfg = self.cfg
        emb = timestep_embedding(timesteps, cfg.model_channels)
        emb = self.time_embed(emb)
        if cfg.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model needs labels")
            emb = emb + self.label_emb(y)
        mg, shard = self.mg, self._shard
        if mg is not None:
            shard.plan = plan_shards(x.shape[2], len(cfg.channel_mult), mg.model_size)
            x = coll.scatter(x, 2, mg, shard.rows(0))
        h = x.to(cfg.dtype).contiguous(memory_format=torch.channels_last)
        hs = []
        for i, block in enumerate(self.input_blocks):
            h = _conv(h, block[0], shard) if i == 0 else block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        h = self.out[0](h.float())
        h = _conv(h, self.out[2], shard)
        if mg is not None:
            h = coll.gather_replicated(h, 2, mg, shard.rows(0))
        return h.contiguous()


def create_model(image_size=256, num_channels=256, num_res_blocks=2, channel_mult="",
                 learn_sigma=True, class_cond=False, attention_resolutions="32,16,8",
                 num_heads=4, num_head_channels=64, num_heads_upsample=-1,
                 use_scale_shift_norm=True, dropout=0.0, resblock_updown=True,
                 use_fp16=False, use_new_attention_order=False, use_checkpoint=False,
                 dtype=torch.bfloat16, remat=True, quant=None, fused_gn_quant=False,
                 quant_1x1=True, model_group=None, **_unused) -> UNetModel:
    """Build a UNet from the OpenAI setup-file argument surface."""
    if channel_mult == "" or channel_mult is None:
        channel_mult = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
                        128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}[image_size]
    elif isinstance(channel_mult, str):
        channel_mult = tuple(int(m) for m in channel_mult.split(","))
    attention_ds = tuple(image_size // int(r) for r in str(attention_resolutions).split(","))
    cfg = UNetConfig(
        image_size=image_size, in_channels=3, model_channels=num_channels,
        out_channels=6 if learn_sigma else 3, num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds, dropout=dropout,
        channel_mult=tuple(channel_mult), num_classes=1000 if class_cond else None,
        num_heads=num_heads, num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm, resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order, dtype=dtype, remat=remat,
        quant=quant, fused_gn_quant=fused_gn_quant, quant_1x1=quant_1x1)
    return UNetModel(cfg, model_group=model_group)

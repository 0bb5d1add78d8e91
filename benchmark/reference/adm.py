"""The ``adm`` denoiser family's reference: the ADM UNet of
guided-diffusion in plain PyTorch, float32 throughout, and the iDDPM
linear preconditioner around it.

``Arch`` holds a configuration's published shapes; ``blocks`` lays the
network out as a list of layer specs, which the forward pass walks and
the frozen counts (``forward_flops``, ``input_backward_flops``,
``norm_inputs``) count from. Parameter names are those of the published
state dict (``input_blocks.1.0.in_layers.0.weight``, ...), so one dict of
seeded weights serves the program and this reference.

The family interface (``benchmark/README.md``, "Adding a denoiser
family"): ``arch_of``, ``param_shapes``, ``preclamp``, ``snap_grid``,
``sigma_range``, ``forward_flops``, ``input_backward_flops``,
``norm_inputs``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GROUPS = 32
EPS = 1e-5
M_STEPS = 1000
CHANNEL_MULT = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
                128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}


@dataclasses.dataclass(frozen=True)
class Arch:
    image_size: int
    num_channels: int
    num_res_blocks: int
    channel_mult: Tuple[float, ...]
    attention_ds: Tuple[int, ...]
    num_head_channels: int
    num_heads: int
    out_channels: int
    use_scale_shift_norm: bool
    resblock_updown: bool


def arch_of(model: dict) -> Arch:
    """The architecture of a configuration file's ``model`` block (the
    published setup flags)."""
    if not model.get("resblock_updown", True):
        raise ValueError("only resblock_updown=True is laid out")
    if model.get("class_cond", False):
        raise ValueError("only unconditional models are laid out")
    if model.get("use_new_attention_order", False):
        raise ValueError("only the legacy attention order is laid out")
    if model.get("noise_schedule", "linear") != "linear" or \
            int(model.get("diffusion_steps", M_STEPS)) != M_STEPS:
        raise ValueError(f"only the linear {M_STEPS}-step iDDPM grid is laid out")
    res = int(model["image_size"])
    mult = model.get("channel_mult") or CHANNEL_MULT[res]
    if isinstance(mult, str):
        mult = tuple(int(m) for m in mult.split(","))
    att = tuple(res // int(r) for r in str(model["attention_resolutions"]).split(","))
    return Arch(image_size=res, num_channels=int(model["num_channels"]),
                num_res_blocks=int(model["num_res_blocks"]), channel_mult=tuple(mult),
                attention_ds=att, num_head_channels=int(model.get("num_head_channels", -1)),
                num_heads=int(model.get("num_heads", 4)),
                out_channels=6 if model.get("learn_sigma", True) else 3,
                use_scale_shift_norm=bool(model.get("use_scale_shift_norm", True)),
                resblock_updown=True)


def blocks(a: Arch) -> dict:
    """The layer specs: {"input": [[spec, ...], ...], "middle": [...],
    "output": [[...], ...]}. A spec is a dict with ``kind`` ("conv", "res",
    "attn"), ``name`` and its shapes; ``res`` is the input's side."""
    mc, ted = a.num_channels, 4 * a.num_channels
    heads = (lambda ch: a.num_heads if a.num_head_channels == -1 else ch // a.num_head_channels)
    ch = int(a.channel_mult[0] * mc)
    res = a.image_size
    inp = [[dict(kind="conv", name="input_blocks.0.0", cin=3, cout=ch, res=res)]]
    chans, ds = [ch], 1
    for level, mult in enumerate(a.channel_mult):
        for _ in range(a.num_res_blocks):
            i = len(inp)
            layers = [dict(kind="res", name=f"input_blocks.{i}.0", cin=ch, cout=int(mult * mc),
                           res=res, updown=None, ted=ted)]
            ch = int(mult * mc)
            if ds in a.attention_ds:
                layers.append(dict(kind="attn", name=f"input_blocks.{i}.1", ch=ch, res=res,
                                   heads=heads(ch)))
            inp.append(layers)
            chans.append(ch)
        if level != len(a.channel_mult) - 1:
            i = len(inp)
            inp.append([dict(kind="res", name=f"input_blocks.{i}.0", cin=ch, cout=ch, res=res,
                             updown="down", ted=ted)])
            chans.append(ch)
            ds *= 2
            res //= 2
    mid = [dict(kind="res", name="middle_block.0", cin=ch, cout=ch, res=res, updown=None, ted=ted),
           dict(kind="attn", name="middle_block.1", ch=ch, res=res, heads=heads(ch)),
           dict(kind="res", name="middle_block.2", cin=ch, cout=ch, res=res, updown=None, ted=ted)]
    out = []
    for level, mult in reversed(list(enumerate(a.channel_mult))):
        for i in range(a.num_res_blocks + 1):
            j = len(out)
            ich = chans.pop()
            layers = [dict(kind="res", name=f"output_blocks.{j}.0", cin=ch + ich,
                           cout=int(mult * mc), res=res, updown=None, ted=ted)]
            ch = int(mult * mc)
            if ds in a.attention_ds:
                layers.append(dict(kind="attn", name=f"output_blocks.{j}.1", ch=ch, res=res,
                                   heads=heads(ch)))
            if level and i == a.num_res_blocks:
                layers.append(dict(kind="res", name=f"output_blocks.{j}.{len(layers)}", cin=ch,
                                   cout=ch, res=res, updown="up", ted=ted))
                ds //= 2
                res *= 2
            out.append(layers)
    return {"input": inp, "middle": mid, "output": out, "final_ch": ch}


def param_shapes(a: Arch) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter's name, shape and init kind, in a fixed order (the
    order ``benchmark/weights.py`` draws them in). Kinds: ``fan_in`` a
    convolution or linear weight, ``zero_init`` one the published model
    initialises to zero (each ResBlock's last conv, attention's proj_out,
    the final conv), ``norm_scale`` and ``norm_shift`` a GroupNorm's affine,
    ``bias``."""
    mc, ted = a.num_channels, 4 * a.num_channels
    out = [("time_embed.0.weight", (ted, mc), "fan_in"), ("time_embed.0.bias", (ted,), "bias"),
           ("time_embed.2.weight", (ted, ted), "fan_in"), ("time_embed.2.bias", (ted,), "bias")]

    def add(name, shape, kind="fan_in"):
        norm = kind == "norm_scale"
        out.append((name + ".weight", shape, kind))
        out.append((name + ".bias", (shape[0],), "norm_shift" if norm else "bias"))

    lay = blocks(a)
    for spec in _specs(lay):
        n = spec["name"]
        if spec["kind"] == "conv":
            add(n, (spec["cout"], spec["cin"], 3, 3))
        elif spec["kind"] == "res":
            cin, cout = spec["cin"], spec["cout"]
            add(n + ".in_layers.0", (cin,), "norm_scale")
            add(n + ".in_layers.2", (cout, cin, 3, 3))
            add(n + ".emb_layers.1", (2 * cout if a.use_scale_shift_norm else cout, ted))
            add(n + ".out_layers.0", (cout,), "norm_scale")
            add(n + ".out_layers.3", (cout, cout, 3, 3), "zero_init")
            if cin != cout:
                add(n + ".skip_connection", (cout, cin, 1, 1))
        else:
            c = spec["ch"]
            add(n + ".norm", (c,), "norm_scale")
            add(n + ".qkv", (3 * c, c, 1))
            add(n + ".proj_out", (c, c, 1), "zero_init")
    add("out.0", (lay["final_ch"],), "norm_scale")
    add("out.2", (a.out_channels, lay["final_ch"], 3, 3), "zero_init")
    return out


# -- the forward pass ----------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _gn(x, p, name, silu):
    y = F.group_norm(x, GROUPS, p[name + ".weight"], p[name + ".bias"], EPS)
    return F.silu(y) if silu else y


_ROUND = [None]   # set by ``unet`` for one forward: rounds a torso product's operands


def _conv(x, p, name, pad=1, stride=1):
    w, r = p[name + ".weight"], _ROUND[0]
    if r is not None and name != "out.2":
        x, w = r(x), r(w)
    return F.conv2d(x, w, p[name + ".bias"], stride=stride, padding=pad)


def _linear(x, w, b):
    r = _ROUND[0]
    if r is not None:
        x, w = r(x), r(w)
    return F.linear(x, w, b)


def _res(x, emb, p, spec, a: Arch):
    n = spec["name"]
    h = _gn(x, p, n + ".in_layers.0", True)
    if spec["updown"] == "up":
        h, x = F.interpolate(h, scale_factor=2, mode="nearest"), \
            F.interpolate(x, scale_factor=2, mode="nearest")
    elif spec["updown"] == "down":
        h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
    h = _conv(h, p, n + ".in_layers.2")
    e = _linear(F.silu(emb), p[n + ".emb_layers.1.weight"], p[n + ".emb_layers.1.bias"])
    e = e[:, :, None, None]
    if a.use_scale_shift_norm:
        scale, shift = torch.chunk(e, 2, dim=1)
        h = F.silu(_gn(h, p, n + ".out_layers.0", False) * (1 + scale) + shift)
    else:
        h = _gn(h + e, p, n + ".out_layers.0", True)
    h = _conv(h, p, n + ".out_layers.3")
    skip = x if spec["cin"] == spec["cout"] else _conv(x, p, n + ".skip_connection", pad=0)
    return skip + h


def _attn(x, p, spec):
    n = spec["name"]
    b, c, hh, ww = x.shape
    heads = spec["heads"]
    ch = c // heads
    t = hh * ww
    y = _gn(x, p, n + ".norm", False).permute(0, 2, 3, 1).reshape(b, t, c)
    qkv = _linear(y, p[n + ".qkv.weight"][..., 0], p[n + ".qkv.bias"])
    q, k, v = torch.chunk(qkv.reshape(b, t, heads, 3 * ch), 3, dim=-1)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    logits = torch.matmul((q * scale).permute(0, 2, 1, 3), (k * scale).permute(0, 2, 3, 1))
    w = torch.softmax(logits, dim=-1)
    vt = v.permute(0, 2, 1, 3)
    if _ROUND[0] is not None:
        w, vt = _ROUND[0](w), _ROUND[0](vt)
    o = torch.matmul(w, vt).permute(0, 2, 1, 3).reshape(b, t, c)
    o = _linear(o, p[n + ".proj_out.weight"][..., 0], p[n + ".proj_out.bias"])
    return x + o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def _layer(h, emb, p, spec, a):
    if spec["kind"] == "conv":
        return _conv(h, p, spec["name"])
    if spec["kind"] == "res":
        return _res(h, emb, p, spec, a)
    return _attn(h, p, spec)


def unet(p: Dict[str, torch.Tensor], a: Arch, x: torch.Tensor, t: torch.Tensor,
         rounding=None) -> torch.Tensor:
    """The UNet's (N, out_channels, H, W) output for (N, 3, H, W) x at
    timesteps t; ``p`` holds float32 parameters. ``rounding``
    (``freehunch.fp8``, for the control) rounds the operands of the products the configuration
    runs in the torso's type (its convs and linears but the final conv,
    attention's weights @ v)."""
    _ROUND[0] = rounding
    try:
        return _unet(p, a, x, t, blocks(a))
    finally:
        _ROUND[0] = None


def _unet(p, a: Arch, x, t, lay):
    emb = timestep_embedding(t, a.num_channels)
    emb = F.linear(F.silu(F.linear(emb, p["time_embed.0.weight"], p["time_embed.0.bias"])),
                   p["time_embed.2.weight"], p["time_embed.2.bias"])
    h, hs = x, []
    for blk in lay["input"]:
        for spec in blk:
            h = _layer(h, emb, p, spec, a)
        hs.append(h)
    for spec in lay["middle"]:
        h = _layer(h, emb, p, spec, a)
    for blk in lay["output"]:
        h = torch.cat([h, hs.pop()], dim=1)
        for spec in blk:
            h = _layer(h, emb, p, spec, a)
    h = _gn(h, p, "out.0", True)
    return _conv(h, p, "out.2")


# -- the iDDPM linear preconditioner --------------------------------------------

def sigma_grid() -> np.ndarray:
    """The linear-beta DDPM schedule's sigmas by reversed index, u[M] = 0
    (float64; the denoiser snaps to their float32 values)."""
    betas = np.concatenate([[0.0], np.linspace(0.0001, 0.02, M_STEPS)])
    alpha_bar = np.cumprod(1.0 - betas)[::-1]
    return np.sqrt((1.0 - alpha_bar) / alpha_bar)


GRID = sigma_grid()


def snap_grid(a: Arch) -> np.ndarray:
    """The sigmas the denoiser snaps to (float64): the iDDPM grid."""
    return GRID


def sigma_range(a: Arch) -> Tuple[float, float]:
    """The denoiser's (sigma_min, sigma_max): the grid's smallest nonzero
    sigma and its largest."""
    return float(GRID[M_STEPS - 1]), float(GRID[0])


def round_index(sigmas: Sequence[float], grid: np.ndarray) -> np.ndarray:
    """Index of the nearest grid sigma (the first of ties)."""
    s = np.asarray(sigmas, np.float32).reshape(-1)
    g = np.asarray(grid, np.float32)
    return np.argmin(np.abs(s[:, None] - g[None, :]), axis=1)


def preclamp(p, a: Arch, x: torch.Tensor, sigma: float, rounding=None) -> torch.Tensor:
    """x - sigma F(c_in x, c_noise) for a host sigma: the denoiser before
    its clip to [-1, 1]; x is float32 (N, 3, H, W). ``rounding`` as in
    ``unet``."""
    n = x.shape[0]
    s32 = np.float32(sigma)
    idx = int(round_index([s32], GRID)[0])
    sig = torch.full((n,), float(s32), dtype=torch.float32, device=x.device)
    c_in = 1.0 / torch.sqrt(sig ** 2 + 1.0)
    c_noise = torch.full((n,), float(M_STEPS - idx), dtype=torch.float32, device=x.device)
    out = unet(p, a, c_in[:, None, None, None] * x, c_noise, rounding)
    return x - sig[:, None, None, None] * out[:, :3]


# -- the frozen counts ------------------------------------------------------------
#
# Operations count two per multiply-add of every product: convolutions,
# linear layers, attention's two matmuls. Elementwise work, norms and
# softmax are not counted. They are split by the precision the
# configuration states for them: the torso's products in its type, the
# rest in float32 (the time embedding, attention's logits, the final conv).
# Recomputation (remat) is implementation, not model work: not counted.

def _conv_flops(cin, cout, k, hw_out):
    return 2 * cin * cout * k * k * hw_out


def _specs(lay: dict) -> list:
    """Every layer spec of ``blocks``, in the forward's order."""
    return [s for b in lay["input"] for s in b] + lay["middle"] + \
        [s for b in lay["output"] for s in b]


def forward_flops(arch: Arch, torso: str, batch: int = 1) -> Dict[str, float]:
    """{precision: FLOPs} of one denoiser forward at ``batch``."""
    f = {"float32": 0, torso: 0}
    mc, ted = arch.num_channels, 4 * arch.num_channels
    f["float32"] += 2 * mc * ted + 2 * ted * ted           # time embedding
    lay = blocks(arch)
    for s in _specs(lay):
        r = s["res"]
        if s["kind"] == "conv":
            f[torso] += _conv_flops(s["cin"], s["cout"], 3, r * r)
        elif s["kind"] == "res":
            ro = r * 2 if s["updown"] == "up" else (r // 2 if s["updown"] == "down" else r)
            cin, cout = s["cin"], s["cout"]
            f[torso] += _conv_flops(cin, cout, 3, ro * ro) + _conv_flops(cout, cout, 3, ro * ro)
            f[torso] += 2 * ted * (2 * cout if arch.use_scale_shift_norm else cout)
            if cin != cout:
                f[torso] += _conv_flops(cin, cout, 1, ro * ro)
        else:
            c, t = s["ch"], r * r
            f[torso] += 2 * t * c * 3 * c + 2 * t * c * c     # qkv, proj_out
            f["float32"] += 2 * t * t * c                      # q k^T, f32 logits
            f[torso] += 2 * t * t * c                          # weights @ v
    f["float32"] += _conv_flops(lay["final_ch"], arch.out_channels, 3, arch.image_size ** 2)
    return {k: v * batch for k, v in f.items()}


def input_backward_flops(arch: Arch, torso: str, batch: int = 1) -> Dict[str, float]:
    """{precision: FLOPs} of the pullback to the input (no weight
    gradients): each product's input gradient, attention's matmuls twice,
    nothing for the embeddings, which do not depend on the input."""
    f = forward_flops(arch, torso, 1)
    mc, ted = arch.num_channels, 4 * arch.num_channels
    f["float32"] -= 2 * mc * ted + 2 * ted * ted
    for s in _specs(blocks(arch)):
        if s["kind"] == "res":
            f[torso] -= 2 * ted * (2 * s["cout"] if arch.use_scale_shift_norm else s["cout"])
        elif s["kind"] == "attn":
            c, t = s["ch"], s["res"] ** 2
            f["float32"] += 2 * t * t * c
            f[torso] += 2 * t * t * c
    return {k: v * batch for k, v in f.items()}


def norm_inputs(arch: Arch) -> List[Tuple[int, int, int]]:
    """(C, H, W) of every GroupNorm's input in one forward, in order."""
    out = []
    lay = blocks(arch)
    for s in _specs(lay):
        r = s["res"]
        if s["kind"] == "res":
            ro = r * 2 if s["updown"] == "up" else (r // 2 if s["updown"] == "down" else r)
            out += [(s["cin"], r, r), (s["cout"], ro, ro)]
        elif s["kind"] == "attn":
            out.append((s["ch"], r, r))
    out.append((lay["final_ch"], arch.image_size, arch.image_size))
    return out

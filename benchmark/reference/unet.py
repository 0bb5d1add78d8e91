"""The ADM UNet of guided-diffusion in plain PyTorch, float32 throughout,
and the iDDPM linear preconditioner around it.

``Arch`` holds a configuration's published shapes; ``blocks`` lays the
network out as a list of layer specs, which the forward pass walks and
which ``benchmark/flops.py`` counts operations and bytes from. Parameter
names are those of the published state dict (``input_blocks.1.0.
in_layers.0.weight``, ...), so one dict of seeded weights serves the
program and this reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GROUPS = 32
EPS = 1e-5
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


def param_shapes(a: Arch) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter's name and shape, in a fixed order."""
    mc, ted = a.num_channels, 4 * a.num_channels
    out = [("time_embed.0.weight", (ted, mc)), ("time_embed.0.bias", (ted,)),
           ("time_embed.2.weight", (ted, ted)), ("time_embed.2.bias", (ted,))]

    def add(name, shape):
        out.append((name + ".weight", shape))
        out.append((name + ".bias", (shape[0],)))

    lay = blocks(a)
    for spec in [s for b in lay["input"] for s in b] + lay["middle"] + \
            [s for b in lay["output"] for s in b]:
        n = spec["name"]
        if spec["kind"] == "conv":
            add(n, (spec["cout"], spec["cin"], 3, 3))
        elif spec["kind"] == "res":
            cin, cout = spec["cin"], spec["cout"]
            add(n + ".in_layers.0", (cin,))
            add(n + ".in_layers.2", (cout, cin, 3, 3))
            add(n + ".emb_layers.1", (2 * cout if a.use_scale_shift_norm else cout, ted))
            add(n + ".out_layers.0", (cout,))
            add(n + ".out_layers.3", (cout, cout, 3, 3))
            if cin != cout:
                add(n + ".skip_connection", (cout, cin, 1, 1))
        else:
            c = spec["ch"]
            add(n + ".norm", (c,))
            add(n + ".qkv", (3 * c, c, 1))
            add(n + ".proj_out", (c, c, 1))
    add("out.0", (lay["final_ch"],))
    add("out.2", (a.out_channels, lay["final_ch"], 3, 3))
    return out


def is_norm(name: str) -> bool:
    """A GroupNorm affine parameter."""
    return any(k in name for k in (".in_layers.0.", ".out_layers.0.", ".norm.")) or \
        name.startswith("out.0.")


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


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (abs-max to
    448), back in t's type: the control's torso operands."""
    s = torch.clamp(t.detach().abs().amax(), min=1e-30) / 448.0
    q = (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach()


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
         lay: Optional[dict] = None, rounding=None) -> torch.Tensor:
    """The UNet's (N, out_channels, H, W) output for (N, 3, H, W) x at
    timesteps t; ``p`` holds float32 parameters. ``rounding`` (``fp8``, for
    the control) rounds the operands of the products the configuration
    runs in the torso's type (its convs and linears but the final conv,
    attention's weights @ v)."""
    _ROUND[0] = rounding
    try:
        return _unet(p, a, x, t, lay or blocks(a))
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

M_STEPS = 1000


def sigma_grid() -> np.ndarray:
    """The linear-beta DDPM schedule's sigmas by reversed index, u[M] = 0
    (float64; the denoiser snaps to their float32 values)."""
    betas = np.concatenate([[0.0], np.linspace(0.0001, 0.02, M_STEPS)])
    alpha_bar = np.cumprod(1.0 - betas)[::-1]
    return np.sqrt((1.0 - alpha_bar) / alpha_bar)


def round_index(sigmas: Sequence[float], grid: np.ndarray) -> np.ndarray:
    """Index of the nearest grid sigma (the first of ties)."""
    s = np.asarray(sigmas, np.float32).reshape(-1)
    g = np.asarray(grid, np.float32)
    return np.argmin(np.abs(s[:, None] - g[None, :]), axis=1)


def preclamp(p, a: Arch, x: torch.Tensor, sigma: float, grid: np.ndarray,
             lay: Optional[dict] = None, rounding=None) -> torch.Tensor:
    """x - sigma F(c_in x, c_noise) for a host sigma: the denoiser before
    its clip to [-1, 1]; x is float32 (N, 3, H, W)."""
    n = x.shape[0]
    s32 = np.float32(sigma)
    idx = int(round_index([s32], grid)[0])
    sig = torch.full((n,), float(s32), dtype=torch.float32, device=x.device)
    c_in = 1.0 / torch.sqrt(sig ** 2 + 1.0)
    c_noise = torch.full((n,), float(M_STEPS - idx), dtype=torch.float32, device=x.device)
    out = unet(p, a, c_in[:, None, None, None] * x, c_noise, lay, rounding)
    return x - sig[:, None, None, None] * out[:, :3]


def denoise_rows(p, a: Arch, x: torch.Tensor, sigma: float, grid: np.ndarray,
                 rows: int, pullbacks: Sequence[tuple] = (), rounding=None):
    """The denoiser before its clip (D = clip(pre, -1, 1)) and, for each
    (cotangent c, judged D) of ``pullbacks``, the pullback of c through D
    with the clip's gradient where the judged D lies strictly inside
    [-1, 1] (which pixels a D clips is the judged D's to say, and the unet
    number judges that D); in blocks of ``rows`` samples (each block's
    graph freed before the next). ``rounding`` as in ``unet``. Returns
    (pre, [pullbacks])."""
    lay = blocks(a)
    outs, pulls = [], [[] for _ in pullbacks]
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows].detach()
        if not pullbacks:
            with torch.no_grad():
                outs.append(preclamp(p, a, xb, sigma, grid, lay, rounding))
            continue
        xb = xb.clone().requires_grad_(True)
        with torch.enable_grad():
            pre = preclamp(p, a, xb, sigma, grid, lay, rounding)
            for j, (ct, judged) in enumerate(pullbacks):
                m = (torch.abs(judged[s:s + rows]) < 1.0).to(pre.dtype)
                (g,) = torch.autograd.grad(pre, xb, ct[s:s + rows] * m,
                                           retain_graph=j < len(pullbacks) - 1)
                pulls[j].append(g)
        outs.append(pre.detach())
    return torch.cat(outs), [torch.cat(g) for g in pulls]

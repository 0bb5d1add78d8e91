"""The ``ncsnpp`` denoiser family's reference: score_sde's NCSN++
(github.com/yang-song/score_sde, ``models/ncsnpp.py``, ``layerspp.py``,
``up_or_down_sampling.py``) in plain PyTorch, float32 throughout (its
callers run it with TF32 off), under the continuous-sigma VE SDE.

``Arch`` holds a configuration's ``model`` block (the score_sde config's
``model`` keys and its data keys ``image_size``, ``centered``); ``plan``
lays the network out level by level, and the forward pass and the frozen
counts (``forward_flops``, ``input_backward_flops``, ``norm_inputs``,
``fir_inputs``) walk it. Parameter names are the program's
(``down.0.res.0.conv0.weight``, ...; a score_sde state dict's
``all_modules.<i>`` names map onto them), so one dict of seeded weights
serves both; attention's projections are (out, in) linear weights (the
source's ``NIN`` holds (in, out)), and the Fourier ``W`` holds N(0, 1)
draws that the forward multiplies by ``fourier_scale`` (the source stores
them already scaled).

The FIR resampling is written from ``upfirdn2d``'s definition: each
channel alone, zeros inserted after every sample (up), padding, a 2-D
convolution with the flipped kernel, every second sample kept (down).

The data range: score_sde trains FFHQ with ``data.centered`` False, on
[0, 1], and maps it to [-1, 1] inside the network. ``preclamp`` takes the
benchmark's [-1, 1] images to the network's range, x_m = (x + 1) / 2 at
sigma_m = sigma / 2, and back: x + sigma^2 / 2 s(x_m, sigma_m), s the
network's score (its output over sigma_m under ``scale_by_sigma``).

The family interface (``benchmark/README.md``, "Adding a denoiser
family"): ``arch_of``, ``param_shapes``, ``preclamp``, ``snap_grid``,
``sigma_range``, ``forward_flops``, ``input_backward_flops``,
``norm_inputs``; and ``fir_inputs``, which ``metrics/fir_roofline.py``
reads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6
PUBLISHED = {"resblock_type": "biggan", "progressive": "output_skip",
             "progressive_input": "input_skip", "progressive_combine": "sum",
             "attention_type": "ddpm", "embedding_type": "fourier", "fir": True,
             "conditional": True, "resamp_with_conv": True, "skip_rescale": True,
             "scale_by_sigma": True, "normalization": "GroupNorm", "nonlinearity": "swish",
             "conv_size": 3}


@dataclasses.dataclass(frozen=True)
class Arch:
    image_size: int
    channels: int
    centered: bool
    nf: int
    ch_mult: Tuple[int, ...]
    num_res_blocks: int
    attn_resolutions: Tuple[int, ...]
    fir_kernel: Tuple[int, ...]
    fourier_scale: float
    sigma_min: float
    sigma_max: float


def arch_of(model: dict) -> Arch:
    """The architecture of a configuration file's ``model`` block."""
    for k, v in PUBLISHED.items():
        if model.get(k, v) != v:
            raise ValueError(f"only {k}={v!r} is laid out, got {model[k]!r}")
    return Arch(image_size=int(model["image_size"]), channels=int(model.get("num_channels", 3)),
                centered=bool(model.get("centered", False)), nf=int(model["nf"]),
                ch_mult=tuple(int(m) for m in model["ch_mult"]),
                num_res_blocks=int(model["num_res_blocks"]),
                attn_resolutions=tuple(int(r) for r in model["attn_resolutions"]),
                fir_kernel=tuple(int(k) for k in model["fir_kernel"]),
                fourier_scale=float(model["fourier_scale"]),
                sigma_min=float(model["sigma_min"]), sigma_max=float(model["sigma_max"]))


def groups(c: int) -> int:
    return min(c // 4, 32)


def plan(a: Arch) -> dict:
    """The network level by level: {"down": [level, ...], "mid": (res,
    attn, res), "up": [level, ...]} (``up`` from the deepest level). A
    block is (name, cin, cout, res, updown); ``res`` is its input's side,
    ``updown`` None, "up" or "down"."""
    side = lambda lv: a.image_size // 2 ** lv  # noqa: E731
    ch = lambda lv: a.nf * a.ch_mult[lv]  # noqa: E731
    last = len(a.ch_mult) - 1
    down, cin, skips = [], a.nf, [a.nf]
    for lv in range(last + 1):
        r, c = side(lv), ch(lv)
        lev = dict(res=[], attn=[], down=None, combine=None, side=r, ch=c)
        for b in range(a.num_res_blocks):
            lev["res"].append((f"down.{lv}.res.{b}", cin, c, r, None))
            if r in a.attn_resolutions:
                lev["attn"].append(f"down.{lv}.attn.{b}")
            cin = c
            skips.append(c)
        if lv != last:
            lev["down"] = (f"down.{lv}.down", c, c, r, "down")
            lev["combine"] = f"down.{lv}.combine"
            skips.append(c)
        down.append(lev)
    r = side(last)
    mid = (("mid.0", cin, cin, r, None), "mid.1", ("mid.2", cin, cin, r, None))
    up = []
    for k, lv in enumerate(reversed(range(last + 1))):
        r, c = side(lv), ch(lv)
        lev = dict(res=[], attn=None, up=None, side=r, ch=c, k=k)
        for b in range(a.num_res_blocks + 1):
            lev["res"].append((f"up.{k}.res.{b}", cin + skips.pop(), c, r, None))
            cin = c
        if r in a.attn_resolutions:
            lev["attn"] = f"up.{k}.attn"
        if lv != 0:
            lev["up"] = (f"up.{k}.up", c, c, r, "up")
        up.append(lev)
    return {"down": down, "mid": mid, "up": up}


def _blocks(pl: dict) -> list:
    """Every BigGAN block of ``plan``, in the forward's order."""
    out = []
    for lev in pl["down"]:
        out += lev["res"] + ([lev["down"]] if lev["down"] else [])
    out += [pl["mid"][0], pl["mid"][2]]
    for lev in pl["up"]:
        out += lev["res"] + ([lev["up"]] if lev["up"] else [])
    return out


def _attns(pl: dict, a: Arch) -> List[Tuple[str, int, int]]:
    """(name, channels, side) of every attention block, in order."""
    out = []
    for lev in pl["down"]:
        out += [(n, lev["ch"], lev["side"]) for n in lev["attn"]]
    c, r = pl["mid"][0][1], pl["mid"][0][3]
    out.append((pl["mid"][1], c, r))
    out += [(lev["attn"], lev["ch"], lev["side"]) for lev in pl["up"] if lev["attn"]]
    return out


def param_shapes(a: Arch) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter's name, shape and init kind, in the program's
    state-dict order (the order ``benchmark/weights.py`` draws them in).
    ``zero_init``: the layers ``init_scale`` 0 zeroes (each block's conv1,
    attention's output projection, the output pyramid's convs); the
    Fourier ``W`` is ``fan_in`` of a 1-D tensor, N(0, 1)."""
    nf, temb = a.nf, 4 * a.nf
    out = [("fourier.W", (nf,), "fan_in")]

    def add(name, shape, kind="fan_in"):
        out.append((name + ".weight", shape, kind))
        out.append((name + ".bias", (shape[0],), "norm_shift" if kind == "norm_scale"
                    else "bias"))

    def res(blk):
        n, cin, cout, _, ud = blk
        add(n + ".norm0", (cin,), "norm_scale")
        add(n + ".conv0", (cout, cin, 3, 3))
        add(n + ".dense", (cout, temb))
        add(n + ".norm1", (cout,), "norm_scale")
        add(n + ".conv1", (cout, cout, 3, 3), "zero_init")
        if cin != cout or ud:
            add(n + ".skip", (cout, cin, 1, 1))

    def attn(n, c):
        add(n + ".norm", (c,), "norm_scale")
        for p in ("q", "k", "v"):
            add(f"{n}.{p}", (c, c))
        add(n + ".proj", (c, c), "zero_init")

    add("temb.0", (temb, 2 * nf))
    add("temb.1", (temb, temb))
    add("conv_in", (nf, a.channels, 3, 3))
    pl = plan(a)
    for lev in pl["down"]:
        for i, blk in enumerate(lev["res"]):
            res(blk)
            if lev["attn"]:
                attn(lev["attn"][i], lev["ch"])
        if lev["down"]:
            res(lev["down"])
            add(lev["combine"], (lev["ch"], a.channels, 1, 1))
    res(pl["mid"][0])
    attn(pl["mid"][1], pl["mid"][0][2])
    res(pl["mid"][2])
    for lev in pl["up"]:
        for blk in lev["res"]:
            res(blk)
        if lev["attn"]:
            attn(lev["attn"], lev["ch"])
        add(f"up.{lev['k']}.out_norm", (lev["ch"],), "norm_scale")
        add(f"up.{lev['k']}.out_conv", (a.channels, lev["ch"], 3, 3), "zero_init")
        if lev["up"]:
            res(lev["up"])
    return out


# -- FIR resampling: upfirdn2d -----------------------------------------------------

def fir_kernel(taps) -> torch.Tensor:
    k = torch.tensor([float(t) for t in taps], dtype=torch.float64)
    k = torch.outer(k, k)
    return (k / k.sum()).float()


def upfirdn2d(x: torch.Tensor, k: torch.Tensor, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """StyleGAN2's ``upfirdn2d_native`` on (N, C, H, W): each channel alone,
    ``up - 1`` zeros after every sample, ``pad`` (before, after) on both
    axes, a 2-D convolution with the flipped kernel, every ``down``-th
    sample kept."""
    n, c, h, w = x.shape
    t = x.reshape(n * c, 1, h, 1, w, 1)
    t = F.pad(t, [0, up - 1, 0, 0, 0, up - 1])
    t = t.reshape(n * c, 1, h * up, w * up)
    t = F.pad(t, [pad[0], pad[1], pad[0], pad[1]])
    t = F.conv2d(t, torch.flip(k, [0, 1])[None, None].to(x))
    t = t[:, :, ::down, ::down]
    return t.reshape(n, c, t.shape[2], t.shape[3])


def upsample_2d(x, taps):
    k = fir_kernel(taps) * 4
    p = k.shape[0] - 2
    return upfirdn2d(x, k, up=2, pad=((p + 1) // 2 + 1, p // 2))


def downsample_2d(x, taps):
    k = fir_kernel(taps)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, down=2, pad=((p + 1) // 2, p // 2))


# -- the forward pass ----------------------------------------------------------------

_ROUND = [None]   # set by ``net`` for one forward: rounds a torso product's operands


def _r(t):
    return t if _ROUND[0] is None else _ROUND[0](t)


def _conv(x, p, name, pad=1, torso=True):
    w = p[name + ".weight"]
    if torso:
        x, w = _r(x), _r(w)
    return F.conv2d(x, w, p[name + ".bias"], padding=pad)


def _dense(x, p, name):
    return F.linear(_r(x), _r(p[name + ".weight"]), p[name + ".bias"])


def _gn(x, p, name, silu):
    y = F.group_norm(x, groups(x.shape[1]), p[name + ".weight"], p[name + ".bias"], EPS)
    return F.silu(y) if silu else y


def _res(x, temb, p, blk, a: Arch):
    n, cin, cout, _, ud = blk
    h = _gn(x, p, n + ".norm0", True)
    if ud == "up":
        h, x = upsample_2d(h, a.fir_kernel), upsample_2d(x, a.fir_kernel)
    elif ud == "down":
        h, x = downsample_2d(h, a.fir_kernel), downsample_2d(x, a.fir_kernel)
    h = _conv(h, p, n + ".conv0")
    h = h + _dense(F.silu(temb), p, n + ".dense")[:, :, None, None]
    h = _conv(_gn(h, p, n + ".norm1", True), p, n + ".conv1")
    if cin != cout or ud:
        x = _conv(x, p, n + ".skip", pad=0)
    return (x + h) / np.sqrt(2.0)


def _attn(x, p, name):
    b, c, hh, ww = x.shape
    y = _gn(x, p, name + ".norm", False).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    q, k, v = (_dense(y, p, f"{name}.{s}") for s in ("q", "k", "v"))
    w = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * (c ** -0.5), dim=-1)
    h = _dense(torch.matmul(_r(w), _r(v)), p, name + ".proj")
    return (x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)) / np.sqrt(2.0)


def net(p: Dict[str, torch.Tensor], a: Arch, x: torch.Tensor, sigma: torch.Tensor,
        rounding=None) -> torch.Tensor:
    """NCSN++'s score (N, C, H, W) of x in the network's data range at
    sigma (N,) in its units; ``p`` holds float32 parameters. ``rounding``
    (``freehunch.fp8``, for the control) rounds the operands of the
    products the configuration runs in the torso's type: the convs but the
    output pyramid's, the blocks' dense layers, attention's projections and
    weights @ v."""
    _ROUND[0] = rounding
    try:
        return _net(p, a, x, sigma, plan(a))
    finally:
        _ROUND[0] = None


def _net(p, a: Arch, x, sigma, pl):
    proj = torch.log(sigma)[:, None] * (p["fourier.W"] * a.fourier_scale)[None] * (2 * np.pi)
    temb = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    temb = F.linear(temb, p["temb.0.weight"], p["temb.0.bias"])
    temb = F.linear(F.silu(temb), p["temb.1.weight"], p["temb.1.bias"])
    if not a.centered:
        x = 2 * x - 1.0
    pyr, hs = x, [_conv(x, p, "conv_in")]
    for lev in pl["down"]:
        for i, blk in enumerate(lev["res"]):
            h = _res(hs[-1], temb, p, blk, a)
            if lev["attn"]:
                h = _attn(h, p, lev["attn"][i])
            hs.append(h)
        if lev["down"]:
            h = _res(hs[-1], temb, p, lev["down"], a)
            pyr = downsample_2d(pyr, a.fir_kernel)
            hs.append(_conv(pyr, p, lev["combine"], pad=0) + h)
    h = _res(hs[-1], temb, p, pl["mid"][0], a)
    h = _res(_attn(h, p, pl["mid"][1]), temb, p, pl["mid"][2], a)
    pyramid = None
    for lev in pl["up"]:
        for blk in lev["res"]:
            h = _res(torch.cat([h, hs.pop()], dim=1), temb, p, blk, a)
        if lev["attn"]:
            h = _attn(h, p, lev["attn"])
        k = lev["k"]
        o = _conv(_gn(h, p, f"up.{k}.out_norm", True), p, f"up.{k}.out_conv", torso=False)
        pyramid = o if pyramid is None else upsample_2d(pyramid, a.fir_kernel) + o
        if lev["up"]:
            h = _res(h, temb, p, lev["up"], a)
    return pyramid / sigma[:, None, None, None]


def preclamp(p, a: Arch, x: torch.Tensor, sigma: float, rounding=None) -> torch.Tensor:
    """x + c sigma^2 s(c x + b, c sigma) for a host sigma: the denoiser
    before its clip to [-1, 1], with (c, b) = (1/2, 1/2) the map to the
    network's [0, 1] data range ((1, 0) where ``centered``); x is float32
    (N, 3, H, W). ``rounding`` as in ``net``."""
    n = x.shape[0]
    c, b = (1.0, 0.0) if a.centered else (0.5, 0.5)
    sig = torch.full((n,), float(np.float32(sigma)), dtype=torch.float32, device=x.device)
    score = net(p, a, c * x + b, c * sig, rounding)
    s4 = sig[:, None, None, None]
    return x + (c * s4 ** 2) * score


def snap_grid(a: Arch):
    """None: a continuous-sigma denoiser."""
    return None


def sigma_range(a: Arch) -> Tuple[float, float]:
    """The VE SDE's (sigma_min, sigma_max): 0.01 and 1348 at FFHQ 1024."""
    return a.sigma_min, a.sigma_max


# -- the frozen counts ------------------------------------------------------------
#
# Operations count two per multiply-add of every product: convolutions,
# dense layers, attention's two matmuls, the FIR resampling (a down's 16
# taps an output sample, an up's 4 an output sample: its zeros are not
# multiplied), the Fourier features (one product a feature). Elementwise
# work, norms and softmax are not counted. They are split by the precision
# the configuration states for them: the torso's products in its type,
# the rest in float32 (the embedding and its dense layers, attention's
# logits, the output pyramid's convs and FIR). Recomputation (remat) is
# implementation, not model work: not counted.

def _conv_flops(cin, cout, k, side):
    return 2 * cin * cout * k * k * side * side


def _fir_flops(c, side, up):
    """A FIR call on a (c, side, side) input: 16 taps per output sample of
    a down, 4 per output sample (16 per input sample) of an up."""
    return 2 * 16 * c * side * side if up else 2 * 4 * c * side * side


def fir_inputs(a: Arch) -> List[Tuple[int, int, int, str]]:
    """(C, H, W, "up" | "down") of every FIR call's input in one forward,
    in order: each resampling block's two (its activation and its skip),
    the input pyramid's down and the output pyramid's up."""
    out = []
    pl = plan(a)
    for lev in pl["down"]:
        if lev["down"]:
            c, r = lev["ch"], lev["side"]
            out += [(c, r, r, "down")] * 2 + [(a.channels, r, r, "down")]
    for lev in pl["up"]:
        if lev is not pl["up"][0]:
            r = lev["side"] // 2
            out.append((a.channels, r, r, "up"))
        if lev["up"]:
            c, r = lev["ch"], lev["side"]
            out += [(c, r, r, "up")] * 2
    return out


def forward_flops(arch: Arch, torso: str, batch: int = 1) -> Dict[str, float]:
    """{precision: FLOPs} of one denoiser forward at ``batch``."""
    a, f = arch, {"float32": 0, torso: 0}
    nf, temb = a.nf, 4 * a.nf
    f["float32"] += 2 * nf + 2 * (2 * nf) * temb + 2 * temb * temb    # embedding
    f[torso] += _conv_flops(a.channels, nf, 3, a.image_size)            # conv_in
    pl = plan(a)
    for n, cin, cout, r, ud in _blocks(pl):
        ro = r * 2 if ud == "up" else (r // 2 if ud == "down" else r)
        f[torso] += _conv_flops(cin, cout, 3, ro) + _conv_flops(cout, cout, 3, ro)
        f[torso] += 2 * temb * cout
        if cin != cout or ud:
            f[torso] += _conv_flops(cin, cout, 1, ro)
        if ud:
            f[torso] += 2 * _fir_flops(cin, r, ud == "up")   # the activation and the skip
    for _, c, r in _attns(pl, a):
        t = r * r
        f[torso] += 4 * 2 * t * c * c + 2 * t * t * c        # q, k, v, proj; weights @ v
        f["float32"] += 2 * t * t * c                         # logits
    for lev in pl["down"]:                     # the input pyramid
        if lev["combine"]:
            f[torso] += _fir_flops(a.channels, lev["side"], False)
            f[torso] += _conv_flops(a.channels, lev["ch"], 1, lev["side"] // 2)
    for lev in pl["up"]:                       # the output pyramid
        f["float32"] += _conv_flops(lev["ch"], a.channels, 3, lev["side"])
        if lev is not pl["up"][0]:
            f["float32"] += _fir_flops(a.channels, lev["side"] // 2, True)
    return {k: v * batch for k, v in f.items()}


def input_backward_flops(arch: Arch, torso: str, batch: int = 1) -> Dict[str, float]:
    """{precision: FLOPs} of the pullback to the input (no weight
    gradients): each product's input gradient, attention's matmuls twice,
    nothing for the embedding and the blocks' dense layers, which do not
    depend on the input."""
    a = arch
    f = forward_flops(a, torso, 1)
    nf, temb = a.nf, 4 * a.nf
    f["float32"] -= 2 * nf + 2 * (2 * nf) * temb + 2 * temb * temb
    pl = plan(a)
    for _, _, cout, _, _ in _blocks(pl):
        f[torso] -= 2 * temb * cout
    for _, c, r in _attns(pl, a):
        f["float32"] += 2 * r ** 4 * c
        f[torso] += 2 * r ** 4 * c
    return {k: v * batch for k, v in f.items()}


def norm_inputs(arch: Arch) -> List[Tuple[int, int, int]]:
    """(C, H, W) of every GroupNorm's input in one forward, in order."""
    a, out = arch, []
    pl = plan(a)

    def res(blk):
        _, cin, cout, r, ud = blk
        ro = r * 2 if ud == "up" else (r // 2 if ud == "down" else r)
        out.extend([(cin, r, r), (cout, ro, ro)])

    for lev in pl["down"]:
        for i, blk in enumerate(lev["res"]):
            res(blk)
            if lev["attn"]:
                out.append((lev["ch"], lev["side"], lev["side"]))
        if lev["down"]:
            res(lev["down"])
    res(pl["mid"][0])
    c, r = pl["mid"][0][1], pl["mid"][0][3]
    out.append((c, r, r))
    res(pl["mid"][2])
    for lev in pl["up"]:
        for blk in lev["res"]:
            res(blk)
        if lev["attn"]:
            out.append((lev["ch"], lev["side"], lev["side"]))
        out.append((lev["ch"], lev["side"], lev["side"]))
        if lev["up"]:
            res(lev["up"])
    return out

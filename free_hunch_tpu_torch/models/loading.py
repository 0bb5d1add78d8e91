"""Model loading: OpenAI setup-file parsing, the reference checkpoint or a
seeded random init, and the preconditioner wrapper.

Counterpart of ``free_hunch_tpu/models/loading.py`` (``parse_setup_txt``
:32-53, ``load_model`` :56-132, ``wrap_precond`` :135-150 with both preconditioners,
``randomize_zero_leaves`` :200). The reference ``.pt`` state dict loads into
the port's UNet as it is (same parameter names).

The denoiser family is the configuration's ``architecture``: ``openai``
(the ADM UNet, the default) or ``ncsnpp`` (score_sde's NCSN++,
``models/ncsnpp.py``), whose setup file is a JSON object of the score_sde
config's ``model`` keys and its data keys (``image_size``, ``centered``)
and whose checkpoint is a score_sde state dict (``models/convert.py``
maps its names); it takes the ``ve`` preconditioner.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from free_hunch_tpu_torch import resolve_device, use_full_f32
from free_hunch_tpu_torch.models import ncsnpp
from free_hunch_tpu_torch.models.convert import ncsnpp_state_dict_from_score_sde
from free_hunch_tpu_torch.models.precond import PRECONDS, VEPrecond
from free_hunch_tpu_torch.models.unet import GroupNorm32, create_model

ARCHITECTURES = ("openai", "ncsnpp")
# the layers each family's published model initialises to zero
_ZERO_LAYERS = ("out_layers.3", "proj_out", "out.2", ".conv1", ".proj", ".out_conv")

_BOOL_KEYS = ("class_cond", "learn_sigma", "resblock_updown",
              "use_new_attention_order", "use_fp16", "use_scale_shift_norm",
              "use_checkpoint")
_INT_KEYS = ("image_size", "num_channels", "num_head_channels", "num_res_blocks",
             "num_heads", "num_heads_upsample")
_FLOAT_KEYS = ("dropout",)
_DROP_KEYS = ("diffusion_steps", "noise_schedule", "timestep_respacing", "rescale_timesteps",
              "rescale_learned_sigmas", "use_kl", "predict_xstart", "lr", "batch_size")


def parse_setup_txt(text: str) -> dict:
    """Parse an OpenAI '--key value --key value' setup string into typed kwargs."""
    args = {}
    for chunk in text.strip().split("--")[1:]:
        chunk = chunk.strip()
        if not chunk:
            continue
        key, _, value = chunk.partition(" ")
        args[key.strip()] = value.strip()
    for k in _DROP_KEYS:
        args.pop(k, None)
    for k in _BOOL_KEYS:
        if k in args:
            args[k] = str(args[k]).lower() == "true"
    for k in _INT_KEYS:
        if k in args:
            args[k] = int(args[k])
    for k in _FLOAT_KEYS:
        if k in args:
            args[k] = float(args[k])
    return args


@torch.no_grad()
def random_init_(model: nn.Module, seed: int = 0, zero_scale: float = 0.1) -> nn.Module:
    """Seeded random weights through a ``torch.Generator`` on the model's
    device: conv/linear weights ~ N(0, 1/fan_in) (LeCun normal), GroupNorm
    at (1, 0), NCSN++'s Fourier ``W`` N(0, 1), the reference's
    zero-initialised layers (residual out convs, attention output
    projections, the final out convs) zero; then, as the JAX
    package's ``randomize_zero_leaves`` does, every all-zero tensor (those
    layers and every bias) becomes N(0, (zero_scale / sqrt(fan_in))^2), so a
    random-init run exercises the whole network instead of F(x) == 0."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    zero_layers = {id(m) for name, m in model.named_modules() if name.endswith(_ZERO_LAYERS)}
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            if id(m) in zero_layers:
                m.weight.zero_()
            else:
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=gen, device=dev)
                m.weight.copy_(w / np.sqrt(fan_in))
            m.bias.zero_()
        elif isinstance(m, (GroupNorm32, ncsnpp.GroupNormpp)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ncsnpp.GaussianFourier):
            m.W.copy_(torch.randn(m.W.shape, generator=gen, device=dev))
    for p in model.parameters():
        if p.numel() and float(p.abs().max()) == 0.0:
            fan_in = p[0].numel() if p.dim() > 1 else p.shape[0]
            noise = torch.randn(p.shape, generator=gen, device=dev)
            p.copy_(noise * (zero_scale / np.sqrt(max(fan_in, 1))))
    return model


def load_model(state_dict_path: str, setup_path: str, dtype=torch.bfloat16,
               init_random_if_missing: bool = False, rng_seed: int = 0,
               remat: bool = True, device=None, quant=None, fused_gn_quant: bool = False,
               quant_1x1: bool = True, model_group=None,
               architecture: str = "openai") -> Tuple[nn.Module, dict]:
    """Build the UNet per the setup file on ``device`` (default CUDA) and
    load the reference checkpoint, or, when it is absent and
    ``init_random_if_missing``, seeded random weights. Returns
    (model, model_args); the model is in eval mode with frozen parameters
    (the guidance vjp differentiates with respect to the input only).
    Sets the port's precision policy (``use_full_f32``).

    quant: None (bf16 torso) or "int8" / "int8_static" / "int8_calib";
    ``fused_gn_quant`` and ``quant_1x1`` as in ``UNetConfig``;
    ``model_group`` as in ``UNetModel``. A seed gives the
    same random weights for every torso, and on every rank of a model group
    (the seed is the caller's, never the rank). ``architecture``: the
    denoiser family (``ARCHITECTURES``; see the module docstring); NCSN++
    has neither an int8 torso nor a sharded one."""
    dev = resolve_device(device)
    use_full_f32()
    if architecture not in ARCHITECTURES:
        raise ValueError(f"unknown architecture {architecture!r} ({' | '.join(ARCHITECTURES)})")
    with open(setup_path, "r") as f:
        text = f.read()
    if architecture == "ncsnpp":
        if quant is not None or (model_group is not None and model_group.sharded):
            raise ValueError("NCSN++ runs the bf16 torso on one rank: no quant, no model axis")
        model_args = json.loads(text)
        with torch.device(dev):
            model = ncsnpp.create_model(dtype=dtype, remat=remat, **model_args)
    else:
        model_args = parse_setup_txt(text)
        with torch.device(dev):
            model = create_model(dtype=dtype, remat=remat, quant=quant,
                                 fused_gn_quant=fused_gn_quant, quant_1x1=quant_1x1,
                                 model_group=model_group,
                                 **model_args)
    if state_dict_path and os.path.exists(state_dict_path):
        sd = torch.load(state_dict_path, map_location=dev, weights_only=True)
        if architecture == "ncsnpp":
            sd = ncsnpp_state_dict_from_score_sde(sd, model.cfg)
        model.load_state_dict(sd)
    elif init_random_if_missing:
        random_init_(model, seed=rng_seed)
    else:
        raise FileNotFoundError(
            f"checkpoint {state_dict_path!r} not found; download it per the "
            f"upstream README or pass init_random_if_missing=True")
    model.eval().requires_grad_(False)
    return model, model_args


def wrap_precond(model: nn.Module, model_args: dict, kind: str = "linear",
                 qscales=None):
    """Wrap in the sigma parameterisation: ``kind`` 'linear' (linear-beta
    iDDPM) or 'cosine' (cosine iDDPM) around the ADM UNet, 've' (score_sde's
    VE SDE, ``precond.VEPrecond``) around NCSN++.

    qscales: the per-(site, sigma-stage) activation-scale table of a
    ``quant="int8_static"`` model (``models/calibrate.calibrate_qscales``),
    which such a model needs."""
    if kind not in PRECONDS and kind != "ve":
        raise ValueError(f"unknown preconditioner {kind!r} (linear | cosine | ve)")
    if (kind == "ve") != isinstance(model, ncsnpp.NCSNpp):
        raise ValueError(f"preconditioner {kind!r} does not fit a {type(model).__name__}: "
                         "'ve' takes NCSN++, 'linear' and 'cosine' the ADM UNet")
    if kind == "ve":
        return VEPrecond.around(model)
    if model.cfg.quant == "int8_static" and qscales is None:
        raise ValueError(
            "quant='int8_static' needs a calibration table: pass qscales="
            "(sigmas, table) from models/calibrate.calibrate_qscales (or use "
            "quant='int8' for dynamic activation scales)")
    res = model_args.get("image_size", model.cfg.image_size)
    label_dim = 1000 if model_args.get("class_cond") else 0
    return PRECONDS[kind](model, img_resolution=res, img_channels=3, label_dim=label_dim,
                          qscales=qscales).to(next(model.parameters()).device)

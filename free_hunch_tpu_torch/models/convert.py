"""Weights bridge between the JAX package's flax parameter tree and the
port's state dict, which uses the reference torch names.

The port's own copy of the name map of ``free_hunch_tpu/models/convert.py``
(``name_map`` :72-156). ``state_dict_from_flax`` is the exact inverse of
that file's ``convert_state_dict`` (:162-182): HWIO -> OIHW for convs,
(I, O) -> (O, I) for linears, and Dense (I, O) -> 1x1 conv1d (O, I, 1) for
the attention ``qkv``/``proj_out``. Tests use it so that both packages
compute with the same weights.

``qscales_from_flax`` / ``qscales_to_flax`` carry an ``int8_static``
calibration table across: the JAX package's is (sigmas, a 'qscales' tree
keyed by flax module paths such as ``down_3_res/in_conv/act_scale``); the
port's is (sigmas, {torch module name: scales}), e.g.
``input_blocks.4.0.in_layers.2``. The site pairs come from ``name_map``.

``vae_state_dict_from_flax`` does the same for the SD-VAE of
``free_hunch_tpu/models/vae.py`` (flax module paths such as
``encoder/down_0_resnet_1/norm1`` -> diffusers names such as
``encoder.down_blocks.0.resnets.1.norm1``), and ``load_vae_npz`` reads that
package's weights file.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from free_hunch_tpu_torch.models.unet import UNetConfig


def _resblock_entries(torch_prefix: str, flax_prefix: Tuple[str, ...],
                      has_skip: bool) -> List[Tuple[str, Tuple[str, ...], str]]:
    e = [
        (f"{torch_prefix}.in_layers.0.weight", flax_prefix + ("in_norm", "scale"), "raw"),
        (f"{torch_prefix}.in_layers.0.bias", flax_prefix + ("in_norm", "bias"), "raw"),
        (f"{torch_prefix}.in_layers.2.weight", flax_prefix + ("in_conv", "kernel"), "conv"),
        (f"{torch_prefix}.in_layers.2.bias", flax_prefix + ("in_conv", "bias"), "raw"),
        (f"{torch_prefix}.emb_layers.1.weight", flax_prefix + ("emb_proj", "kernel"), "lin"),
        (f"{torch_prefix}.emb_layers.1.bias", flax_prefix + ("emb_proj", "bias"), "raw"),
        (f"{torch_prefix}.out_layers.0.weight", flax_prefix + ("out_norm", "scale"), "raw"),
        (f"{torch_prefix}.out_layers.0.bias", flax_prefix + ("out_norm", "bias"), "raw"),
        (f"{torch_prefix}.out_layers.3.weight", flax_prefix + ("out_conv", "kernel"), "conv"),
        (f"{torch_prefix}.out_layers.3.bias", flax_prefix + ("out_conv", "bias"), "raw"),
    ]
    if has_skip:
        e += [
            (f"{torch_prefix}.skip_connection.weight", flax_prefix + ("skip", "kernel"), "conv"),
            (f"{torch_prefix}.skip_connection.bias", flax_prefix + ("skip", "bias"), "raw"),
        ]
    return e


def _attn_entries(torch_prefix: str, flax_prefix: Tuple[str, ...]):
    return [
        (f"{torch_prefix}.norm.weight", flax_prefix + ("norm", "scale"), "raw"),
        (f"{torch_prefix}.norm.bias", flax_prefix + ("norm", "bias"), "raw"),
        (f"{torch_prefix}.qkv.weight", flax_prefix + ("qkv", "kernel"), "conv1d"),
        (f"{torch_prefix}.qkv.bias", flax_prefix + ("qkv", "bias"), "raw"),
        (f"{torch_prefix}.proj_out.weight", flax_prefix + ("proj_out", "kernel"), "conv1d"),
        (f"{torch_prefix}.proj_out.bias", flax_prefix + ("proj_out", "bias"), "raw"),
    ]


def name_map(cfg: UNetConfig) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(torch name, flax path, kind) for every parameter of a config, by
    replaying the constructor structure of the reference UNet."""
    entries: List[Tuple[str, Tuple[str, ...], str]] = [
        ("time_embed.0.weight", ("time_embed_0", "kernel"), "lin"),
        ("time_embed.0.bias", ("time_embed_0", "bias"), "raw"),
        ("time_embed.2.weight", ("time_embed_2", "kernel"), "lin"),
        ("time_embed.2.bias", ("time_embed_2", "bias"), "raw"),
        ("input_blocks.0.0.weight", ("in_conv", "kernel"), "conv"),
        ("input_blocks.0.0.bias", ("in_conv", "bias"), "raw"),
        ("out.0.weight", ("out_norm", "scale"), "raw"),
        ("out.0.bias", ("out_norm", "bias"), "raw"),
        ("out.2.weight", ("out_conv", "kernel"), "conv"),
        ("out.2.bias", ("out_conv", "bias"), "raw"),
    ]
    if cfg.num_classes is not None:
        entries.append(("label_emb.weight", ("label_emb", "embedding"), "raw"))

    tid = 1
    ds = 1
    ch = int(cfg.channel_mult[0] * cfg.model_channels)
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            out_ch = int(mult * cfg.model_channels)
            entries += _resblock_entries(f"input_blocks.{tid}.0",
                                         (f"down_{tid-1}_res",), has_skip=(out_ch != ch))
            ch = out_ch
            if ds in cfg.attention_resolutions:
                entries += _attn_entries(f"input_blocks.{tid}.1", (f"down_{tid-1}_attn",))
            tid += 1
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                entries += _resblock_entries(f"input_blocks.{tid}.0",
                                             (f"down_{tid-1}_res",), has_skip=False)
            else:
                entries += [
                    (f"input_blocks.{tid}.0.op.weight", (f"down_{tid-1}_ds", "op", "kernel"), "conv"),
                    (f"input_blocks.{tid}.0.op.bias", (f"down_{tid-1}_ds", "op", "bias"), "raw"),
                ]
            ds *= 2
            tid += 1

    entries += _resblock_entries("middle_block.0", ("mid_res0",), has_skip=False)
    entries += _attn_entries("middle_block.1", ("mid_attn",))
    entries += _resblock_entries("middle_block.2", ("mid_res1",), has_skip=False)

    input_block_chans = [int(cfg.channel_mult[0] * cfg.model_channels)]
    c = input_block_chans[0]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            c = int(mult * cfg.model_channels)
            input_block_chans.append(c)
        if level != len(cfg.channel_mult) - 1:
            input_block_chans.append(c)

    oid = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            ich = input_block_chans.pop()
            out_ch = int(mult * cfg.model_channels)
            entries += _resblock_entries(f"output_blocks.{oid}.0", (f"up_{oid}_res",),
                                         has_skip=(out_ch != ch + ich))
            ch = out_ch
            sub = 1
            if ds in cfg.attention_resolutions:
                entries += _attn_entries(f"output_blocks.{oid}.{sub}", (f"up_{oid}_attn",))
                sub += 1
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    entries += _resblock_entries(f"output_blocks.{oid}.{sub}",
                                                 (f"up_{oid}_us",), has_skip=False)
                else:
                    entries += [
                        (f"output_blocks.{oid}.{sub}.conv.weight",
                         (f"up_{oid}_us", "conv", "kernel"), "conv"),
                        (f"output_blocks.{oid}.{sub}.conv.bias",
                         (f"up_{oid}_us", "conv", "bias"), "raw"),
                    ]
                ds //= 2
            oid += 1
    return entries


# flax layout -> torch layout, the inverses of the JAX package's converters
_FROM_FLAX = {
    "raw": lambda w: w,
    "conv": lambda w: np.transpose(w, (3, 2, 0, 1)),       # HWIO -> OIHW
    "lin": lambda w: np.transpose(w, (1, 0)),              # (I, O) -> (O, I)
    "conv1d": lambda w: np.transpose(w, (1, 0))[..., None],  # (I, O) -> (O, I, 1)
}


def state_dict_from_flax(params: dict, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """Flax params ({'params': nested dicts of arrays}, or the inner dict)
    -> the port's state dict (f32 CPU tensors, reference torch names)."""
    tree = params.get("params", params)
    out = {}
    for torch_name, flax_path, kind in name_map(cfg):
        node = tree
        for key in flax_path:
            node = node[key]
        out[torch_name] = torch.from_numpy(
            np.array(_FROM_FLAX[kind](np.asarray(node, np.float32)), order="C"))
    return out


def quant_site_paths(cfg: UNetConfig) -> Dict[str, Tuple[str, ...]]:
    """torch module name -> flax module path, for every conv and dense
    layer of a config (the int8 sites are among them)."""
    return {t[:-len(".weight")]: f[:-1] for t, f, kind in name_map(cfg)
            if kind in ("conv", "conv1d") and t.endswith(".weight")}


def qscales_from_flax(qscales, cfg: UNetConfig) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The JAX package's (sigmas, 'qscales' tree) -> the port's (sigmas,
    {site: (S,) f32}). Raises if a scale of the tree has no site."""
    sigmas, tree = qscales
    table = {}
    for site, path in quant_site_paths(cfg).items():
        node = tree
        for key in path:
            node = node.get(key) if isinstance(node, Mapping) else None
        if isinstance(node, Mapping) and "act_scale" in node:
            table[site] = np.asarray(node["act_scale"], np.float32)

    def count(node):
        if isinstance(node, Mapping):
            return sum(count(v) for v in node.values())
        return 1
    if count(tree) != len(table):
        raise KeyError(f"qscales tree has {count(tree)} scales, {len(table)} map to "
                       f"sites of this config")
    return np.asarray(sigmas, np.float32), table


def qscales_to_flax(qscales, cfg: UNetConfig) -> Tuple[np.ndarray, dict]:
    """The port's (sigmas, {site: scales}) -> the JAX package's (sigmas,
    nested 'qscales' tree of numpy arrays)."""
    sigmas, table = qscales
    paths = quant_site_paths(cfg)
    tree: dict = {}
    for site, scales in table.items():
        node = tree
        for key in paths[site]:
            node = node.setdefault(key, {})
        node["act_scale"] = np.asarray(scales, np.float32)
    return np.asarray(sigmas, np.float32), tree


# -- the SD-VAE (models/vae.py) ----------------------------------------------

def _vae_module_name(path: Tuple[str, ...]) -> str:
    """A flax module path of ``free_hunch_tpu/models/vae.py`` -> the
    diffusers module name the port uses."""
    out: List[str] = []
    for p in path:
        m = re.fullmatch(r"(down|up)_(\d+)_resnet_(\d+)", p)
        if m:
            out += [f"{m[1]}_blocks", m[2], "resnets", m[3]]
            continue
        m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", p)
        if m:
            out += [f"{m[1]}_blocks", m[2], f"{m[3]}rs", "0", "conv"]
            continue
        m = re.fullmatch(r"(resnets|attentions)_(\d+)", p)
        if m:
            out += [m[1], m[2]]
            continue
        out.append({"mid": "mid_block", "to_out": "to_out.0"}.get(p, p))
    return ".".join(out)


def vae_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's AutoencoderKL parameters ({'params': nested dicts
    of arrays}, or the inner dict) -> the port's state dict (f32 CPU
    tensors, diffusers names): HWIO -> OIHW for convolutions, (I, O) ->
    (O, I) for linears, GroupNorm ``scale`` -> ``weight``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        w = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            w = np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T
        name = "bias" if leaf == "bias" else "weight"
        out[f"{_vae_module_name(path[:-1])}.{name}"] = torch.from_numpy(np.array(w, order="C"))

    walk(params.get("params", params), ())
    return out


def load_vae_npz(path: str) -> dict:
    """The JAX package's SD-VAE weights file (an npz of the flattened
    parameter tree, '/'-joined keys) -> {'params': nested dicts}."""
    tree: dict = {}
    with np.load(path) as blob:
        for key in blob.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(blob[key])
    return {"params": tree.get("params", tree)}

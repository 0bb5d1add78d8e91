"""Typed JSON config with ``--key=value`` / ``--key value`` CLI overrides.

Counterpart of ``free_hunch_tpu/config.py``. The schema and defaults are a
copy of the JAX package's ``config_default.yaml`` as JSON
(``config_default.json``, read with the stdlib), so the port needs no YAML
parser; the key surface, the typed coercion and its
``ValueError: Invalid type for ...`` are the JAX module's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional

from free_hunch_tpu_torch.utils.easydict import EasyDict

_DEFAULT_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "config_default.json"
)


def parse_type(type_str: str):
    """Map a schema type string ('str', 'int', 'float', 'bool', 'List[T]') to a converter."""
    if type_str == "str":
        return str
    if type_str == "int":
        return int
    if type_str == "float":
        return float
    if type_str == "bool":
        return bool
    if type_str.startswith("List["):
        return parse_type(type_str[5:-1])
    raise ValueError(f"Unknown schema type: {type_str}")


def _coerce(key: str, value: Any, type_str: str) -> Any:
    conv = parse_type(type_str)
    if value is None:
        return None
    if conv is bool:
        if isinstance(value, str):
            return value.lower() in ("true", "yes", "1", "on")
        return bool(value)
    if type_str.startswith("List["):
        if isinstance(value, str):
            return [conv(v.strip()) for v in value.split(",")]
        if isinstance(value, (list, tuple)):
            return [conv(v) for v in value]
        return [conv(value)]
    return conv(value)


def validate_and_convert(config: Dict[str, Any], schema: Dict[str, str]) -> EasyDict:
    """Coerce config values to their schema types; unknown keys pass through unchanged."""
    out = {}
    for key, value in config.items():
        if key in schema:
            try:
                out[key] = _coerce(key, value, schema[key])
            except (ValueError, TypeError):
                raise ValueError(
                    f"Invalid type for {key!r}: expected {schema[key]}, got {type(value).__name__}"
                ) from None
        else:
            out[key] = value
    return EasyDict(out)


def load_config(args: Optional[Dict[str, Any]] = None,
                config_path: str = _DEFAULT_CONFIG_PATH,
                argv: Optional[list] = None) -> EasyDict:
    """Merge the defaults of ``config_default.json`` with CLI ``--key=value`` overrides.

    ``args`` may be a dict of overrides (used programmatically / in tests);
    when None, ``sys.argv`` (or ``argv``) is parsed: ``--outdir`` is required,
    every other ``--key=value`` pair overrides the default config.
    """
    with open(config_path, "r") as f:
        data = json.load(f)
    schema = data["schema"]
    config = dict(data["config"])

    if args is None:
        parser = argparse.ArgumentParser()
        parser.add_argument("--outdir", type=str, required=True)
        ns, unknown = parser.parse_known_args(argv if argv is not None else sys.argv[1:])
        config["outdir"] = ns.outdir
        i = 0
        while i < len(unknown):
            tok = unknown[i]
            if tok.startswith("--") and "=" in tok:
                param, value = tok[2:].split("=", 1)
                config[param] = value
                i += 1
            elif (tok.startswith("--") and i + 1 < len(unknown)
                  and not unknown[i + 1].startswith("--")):
                # space-separated override: '--key value'
                config[tok[2:]] = unknown[i + 1]
                i += 2
            else:
                raise SystemExit(f"unrecognized argument {tok!r} "
                                 "(overrides are --key=value or --key value)")
    else:
        # programmatic values pass through natively: a string round trip
        # would corrupt lists and None
        for k, v in args.items():
            config[k] = v
        if "outdir" in args:
            config["outdir"] = args["outdir"]

    if "dataset_path" not in config or config.get("dataset_path") is None:
        config["dataset_path"] = os.path.join(
            "data", f"{config.get('dataset', 'imagenet')}_{config.get('data_subset', 'val')}"
        )

    return validate_and_convert(config, schema)


_KEY_SHORTHANDS = {
    "operator_name": "op", "noise_sigma": "ns", "solver": "slv", "num_steps": "stp",
    "S_churn": "ch", "total_images": "img", "cond_scaling": "cs",
    "image_base_covariance": "ibc", "pca_component_count": "pca",
    "denoiser_mean_error_threshold": "det", "use_analytical_score_time_update": "atu",
    "project_to_diagonal": "ptd", "space_step_update_threshold": "sut",
    "space_step_update_lower_threshold": "slt", "pigdm_posthoc_scaling": "pps",
    "clip_x0_mean": "cx0m", "conditioning_mechanism": "cm", "use_rtol_func": "urf",
    "solver_type": "st",
}

_BASE_KEYS = ["operator_name", "noise_sigma", "solver", "num_steps", "S_churn",
              "total_images", "cond_scaling"]


def get_job_name_params(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Per-mechanism shorthand key sets used to name sweep runs."""
    mech = cfg["conditioning_mechanism"]
    if mech == "dps":
        keys = list(_BASE_KEYS)
        # raw keys, no shorthand mapping: the reference's dps branch returns
        # before it applies the shorthands
        return {k: v for k, v in cfg.items() if k != "outdir" and k in keys}
    if mech in ("pigdm", "tmpd", "peng_convert", "peng_analytic", "ddnm", "diffpir",
                "pigdm_videodiff_schedule"):
        keys = _BASE_KEYS + ["pigdm_posthoc_scaling", "clip_x0_mean"]
    elif mech == "online_covariance":
        keys = _BASE_KEYS + [
            "image_base_covariance", "pca_component_count", "denoiser_mean_error_threshold",
            "use_analytical_score_time_update", "project_to_diagonal",
            "space_step_update_threshold", "space_step_update_lower_threshold",
            "pigdm_posthoc_scaling", "clip_x0_mean", "max_rtol", "use_analytic_var_at_end",
            "use_rtol_func", "solver_type",
        ]
    else:
        raise ValueError(f"Unknown conditioning mechanism: {mech}")
    sel = {k: v for k, v in cfg.items() if k != "outdir" and k in keys}
    return {_KEY_SHORTHANDS.get(k, k): v for k, v in sel.items()}

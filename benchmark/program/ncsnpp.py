"""The ``ncsnpp`` denoiser family on the program's side: the port's
NCSN++ (``models.ncsnpp.NCSNpp`` of the configuration's score_sde
``model`` block) behind score_sde's continuous-sigma VE preconditioner
(``models.precond.VEPrecond``), as the port's loader pairs them."""
from __future__ import annotations

import torch

import weights as weights_mod
from free_hunch_tpu_torch.models.ncsnpp import GroupNormpp, NCSNpp, config_of
from free_hunch_tpu_torch.models.precond import VEPrecond


def build(config: dict, weights, device, **options):
    """(model, preconditioner) of ``config`` on ``device`` with ``weights``
    loaded: the torso in ``precision.torso``, the ``program`` block's model
    options, ``options`` over them."""
    args = dict(config["model"], **dict(config["program"], **options))
    with torch.device(device):
        model = NCSNpp(config_of(dtype=weights_mod.dtype(config["precision"]["torso"]), **args))
    model.load_state_dict(weights)
    model = model.eval().requires_grad_(False)
    return model, VEPrecond.around(model)


def norm_modules(model) -> list:
    """The model's GroupNorm(+SiLU) modules, each a K1 call a forward."""
    return [m for m in model.modules() if type(m) is GroupNormpp]

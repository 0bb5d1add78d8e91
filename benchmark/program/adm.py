"""The ``adm`` denoiser family on the program's side: the port's ADM UNet
(``models.unet.create_model`` from the configuration's guided-diffusion
setup flags) behind the iDDPM linear preconditioner
(``models.loading.wrap_precond``)."""
from __future__ import annotations

import torch

import weights as weights_mod
from free_hunch_tpu_torch.models import loading
from free_hunch_tpu_torch.models.unet import GroupNorm32, create_model


def build(config: dict, weights, device, **options):
    """(model, preconditioner) of ``config`` on ``device`` with ``weights``
    loaded: the torso in ``precision.torso``, the ``program`` block's model
    options, ``options`` over them (the control's int8 torso)."""
    args = dict(config["model"])
    with torch.device(device):
        model = create_model(**args, dtype=weights_mod.dtype(config["precision"]["torso"]),
                             **dict(config["program"], **options))
    model.load_state_dict(weights)
    model = model.eval().requires_grad_(False)
    return model, loading.wrap_precond(model, args, "linear")


def norm_modules(model) -> list:
    """The model's GroupNorm(+SiLU) modules, each a K1 call a forward."""
    return [m for m in model.modules() if type(m) is GroupNorm32]

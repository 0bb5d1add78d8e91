"""DDNM+ evaluation driver.

Counterpart of ``free_hunch_tpu/eval_ddnm.py``: the shared evaluation loop
of ``eval.Evaluator`` with the DDNM+ sampler (``samplers/ddnm.py``) over
the SVD operators (``operators/svd.py``). The raw epsilon-prediction UNet
runs on the DDPM index grid with its variance channel stripped, bypassing
the preconditioner. Inpainting takes a fresh mask per image (the base
driver's ``_gen_masks``), shared by the image's seed replicas, as a per-row
``Inpainting`` whose missing indices come from the mask's (C, H, W)
flattening, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

from free_hunch_tpu_torch import randn
from free_hunch_tpu_torch.eval import Evaluator
from free_hunch_tpu_torch.operators import svd
from free_hunch_tpu_torch.samplers.ddnm import build_svd_operator, ddnm_sample


@dataclasses.dataclass
class DDNMEvaluator(Evaluator):
    def __post_init__(self):
        self.opts = dict(self.opts, conditioning_mechanism="ddnm")
        super().__post_init__()
        self.num_steps = int(self.opts.get("num_steps", 100))
        self.sigma_y = float(self.opts.get("noise_sigma", 0.0))
        self.eta = float(self.opts.get("eta", 1.0))
        self._svd_template = None
        if not self.is_inpainting:
            self._svd_template = build_svd_operator(self.operator_kwargs, self.res,
                                                    device=self.device)

    def _batch_fn(self, noise, cond_latents, operator, gens, labels=None):
        """(x, trajectory or None, the measurement image): y = A x +
        sigma_y n with n from ``gens[0]``, the sampler's draws from
        ``gens[1]``."""
        b = noise.shape[0]

        def eps_fn(x, t):
            return self.model(x, t, y=labels)[:, :3]

        flat = cond_latents.reshape(b, -1)
        y = operator.A(flat)
        y = y + self.sigma_y * randn(y.shape, gens[0], dtype=y.dtype, device=y.device)
        x, traj = ddnm_sample(eps_fn, operator, noise, y, num_steps=self.num_steps,
                              sigma_y=self.sigma_y, eta=self.eta, generator=gens[1],
                              return_trajectory=self.save_videos)
        if self.is_inpainting:
            y_img = operator.A_with_zeros(flat).reshape(cond_latents.shape)
        else:
            y_img = operator.At(y).reshape(cond_latents.shape)
        return x, (traj if self.save_videos else None), y_img

    def _make_operator(self, gidx):
        if self._svd_template is not None:
            return self._svd_template
        return svd.Inpainting.from_masks(self._gen_masks(gidx), len(self.seeds),
                                         device=self.device)

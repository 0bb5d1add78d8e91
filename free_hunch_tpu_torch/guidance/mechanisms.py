"""Free Hunch conditioning: x0_mean <- x0_mean + sigma^2 * grad log p(y | x_t)
with an online estimate of the denoiser covariance.

Counterpart of ``FreeHunchState``, ``FreeHunch`` and ``_denoise_with_vjp``
in ``free_hunch_tpu/guidance/mechanisms.py`` (:128-134, :247-701). Where the
JAX package branches with ``lax.cond`` on traced booleans, the port branches
in Python on host values: ``sigma`` and the step count live on the host, and
``x_changed`` (one batch-global comparison) is the only device read, made
only when a space update or a re-evaluation could follow. Per-sample
decisions (BFGS guards, the large-update fallback) stay on the device as
``torch.where``.

The guidance gradient is ``torch.autograd.grad`` of x0_mean with respect to
x_t against ``mat``, through the UNet with frozen parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from free_hunch_tpu_torch.guidance import covariance as cov_mod
from free_hunch_tpu_torch.guidance.solvers import RTOL_F32_FLOOR, choose_solver
from free_hunch_tpu_torch.operators import assets
from free_hunch_tpu_torch.ops import lowrank
from free_hunch_tpu_torch.ops.dct import dct_2d, idct_2d
from free_hunch_tpu_torch.ops.lowrank import LowRank


def _denoise_with_vjp(denoise: Callable, x_t: torch.Tensor, sigma):
    """One forward through the denoiser; returns (x0_mean, x0_var, pullback)
    with pullback(ct) = d(ct . x0_mean)/d x_t. The pullback runs once."""
    x = x_t.detach().requires_grad_(True)
    with torch.enable_grad():
        x0, x0_var = denoise(x, sigma)

    def pullback(ct):
        (g,) = torch.autograd.grad(x0, x, grad_outputs=ct)
        return g

    return x0.detach(), x0_var.detach(), pullback


class FreeHunchState(NamedTuple):
    """Per-run state of the online covariance mechanism. ``cov`` has a
    leading batch axis; ``prev_*`` hold the previous guidance call;
    ``prev_u`` the previous stage's measurement-space CG solution for
    ``cg_warm_start='prev'``. Host scalars are Python numbers."""
    cov: LowRank
    prev_sigma: float
    prev_x: torch.Tensor       # (B, C, H, W)
    prev_mean: torch.Tensor    # (B, C, H, W)
    prev_u: torch.Tensor       # (B, *measurement_shape)
    step: int
    cg_niter: int              # iterations of the last mat solve
    cg_resnorm: torch.Tensor   # () f32 batch-mean final residual norm
    cg_optfrac: torch.Tensor   # () f32 fraction of rows converged to rtol
    cg_host_syncs: int         # host syncs of the last solve


def choose_conditioning_mechanism(name: str):
    """The port knows ``online_covariance`` (Free Hunch) so far."""
    if name == "online_covariance":
        return FreeHunch
    raise NotImplementedError(f"conditioning mechanism {name!r} is not ported yet "
                              "(have: online_covariance)")


@dataclasses.dataclass(frozen=True)
class FreeHunch:
    """Online denoiser-covariance guidance. Per call: time update of the
    covariance with analytic transport of the previous denoiser mean, gated
    BFGS space update, tailored CG solve against Sigma_0, and the guidance
    gradient (vjp of ``mat`` through the UNet, with the large-update fallback
    Sigma_0 mat / sigma^2). The knobs and their reasons are the JAX class's;
    ``use_analytic_var_at_end``, ``algebra_dtype`` and ``cov_partition`` are
    not ported and raise."""
    cond_scaling: float
    forward_operator: object
    clip_x0_mean: bool = False
    max_rtol: float = 1.0
    use_rtol_func: bool = False
    cg_maxiter: Optional[int] = None
    image_base_covariance: str = "identity"   # identity | dct_diagonal | dct_diagonal_noinfo
    init_denoiser_variance: float = 1.0
    init_noise_variance: float = 1.0
    data_dim: int = 0
    cov_capacity: int = 128
    project_to_diagonal: bool = False
    do_space_updates: bool = True
    use_analytical_score_time_update: bool = True
    space_step_update_threshold: float = 10.0
    space_step_update_lower_threshold: float = 1.0
    denoiser_mean_error_threshold: float = 0.2
    use_analytic_var_at_end: bool = False
    solver_type: str = "customcuda"
    data_dir: Optional[str] = None
    dataset: str = "imagenet"
    cg_precondition: bool = True
    cg_stall_iters: int = 25
    cg_track_best: bool = True
    bfgs_curvature_guard: bool = True
    bfgs_secant_novelty_min: float = 0.02
    guidance_update_bound: Optional[float] = None
    transport_mean_bound: Optional[float] = None
    algebra_dtype: Optional[str] = None
    rtol_floor: float = RTOL_F32_FLOOR
    cg_coords: str = "pixel"
    cg_warm_start: str = "b"
    transport_formula: str = "telescoped"
    guidance_gradient: str = "vjp"
    guidance_vjp_below: float = 1.0
    cov_partition: Optional[Tuple[Optional[str], Optional[str]]] = None

    def __post_init__(self):
        if self.use_analytic_var_at_end:
            raise NotImplementedError("use_analytic_var_at_end needs the scipy-budget "
                                      "solver, which is not ported yet")
        if self.algebra_dtype not in (None, "float32"):
            raise NotImplementedError("algebra_dtype other than float32 is not ported")
        if self.cov_partition is not None:
            raise NotImplementedError("cov_partition (sharded covariance) is not ported")
        if self.guidance_gradient not in ("vjp", "covariance", "hybrid"):
            raise ValueError(f"unknown guidance_gradient {self.guidance_gradient!r} "
                             f"(vjp | covariance | hybrid)")
        if self.cg_warm_start not in ("b", "prev"):
            raise ValueError(f"cg_warm_start must be 'b' or 'prev', got "
                             f"{self.cg_warm_start!r}")
        if self.transport_formula not in ("telescoped", "two_inverse"):
            raise ValueError(f"unknown transport_formula {self.transport_formula!r}")

    def __call__(self, denoise: Callable, x_t, y, sigma, state):
        x0_new, state = self.x0_mean_update(denoise, x_t, y, sigma, state)
        if self.clip_x0_mean:
            x0_new = torch.clamp(x0_new, -1.0, 1.0)
        return x0_new, state

    # -- basis --------------------------------------------------------------

    def _to_basis(self, x):
        """(B, C, H, W) pixel -> (B, d) transform coordinates."""
        if self.image_base_covariance.startswith("dct"):
            x = dct_2d(x)
        return x.reshape(x.shape[0], -1)

    def _from_basis(self, v, img_shape):
        v = v.reshape((-1,) + tuple(img_shape))
        if self.image_base_covariance.startswith("dct"):
            v = idct_2d(v)
        return v

    def _init_diag(self, img_shape, device) -> torch.Tensor:
        d = int(np.prod(img_shape))
        if self.image_base_covariance == "dct_diagonal":
            dv = (assets.load_dct_variance_from_dir(self.data_dir) if self.data_dir
                  else assets.dct_variance(self.dataset))
            # other resolutions truncate the 256 px prior, as the JAX package does
            flat = np.asarray(dv, np.float32).reshape(-1)[:d]
            return torch.as_tensor(flat, device=device)
        if self.image_base_covariance in ("dct_diagonal_noinfo", "identity"):
            return torch.full((d,), float(self.init_denoiser_variance),
                              dtype=torch.float32, device=device)
        raise ValueError(f"unknown image_base_covariance {self.image_base_covariance!r}")

    def init_state(self, batch: int, img_shape: Tuple[int, ...]) -> FreeHunchState:
        dev = self.forward_operator.device
        d = int(np.prod(img_shape))
        cov = cov_mod.init_state(self._init_diag(img_shape, dev), batch, d,
                                 self.cov_capacity)
        zeros = torch.zeros((batch,) + tuple(img_shape), dtype=torch.float32, device=dev)
        u_shape = (batch,) + tuple(self.forward_operator.out_shape[1:])
        return FreeHunchState(
            cov=cov, prev_sigma=0.0, prev_x=zeros, prev_mean=zeros,
            prev_u=torch.zeros(u_shape, dtype=torch.float32, device=dev), step=0,
            cg_niter=0, cg_resnorm=torch.zeros((), device=dev),
            cg_optfrac=torch.ones((), device=dev), cg_host_syncs=0)

    def cov_matvec_pixel(self, cov, v):
        """Sigma_0 @ v for pixel-space (B, C, H, W) v (the CG callback)."""
        shape = v.shape[1:]
        return self._from_basis(cov_mod.cov_matvec(cov, self._to_basis(v)), shape)

    # -- the guidance update --------------------------------------------------

    def x0_mean_update(self, denoise, x_t, y, sigma, state: FreeHunchState):
        img_shape = x_t.shape[1:]
        sigma = float(np.float32(sigma))
        x_t = x_t.float()
        if self.guidance_gradient == "covariance":
            with torch.no_grad():
                x0, _ = denoise(x_t, sigma)
            pullback = None
        else:
            x0, _, pullback = _denoise_with_vjp(denoise, x_t, sigma)

        has_prev = state.step > 0
        sigma_changed = has_prev and sigma != state.prev_sigma

        def x_changed():
            return has_prev and not bool(torch.all(torch.abs(x_t - state.prev_x) < 1e-12))

        cov = state.cov
        if self.do_space_updates:
            prev_x_b = self._to_basis(state.prev_x)
            prev_mean_b = self._to_basis(state.prev_mean)
            # (1) time update + analytic transport of the previous mean
            if sigma_changed:
                transport = (cov_mod.transport_score_two_inverse
                             if self.transport_formula == "two_inverse"
                             else cov_mod.transport_score)
                score_prev = (prev_mean_b - prev_x_b) / state.prev_sigma**2
                cov = cov_mod.time_update(state.cov, state.prev_sigma, sigma)
                prev_mean_b, _ = transport(state.cov, cov, state.prev_sigma, sigma,
                                           prev_x_b, score_prev)
                if self.transport_mean_bound is not None:
                    b = float(self.transport_mean_bound)
                    prev_mean_b = self._to_basis(torch.clamp(
                        self._from_basis(prev_mean_b, img_shape), -b, b))
            # (2) optional extra network evaluation at (prev_x, sigma)
            in_window = (self.space_step_update_lower_threshold < sigma
                         < self.space_step_update_threshold)
            changed = (x_changed() if in_window or not self.use_analytical_score_time_update
                       else False)
            if not self.use_analytical_score_time_update and changed:
                with torch.no_grad():
                    m, _ = denoise(state.prev_x.float(), sigma)
                prev_mean_b = self._to_basis(m)
            # (3) gated BFGS space update
            if changed and in_window:
                params = cov_mod.CovParams(
                    project_to_diagonal=self.project_to_diagonal,
                    curvature_guard=self.bfgs_curvature_guard,
                    secant_novelty_min=self.bfgs_secant_novelty_min)
                cov = cov_mod.space_update(cov, sigma, prev_x_b, self._to_basis(x_t),
                                           prev_mean_b, self._to_basis(x0), params)
        elif sigma_changed:
            cov = cov_mod.time_update(state.cov, state.prev_sigma, sigma)

        # (4) solve (A Sigma_0 A^T + sigma_s^2 I) u = y - A x0;  mat = A^T u
        dct_basis = self.image_base_covariance.startswith("dct")
        cov_vbar = None
        if not dct_basis:
            lr_trace = torch.sum(cov.M * torch.bmm(cov.Ut, cov.Ut.transpose(1, 2)),
                                 dim=(-2, -1))
            cov_vbar = (torch.sum(cov.diag, dim=-1) + lr_trace) / cov.diag.shape[-1]
        recycle = self.cg_warm_start == "prev"
        recycle_kw = (dict(u_init=state.prev_u, u_init_valid=state.step > 0,
                           return_u=True) if recycle else {})
        solved = choose_solver(self.forward_operator, y.float(), x0,
                               cov_mv=lambda v: self.cov_matvec_pixel(cov, v),
                               method=self.solver_type, max_rtol=self.max_rtol,
                               sigma_t=sigma, use_rtol_func=self.use_rtol_func,
                               maxiter=self.cg_maxiter, cov_trace_mean=cov_vbar,
                               return_info=True, precondition=self.cg_precondition,
                               stall_iters=self.cg_stall_iters,
                               cov_dct_diag=lowrank.diag_of(cov) if dct_basis else None,
                               rtol_floor=self.rtol_floor,
                               track_best=self.cg_track_best,
                               cg_coords=self.cg_coords, **recycle_kw)
        if recycle:
            mat, cg_info, u_next = solved
        else:
            (mat, cg_info), u_next = solved, state.prev_u

        # (5) guidance gradient with the large-update fallback
        fallback = self.cov_matvec_pixel(cov, mat) / sigma**2

        def guarded(g):
            s = torch.std((g * sigma**2).reshape(g.shape[0], -1), dim=-1, correction=0)
            use_fb = s > self.denoiser_mean_error_threshold
            return torch.where(use_fb[:, None, None, None], fallback, g)

        if self.guidance_gradient == "covariance":
            grad = fallback
        elif self.guidance_gradient == "hybrid":
            grad = guarded(pullback(mat)) if sigma < self.guidance_vjp_below else fallback
        else:
            grad = guarded(pullback(mat))
        update = grad * self.cond_scaling * sigma**2
        if self.guidance_update_bound is not None:
            gb = float(self.guidance_update_bound)
            update = torch.clamp(update, -gb, gb)
        # a chain whose solve diverged falls back to the unguided mean
        update = torch.where(torch.isfinite(update), update, torch.zeros_like(update))
        x0_new = x0 + update
        # a non-finite recycled start would poison every later solve
        u_next = torch.where(torch.isfinite(u_next), u_next, torch.zeros_like(u_next))
        new_state = FreeHunchState(
            cov=cov, prev_sigma=sigma, prev_x=x_t, prev_mean=x0, prev_u=u_next,
            step=state.step + 1, cg_niter=cg_info.niter,
            cg_resnorm=torch.mean(cg_info.residual_norm).float(),
            cg_optfrac=torch.mean(cg_info.optimal.float()),
            cg_host_syncs=cg_info.host_syncs)
        return x0_new, new_state

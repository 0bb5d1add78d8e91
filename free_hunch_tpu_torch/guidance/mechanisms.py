"""Conditioning mechanisms: x0_mean <- x0_mean + sigma^2 * grad log p(y | x_t).

Counterpart of ``free_hunch_tpu/guidance/mechanisms.py``: the factory
``choose_conditioning_mechanism`` (:43-59), ``EmptyState``, the
``ConditioningMechanism`` base and the seven stateless mechanisms (DPS,
PiGDM, PiGDM-videodiff, PengConvert, PengAnalytic, TMPD, DiffPIR; :62-240),
and Free Hunch (``online_covariance``; ``FreeHunchState``, ``FreeHunch``,
:247-701). Where the JAX package branches with ``lax.cond`` on traced
values, the port branches in Python on host values: ``sigma`` and the step
count live on the host, and ``x_changed`` (one batch-global comparison) is
the only device read, made only when a space update or a re-evaluation
could follow. Per-sample decisions (BFGS guards, the large-update fallback)
stay on the device as ``torch.where``. Host scalars that the JAX package
computes in f32 (variances from sigma) are computed in f32 here too.

Guidance gradients are ``torch.autograd.grad`` of x0_mean with respect to
x_t against a cotangent, through the UNet with frozen parameters.
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

_F32 = np.float32


def _mle_var(sigma) -> float:
    """sigma^2 / (1 + sigma^2) in f32 arithmetic."""
    s2 = _F32(sigma) * _F32(sigma)
    return float(s2 / (_F32(1.0) + s2))


def _analytic_var(dataset: str, sigma) -> float:
    """The recon_mse table's variance at the tabulated sigma nearest to
    ``sigma`` (f32, first of ties)."""
    t = assets.recon_mse(dataset)
    sig = np.asarray(t["sigmas"], _F32)
    return float(np.asarray(t["mse_list"], _F32)[np.argmin(np.abs(sig - _F32(sigma)))])


def choose_conditioning_mechanism(name: str):
    table = {
        "dps": DPS,
        "pigdm": PiGDM,
        "pigdm_videodiff_schedule": PiGDMVideodiffSchedule,
        "online_covariance": FreeHunch,
        "peng_convert": PengConvert,
        "peng_analytic": PengAnalytic,
        "tmpd": TMPD,
        "diffpir": DiffPIR,
    }
    if name == "ddnm":
        raise ValueError("ddnm runs through the dedicated DDNM+ sampler "
                         "(free_hunch_tpu_torch.samplers.ddnm), not a conditioning "
                         "mechanism")
    if name not in table:
        raise ValueError(f"Unknown conditioning mechanism: {name}")
    return table[name]


def _denoise_with_vjp(denoise: Callable, x_t: torch.Tensor, sigma):
    """One forward through the denoiser; returns (x0_mean, x0_var, pullback)
    with pullback(ct) = d(ct . x0_mean)/d x_t. The last pullback frees the
    graph; an earlier one passes ``retain_graph=True``. x0_var is not
    differentiated."""
    x = x_t.detach().requires_grad_(True)
    with torch.enable_grad():
        x0, x0_var = denoise(x, sigma)

    def pullback(ct, retain_graph=False):
        (g,) = torch.autograd.grad(x0, x, grad_outputs=ct, retain_graph=retain_graph)
        return g

    return x0.detach(), x0_var.detach(), pullback


class EmptyState(NamedTuple):
    """State of the stateless mechanisms: the call count and the last
    solve's CG record (closed forms: 0 iterations, no host sync)."""
    step: int
    cg_niter: int               # iterations of the last mat solve
    cg_resnorm: torch.Tensor    # () f32 batch-mean final residual norm
    cg_optfrac: torch.Tensor    # () f32 fraction of rows converged to rtol
    cg_host_syncs: int          # host syncs of the last solve


def _record_cg(state, info):
    """Stamp a solve's CGInfo onto the mechanism state."""
    return state._replace(cg_niter=info.niter,
                          cg_resnorm=torch.mean(info.residual_norm).float(),
                          cg_optfrac=torch.mean(info.optimal.float()),
                          cg_host_syncs=info.host_syncs)


@dataclasses.dataclass(frozen=True)
class ConditioningMechanism:
    """Base: clips the updated x0_mean to [-1, 1] when configured."""
    cond_scaling: float
    forward_operator: object
    clip_x0_mean: bool = False
    pigdm_posthoc_scaling: bool = False
    max_rtol: float = 1.0
    use_rtol_func: bool = False
    cg_maxiter: Optional[int] = None

    def init_state(self, batch: int, img_shape: Tuple[int, ...]):
        dev = self.forward_operator.device
        return EmptyState(step=0, cg_niter=0, cg_resnorm=torch.zeros((), device=dev),
                          cg_optfrac=torch.ones((), device=dev), cg_host_syncs=0)

    def __call__(self, denoise: Callable, x_t, y, sigma, state):
        x0_new, state = self.x0_mean_update(denoise, x_t, y, float(_F32(sigma)), state)
        if self.clip_x0_mean:
            x0_new = torch.clamp(x0_new, -1.0, 1.0)
        return x0_new, state

    def _bump(self, state):
        return state._replace(step=state.step + 1)

    def _solve_and_guide(self, x0, pullback, y, sigma, state, theta0_var,
                         scale=None, **solver_kw):
        """The stateless mechanisms' tail: solve ``(A C A^T + sigma_s^2 I) u
        = y - A x0`` for ``mat = A^T u`` on the scipy budget, pull the
        guidance gradient back through the denoiser, return
        ``x0 + grad * scale * sigma^2`` and record the solve."""
        mat, info = choose_solver(self.forward_operator, y, x0, theta0_var=theta0_var,
                                  method="scipy", max_rtol=self.max_rtol,
                                  maxiter=self.cg_maxiter, return_info=True, **solver_kw)
        grad = pullback(mat.detach())
        s = self.cond_scaling if scale is None else scale
        return x0 + grad * s * sigma**2, _record_cg(self._bump(state), info)


@dataclasses.dataclass(frozen=True)
class DPS(ConditioningMechanism):
    """Diffusion posterior sampling: the gradient of ||y - A x0(x_t)||
    through the denoiser. cond_scaling = zeta."""

    def x0_mean_update(self, denoise, x_t, y, sigma, state):
        x = x_t.detach().requires_grad_(True)
        with torch.enable_grad():
            x0, _ = denoise(x, sigma)
            diff = y - self.forward_operator.forward(x0, noiseless=True)
            # per-sample norms summed: batch samples stay independent
            norms = torch.sqrt(torch.sum(diff.reshape(diff.shape[0], -1) ** 2, dim=-1))
            (g,) = torch.autograd.grad(torch.sum(norms), x)
        return x0.detach() - self.cond_scaling * g * sigma**2, self._bump(state)


@dataclasses.dataclass(frozen=True)
class PiGDM(ConditioningMechanism):
    """Pseudo-inverse guided diffusion with the MLE variance sigma^2/(1+sigma^2)."""

    def x0_mean_update(self, denoise, x_t, y, sigma, state):
        x0, _, pullback = _denoise_with_vjp(denoise, x_t, sigma)
        x0_var = _mle_var(sigma)
        scale = (x0_var if self.pigdm_posthoc_scaling else 1.0) * self.cond_scaling
        return self._solve_and_guide(x0, pullback, y, sigma, state, x0_var, scale=scale)


@dataclasses.dataclass(frozen=True)
class PiGDMVideodiffSchedule(ConditioningMechanism):
    """PiGDM with the videodiff variance schedule x0_var = sigma^2."""

    def x0_mean_update(self, denoise, x_t, y, sigma, state):
        x0, _, pullback = _denoise_with_vjp(denoise, x_t, sigma)
        return self._solve_and_guide(x0, pullback, y, sigma, state,
                                     float(_F32(sigma) * _F32(sigma)))


@dataclasses.dataclass(frozen=True)
class PengConvert(ConditioningMechanism):
    """Peng et al. 'convert': the network's learned per-pixel x0 variance
    below the threshold, sigma^2/(1+sigma^2) per pixel above it."""
    mle_sigma_thres: float = 0.2

    def x0_mean_update(self, denoise, x_t, y, sigma, state):
        x0, x0_var, pullback = _denoise_with_vjp(denoise, x_t, sigma)
        var = x0_var if sigma < self.mle_sigma_thres else torch.full_like(
            x0_var, _mle_var(sigma))
        return self._solve_and_guide(x0, pullback, y, sigma, state, var)


@dataclasses.dataclass(frozen=True)
class PengAnalytic(ConditioningMechanism):
    """Peng et al. 'analytic': the recon_mse table's per-sigma average
    reconstruction MSE below the threshold, sigma^2/(1+sigma^2) above."""
    mle_sigma_thres: float = 0.2
    dataset: str = "imagenet"

    def x0_mean_update(self, denoise, x_t, y, sigma, state):
        x0, _, pullback = _denoise_with_vjp(denoise, x_t, sigma)
        var = (_analytic_var(self.dataset, sigma) if sigma < self.mle_sigma_thres
               else _mle_var(sigma))
        return self._solve_and_guide(x0, pullback, y, sigma, state, var)


@dataclasses.dataclass(frozen=True)
class TMPD(ConditioningMechanism):
    """Tweedie moment-projected diffusion: per-pixel variance from the row
    sums of the denoiser Jacobian, sigma^2 * d(sum x0)/dx_t. One forward
    serves the variance probe and the guidance gradient: the probe's
    pullback keeps the graph for the second."""

    def x0_mean_update(self, denoise, x_t, y, sigma, state):
        x0, _, pullback = _denoise_with_vjp(denoise, x_t, sigma)
        x0_var = pullback(torch.ones_like(x0), retain_graph=True) * sigma**2
        return self._solve_and_guide(x0, pullback, y, sigma, state, x0_var.detach(),
                                     sigma_t=sigma, use_rtol_func=True)


@dataclasses.dataclass(frozen=True)
class DiffPIR(ConditioningMechanism):
    """Plug-and-play data proximal step: x0 + var * mat with
    var = sigma^2 / lambda. No gradient through the network."""
    diffpir_lambda: float = 10.0

    def x0_mean_update(self, denoise, x_t, y, sigma, state):
        with torch.no_grad():
            x0, _ = denoise(x_t, sigma)
        x0_var = float(_F32(sigma) * _F32(sigma) / _F32(self.diffpir_lambda))
        mat, info = choose_solver(self.forward_operator, y, x0, theta0_var=x0_var,
                                  method="scipy", max_rtol=self.max_rtol,
                                  maxiter=self.cg_maxiter, return_info=True)
        return x0 + mat * x0_var, _record_cg(self._bump(state), info)


# ---------------------------------------------------------------------------
# Free Hunch (the paper's contribution)
# ---------------------------------------------------------------------------

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


@dataclasses.dataclass(frozen=True)
class FreeHunch(ConditioningMechanism):
    """Online denoiser-covariance guidance. Per call: time update of the
    covariance with analytic transport of the previous denoiser mean, gated
    BFGS space update, tailored CG solve against Sigma_0 (below
    ``mle_sigma_thres`` against the recon_mse variance instead, with
    ``use_analytic_var_at_end``), and the guidance gradient (vjp of ``mat``
    through the UNet, with the large-update fallback Sigma_0 mat / sigma^2).
    The knobs and their reasons are the JAX class's. ``algebra_dtype``
    ('float32', the default, or 'float64') is the dtype of the covariance
    state, the basis changes and the CG solve; the denoiser and its vjp stay
    f32. ``cov_partition`` (a sharded covariance) is not ported and raises."""
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
    mle_sigma_thres: float = 0.2
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
    cg_coords: str = "auto"
    cg_warm_start: str = "b"
    transport_formula: str = "telescoped"
    guidance_gradient: str = "vjp"
    guidance_vjp_below: float = 1.0
    cov_partition: Optional[Tuple[Optional[str], Optional[str]]] = None

    def __post_init__(self):
        if self.algebra_dtype not in (None, "float32", "float64"):
            raise ValueError(f"algebra_dtype must be None, 'float32' or 'float64', "
                             f"got {self.algebra_dtype!r}")
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

    @property
    def _adt(self) -> torch.dtype:
        """The algebra dtype."""
        return torch.float64 if self.algebra_dtype == "float64" else torch.float32

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
            flat = np.asarray(dv, np.float64 if self._adt == torch.float64 else np.float32)
            return torch.as_tensor(flat.reshape(-1)[:d], device=device)
        if self.image_base_covariance in ("dct_diagonal_noinfo", "identity"):
            return torch.full((d,), float(self.init_denoiser_variance),
                              dtype=self._adt, device=device)
        raise ValueError(f"unknown image_base_covariance {self.image_base_covariance!r}")

    def init_state(self, batch: int, img_shape: Tuple[int, ...]) -> FreeHunchState:
        dev = self.forward_operator.device
        d = int(np.prod(img_shape))
        cov = cov_mod.init_state(self._init_diag(img_shape, dev), batch, d,
                                 self.cov_capacity)
        zeros = torch.zeros((batch,) + tuple(img_shape), dtype=self._adt, device=dev)
        u_shape = (batch,) + tuple(self.forward_operator.out_shape[1:])
        return FreeHunchState(
            cov=cov, prev_sigma=0.0, prev_x=zeros, prev_mean=zeros,
            prev_u=torch.zeros(u_shape, dtype=self._adt, device=dev), step=0,
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
        # the denoiser and its vjp run in f32; the covariance algebra and the
        # CG solve in the algebra dtype, which an f32 sigma converts to exactly
        if self.guidance_gradient == "covariance":
            with torch.no_grad():
                x0, _ = denoise(x_t.float(), sigma)
            pullback = None
        else:
            x0, _, pullback = _denoise_with_vjp(denoise, x_t.float(), sigma)
        adt = self._adt
        x_t, y, x0_a = x_t.to(adt), y.to(adt), x0.to(adt)

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
                prev_mean_b = self._to_basis(m.to(adt))
            # (3) gated BFGS space update
            if changed and in_window:
                params = cov_mod.CovParams(
                    project_to_diagonal=self.project_to_diagonal,
                    curvature_guard=self.bfgs_curvature_guard,
                    secant_novelty_min=self.bfgs_secant_novelty_min)
                cov = cov_mod.space_update(cov, sigma, prev_x_b, self._to_basis(x_t),
                                           prev_mean_b, self._to_basis(x0_a), params)
        elif sigma_changed:
            cov = cov_mod.time_update(state.cov, state.prev_sigma, sigma)

        # (4) solve (A Sigma_0 A^T + sigma_s^2 I) u = y - A x0;  mat = A^T u
        dct_basis = self.image_base_covariance.startswith("dct")
        # the mean eigenvalue of Sigma_0 per sample: the scalar preconditioner
        # of the solvers that take no spectrum (inpainting, identity basis)
        lr_trace = torch.sum(cov.M * torch.bmm(cov.Ut, cov.Ut.transpose(1, 2)), dim=(-2, -1))
        cov_vbar = (torch.sum(cov.diag, dim=-1) + lr_trace) / cov.diag.shape[-1]
        recycle = self.cg_warm_start == "prev"
        recycle_kw = (dict(u_init=state.prev_u, u_init_valid=state.step > 0,
                           return_u=True) if recycle else {})
        analytic_case = self.use_analytic_var_at_end and sigma < self.mle_sigma_thres
        if analytic_case:
            # below the threshold the solve takes the recon_mse variance on
            # the scipy budget, with the mechanism's CG knobs
            var = _analytic_var(self.dataset, sigma)
            solved = choose_solver(self.forward_operator, y, x0_a,
                                   theta0_var=torch.full_like(x0_a, var), method="scipy",
                                   max_rtol=self.max_rtol, sigma_t=sigma,
                                   use_rtol_func=self.use_rtol_func, maxiter=self.cg_maxiter,
                                   return_info=True, precondition=self.cg_precondition,
                                   stall_iters=self.cg_stall_iters,
                                   rtol_floor=self.rtol_floor,
                                   track_best=self.cg_track_best, **recycle_kw)
        else:
            solved = choose_solver(self.forward_operator, y, x0_a,
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

        # (5) guidance gradient with the large-update fallback; where mat was
        # solved against var * I, every non-vjp gradient is var * mat / sigma^2
        if analytic_case:
            fallback = (var * mat / sigma**2).float()
        else:
            fallback = (self.cov_matvec_pixel(cov, mat) / sigma**2).float()

        def guarded(g):
            if analytic_case:
                return g
            s = torch.std((g * sigma**2).reshape(g.shape[0], -1), dim=-1, correction=0)
            use_fb = s > self.denoiser_mean_error_threshold
            return torch.where(use_fb[:, None, None, None], fallback, g)

        if self.guidance_gradient == "covariance":
            grad = fallback
        elif self.guidance_gradient == "hybrid":
            grad = (guarded(pullback(mat.float())) if sigma < self.guidance_vjp_below
                    else fallback)
        else:
            grad = guarded(pullback(mat.float()))
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
            cov=cov, prev_sigma=sigma, prev_x=x_t, prev_mean=x0_a, prev_u=u_next.to(adt),
            step=state.step + 1, cg_niter=cg_info.niter,
            cg_resnorm=torch.mean(cg_info.residual_norm).float(),
            cg_optfrac=torch.mean(cg_info.optimal.float()),
            cg_host_syncs=cg_info.host_syncs)
        return x0_new, new_state

"""What decides ``correct``: the program's guided calls and Heun steps,
sampled from the seed, judged against the plain reference.

Whole trajectories cannot be compared: rounding moves them chaotically
(the DCT prior's unobserved directions, CG stopping rules), so the check
follows the program stage by stage from its own state, and judges each
stage by itself from the stage before it:

* ``start``: the first call's x (sigma0 times the initial noise) and the
  covariance's initial state (the prior's diagonal, no columns), exactly;
* ``unet``: the denoiser D(x_t) (the program's unguided mean of the call)
  against the reference's float32 UNet, relative to the denoiser's move
  (sigma F) where the reference does not clip it to [-1, 1];
* ``cov``: the covariance after the call's time and space updates, from
  the state the call found and the program's D, applied to three probes
  (random, the secant x_t - prev_x, the guidance direction): its distance
  from the update in float64 over the reference's own float32 distance on
  the same state (floored at a float32 ulp of the product's terms);
* ``cg``, ``cg_floor``: the residual of the program's CG solution in the
  guidance system of its own D and covariance, over the larger of the
  tolerance the schedule asks and the residual the reference's own float32
  CG reaches on that system from the same start (a row whose system the CG
  cannot improve, as an indefinite covariance gives, reads 1 on both
  sides); ``cg`` for the calls whose tolerance is 1e-3 or looser (sigma
  above about 0.2), which the CG has to meet, ``cg_floor`` for the others,
  whose tolerance lies at float32's floor, where rounding sets where a CG
  stalls;
* ``guide``: the guided output D + sigma^2 g (g the vjp through the
  reference UNet of the program's A^T u, or the covariance gradient where
  the guard takes it), beyond two float32 ulps of the output, relative to
  the update sigma^2 g or, where larger, the size of the covariance
  gradient's terms;
* ``heun``: the step's predictor and result from the program's two guided
  outputs.

Each number is the worst over the sampled calls and the batch's images.
Where the program's decision lies within rounding of its threshold, either
branch is taken as sound: the BFGS pair's guards (curvature, novelty) and
the vjp guard's spread against 0.2. Which pixels D clips to [-1, 1] is the
judged D's to say (the unet number judges that D): the reference's pullback
takes its clip from there, and a pixel that D clips but whose reference
value lies within rounding of the clip is left out of ``guide`` (the
program's value may have landed exactly on the clip, where the clip's
gradient passes). Rounding there is the larger of 5% of the pixel's sigma F
and, in the vjp's branch, the torso's own largest distance from the
reference in that image, read where D does not clip (there D is the value
before the clip): the torso's error at one pixel is not a share of that
pixel's sigma F. A covariance applied to a vector can cancel
(the BFGS pairs shrink it in the directions they saw), so ``guide`` is
relative to the size of the product's terms (``freehunch.magnitude``),
which rounding of a cancelling sum is relative to; the update's inverses
amplify rounding by their conditioning, so ``cov`` is relative to what
float32 does on the same state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from reference import freehunch as ref_fh

NUMBERS = ("start", "unet", "cov", "cg", "cg_floor", "guide", "heun")
GUARD = 0.2          # the vjp guard's threshold (denoiser_mean_error_threshold)
GUARD_BAND = 0.05    # a spread within 5% of it may fall either side
SECANT_BAND = 1e-3   # a BFGS guard within this (relative) of its threshold too
EDGE = 0.05          # a clipped pixel within 5% of sigma F of the clip
EPS32 = 2.0 ** -23
TOL_BOUND = 1e-3     # a CG tolerance this loose or looser lies far above float32's floor


def _rel(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per row ||a - b|| / ||scale||, in float64."""
    n = a.shape[0]
    d = (a.double() - b.double()).reshape(n, -1)
    s = scale.double().reshape(n, -1)
    return torch.linalg.vector_norm(d, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(s, dim=-1), min=1e-30)


class Judge:
    """The reference side of a cell, for one seed: its denoiser family
    (``fam``, ``reference/<family>.py``), weights, basis, schedule and
    probes."""

    def __init__(self, fam, arch, p32: Dict[str, torch.Tensor], prior: dict,
                 steps: int, check: dict, gradient: str, seed: int, device):
        self.fam, self.arch, self.p, self.gradient = fam, arch, p32, gradient
        self.rows = check["rows"]
        self.control_algebra = check["control_algebra"]
        self.control_torso = check["control_torso"]
        self.sched = ref_fh.schedule(steps, fam.snap_grid(arch), fam.sigma_range(arch))
        self.basis = ref_fh.Basis(prior["name"])
        self.seed, self.device = seed, device

    # -- the numbers of one guided call ------------------------------------------

    def call(self, x_t, sigma, before: ref_fh.Before, y, op, out: dict) -> Dict[str, float]:
        """The numbers of one guided call. ``out``: the judged side's
        outputs: ``D`` its denoiser output, ``cov`` its covariance after
        the call, ``u`` its CG solution, ``x0`` its guided output,
        ``pre_ref`` the reference's denoiser at x_t before its clip and
        ``vjp_ref`` the reference's pullback of the judged side's A^T u (vjp
        cells)."""
        sigma = float(np.float32(sigma))
        D, cov, u, x0 = out["D"], out["cov"], out["u"], out["x0"]
        # the denoiser against the reference's, relative to sigma F where the
        # reference does not clip it
        pre = out["pre_ref"]
        inside = (torch.abs(pre) < 1.0).double()
        nums = {"unet": float(torch.max(_rel(D, torch.clamp(pre, -1.0, 1.0),
                                              (x_t - pre) * inside)))}
        # a pixel D clips, within rounding of the clip: its gradient passes
        # where the program's value lay exactly on it (the clip's gradient is
        # 1 there), which D cannot show; left out of ``guide``
        edge = clip_edge(D, pre, x_t)
        edge_v = clip_edge(D, pre, x_t, torso_band(D, pre))
        # the covariance after the call from the state it found and D
        # against the update in float64, over the reference's own float32
        # error on this state: the update inverts matrices whose conditioning
        # (the columns the BFGS pairs added) sets both errors (a pair whose
        # guard lies within rounding of its threshold may be taken or not)
        with ref_fh.tf32(False):
            cov32, margin = ref_fh.cov_update(before, x_t.float(), D.float(), sigma, self.basis)
            near = margin < SECANT_BAND
            b64 = ref_fh.Before(ref_fh.cov_to(before.cov, torch.float64), before.prev_sigma,
                                before.prev_x.double(), before.prev_mean.double(),
                                before.prev_u.double(), before.step)
            flips = [None] + ([near] if bool(near.any()) else [])
            refs = [(ref_fh.cov_update(before, x_t.float(), D.float(), sigma, self.basis,
                                       flip=f)[0],
                     ref_fh.cov_update(b64, x_t.double(), D.double(), sigma, self.basis,
                                       flip=f)[0]) for f in flips]
        mat = ref_fh.mat_of(op, u.float())
        gen = torch.Generator(device=x_t.device).manual_seed(self.seed % (2 ** 63))
        probes = [torch.randn(x_t.shape, generator=gen, device=x_t.device),
                  x_t.float() - before.prev_x.float(), mat]
        gap = torch.zeros(x_t.shape[:1], dtype=torch.float64, device=x_t.device)
        for v in probes:
            vb = self.basis.to(v.double())
            a = ref_fh.matvec(ref_fh.cov_to(cov, torch.float64), vb)
            g = None
            for r32, r64 in refs:
                exact = ref_fh.matvec(r64, vb)
                own = torch.linalg.vector_norm(
                    (ref_fh.matvec(ref_fh.cov_to(r32, torch.float64), vb) - exact), dim=-1)
                floor = EPS32 * torch.linalg.vector_norm(ref_fh.magnitude(r64, vb), dim=-1)
                gv = torch.linalg.vector_norm(a - exact, dim=-1) / torch.maximum(own, floor)
                g = gv if g is None else torch.where(near, torch.minimum(g, gv), g)
            gap = torch.maximum(gap, torch.nan_to_num(g, nan=0.0))
        nums["cov"] = float(torch.max(gap))
        # the CG's answer by its residual, against what the reference's own
        # float32 CG reaches on the same system from the same start
        u_ref, _ = self.cg_ref(op, before, cov, D, y, ref_fh.rtol_schedule(sigma))
        nums.update([self.cg_number(op, cov, D, y, u, u_ref, sigma)])
        # the guided output x0 = D + sigma^2 g, either branch of the guard
        # where it is close, beyond two float32 ulps of the output (the sum
        # rounds an update far below D away)
        with ref_fh.tf32(False):
            fb = ref_fh.fallback(self.basis, ref_fh.cov_to(cov, torch.float32), mat, sigma)
        # the covariance gradient's terms' size (an orthonormal basis keeps norms)
        scale = torch.linalg.vector_norm(ref_fh.magnitude(
            ref_fh.cov_to(cov, torch.float64), self.basis.to(mat.double())), dim=-1)
        gap = self._guided(x0, D, fb, sigma, scale, edge)
        if self.gradient != "covariance":
            gv = out["vjp_ref"]
            spread = ref_fh.guard_std(gv, sigma)
            gap_v = self._guided(x0, D, gv, sigma, scale, edge_v)
            near = torch.abs(spread / GUARD - 1.0) < GUARD_BAND
            gap = torch.where(near, torch.minimum(gap_v, gap), torch.where(spread > GUARD, gap,
                                                                            gap_v))
        nums["guide"] = float(torch.max(gap))
        return nums

    def cg_ref(self, op, before: ref_fh.Before, cov, D, y, rtol: float, maxiter: int = 5000):
        """The reference's float32 CG on the call's guidance system (the
        judged D and covariance) from the call's start: (u, iterations)."""
        with ref_fh.tf32(False):
            sys32 = ref_fh.system(op, self.basis, ref_fh.cov_to(cov, torch.float32), D.float(), y)
            return ref_fh.cg(sys32, before.prev_u.float() if before.step > 0 else sys32.b,
                             rtol, maxiter)

    def cg_number(self, op, cov, D, y, u, u_ref, sigma: float):
        """(name, number): u's residual over the larger of the tolerance and
        u_ref's. ``cg`` where the tolerance is TOL_BOUND or looser, so the
        CG has to meet it; ``cg_floor`` below, where float32 rounding sets
        where a CG stops."""
        rtol = ref_fh.rtol_schedule(sigma)
        rho = ref_fh.rel_residual(op, self.basis, cov, D.float(), y, u.float())
        rho_ref = ref_fh.rel_residual(op, self.basis, cov, D.float(), y, u_ref)
        return ("cg" if rtol >= TOL_BOUND else "cg_floor",
                float(torch.max(rho / torch.clamp(rho_ref, min=rtol))))

    @staticmethod
    def _guided(x0, D, g, sigma: float, scale, edge) -> torch.Tensor:
        """Per row: the judged x0 against D + sigma^2 g summed in float32,
        beyond two ulps of the sum and off the ``edge`` pixels, relative to
        the update sigma^2 g or, where larger, ``scale``."""
        upd = g.float() * 1.0 * sigma ** 2
        upd = torch.where(torch.isfinite(upd), upd, torch.zeros_like(upd))
        want = D.float() + upd
        ulp = torch.abs(torch.nextafter(want, torch.full_like(want, float("inf"))) - want)
        d = torch.clamp(torch.abs(x0.float() - want) - 2 * ulp, min=0.0) * (~edge)
        n = d.shape[0]
        size = torch.maximum(torch.linalg.vector_norm(upd.reshape(n, -1).double(), dim=-1), scale)
        return torch.linalg.vector_norm(d.reshape(n, -1).double(), dim=-1) / \
            torch.clamp(size, min=1e-30)

    def heun(self, i: int, x_hat, d1, x_prime, d2, x_next) -> float:
        """The step's predictor and result against the reference's Heun
        update from the judged side's guided outputs."""
        pred, nxt = ref_fh.heun(x_hat.float(), d1.float(), x_prime.float()
                                if x_prime is not None else None,
                                d2.float() if d2 is not None else None, self.sched, i)
        worst = float(torch.max(_rel(x_next, nxt, nxt - x_hat.float())))
        if x_prime is not None:
            worst = max(worst, float(torch.max(_rel(x_prime, pred, pred - x_hat.float()))))
        return worst


def denoise_rows(fam, p, arch, x: torch.Tensor, sigma: float, rows: int,
                 pullbacks=(), rounding=None):
    """The family ``fam``'s reference denoiser before its clip (D = clip(pre,
    -1, 1)) and, for each (cotangent c, judged D) of ``pullbacks``, the
    pullback of c through D with the clip's gradient where the judged D lies
    strictly inside [-1, 1] (which pixels a D clips is the judged D's to
    say, and the unet number judges that D); in blocks of ``rows`` samples
    (each block's graph freed before the next). ``rounding`` goes to
    ``fam.preclamp``. Returns (pre, [pullbacks])."""
    outs, pulls = [], [[] for _ in pullbacks]
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows].detach()
        if not pullbacks:
            with torch.no_grad():
                outs.append(fam.preclamp(p, arch, xb, sigma, rounding))
            continue
        xb = xb.clone().requires_grad_(True)
        with torch.enable_grad():
            pre = fam.preclamp(p, arch, xb, sigma, rounding)
            for j, (ct, judged) in enumerate(pullbacks):
                m = (torch.abs(judged[s:s + rows]) < 1.0).to(pre.dtype)
                (g,) = torch.autograd.grad(pre, xb, ct[s:s + rows] * m,
                                           retain_graph=j < len(pullbacks) - 1)
                pulls[j].append(g)
        outs.append(pre.detach())
    return torch.cat(outs), [torch.cat(g) for g in pulls]


def torso_band(D, pre) -> torch.Tensor:
    """Per row, the judged torso's largest distance from the reference's
    denoiser before its clip, over the pixels D does not clip (where D is
    the torso's value before the clip), shaped to broadcast over D."""
    inside = torch.abs(D) < 1.0
    d = torch.where(inside, torch.abs(D.float() - pre.float()), torch.zeros_like(pre.float()))
    return d.reshape(d.shape[0], -1).amax(dim=1).reshape((-1,) + (1,) * (D.dim() - 1))


def clip_edge(D, pre, x_t, band=None) -> torch.Tensor:
    """The pixels D clips whose reference value before the clip lies within
    rounding of the clip: 5% of the pixel's sigma F, or ``band`` where
    larger, and four float32 ulps."""
    room = EDGE * torch.abs(x_t - pre)
    if band is not None:
        room = torch.maximum(room, band)
    return (torch.abs(D) == 1.0) & (torch.abs(torch.abs(pre) - 1.0) <= room + 4 * EPS32)


def start(x0, noise, sigma0: float, diag, prior_diag, zeros: torch.Tensor) -> float:
    """The first call's x and initial state against sigma0 * noise and the
    prior: the largest absolute difference (and the largest entry of what
    starts at zero: U, M - I, k, the previous x, mean and solution)."""
    want = noise.float() * sigma0
    return max(float(torch.max(torch.abs(x0.double() - want.double()))),
               float(torch.max(torch.abs(diag.double() - prior_diag.double()[None]))),
               float(torch.max(zeros.double())))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number present, finite and within its limit."""
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)

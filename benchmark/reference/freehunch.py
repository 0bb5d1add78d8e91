"""Free Hunch's guided call and the EDM Heun step, in plain PyTorch.

A frozen, plain copy of the algorithm the program runs (Rissanen et al.,
ICLR 2025: the denoiser covariance as diag + U M U^T in a DCT or pixel
basis, moved between noise levels by a time update, refined by BFGS
secant pairs, and used in the CG solve of the guidance system), cut to
what the benchmark's cells run: the convolution and mask operators
(``operators/<name>.py`` builds each cell's), the DCT-diagonal and
identity priors, the telescoped score transport, the vjp and covariance
gradients, CG recycling its previous solution. Every function takes
plain tensors; float32 is the configured precision, and ``tf32`` runs a
block with TF32 matmuls, the precision below it, for the control.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import numpy as np
import torch

F32 = np.float32


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 (``on``) or full float32 inside."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (abs-max to
    448), back in t's type: the control's torso operands, as a family's
    forward takes them through its ``rounding`` hook."""
    s = torch.clamp(t.detach().abs().amax(), min=1e-30) / 448.0
    q = (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach()


# -- the EDM schedule (linear sigma, no scaling, no churn) ----------------------

def schedule(steps: int, grid64, net_range, sigma_min: float = 0.002,
             sigma_max: float = 80.0, rho: float = 7.0) -> dict:
    """Per-step arrays of the Heun sampler (float32, as the sampler reads
    them) and ``sigma0``, the initial noise's scale. ``net_range`` is the
    denoiser's (sigma_min, sigma_max), which bounds the sampler's. Sigmas
    snap to the denoiser's grid (``grid64``, float64; its float32 values
    are the snapped sigmas) or, where ``grid64`` is None (a continuous-sigma
    denoiser), stay as the discretisation gives them."""
    lo = max(sigma_min, float(net_range[0]))
    hi = min(sigma_max, float(net_range[1]))
    i = np.arange(steps, dtype=np.float64)
    s = (hi ** (1 / rho) + i / (steps - 1) * (lo ** (1 / rho) - hi ** (1 / rho))) ** rho
    if grid64 is None:
        t = np.concatenate([s, [0.0]])
    else:
        grid = np.asarray(grid64).astype(F32)
        idx = np.argmin(np.abs(s.astype(np.float32)[:, None] - grid[None, :]), axis=1)
        t = np.concatenate([grid[idx].astype(np.float64), [0.0]])
    heun = np.arange(steps) < steps - 1
    h = t[1:] - t[:-1]
    with np.errstate(divide="ignore"):
        c = np.where(heun, 1.0 / np.where(heun, t[1:], 1.0), 0.0)
    return dict(sigma_hat=t[:-1].astype(F32), h=h.astype(F32), sigma_prime=t[1:].astype(F32),
                c1=c.astype(F32), c2=c.astype(F32), use_heun=heun, sigma0=float(t[0]))


def cov_capacity(sched: dict, lower: float = 1.0, upper: float = 10.0, slack: int = 2) -> int:
    """Two columns per guided call whose sigma lies inside the space-update
    window, plus slack."""
    sig = np.concatenate([sched["sigma_hat"].astype(np.float64),
                          sched["sigma_prime"].astype(np.float64)[sched["use_heun"]]])
    return max(2 * int(np.sum((sig > lower) & (sig < upper))) + slack, 2)


def heun(x_hat, d1, x_prime, d2, st: dict, i: int, dtype=torch.float32):
    """The step's predictor and its result from the two guided outputs:
    (x', x_next) with x' = x_hat + h d_cur and, on a Heun step, x_next =
    x_hat + h (d_cur + d') / 2; on the last (Euler) step x_next = x'.
    ``dtype`` is the arithmetic's type."""
    x_hat, d1 = x_hat.to(dtype), d1.to(dtype)
    h, s = float(st["h"][i]), float(st["sigma_hat"][i])
    d_cur = (x_hat - d1) / s
    pred = x_hat + h * d_cur
    if not st["use_heun"][i]:
        return pred, pred
    d_prime = float(st["c1"][i]) * x_prime.to(dtype) - float(st["c2"][i]) * d2.to(dtype)
    return pred, x_hat + h * (0.5 * d_cur + 0.5 * d_prime)


# -- operators -----------------------------------------------------------------

def otf(kernel: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """The kernel's optical transfer function on an (h, w) grid: zero-pad,
    roll its centre to the origin, FFT (complex64, (1, 1, h, w))."""
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    if kh > h or kw > w:   # a kernel larger than the grid keeps its centre
        ch, cw = min(kh, h), min(kw, w)
        k = k[(kh - ch) // 2:(kh - ch) // 2 + ch, (kw - cw) // 2:(kw - cw) // 2 + cw]
        kh, kw = ch, cw
    pad = np.zeros((h, w), np.complex64)
    pad[:kh, :kw] = k
    pad = np.roll(pad, (-(kh // 2), -(kw // 2)), axis=(0, 1))
    return torch.as_tensor(np.fft.fft2(pad).astype(np.complex64)[None, None], device=device)


def _cdt(x):
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


class Blur:
    """Circular convolution by a kernel: A x = real(ifft2(FB fft2(x))).

    An operator of the reference has ``forward``, ``adjoint``, ``precond``,
    ``mat`` (A^T u as the guidance takes it), ``residual`` (the guidance
    system's right-hand side), ``measure`` (y from a clean image and unit
    noise), ``sigma_s`` and ``spectral`` (the CG's preconditioner is the
    covariance's diagonal on the Fourier grid where the basis is the DCT)."""
    spectral = True

    def __init__(self, kernel: np.ndarray, h: int, w: int, sigma_s: float, device):
        self.FB = otf(kernel, h, w, device)
        self.sigma_s = float(max(F32(sigma_s), F32(0.001)))
        self.sigma_y = float(F32(sigma_s))

    def _apply(self, x, fb):
        return torch.fft.ifft2(fb.to(_cdt(x)) * torch.fft.fft2(x.to(_cdt(x)))).real.to(x.dtype)

    def forward(self, x):
        return self._apply(x, self.FB)

    def adjoint(self, u):
        return self._apply(u, torch.conj(self.FB))

    def precond(self, spec):
        """r -> (sigma_s^2 + spec |FB|^2)^-1 r in Fourier space, for a
        per-frequency (B, C, H, W) or per-sample (B, 1, 1, 1) variance."""
        denom = self.sigma_s ** 2 + spec * (torch.abs(self.FB) ** 2).to(spec.dtype)
        return lambda r: torch.fft.ifft2(torch.fft.fft2(r.to(_cdt(r))) / denom).real.to(r.dtype)

    def mat(self, u):
        return self.adjoint(u)

    def residual(self, y, x0):
        return y - self.forward(x0)

    def measure(self, clean, noise):
        return self.forward(clean) + self.sigma_y * noise


class Mask:
    """Inpainting: A x = mask * x, with one mask per sample (B, C, H, W).
    The solver's u lives in image space, zero where the mask is, and the
    guidance takes u itself as A^T u (``mat``)."""
    spectral = False

    def __init__(self, mask: torch.Tensor, sigma_s: float):
        self.mask = mask
        self.sigma_s = float(max(F32(sigma_s), F32(0.001)))
        self.sigma_y = float(F32(sigma_s))

    def forward(self, x):
        return x * self.mask.to(x.dtype)

    def adjoint(self, u):
        return u * self.mask.to(u.dtype)

    def precond(self, spec):
        denom = self.sigma_s ** 2 + spec * self.mask.to(spec.dtype)
        return lambda r: r / denom

    def mat(self, u):
        return u

    def residual(self, y, x0):
        return self.forward(y - x0)

    def measure(self, clean, noise):
        return self.forward(clean + self.sigma_y * noise)


# -- the basis of the covariance -------------------------------------------------

def dct_matrix(n: int, dtype, device) -> torch.Tensor:
    """The (n, n) orthonormal DCT-II matrix."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    mat = np.cos(np.pi * (2 * m + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    mat[0] *= np.sqrt(0.5)
    return torch.as_tensor(mat, dtype=dtype, device=device)


class Basis:
    """Pixel <-> covariance coordinates: the 2-D DCT for the DCT priors,
    the identity otherwise. Vectors are (B, d)."""

    def __init__(self, prior: str):
        self.dct = prior.startswith("dct")

    def to(self, x):
        if self.dct:
            c = dct_matrix(x.shape[-1], x.dtype, x.device)
            x = c @ x @ c.T
        return x.reshape(x.shape[0], -1)

    def back(self, v, shape):
        v = v.reshape((-1,) + tuple(shape))
        if self.dct:
            c = dct_matrix(v.shape[-1], v.dtype, v.device)
            v = c.T @ v @ c
        return v


# -- diag + U M U^T, one per sample ----------------------------------------------

class Cov(NamedTuple):
    diag: torch.Tensor   # (B, d)
    Ut: torch.Tensor     # (B, K, d), rows >= k zero
    M: torch.Tensor      # (B, K, K), inactive block the identity
    k: torch.Tensor      # (B,) int64


def cov_to(c: Cov, dtype) -> Cov:
    return Cov(c.diag.to(dtype), c.Ut.to(dtype), c.M.to(dtype), c.k)


def matvec(c: Cov, v):
    t = torch.bmm(c.M, torch.bmm(c.Ut, v.unsqueeze(-1)))
    return c.diag * v + torch.bmm(c.Ut.transpose(1, 2), t).squeeze(-1)


def magnitude(c: Cov, v):
    """|diag v| + |U| |M| |U^T v|: the size of the terms whose sum is
    ``matvec(c, v)``, which rounding of that sum is relative to (the BFGS
    pairs make it cancel in the directions they saw)."""
    t = torch.bmm(torch.abs(c.M), torch.abs(torch.bmm(c.Ut, v.unsqueeze(-1))))
    return torch.abs(c.diag * v) + torch.bmm(torch.abs(c.Ut).transpose(1, 2), t).squeeze(-1)


def diag_of(c: Cov):
    return c.diag + torch.einsum("bkd,bkd->bd", c.Ut, torch.bmm(c.M, c.Ut))


def _sym(a):
    return 0.5 * (a + a.transpose(-1, -2))


def inverse(c: Cov) -> Cov:
    """Woodbury: D^-1 + (D^-1 U) Mi (D^-1 U)^T, Mi = -(M^-1 + U^T D^-1 U)^-1."""
    di = 1.0 / c.diag
    uit = c.Ut * di[:, None, :]
    inner = _sym(_inv(c.M)) + _sym(torch.bmm(c.Ut, uit.transpose(1, 2)))
    return Cov(di, uit, -_sym(_inv(inner)), c.k)


def _inv(a):
    """The inverse of small K x K matrices (solved in float32 at least:
    the linear algebra library has no half-precision inverse)."""
    return torch.linalg.inv(a.float() if a.dtype in (torch.bfloat16, torch.float16)
                            else a).to(a.dtype)


def affine(c: Cov, alpha, beta) -> Cov:
    return Cov(c.diag * alpha + beta, c.Ut, c.M * alpha, c.k)


def select(mask, a: Cov, b: Cov) -> Cov:
    return Cov(torch.where(mask[:, None], a.diag, b.diag),
               torch.where(mask[:, None, None], a.Ut, b.Ut),
               torch.where(mask[:, None, None], a.M, b.M), torch.where(mask, a.k, b.k))


def compress(c: Cov, target: int) -> Cov:
    """Keep each row's ``target`` eigen-directions of U M U^T of largest
    |eigenvalue| (a row whose Gram matrix does not factor keeps none)."""
    K = c.Ut.shape[1]
    dtype, dev = c.diag.dtype, c.diag.device
    eye = torch.eye(K, dtype=dtype, device=dev)
    G = _sym(torch.bmm(c.Ut, c.Ut.transpose(1, 2)))
    jitter = (G.diagonal(dim1=-2, dim2=-1).sum(-1) / K) * 1e-7 + 1e-30
    L, info = torch.linalg.cholesky_ex(G + jitter[:, None, None] * eye)
    ok = info == 0
    L = torch.where(ok[:, None, None], L, eye)
    lam, Q = torch.linalg.eigh(_sym(L.transpose(1, 2) @ c.M @ L))
    Wt = Q.transpose(1, 2) @ torch.linalg.solve_triangular(L, c.Ut, upper=False)
    order = torch.argsort(-lam.abs(), dim=-1, stable=True)
    lam = torch.gather(lam, -1, order)
    Wt = torch.gather(Wt, 1, order[:, :, None].expand_as(Wt))
    strong = lam.abs() > 1e-6 * lam[:, :1].abs() + torch.finfo(dtype).tiny
    keep = (torch.arange(K, device=dev) < target)[None, :] & strong & ok[:, None]
    return Cov(c.diag, torch.where(keep[:, :, None], Wt, torch.zeros((), dtype=dtype, device=dev)),
               torch.diag_embed(torch.where(keep, lam, torch.ones((), dtype=dtype, device=dev))),
               keep.sum(-1).to(torch.int64))


def append_pair(c: Cov, a, wa, b, wb) -> Cov:
    """c + wa a a^T + wb b b^T per row, columns unit-normalised; a row
    that would overflow is first compressed to capacity - 2."""
    K = c.Ut.shape[1]
    need = c.k + 2 > K
    if bool(need.any()):
        c = select(need, compress(c, K - 2), c)
    tiny = torch.finfo(a.dtype).tiny
    na, nb = torch.sum(a * a, dim=-1), torch.sum(b * b, dim=-1)
    rows = torch.arange(c.k.shape[0], device=c.k.device)
    Ut, M = c.Ut.clone(), c.M.clone()
    Ut[rows, c.k] = a / torch.sqrt(torch.clamp(na, min=tiny))[:, None]
    Ut[rows, c.k + 1] = b / torch.sqrt(torch.clamp(nb, min=tiny))[:, None]
    M[rows, c.k, c.k] = wa * na
    M[rows, c.k + 1, c.k + 1] = wb * nb
    return Cov(c.diag, Ut, M, c.k + 2)


def space_update(c: Cov, sigma, x, x_next, m, m_next, novelty: float = 0.02, flip=None):
    """The BFGS secant pair of two denoiser outputs at one sigma, guarded
    by positive curvature and novelty; rows failing a guard keep c.
    Returns (c', margin): each row's distance from its guards' thresholds
    (relative); ``flip`` (B,) bool reverses the guards' decision of those
    rows."""
    dx = x_next - x
    de = sigma ** 2 * (m_next - m)
    sv = matvec(c, dx)
    tiny = torch.finfo(x.dtype).tiny
    dxsv, dxde = torch.sum(dx * sv, -1), torch.sum(dx * de, -1)
    res2 = torch.sum((de - sv) ** 2, -1)
    floor2 = novelty ** 2 * torch.maximum(torch.sum(de * de, -1), torch.sum(sv * sv, -1))
    valid = (dxde > tiny) & (dxsv > tiny) & (res2 > floor2)
    nx = torch.linalg.vector_norm(dx, dim=-1)
    margin = torch.minimum(torch.minimum(
        torch.abs(dxde) / torch.clamp(nx * torch.linalg.vector_norm(de, dim=-1), min=tiny),
        torch.abs(dxsv) / torch.clamp(nx * torch.linalg.vector_norm(sv, dim=-1), min=tiny)),
        torch.abs(res2 - floor2) / torch.clamp(torch.maximum(res2, floor2), min=tiny))
    if flip is not None:
        valid = valid ^ flip
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    cneg = torch.where(valid, -1.0 / torch.where(valid, dxsv, one), zero)
    gam = torch.where(valid, 1.0 / torch.where(valid, dxde, one), zero)
    return select(valid, append_pair(c, sv, cneg, de, gam), c), margin


class Before(NamedTuple):
    """The mechanism's state as a call finds it."""
    cov: Cov
    prev_sigma: float
    prev_x: torch.Tensor     # (B, C, H, W)
    prev_mean: torch.Tensor  # (B, C, H, W)
    prev_u: torch.Tensor     # (B, C, H, W)
    step: int


def cov_update(st: Before, x_t, x0, sigma: float, basis: Basis,
               window=(1.0, 10.0), novelty: float = 0.02, flip=None):
    """Stages 1-3 of a call: the time update of the covariance to
    ``sigma`` with the previous mean transported analytically, then the
    BFGS pair of (prev_x, transported mean) and (x_t, x0) where sigma lies
    in the space-update window and x_t moved. Returns (cov, margin): the
    secant guards' margin per row (inf without a pair), ``flip`` as in
    ``space_update``."""
    has_prev = st.step > 0
    cov = st.cov
    px, pm = basis.to(st.prev_x), basis.to(st.prev_mean)
    if has_prev and sigma != st.prev_sigma:
        s0 = st.prev_sigma
        score = (pm - px) / s0 ** 2
        inv = inverse(cov)
        cov = inverse(Cov(inv.diag + (1.0 / sigma ** 2 - 1.0 / s0 ** 2), inv.Ut, inv.M, inv.k))
        a = 1.0 / sigma ** 2 - 1.0 / s0 ** 2
        op = inverse(affine(st.cov, a, 1.0))
        pm = px + sigma ** 2 * ((s0 ** 2 / sigma ** 2) * matvec(op, score))
    if window[0] < sigma < window[1] and has_prev and \
            not bool(torch.all(torch.abs(x_t - st.prev_x) < 1e-12)):
        return space_update(cov, sigma, px, basis.to(x_t), pm, basis.to(x0), novelty, flip)
    return cov, torch.full(x_t.shape[:1], float("inf"), device=x_t.device)


# -- the guidance system and its CG -----------------------------------------------

def rtol_schedule(sigma, rtol_max=1.0, rtol_min=1e-14, p=0.1, floor=1e-6) -> float:
    """The CG tolerance: log-log interpolated in sigma, tight at small
    sigma, never under the float32 floor."""
    f = F32
    s = np.clip(f(sigma), f(0.1), f(80.0))
    ratio = (np.log10(s) - np.log10(f(0.1))) / (np.log10(f(80.0)) - np.log10(f(0.1)))
    lf = np.clip(ratio, f(0.0), f(1.0)) ** f(p)
    return float(np.maximum(f(10.0) ** (lf * (np.log10(f(rtol_max)) - np.log10(f(rtol_min)))
                                        + np.log10(f(rtol_min))), f(floor)))


class System(NamedTuple):
    matvec: Callable   # u -> (sigma_s^2 + A Sigma A^T) u
    b: torch.Tensor    # y - A x0 (masked for inpainting)
    precond: Callable


def system(op, basis: Basis, cov: Cov, x0, y) -> System:
    """(sigma_s^2 I + A Sigma A^T) u = y - A x0, with the preconditioner
    the program's solver takes: the covariance's diagonal mapped to the
    Fourier grid for a blur with a DCT prior, else its mean variance."""
    shape = x0.shape[1:]

    def cov_mv(v):
        return basis.back(matvec(cov, basis.to(v)), shape)

    def mv(u):
        return op.sigma_s ** 2 * u + op.forward(cov_mv(op.adjoint(u)))

    if op.spectral and basis.dct:
        n_h, n_w = shape[-2], shape[-1]

        def fold(n):
            i = torch.arange(n, device=x0.device)
            return torch.clamp(2 * torch.minimum(i, n - i), max=n - 1)

        spec = diag_of(cov).reshape(x0.shape)[..., fold(n_h), :][..., :, fold(n_w)]
        pc = op.precond(torch.clamp(spec, min=1e-8))
    else:
        gram = torch.bmm(cov.Ut, cov.Ut.transpose(1, 2))
        vbar = (torch.sum(cov.diag, -1) + torch.sum(cov.M * gram, dim=(-2, -1))) / x0[0].numel()
        pc = op.precond(torch.clamp(vbar, min=1e-8)[:, None, None, None])
    b = op.residual(y, x0)
    return System(mv, b, pc)


def cg(sys_: System, x0, rtol, maxiter=5000, min_iter=1, stall_iters=25):
    """Batched preconditioned CG with per-row freezing (tolerance, stall at
    a proven floor, breakdown), best iterate kept; rows are (B, ...)
    tensors. Returns (u, iterations)."""
    shape = sys_.b.shape
    flat = lambda t: t.reshape(shape[0], -1)  # noqa: E731
    mv = lambda v: flat(sys_.matvec(v.reshape(shape)))  # noqa: E731
    pc = lambda v: flat(sys_.precond(v.reshape(shape)))  # noqa: E731
    dot = lambda a, b: torch.sum(a * b, dim=-1)  # noqa: E731
    b = flat(sys_.b)
    dtype, dev = b.dtype, b.device
    tiny, eps = torch.finfo(dtype).tiny, torch.finfo(dtype).eps
    bn = torch.sqrt(dot(b, b))
    stop = rtol * bn
    x = flat(x0)
    r = b - mv(x)
    z = pc(r)
    p, rz = z, dot(r, z)
    best = torch.sqrt(dot(r, r))
    active = best > stop
    stall = torch.zeros_like(bn, dtype=torch.int32)
    bx, i = x, 0
    while i < maxiter:
        forced = i < min_iter
        if not forced and not bool(active.any()):
            break
        act = torch.ones_like(active) if forced else active
        ap = mv(p)
        pap = dot(p, ap)
        brk = pap <= 1e-16 * torch.sqrt(dot(p, p) * dot(ap, ap))
        alpha = torch.where(brk, torch.zeros((), dtype=dtype, device=dev),
                            rz / torch.clamp(pap, min=tiny))
        m = act[:, None].to(dtype)
        x = x + m * alpha[:, None] * p
        r = r - m * alpha[:, None] * ap
        z = pc(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = torch.where(act[:, None], z + beta[:, None] * p, p)
        res = torch.sqrt(dot(r, r))
        improved = res < 0.999 * best
        take = torch.ones_like(active) if forced else (res < best) & torch.isfinite(res)
        bx = torch.where(take[:, None], x, bx)
        best = res if forced else torch.minimum(best, res)
        stall = torch.where(~improved & (best < 0.5 * bn), stall + 1, torch.zeros_like(stall))
        hit = stall >= stall_iters
        if bool((hit & act).any()):
            ax = mv(x)
            tr = torch.sqrt(dot(b - ax, b - ax))
            floor = (tr <= 10.0 * eps * (torch.sqrt(dot(ax, ax)) + bn)) | \
                (torch.abs(tr - res) > 0.5 * tr)
        else:
            floor = torch.ones_like(hit)
        stall = torch.where(hit & ~floor, torch.zeros_like(stall), stall)
        active = act & (res > stop) & ~(hit & floor) & torch.isfinite(res) & ~brk
        rz = rz_new
        i += 1
    return bx.reshape(shape), i


def rel_residual(op, basis: Basis, cov: Cov, x0, y, u) -> torch.Tensor:
    """Per row ||(sigma_s^2 + A Sigma A^T) u - b|| / ||b||, in float64."""
    d = torch.float64
    s = system(op, basis, cov_to(cov, d), x0.to(d), y.to(d))
    r = (s.matvec(u.to(d)) - s.b).reshape(u.shape[0], -1)
    return torch.linalg.vector_norm(r, dim=-1) / \
        torch.clamp(torch.linalg.vector_norm(s.b.reshape(u.shape[0], -1), dim=-1), min=1e-300)


def mat_of(op, u):
    """A^T u as the guidance takes it (the blur's adjoint; for a mask, u)."""
    return op.mat(u)


def fallback(basis: Basis, cov: Cov, mat, sigma: float):
    """The covariance gradient Sigma mat / sigma^2."""
    return basis.back(matvec(cov, basis.to(mat)), mat.shape[1:]) / sigma ** 2


def guard_std(g, sigma: float):
    """Per row, the spread of the vjp's update sigma^2 g that the guard
    holds against its threshold."""
    return torch.std((g * sigma ** 2).reshape(g.shape[0], -1), dim=-1, correction=0)


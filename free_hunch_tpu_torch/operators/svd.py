"""SVD-factorised measurement operators: the DDNM+ ``A_functions`` library.

Counterpart of ``free_hunch_tpu/operators/svd.py``: the ``AFunctions``
interface and its derived maps (:36-94), the shared DDNM+ spectral factors
``_ddnm_factors`` (:96-131), ``_pad_singulars``, ``_conv1d_matrix`` and the
ten operators (Denoising, Inpainting with ``create_inpainting_operator``,
SuperResolution, Colorization, Deblurring, Deblurring2D, SRConv, GeneralA,
CS, WalshHadamardCS with ``fwht``).

* Setup SVDs are the JAX package's: numpy float64 on the host, then a cast
  to float32, so every factor matrix, permutation and singular-value vector
  equals the JAX package's bit for bit. They live on the operator's device.
* Every V/Vt/U/Ut product is an f32 ``torch.matmul`` in full f32 (TF32 off,
  ``free_hunch_tpu_torch.use_full_f32``; checked on CUDA tensors), or an
  index gather. The separable operators' two-sided (dim x dim) products
  are plain matmuls, as the JAX package leaves them to XLA.
* Channel layout is the JAX package's: per-pixel channels interleaved by Vt
  and the singular values repeat-interleaved to match, ``Deblurring``
  included (upstream tiles its singular values there).
* Inpainting keeps the padded-singulars design: the singular-value vector
  has full length with zeros on the masked coordinates, so one shared mask
  and a list of per-row masks (gathered with ``torch.gather``) both work.

Vectors are (batch, N) flattened. The DDNM+ scalars ``a`` and ``sigma_t``
are host numbers holding float32 values; the factor arithmetic runs in
float32, as the JAX package's does.
"""
from __future__ import annotations

import numpy as np
import torch

from free_hunch_tpu_torch import check_full_f32, resolve_device
from free_hunch_tpu_torch.operators import masks as mask_mod

_F32 = np.float32


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    """A host array as a device tensor: float64 factors are cast to f32 in
    numpy first, as ``jnp.asarray(a, jnp.float32)`` does."""
    if dtype == torch.float32:
        a = np.asarray(a, np.float32)
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 matmul in full f32 (TF32 off)."""
    check_full_f32(b)
    return torch.matmul(a, b)


def _flat(vec: torch.Tensor) -> torch.Tensor:
    return vec.reshape(vec.shape[0], -1)


def _pad_to(v: torch.Tensor, n: int) -> torch.Tensor:
    """(B, m) -> (B, n), zeros after the first m entries."""
    return torch.cat([v, v.new_zeros((v.shape[0], n - v.shape[1]))], dim=1)


class AFunctions:
    """Interface of an SVD-factorised linear operator A = U diag(s) V^T."""

    channels: int = 3

    def V(self, vec):
        raise NotImplementedError

    def Vt(self, vec):
        raise NotImplementedError

    def U(self, vec):
        raise NotImplementedError

    def Ut(self, vec):
        raise NotImplementedError

    def singulars(self):
        raise NotImplementedError

    def add_zeros(self, vec):
        """Pad a small-space vector with zeros up to the big space."""
        raise NotImplementedError

    # -- derived maps ---------------------------------------------------------

    def A(self, vec):
        s = self.singulars()
        temp = self.Vt(vec)
        return self.U(s * temp[:, :s.shape[-1]])

    def A_with_zeros(self, vec):
        return self.V(self.add_zeros(self.A(vec)))

    def At(self, vec):
        s = self.singulars()
        temp = self.Ut(vec)
        return self.V(self.add_zeros(s * temp[:, :s.shape[-1]]))

    def _scale_head(self, temp, factors):
        n = factors.shape[-1]
        return torch.cat([temp[:, :n] * factors, temp[:, n:]], dim=1)

    def A_pinv(self, vec):
        s = self.singulars()
        pos = s > 0
        factors = torch.where(pos, 1.0 / torch.where(pos, s, torch.ones_like(s)),
                              torch.zeros_like(s))
        return self.V(self.add_zeros(self._scale_head(self.Ut(vec), factors)))

    def A_pinv_eta(self, vec, eta):
        s = self.singulars()
        factors = s / (s * s + eta)
        return self.V(self.add_zeros(self._scale_head(self.Ut(vec), factors)))

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        raise NotImplementedError

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        raise NotImplementedError


def _ddnm_factors(singulars_padded: torch.Tensor, a, sigma_y, sigma_t, eta):
    """DDNM+ spectral coefficients over a padded singular-value vector:
    (lambda_t, d1_t, d2_t). lambda_t shrinks the pseudo-inverse correction
    where the observation is noisier than the step; d1_t and d2_t split the
    ancestral noise between the fresh draw and the predicted epsilon.

    ``a`` and ``sigma_t`` hold float32 values and every product is taken in
    float32, in the JAX package's order; ``sqrt(1 - eta^2)`` is rounded to
    float32 once, as the JAX package's float32 arithmetic rounds it."""
    s = singulars_padded
    a, sigma_t = _F32(a), _F32(sigma_t)
    c_eta = float(_F32(np.sqrt(max(1 - eta**2, 0.0))))
    pos = s > 0
    inv_s = torch.where(pos, 1.0 / torch.where(pos, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    ones = torch.ones_like(s)
    lambda_t = ones
    d1_t = ones * float(sigma_t) * eta
    d2_t = ones * float(sigma_t) * c_eta

    if sigma_y == 0:
        return lambda_t, d1_t, d2_t

    thresh = float(a * _F32(sigma_y)) * inv_s
    below = (float(sigma_t) < thresh).to(s.dtype)      # noisier observation
    above = (float(sigma_t) > thresh).to(s.dtype)
    zero = (s == 0).to(s.dtype)

    lambda_t = (lambda_t * (1 - below)
                + below * (s * float(sigma_t) * c_eta / float(a) / sigma_y))
    d1_t = d1_t * (1 - below) + below * float(sigma_t) * eta
    d2_t = d2_t * (1 - below)
    gap = float(sigma_t * sigma_t) - float((a * a) * _F32(sigma_y**2)) * (inv_s * inv_s)
    # where, not the JAX package's product above * gap: 1 / s^2 overflows
    # f32 for s < ~1e-19 (Deblurring's unthresholded Kronecker values at
    # 64 px), and 0 * -inf is NaN there; elsewhere the two are equal
    gap = torch.where(above > 0, gap, torch.zeros_like(gap))
    d1_t = d1_t * (1 - above) + torch.sqrt(torch.clamp(gap, min=0.0))
    d2_t = d2_t * (1 - above)
    d1_t = d1_t * (1 - zero) + zero * float(sigma_t) * eta
    d2_t = d2_t * (1 - zero) + zero * float(sigma_t) * c_eta
    return lambda_t, d1_t, d2_t


def _pad_singulars(s: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([s, s.new_zeros((n - s.shape[0],))])


# ---------------------------------------------------------------------------
# Denoising (identity)
# ---------------------------------------------------------------------------

class Denoising(AFunctions):
    def __init__(self, channels, img_dim, device=None):
        self.device = resolve_device(device)
        self.channels = channels
        self.img_dim = img_dim
        self._singulars = torch.ones(channels * img_dim**2, dtype=torch.float32,
                                     device=self.device)

    def V(self, vec):
        return _flat(vec)

    Vt = V
    U = V
    Ut = V
    add_zeros = V

    def singulars(self):
        return self._singulars

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        lam, _, _ = _ddnm_factors(self._singulars[:1], a, sigma_y, sigma_t, eta)
        return vec * lam[0]

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        _, d1, d2 = _ddnm_factors(self._singulars[:1], a, sigma_y, sigma_t, eta)
        return vec * d1[0] + epsilon * d2[0]


# ---------------------------------------------------------------------------
# Inpainting
# ---------------------------------------------------------------------------

class Inpainting(AFunctions):
    """Pixel-subset measurement; V is the kept/missing permutation of the
    pixel-last (channel-interleaved) layout. The singular-value vector has
    full length n with zeros on the missing coordinates, so every shape is
    independent of the mask density."""

    def __init__(self, channels, img_dim, missing_indices, device=None):
        """``missing_indices``: one index array for a mask shared by the
        whole batch, or a LIST of per-row index arrays whose rows align with
        the batch rows of every vector passed in."""
        self.device = resolve_device(device)
        self.channels = channels
        self.img_dim = img_dim
        n = channels * img_dim**2
        self._n = n

        def one(missing):
            missing = np.asarray(missing, np.int64)
            kept = np.setdiff1d(np.arange(n), missing)
            perm = np.concatenate([kept, missing])
            svals = np.zeros(n, np.float32)
            svals[: kept.shape[0]] = 1.0
            return perm, np.argsort(perm), svals

        if isinstance(missing_indices, (list, tuple)):
            perms, invs, svs = zip(*(one(m) for m in missing_indices))
            perm, inv, svals = np.stack(perms), np.stack(invs), np.stack(svs)
        else:
            perm, inv, svals = one(missing_indices)
        self._perm = _t(perm, self.device, torch.int64)
        self._inv_perm = _t(inv, self.device, torch.int64)
        self._singulars = _t(svals, self.device)

    @staticmethod
    def _gather(vec, idx):
        if idx.dim() == 1:
            return vec[:, idx]
        return torch.gather(vec, 1, idx)

    def _to_pixel_last(self, vec):
        b = vec.shape[0]
        return vec.reshape(b, self.channels, -1).transpose(1, 2).reshape(b, -1)

    def _from_pixel_last(self, vec):
        b = vec.shape[0]
        return vec.reshape(b, -1, self.channels).transpose(1, 2).reshape(b, -1)

    def V(self, vec):
        return self._from_pixel_last(self._gather(_flat(vec), self._inv_perm))

    def Vt(self, vec):
        return self._gather(self._to_pixel_last(vec), self._perm)

    def U(self, vec):
        return _flat(vec)

    Ut = U

    def singulars(self):
        return self._singulars

    def add_zeros(self, vec):
        return _flat(vec)

    @staticmethod
    def _bcast(x):
        return x if x.dim() == 2 else x[None, :]

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        out = self.Vt(vec)
        lam, _, _ = _ddnm_factors(self._singulars, a, sigma_y, sigma_t, eta)
        return self.V(out * self._bcast(lam))

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        out_v = self.Vt(vec)
        out_e = self.Vt(epsilon)
        _, d1, d2 = _ddnm_factors(self._singulars, a, sigma_y, sigma_t, eta)
        return self.V(out_v * self._bcast(d1)) + self.V(out_e * self._bcast(d2))


def create_inpainting_operator(channels, img_dim, mask_opt, generator=None, repeats=1,
                               device=None):
    """``Inpainting`` from mask draws (``operators/masks.generate_mask``).

    ``generator``: one CPU ``torch.Generator`` (a mask shared by the batch;
    ``None`` draws from torch's global generator), or a LIST of generators,
    one fresh mask each, repeated ``repeats`` times (seed replicas of an
    image share its mask): a per-row operator whose rows align with an
    (images * repeats) batch. Missing indices are the mask's zeros in its
    (C, H, W) flattening, as in the JAX package."""
    opt = dict(mask_opt)
    opt.setdefault("image_size", img_dim)

    def missing_of(gen):
        m = mask_mod.generate_mask(gen, opt, channels)[0]
        return np.where(m.reshape(-1).numpy() == 0)[0]

    if isinstance(generator, (list, tuple)):
        missing = []
        for g in generator:
            missing += [missing_of(g)] * repeats
        return Inpainting(channels, img_dim, missing, device=device)
    return Inpainting(channels, img_dim, missing_of(generator), device=device)


# ---------------------------------------------------------------------------
# Super-resolution (block average)
# ---------------------------------------------------------------------------

class SuperResolution(AFunctions):
    """ratio x ratio patch averaging: the SVD of the 1 x r^2 averaging row,
    applied per patch. V stores the DC coefficients first, then the others
    patch by patch."""

    def __init__(self, channels, img_dim, ratio, device=None):
        assert img_dim % ratio == 0
        self.device = resolve_device(device)
        self.channels = channels
        self.img_dim = img_dim
        self.ratio = ratio
        self.y_dim = img_dim // ratio
        A = np.full((1, ratio**2), 1.0 / ratio**2)
        U, s, Vt = np.linalg.svd(A, full_matrices=True)
        self.U_small = _t(U, self.device)           # (1, 1)
        self.singulars_small = _t(s, self.device)   # (1,)
        self.V_small = _t(Vt.T, self.device)        # (r^2, r^2)

    def _patches_to_img(self, patches):
        """(B, C, y^2, r^2) -> (B, C*D^2) image layout."""
        b = patches.shape[0]
        p = patches.reshape(b, self.channels, self.y_dim, self.y_dim, self.ratio, self.ratio)
        return p.permute(0, 1, 2, 4, 3, 5).reshape(b, self.channels * self.img_dim**2)

    def _img_to_patches(self, vec):
        b = vec.shape[0]
        p = vec.reshape(b, self.channels, self.y_dim, self.ratio, self.y_dim, self.ratio)
        p = p.permute(0, 1, 2, 4, 3, 5)
        return p.reshape(b, self.channels, self.y_dim**2, self.ratio**2)

    def _by_V(self, patches):      # einsum ij,bcpj->bcpi
        return _mm(patches, self.V_small.T)

    def _by_Vt(self, patches):     # einsum ji,bcpj->bcpi
        return _mm(patches, self.V_small)

    def V(self, vec):
        b = vec.shape[0]
        temp = _flat(vec)
        r2, y2 = self.ratio**2, self.y_dim**2
        n_dc = self.channels * y2
        patches = torch.cat([temp[:, :n_dc].reshape(b, self.channels, y2, 1),
                             temp[:, n_dc:].reshape(b, self.channels, y2, r2 - 1)], dim=-1)
        return self._patches_to_img(self._by_V(patches))

    def Vt(self, vec):
        b = vec.shape[0]
        patches = self._by_Vt(self._img_to_patches(vec))
        return torch.cat([patches[..., 0].reshape(b, -1),
                          patches[..., 1:].reshape(b, -1)], dim=1)

    def U(self, vec):
        return self.U_small[0, 0] * _flat(vec)

    Ut = U

    def singulars(self):
        return self.singulars_small.repeat(self.channels * self.y_dim**2)

    def add_zeros(self, vec):
        v = _flat(vec)
        return _pad_to(v, v.shape[1] * self.ratio**2)

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        patches = self._by_Vt(self._img_to_patches(vec))
        lam, _, _ = _ddnm_factors(_pad_singulars(self.singulars_small, self.ratio**2),
                                  a, sigma_y, sigma_t, eta)
        return self._patches_to_img(self._by_V(patches * lam))

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        pv = self._img_to_patches(vec)
        pe = self._img_to_patches(epsilon)
        _, d1, d2 = _ddnm_factors(_pad_singulars(self.singulars_small, self.ratio**2),
                                  a, sigma_y, sigma_t, eta)
        return (self._patches_to_img(self._by_V(pv * d1))
                + self._patches_to_img(self._by_V(pe * d2)))


# ---------------------------------------------------------------------------
# Colorization
# ---------------------------------------------------------------------------

class Colorization(AFunctions):
    """Per-pixel channel average."""

    def __init__(self, img_dim, device=None):
        self.device = resolve_device(device)
        self.channels = 3
        self.img_dim = img_dim
        A = np.asarray([[0.3333, 0.3334, 0.3333]])
        U, s, Vt = np.linalg.svd(A, full_matrices=True)
        self.U_small = _t(U, self.device)
        self.singulars_small = _t(s, self.device)
        self.V_small = _t(Vt.T, self.device)

    def _needles(self, vec):
        return vec.reshape(vec.shape[0], self.channels, -1).transpose(1, 2)  # (B, D^2, C)

    def _unneedle(self, needles):
        return needles.transpose(1, 2).reshape(needles.shape[0], -1)

    def V(self, vec):
        return self._unneedle(_mm(self._needles(vec), self.V_small.T))

    def Vt(self, vec):
        return self._unneedle(_mm(self._needles(vec), self.V_small))

    def U(self, vec):
        return self.U_small[0, 0] * _flat(vec)

    Ut = U

    def singulars(self):
        return self.singulars_small.repeat(self.img_dim**2)

    def add_zeros(self, vec):
        return _pad_to(_flat(vec), self.channels * self.img_dim**2)

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        n = _mm(self._needles(vec), self.V_small)
        lam, _, _ = _ddnm_factors(_pad_singulars(self.singulars_small, self.channels),
                                  a, sigma_y, sigma_t, eta)
        return self._unneedle(_mm(n * lam, self.V_small.T))

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        nv, ne = self._needles(vec), self._needles(epsilon)
        _, d1, d2 = _ddnm_factors(_pad_singulars(self.singulars_small, self.channels),
                                  a, sigma_y, sigma_t, eta)
        return (self._unneedle(_mm(nv * d1, self.V_small.T))
                + self._unneedle(_mm(ne * d2, self.V_small.T)))


# ---------------------------------------------------------------------------
# Deblurring (separable 1-D convolution matrix SVD)
# ---------------------------------------------------------------------------

def _conv1d_matrix(kernel1d: np.ndarray, img_dim: int) -> np.ndarray:
    """Banded 1-D convolution matrix with support [i - k//2, i + k//2) and a
    zero boundary."""
    k = kernel1d.shape[0]
    A = np.zeros((img_dim, img_dim))
    for off in range(-(k // 2), k // 2):
        diag = kernel1d[off + k // 2]
        idx = np.arange(max(0, -off), min(img_dim, img_dim - off))
        A[idx, idx + off] = diag
    return A


class _Separable(AFunctions):
    """Shared layout of the separable blurs: per channel M_left @ img @
    M_right, then the Kronecker singular-value permutation over pixels with
    the channels interleaved."""

    def _two_sided(self, M_left, M_right, img_flat):
        b = img_flat.shape[0]
        img = img_flat.reshape(b * self.channels, self.img_dim, self.img_dim)
        return _mm(_mm(M_left, img), M_right).reshape(b, -1)

    def _unpermute(self, vec):
        """Spectral (pixel-last, permuted) -> channel-major, unpermuted."""
        b = vec.shape[0]
        temp = vec.reshape(b, self.img_dim**2, self.channels)[:, self._inv_perm, :]
        return temp.transpose(1, 2).reshape(b, -1)

    def _permute(self, temp):
        """Channel-major, unpermuted -> spectral (pixel-last, permuted)."""
        b = temp.shape[0]
        temp = temp.reshape(b, self.channels, -1)[:, :, self._perm]
        return temp.transpose(1, 2).reshape(b, -1)

    def singulars(self):
        # per-pixel channel-interleaved layout (upstream tiles here)
        return torch.repeat_interleave(self._singulars, self.channels)

    def add_zeros(self, vec):
        return _flat(vec)


class Deblurring(_Separable):
    """Separable blur A = (A1 kron A1) per channel via the Kronecker SVD of
    the 1-D convolution matrix: singular values sorted descending with the
    3e-2 hard threshold; Lambda uses the unthresholded ones."""

    def __init__(self, kernel, channels, img_dim, ZERO=3e-2, use_ddnm_kernel_params=False,
                 device=None):
        self.device = resolve_device(device)
        self.channels = channels
        self.img_dim = img_dim
        kernel = np.asarray(kernel, np.float64)
        if kernel.ndim == 2:
            # the centre row of a 2-D kernel, renormalised
            kernel = kernel[kernel.shape[0] // 2]
        kernel = kernel / kernel.sum()
        if use_ddnm_kernel_params:
            sigma = 10.0
            x = np.asarray([-2, -1, 0, 1, 2], np.float64)
            kernel = np.exp(-0.5 * (x / sigma) ** 2)
            kernel = kernel / kernel.sum()

        A1 = _conv1d_matrix(kernel, img_dim)
        U, s, Vt = np.linalg.svd(A1, full_matrices=True)
        self.U_small = _t(U, self.device)
        self.V_small = _t(Vt.T, self.device)
        s_orig = s.copy()
        s = np.where(s < ZERO, 0.0, s)
        big = np.outer(s, s).reshape(-1)
        big_orig = np.outer(s_orig, s_orig).reshape(-1)
        perm = np.argsort(-big, kind="stable")
        self._perm = _t(perm, self.device, torch.int64)
        self._inv_perm = _t(np.argsort(perm), self.device, torch.int64)
        self._singulars = _t(big[perm], self.device)
        self._singulars_orig = _t(big_orig[perm], self.device)

    def V(self, vec):
        return self._two_sided(self.V_small, self.V_small.T, self._unpermute(vec))

    def Vt(self, vec):
        return self._permute(self._two_sided(self.V_small.T, self.V_small, _flat(vec)))

    def U(self, vec):
        return self._two_sided(self.U_small, self.U_small.T, self._unpermute(vec))

    def Ut(self, vec):
        return self._permute(self._two_sided(self.U_small.T, self.U_small, _flat(vec)))

    def _v_scaled(self, x, d):
        """V applied to ``x`` whose pixels, in spectral order, are scaled by
        ``d`` (the common tail of Lambda and Lambda_noise)."""
        b = x.shape[0]
        t = x.reshape(b, self.channels, -1)[:, :, self._perm] * d
        return self._two_sided(self.V_small, self.V_small.T,
                               t[:, :, self._inv_perm].reshape(b, -1))

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        lam, _, _ = _ddnm_factors(self._singulars_orig, a, sigma_y, sigma_t, eta)
        return self._v_scaled(self._two_sided(self.V_small.T, self.V_small, _flat(vec)), lam)

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        _, d1, d2 = _ddnm_factors(self._singulars_orig, a, sigma_y, sigma_t, eta)
        return self._v_scaled(vec, d1) + self._v_scaled(epsilon, d2)


class Deblurring2D(_Separable):
    """Anisotropic separable blur with distinct row and column kernels."""

    def __init__(self, kernel1, kernel2, channels, img_dim, ZERO=3e-2, device=None):
        self.device = resolve_device(device)
        self.channels = channels
        self.img_dim = img_dim
        A1 = _conv1d_matrix(np.asarray(kernel1, np.float64), img_dim)
        A2 = _conv1d_matrix(np.asarray(kernel2, np.float64), img_dim)
        U1, s1, V1t = np.linalg.svd(A1, full_matrices=True)
        U2, s2, V2t = np.linalg.svd(A2, full_matrices=True)
        s1 = np.where(s1 < ZERO, 0.0, s1)
        s2 = np.where(s2 < ZERO, 0.0, s2)
        self.U_small1, self.V_small1 = _t(U1, self.device), _t(V1t.T, self.device)
        self.U_small2, self.V_small2 = _t(U2, self.device), _t(V2t.T, self.device)
        big = np.outer(s1, s2).reshape(-1)
        perm = np.argsort(-big, kind="stable")
        self._perm = _t(perm, self.device, torch.int64)
        self._inv_perm = _t(np.argsort(perm), self.device, torch.int64)
        self._singulars = _t(big[perm], self.device)

    def V(self, vec):
        return self._two_sided(self.V_small1, self.V_small2.T, self._unpermute(vec))

    def Vt(self, vec):
        return self._permute(self._two_sided(self.V_small1.T, self.V_small2, _flat(vec)))

    def U(self, vec):
        return self._two_sided(self.U_small1, self.U_small2.T, self._unpermute(vec))

    def Ut(self, vec):
        return self._permute(self._two_sided(self.U_small1.T, self.U_small2, _flat(vec)))


# ---------------------------------------------------------------------------
# SRConv (arbitrary-kernel strided SR)
# ---------------------------------------------------------------------------

class SRConv(AFunctions):
    """Stride-sampled 1-D convolution matrix with reflective padding,
    Kronecker singular values and the kept-block-first permutation."""

    def __init__(self, kernel, channels, img_dim, stride=1, ZERO=3e-2, device=None):
        self.device = resolve_device(device)
        self.channels = channels
        self.img_dim = img_dim
        self.ratio = stride
        small = img_dim // stride
        self.small_dim = small
        kernel = np.asarray(kernel, np.float64)
        k = kernel.shape[0]
        A = np.zeros((small, img_dim))
        for i in range(stride // 2, img_dim + stride // 2, stride):
            for j in range(i - k // 2, i + k // 2):
                je = j
                if je < 0:
                    je = -je - 1
                if je >= img_dim:
                    je = (img_dim - 1) - (je - img_dim)
                A[i // stride, je] += kernel[j - i + k // 2]
        U, s, Vt = np.linalg.svd(A, full_matrices=True)
        s = np.where(s < ZERO, 0.0, s)
        self.U_small = _t(U, self.device)          # (small, small)
        self.V_small = _t(Vt.T, self.device)       # (D, D)
        self.singulars_small = _t(s, self.device)  # (small,)
        big = np.outer(s, s).reshape(-1)
        self._singulars = _t(big, self.device)
        perm = np.asarray([img_dim * i + j for i in range(small) for j in range(small)]
                          + [img_dim * i + j for i in range(small)
                             for j in range(small, img_dim)], np.int64)
        self._perm = _t(perm, self.device, torch.int64)

    def _mat_by_img(self, M, v, dim):
        b = v.shape[0]
        img = v.reshape(b * self.channels, dim, dim)
        return _mm(M, img).reshape(b, self.channels, M.shape[0], dim)

    def _img_by_mat(self, v, M, dim):
        b = v.shape[0]
        img = v.reshape(b * self.channels, dim, dim)
        return _mm(img, M).reshape(b, self.channels, dim, M.shape[1])

    def V(self, vec):
        b = vec.shape[0]
        x = vec.reshape(b, self.img_dim**2, self.channels)
        np_len = self._perm.shape[0]
        temp = torch.empty_like(x)
        temp[:, self._perm, :] = x[:, :np_len, :]
        # the coordinates beyond the permutation are copied as they are:
        # without that V is rank-deficient instead of orthogonal
        temp[:, np_len:, :] = x[:, np_len:, :]
        temp = temp.transpose(1, 2)
        out = self._mat_by_img(self.V_small, temp.reshape(b, -1), self.img_dim)
        out = self._img_by_mat(out, self.V_small.T, self.img_dim)
        return out.reshape(b, -1)

    def Vt(self, vec):
        b = vec.shape[0]
        temp = self._mat_by_img(self.V_small.T, _flat(vec), self.img_dim)
        temp = self._img_by_mat(temp, self.V_small, self.img_dim)
        temp = temp.reshape(b, self.channels, -1)
        np_len = self._perm.shape[0]
        temp = torch.cat([temp[:, :, self._perm], temp[:, :, np_len:]], dim=-1)
        return temp.transpose(1, 2).reshape(b, -1)

    def U(self, vec):
        b = vec.shape[0]
        temp = vec.reshape(b, self.small_dim**2, self.channels).transpose(1, 2)
        out = self._mat_by_img(self.U_small, temp.reshape(b, -1), self.small_dim)
        out = self._img_by_mat(out, self.U_small.T, self.small_dim)
        return out.reshape(b, -1)

    def Ut(self, vec):
        b = vec.shape[0]
        temp = self._mat_by_img(self.U_small.T, _flat(vec), self.small_dim)
        temp = self._img_by_mat(temp, self.U_small, self.small_dim)
        return temp.reshape(b, self.channels, -1).transpose(1, 2).reshape(b, -1)

    def singulars(self):
        return torch.repeat_interleave(self._singulars[: self.small_dim**2], self.channels)

    def add_zeros(self, vec):
        v = _flat(vec)
        return _pad_to(v, v.shape[1] * self.ratio**2)


# ---------------------------------------------------------------------------
# GeneralA (dense SVD), CS (block random projections), Walsh-Hadamard CS
# ---------------------------------------------------------------------------

class GeneralA(AFunctions):
    """A dense matrix through its full SVD."""

    def __init__(self, A, ZERO=1e-3, device=None):
        self.device = resolve_device(device)
        A = np.asarray(A, np.float64)
        U, s, Vt = np.linalg.svd(A, full_matrices=True)
        s = np.where(s < ZERO, 0.0, s)
        self._Uj = _t(U, self.device)
        self._Vj = _t(Vt.T, self.device)
        self._singulars = _t(s, self.device)

    def _mv(self, M, vec):    # einsum ij,bj->bi
        return _mm(_flat(vec), M.T)

    def V(self, vec):
        return self._mv(self._Vj, vec)

    def Vt(self, vec):
        return self._mv(self._Vj.T, vec)

    def U(self, vec):
        return self._mv(self._Uj, vec)

    def Ut(self, vec):
        return self._mv(self._Uj.T, vec)

    def singulars(self):
        return self._singulars

    def add_zeros(self, vec):
        return _pad_to(_flat(vec), self._Vj.shape[0])


class CS(AFunctions):
    """Block compressive sensing: a random orthogonal projection per 32x32
    patch keeping a ``ratio`` fraction of its coefficients. ``img_dim`` must
    be a multiple of 32."""

    def __init__(self, channels, img_dim, ratio, rng_seed=0, device=None):
        self.device = resolve_device(device)
        self.channels = channels
        self.img_dim = img_dim
        self.patch = 32
        self.y_dim = img_dim // self.patch
        rng = np.random.default_rng(rng_seed)
        A = rng.normal(size=(self.patch**2, self.patch**2))
        _, _, Vt = np.linalg.svd(A, full_matrices=True)
        self.V_small = _t(Vt.T, self.device)
        self.cs_size = int(self.patch**2 * ratio)
        self._singulars = torch.ones(channels * self.y_dim**2 * self.cs_size,
                                     dtype=torch.float32, device=self.device)

    def _img_to_patches(self, vec):
        b = vec.shape[0]
        p = vec.reshape(b, self.channels, self.y_dim, self.patch, self.y_dim, self.patch)
        p = p.permute(0, 1, 2, 4, 3, 5)
        return p.reshape(b, self.channels * self.y_dim**2, self.patch**2)

    def _patches_to_img(self, patches):
        b = patches.shape[0]
        p = patches.reshape(b, self.channels, self.y_dim, self.y_dim, self.patch, self.patch)
        return p.permute(0, 1, 2, 4, 3, 5).reshape(b, self.channels * self.img_dim**2)

    def V(self, vec):
        b = vec.shape[0]
        temp = _flat(vec)
        npatch = self.channels * self.y_dim**2
        kept = temp[:, : npatch * self.cs_size].reshape(b, npatch, self.cs_size)
        rest = temp[:, npatch * self.cs_size:].reshape(b, npatch, -1)
        patches = _mm(torch.cat([kept, rest], dim=-1), self.V_small.T)
        return self._patches_to_img(patches)

    def Vt(self, vec):
        b = vec.shape[0]
        patches = _mm(self._img_to_patches(vec), self.V_small)
        return torch.cat([patches[:, :, : self.cs_size].reshape(b, -1),
                          patches[:, :, self.cs_size:].reshape(b, -1)], dim=-1)

    def U(self, vec):
        return _flat(vec)

    Ut = U

    def singulars(self):
        return self._singulars

    def add_zeros(self, vec):
        return _pad_to(_flat(vec), self.channels * self.img_dim**2)


def fwht(a: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform over the last axis of an (m, n) tensor,
    n a power of two (self-inverse up to a factor n)."""
    m, n = a.shape
    h = 1
    while h < n:
        blk = a.reshape(m, n // (2 * h), 2, h)
        a = torch.cat([blk[:, :, 0, :] + blk[:, :, 1, :],
                       blk[:, :, 0, :] - blk[:, :, 1, :]], dim=-1).reshape(m, n)
        h *= 2
    return a


class WalshHadamardCS(AFunctions):
    """Compressive sensing in the Walsh-Hadamard basis with a random
    coefficient permutation ``perm`` of the img_dim^2 pixels."""

    def __init__(self, channels, img_dim, ratio, perm, device=None):
        self.device = resolve_device(device)
        self.channels = channels
        self.img_dim = img_dim
        self.ratio = ratio
        self.perm = _t(np.asarray(perm, np.int64), self.device, torch.int64)
        self._inv_perm = _t(np.argsort(np.asarray(perm)), self.device, torch.int64)
        self._singulars = torch.ones(channels * img_dim**2 // ratio, dtype=torch.float32,
                                     device=self.device)

    def _fwht(self, x):
        b = x.shape[0]
        out = fwht(x.reshape(b * self.channels, -1)) / self.img_dim
        return out.reshape(b, self.channels, self.img_dim**2)

    def V(self, vec):
        b = vec.shape[0]
        x = vec.reshape(b, -1, self.channels).transpose(1, 2)
        temp = x.new_zeros((b, self.channels, self.img_dim**2))
        temp[:, :, self.perm] = x
        return self._fwht(temp).reshape(b, -1)

    def Vt(self, vec):
        b = vec.shape[0]
        t = self._fwht(vec.reshape(b, self.channels, -1))
        return t[:, :, self.perm].transpose(1, 2).reshape(b, -1)

    def U(self, vec):
        return _flat(vec)

    Ut = U

    def singulars(self):
        return self._singulars

    def add_zeros(self, vec):
        return _pad_to(_flat(vec), self.channels * self.img_dim**2)

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        n = self.channels * self.img_dim**2
        lam, _, _ = _ddnm_factors(_pad_singulars(self._singulars, n), a, sigma_y, sigma_t, eta)
        return self.V(self.Vt(vec) * lam)

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        b = vec.shape[0]
        n = self.channels * self.img_dim**2

        def reorder(x):
            t = x.reshape(b, self.channels, self.img_dim**2)[:, :, self.perm]
            return t.transpose(1, 2).reshape(b, -1)

        _, d1, d2 = _ddnm_factors(_pad_singulars(self._singulars, n), a, sigma_y, sigma_t, eta)
        return self.V(reorder(vec) * d1) + self.V(reorder(epsilon) * d2)

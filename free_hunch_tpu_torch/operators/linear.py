"""Measurement operators A for y = A x + n: the registry and every operator
of the JAX package.

Counterpart of ``free_hunch_tpu/operators/linear.py``: ``LinearOperator``,
``noise``, ``colorization``, the FFT blur family, ``super_resolution``,
``inpainting``, ``phase_retrieval`` and ``nonlinear_blur`` (:75-338).
Operators hold their constants (OTFs as ``complex64``, masks, resize
matrices) on their device, built once at construction, and draw measurement
noise from a passed ``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from free_hunch_tpu_torch import randn, resolve_device
from free_hunch_tpu_torch.operators import assets, masks
from free_hunch_tpu_torch.operators.resize import build_resizer
from free_hunch_tpu_torch.ops.fftops import downsample, fft2c, fft_conv, p2o_np, upsample

_OPERATORS = {}


def register_operator(name: str):
    def wrapper(cls):
        if name in _OPERATORS:
            raise NameError(f"operator {name!r} already registered")
        cls.name = name
        _OPERATORS[name] = cls
        return cls
    return wrapper


def get_operator(name: str, **kwargs):
    if name not in _OPERATORS:
        raise NameError(f"operator {name!r} is not defined in the port "
                        f"(have {sorted(_OPERATORS)})")
    return _OPERATORS[name](**kwargs)


class LinearOperator:
    """Base: forward (noise from an optional generator) + transpose."""
    name = "abstract"
    sigma_s: float

    def forward(self, data, noiseless=False, generator=None):
        raise NotImplementedError

    def transpose(self, y):
        raise NotImplementedError

    def _noise(self, y, noiseless, generator):
        if noiseless or generator is None:
            return y
        n = randn(y.shape, generator, dtype=y.dtype, device=y.device)
        return y + self.sigma_s * n


@register_operator(name="noise")
class DenoiseOperator(LinearOperator):
    """Identity operator (pure denoising)."""

    def __init__(self, sigma_s=0.0, in_shape=(1, 3, 256, 256), device=None, **kwargs):
        self.device = resolve_device(device)
        self.sigma_s = float(np.float32(sigma_s))
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(in_shape)

    def forward(self, data, noiseless=False, generator=None):
        return self._noise(data, noiseless, generator)

    def transpose(self, y):
        return y

    def ortho_project(self, data):
        return data

    def project(self, data):
        return data


@register_operator(name="colorization")
class ColorizationOperator(LinearOperator):
    """Channel mean: y = mean_c(x)."""

    def __init__(self, sigma_s=0.0, in_shape=(1, 3, 256, 256), device=None, **kwargs):
        self.device = resolve_device(device)
        self.sigma_s = float(np.float32(sigma_s))
        self.in_shape = tuple(in_shape)
        self.out_shape = (in_shape[0], 1) + tuple(in_shape[2:])

    def forward(self, data, noiseless=False, generator=None):
        return self._noise(torch.mean(data, dim=1, keepdim=True), noiseless, generator)

    def transpose(self, y):
        c = self.in_shape[1]
        return torch.repeat_interleave(y, c, dim=1) / c


class _FFTBlurOperator(LinearOperator):
    """Shared FFT-diagonalised circular-convolution machinery."""

    def _init_kernel(self, kernel: np.ndarray, in_shape, device):
        self.device = resolve_device(device)
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(in_shape)
        h, w = in_shape[-2:]
        self.kernel = np.asarray(kernel, np.float32)
        FB = p2o_np(self.kernel.reshape(1, 1, *self.kernel.shape), (h, w))
        self.FB = torch.as_tensor(FB, device=self.device)
        self.FBC = torch.conj(self.FB).resolve_conj()
        self.F2B = torch.as_tensor((np.abs(FB) ** 2).astype(np.float32),
                                   device=self.device)

    @property
    def pre_calculated(self):
        """(FB, FBC, F2B, FBFy) as the mat solvers take it; FBFy is unused."""
        return self.FB, self.FBC, self.F2B, None

    def forward(self, data, noiseless=False, generator=None):
        return self._noise(fft_conv(data, self.FB), noiseless, generator)

    def transpose(self, y):
        return fft_conv(y, self.FBC)


@register_operator(name="gaussian_blur")
class GaussianBlurOperator(_FFTBlurOperator):
    """61x61 gaussian blur (the paper's fixed kernel asset)."""

    def __init__(self, kernel_size=61, intensity=3.0, sigma_s=0.0,
                 in_shape=(1, 3, 256, 256), kernel=None, device=None, **kwargs):
        self.kernel_size = kernel_size
        self.sigma_s = float(np.float32(sigma_s))
        k = assets.gaussian_blur_kernel() if kernel is None else kernel
        self._init_kernel(np.asarray(k, np.float32), in_shape, device)


@register_operator(name="motion_blur")
class MotionBlurOperator(_FFTBlurOperator):
    """61x61 motion blur (the fixed kernel asset)."""

    def __init__(self, kernel_size=61, intensity=0.5, sigma_s=0.0,
                 in_shape=(1, 3, 256, 256), kernel=None, device=None, **kwargs):
        self.kernel_size = kernel_size
        self.sigma_s = float(np.float32(sigma_s))
        k = assets.motion_blur_kernel() if kernel is None else kernel
        self._init_kernel(np.asarray(k, np.float32), in_shape, device)


@register_operator(name="super_resolution")
class SuperResolutionOperator(LinearOperator):
    """Bicubic downsample (ResizeRight semantics) as ``R_h x R_w^T``, with an
    FFT-factorised surrogate (bicubic conv kernel + s-fold sampling) for the
    mat solvers."""

    def __init__(self, in_shape=(1, 3, 256, 256), scale_factor=4, sigma_s=0.0, device=None,
                 **kwargs):
        self.device = resolve_device(device)
        self.in_shape = tuple(in_shape)
        self.scale_factor = int(scale_factor)
        self.sigma_s = float(np.float32(sigma_s))
        h, w = in_shape[-2:]
        self.out_shape = (in_shape[0], in_shape[1], h // self.scale_factor,
                          w // self.scale_factor)
        self._down = build_resizer((h, w), 1.0 / self.scale_factor, device=self.device)
        k = assets.bicubic_sr_kernel(self.scale_factor).astype(np.float32)
        FB = p2o_np(k.reshape(1, 1, *k.shape), (h, w))
        self.FB = torch.as_tensor(FB, device=self.device)
        self.FBC = torch.conj(self.FB).resolve_conj()
        self.F2B = torch.as_tensor((np.abs(FB) ** 2).astype(np.float32), device=self.device)

    @property
    def pre_calculated(self):
        return self.FB, self.FBC, self.F2B, None

    def forward(self, data, noiseless=False, generator=None):
        return self._noise(self._down(data), noiseless, generator)

    def transpose(self, y):
        """Adjoint of the bicubic downsample: R_h^T y R_w."""
        Rh, Rw = self._down.matrices
        return Rh.T @ y.to(torch.float32) @ Rw

    def fft_forward(self, x):
        """The solver surrogate: downsample(ifft2(FB fft2(x)))."""
        return downsample(fft_conv(x, self.FB), self.scale_factor)

    def fft_transpose(self, y):
        return fft_conv(upsample(y, self.scale_factor), self.FBC)


@register_operator(name="inpainting")
class InpaintingOperator(LinearOperator):
    """Masked identity. The mask is ``mask`` or drawn at construction from
    ``mask_generator`` (a CPU ``torch.Generator``; without one, from a seed
    of numpy's global generator, as the JAX package draws its key)."""

    def __init__(self, sigma_s=0.0, mask_opt=None, mask=None, mask_generator=None,
                 in_shape=None, device=None, **kwargs):
        self.device = resolve_device(device)
        mask_opt = dict(mask_opt or {"mask_type": "random", "image_size": 256,
                                     "mask_prob_range": (0.1, 0.3)})
        size = mask_opt.get("image_size", 256)
        self.in_shape = tuple(in_shape) if in_shape else (1, 3, size, size)
        self.out_shape = self.in_shape
        self.sigma_s = float(np.float32(sigma_s))
        if mask is None:
            if mask_generator is None:
                mask_generator = torch.Generator().manual_seed(
                    int(np.random.randint(0, 2**31 - 1)))
            mask = masks.generate_mask(mask_generator, mask_opt, self.in_shape[1])
        self.mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)

    def forward(self, data, noiseless=False, generator=None):
        # noise is added before masking, as in the JAX package
        return self._noise(data, noiseless, generator) * self.mask

    def transpose(self, y):
        return y * self.mask


class NonLinearOperator(LinearOperator):
    def project(self, data, measurement, **kwargs):
        return data + measurement - self.forward(data, noiseless=True)


@register_operator(name="phase_retrieval")
class PhaseRetrievalOperator(NonLinearOperator):
    """|F(pad(x))| amplitude measurement: the centred orthonormal 2-D FFT
    of the zero-padded image."""

    def __init__(self, oversample=2.0, in_shape=(1, 3, 256, 256), sigma_s=0.0, device=None,
                 **kwargs):
        self.device = resolve_device(device)
        self.pad = int((oversample / 8.0) * in_shape[-1])
        self.in_shape = tuple(in_shape)
        p2 = 2 * self.pad
        self.out_shape = tuple(in_shape[:2]) + (in_shape[2] + p2, in_shape[3] + p2)
        self.sigma_s = float(np.float32(sigma_s))

    def forward(self, data, noiseless=False, generator=None):
        p = self.pad
        padded = F.pad(data, (p, p, p, p))
        cdt = torch.complex128 if data.dtype == torch.float64 else torch.complex64
        return self._noise(torch.abs(fft2c(padded.to(cdt))), noiseless, generator)


@register_operator(name="nonlinear_blur")
class NonlinearBlurOperator(NonLinearOperator):
    """Learned kernel-space blur: needs the external bkse KernelWizard model,
    which neither the JAX package nor its upstream has; raises as the JAX
    package does."""

    def __init__(self, opt_yml_path=None, **kwargs):
        raise NotImplementedError(
            "nonlinear_blur requires the external bkse KernelWizard model, "
            "which is missing from the upstream snapshot as well")

"""Measurement operators A for y = A x + n: the FFT blur family.

Counterpart of ``free_hunch_tpu/operators/linear.py`` (``LinearOperator``,
``_FFTBlurOperator``, ``GaussianBlurOperator``, ``MotionBlurOperator``,
:75-205). Operators hold their OTF on the device as ``complex64`` and draw
measurement noise from a passed ``torch.Generator``. The registry holds
only the operators this port has.
"""
from __future__ import annotations

import numpy as np
import torch

from free_hunch_tpu_torch import resolve_device
from free_hunch_tpu_torch.operators import assets
from free_hunch_tpu_torch.ops.fftops import fft_conv, p2o_np

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
        n = torch.randn(y.shape, generator=generator, dtype=y.dtype, device=y.device)
        return y + self.sigma_s * n


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

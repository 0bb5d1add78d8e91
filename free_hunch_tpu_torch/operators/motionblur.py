"""Random motion-blur kernel synthesis.

The port's copy of ``free_hunch_tpu/operators/motionblur.py``: the same
numpy/scipy code, so one ``numpy`` seed gives the same kernel bit for bit.
A random non-uniform motion path rasterised into a PSF; the paper's
evaluation uses the fixed bundled kernel (``assets.motion_blur_kernel``).
Host numpy at operator setup.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter


class MotionKernel:
    """Random motion PSF. intensity in [0, 1]: 0 = smooth near-linear path,
    1 = highly erratic path."""

    def __init__(self, size=(61, 61), intensity=0.5, rng=None):
        assert 0 <= intensity <= 1
        self.size = size if isinstance(size, tuple) else (size, size)
        self.intensity = float(intensity)
        rng = np.random.default_rng(rng)
        self.kernelMatrix = self._sample(rng)

    def _sample(self, rng) -> np.ndarray:
        h, w = self.size
        n_steps = 4 * max(h, w)
        # random-walk heading: wobble grows with intensity
        heading = rng.uniform(0, 2 * np.pi)
        turn_scale = 0.08 + 0.9 * self.intensity
        step = max(h, w) / n_steps * (0.6 + 0.8 * rng.uniform())
        xy = np.zeros((n_steps, 2))
        pos = np.zeros(2)
        for i in range(n_steps):
            heading += turn_scale * rng.normal()
            # occasional sharp kink for high intensity
            if rng.uniform() < 0.02 * self.intensity:
                heading += np.pi * rng.uniform(-0.5, 0.5)
            pos = pos + step * np.array([np.cos(heading), np.sin(heading)])
            xy[i] = pos
        xy -= xy.mean(axis=0)
        # rasterise path onto the grid with bilinear splatting
        k = np.zeros((h, w))
        cx, cy = (w - 1) / 2, (h - 1) / 2
        px = np.clip(xy[:, 0] + cx, 0, w - 1.001)
        py = np.clip(xy[:, 1] + cy, 0, h - 1.001)
        x0, y0 = px.astype(int), py.astype(int)
        fx, fy = px - x0, py - y0
        np.add.at(k, (y0, x0), (1 - fx) * (1 - fy))
        np.add.at(k, (y0, x0 + 1), fx * (1 - fy))
        np.add.at(k, (y0 + 1, x0), (1 - fx) * fy)
        np.add.at(k, (y0 + 1, x0 + 1), fx * fy)
        k = gaussian_filter(k, sigma=0.8 + 0.7 * (1 - self.intensity))
        s = k.sum()
        return (k / s) if s > 0 else np.full((h, w), 1.0 / (h * w))

"""The check's rule for pixels on the clip: a pixel that D clips whose
reference value lies within the torso's own rounding of the clip may have
passed the clip's gradient, and is left out of ``guide``."""
import torch

from _tiny import BENCH  # noqa: F401

import compare  # noqa: E402


def test_a_pixel_within_the_torsos_rounding_of_the_clip_is_an_edge():
    pre = torch.tensor([[0.5, -0.3, -1.0000043, -1.01]])
    D = torch.tensor([[0.5 + 2e-5, -0.3 - 1e-5, -1.0, -1.0]])   # inside errors 2e-5, 1e-5
    x_t = torch.tensor([[0.6, -0.2, -0.999995, -0.99]])
    # 5% of the pixel's sigma F alone (4.6e-7) misses the third pixel
    assert compare.clip_edge(D, pre, x_t).tolist() == [[False, False, False, False]]
    band = compare.torso_band(D, pre)
    assert torch.allclose(band, torch.tensor([[2e-5]]), rtol=1e-2)
    assert compare.clip_edge(D, pre, x_t, band).tolist() == [[False, False, True, False]]


def test_a_row_that_clips_everything_has_no_torso_band():
    D = torch.ones((2, 3, 2, 2))
    D[1, 0, 0, 0] = 0.25
    pre = torch.full((2, 3, 2, 2), 1.5)
    pre[1, 0, 0, 0] = 0.5
    band = compare.torso_band(D, pre)
    assert band.shape == (2, 1, 1, 1)
    assert band.flatten().tolist() == [0.0, 0.25]

"""A configuration above the bundled images' 256 px: the run's inputs are
the bundled images bilinearly upsampled, and a DCT prior asset shorter
than the image's dimensions raises. Inputs only, at 512 px."""
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from _tiny import BENCH

import harness  # noqa: E402
import inputs  # noqa: E402
import spec  # noqa: E402

SEED = 2 ** 31 + 512


@pytest.mark.parametrize("traffic", ["blur-vjp", "inpaint-covgrad"])
def test_inputs_at_512_px_are_the_bundled_images_upsampled(traffic):
    torch.set_num_threads(2)
    images = inputs.bundled_images(BENCH.parent / ".bench_cache" / "data")
    tr = dict(spec.cell(f"imagenet256-{traffic}")["traffic"], batch=2)
    big = inputs.Run(SEED, 0, tr, images, "cpu", 512)
    small = inputs.Run(SEED, 0, tr, images, "cpu", 256)
    for t in (big.clean, big.noise, big.y):
        assert t.shape == (2, 3, 512, 512) and bool(torch.isfinite(t).all())
    assert float(big.clean.min()) >= -1.0 and float(big.clean.max()) <= 1.0
    torch.testing.assert_close(big.clean, F.interpolate(small.clean, size=(512, 512),
                                                        mode="bilinear", align_corners=False))
    assert float((F.avg_pool2d(big.clean, 2) - small.clean).abs().mean()) < 0.05


def test_a_dct_prior_shorter_than_the_image_raises():
    dct = {"name": "dct_diagonal", "dataset": "imagenet"}
    with pytest.raises(ValueError, match="variances"):
        harness.prior_diag(dct, SimpleNamespace(image_size=512), "cpu")
    assert harness.prior_diag(dct, SimpleNamespace(image_size=256), "cpu").shape == (196608,)
    assert harness.prior_diag(dct, SimpleNamespace(image_size=32), "cpu").shape == (3072,)
    ones = harness.prior_diag({"name": "identity"}, SimpleNamespace(image_size=512), "cpu")
    assert ones.shape == (3 * 512 * 512,) and bool((ones == 1).all())

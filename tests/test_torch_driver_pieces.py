"""Pieces of the port's evaluation driver below ``Evaluator``: the per-row
inpainting operator that ``DDNMEvaluator`` builds from its masks, the
draws from a CPU generator that give a run on the card the CPU's inputs,
and, on the card, K1 at every GroupNorm shape of the driver's last batch
(ten images at batch 8 end with a batch of 2, whose plan has more and
shorter chunks per sample than batch 8's) and of a rank's batches in a
world of two (5, and 1). The card tests skip without
an NVIDIA card (a CUDA kernel has no CPU mode). The file imports no JAX
(so not ``_torch_parity``; its CPU tests are a few small draws), so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_driver_pieces.py -q
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import free_hunch_tpu_torch as fht
from free_hunch_tpu_torch.operators import masks as tmasks
from free_hunch_tpu_torch.operators import svd

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_gn_plan import norm_calls  # noqa: E402

RES = 32


def test_inpainting_from_masks_rows_follow_the_masks():
    """Per-row masks repeated per seed replica, and one shared mask, give
    the operators built from the masks' missing indices by hand."""
    opt = {"mask_type": "random", "mask_prob_range": (0.2, 0.4), "image_size": RES}
    masks = torch.cat([tmasks.generate_mask(torch.Generator().manual_seed(s), opt)
                       for s in (3, 4)])
    missing = [np.where(m.reshape(-1).numpy() == 0)[0] for m in masks]
    rows = svd.Inpainting.from_masks(masks, repeats=3, device="cpu")
    want = svd.Inpainting(3, RES, [m for m in missing for _ in range(3)], device="cpu")
    one = svd.Inpainting.from_masks(masks[:1], shared=True, device="cpu")
    for got, ref in ((rows, want), (one, svd.Inpainting(3, RES, missing[0], device="cpu"))):
        for name in ("_perm", "_inv_perm", "_singulars"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(ref, name).numpy())
    assert rows._perm.shape == (6, 3 * RES * RES) and one._perm.dim() == 1
    per_gen = svd.create_inpainting_operator(
        3, RES, opt, generator=[torch.Generator().manual_seed(s) for s in (3, 4)], repeats=3,
        device="cpu")
    np.testing.assert_array_equal(per_gen._perm.numpy(), rows._perm.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_randn_is_the_generators_draw(dtype):
    got = fht.randn((2, 3, 4), torch.Generator().manual_seed(9), dtype=dtype, device="cpu")
    want = torch.randn((2, 3, 4), generator=torch.Generator().manual_seed(9), dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert fht.randn((5,), None, device=None).device.type == "cpu"


@pytest.mark.cuda
def test_randn_gives_the_card_the_cpu_draws():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen, ref = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    draws = [fht.randn((8, 3, 64, 64), gen, device="cuda") for _ in range(3)]
    torch.cuda.synchronize()
    for d in draws:
        assert d.is_cuda and torch.equal(d.cpu(), torch.randn((8, 3, 64, 64), generator=ref))


# ten images at batch 8 end with a batch of 2; a world of two ranks strides
# them 5 and 5: one batch of 5 each at batch 8, and 2, 2, 1 at batch 2
SMALL_BATCHES = sorted({(n, s, z) for n in (2, 5, 1) for _, s, z in norm_calls(batch=n)},
                       key=lambda k: (k[0] != 2, -k[0], -k[1][1], -k[1][3]))


@pytest.mark.cuda
@pytest.mark.parametrize("n,shape,itemsize", SMALL_BATCHES,
                         ids=[f"batch{n}_{s[1]}px_{s[3]}_{'f32' if z == 4 else 'bf16'}"
                              for n, s, z in SMALL_BATCHES])
def test_k1_matches_plain_at_every_shape_of_the_last_batch(n, shape, itemsize):
    """K1 with and without SiLU on the path its planner takes at the
    driver's smaller batches (2, and a rank's 5 and 1): two bf16 ulps, or
    1e-5 in f32, as at batch 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import groupnorm as gn
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(6)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    for silu in (True, False):
        want = gn.groupnorm_silu_plain(x, g, b, 32, 1e-5, silu)
        y = gn.groupnorm_silu_cuda(x, g, b, 32, 1e-5, silu)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        else:
            ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
            assert float((y.float() - want.float()).abs().max()) <= 2 * float(ulp)

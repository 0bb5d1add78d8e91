"""The port's hand-written kernels against their plain PyTorch versions on
the card, at the shapes the main path gives them. These tests need an NVIDIA
card and skip without one (a CUDA kernel has no CPU mode). The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""
import pytest
import torch

from free_hunch_tpu_torch.ops import groupnorm as gn


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,silu", [
    ((2, 256, 256, 256), torch.bfloat16, True),
    ((2, 256, 256, 512), torch.bfloat16, True),
    ((2, 256, 256, 256), torch.float32, True),
    ((2, 8, 8, 1024), torch.bfloat16, True),
    ((2, 32, 32, 96), torch.float32, False),
    ((3, 5, 7, 64), torch.bfloat16, False),
], ids=["in_norm", "decoder_concat", "out_norm_f32", "attn_8x8", "odd_width", "ragged"])
def test_kernel_matches_plain_on_the_card(shape, dtype, silu):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    before = gn.launches
    y = gn.groupnorm_silu(x, g, b, 32, 1e-5, silu)
    torch.cuda.synchronize()
    assert gn.launches == before + 1
    want = gn.groupnorm_silu_plain(x, g, b, 32, 1e-5, silu)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    else:
        # f32 arithmetic rounded once to bf16: two bf16 ulps of the magnitude
        ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
        assert float((y.float() - want.float()).abs().max()) <= 2 * float(ulp)
    # backward through the kernel's autograd.Function equals plain autograd
    xs = x[:1, :8].float().contiguous().requires_grad_(True)
    xr = xs.detach().clone().requires_grad_(True)
    gn.groupnorm_silu(xs, g, b, 32, 1e-5, silu).square().sum().backward()
    gn.groupnorm_silu_plain(xr, g, b, 32, 1e-5, silu).square().sum().backward()
    torch.testing.assert_close(xs.grad, xr.grad, rtol=1e-4, atol=1e-5)

"""The frozen counts of benchmark/flops.py: the denoiser's products
against the port's FLOP tool at batch 1, and the GroupNorm bytes against
the calls a program forward and pullback make."""
import pytest
import torch

from _tiny import ADM, BENCH, TINY_MODEL, one_thread

import flops  # noqa: E402

SETUPS = {"imagenet256-adm": (BENCH.parent / "models" / "256x256_diffusion_uncond_setup.txt",
                              2_239_665_537_024, 101),
          "ffhq256-adm": (BENCH.parent / "models" / "ffhq_10m_setup.txt", 387_934_191_616, 65)}


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_forward_count_matches_the_tool_at_batch_1(name):
    """The count from the configuration's shapes equals what the port's
    tools/count_flops.py reads from a CPU forward (ImageNet 2.240 TFLOP,
    FFHQ 0.388 TFLOP)."""
    import spec
    from free_hunch_tpu_torch.tools import count_flops
    one_thread()
    torch.set_num_threads(4)
    setup, want, norms = SETUPS[name]
    arch = ADM.arch_of(spec.config(name)["model"])
    mine = sum(ADM.forward_flops(arch, "bfloat16", 1).values())
    assert mine == want
    assert len(ADM.norm_inputs(arch)) == norms
    precond, _ = count_flops.load_denoiser(str(setup), None, device="cpu")
    got = count_flops.forward_flops(precond, 1)["flops_per_forward"]
    assert got == mine


def test_the_pullback_count_is_the_tools_backward():
    """The input pullback's products equal what the tool counts in a vjp
    of the tiny UNet, less the weight gradients (frozen parameters)."""
    import spec
    from free_hunch_tpu_torch.models import loading
    from free_hunch_tpu_torch.models.unet import create_model
    from free_hunch_tpu_torch.tools.count_flops import count_flops
    one_thread()
    cfg = spec.config("imagenet256-adm")["model"]
    cfg.update(TINY_MODEL)
    arch = ADM.arch_of(cfg)
    model = create_model(**cfg, remat=False).eval().requires_grad_(False)
    pre = loading.wrap_precond(model, cfg)
    x = torch.zeros((2, 3, 32, 32), requires_grad=True)

    def vjp():
        d, _ = pre(x, 5.0)
        return torch.autograd.grad(d, x, torch.ones_like(d))

    _, total, _ = count_flops(vjp)
    want = sum(ADM.forward_flops(arch, "bfloat16", 2).values()) + \
        sum(ADM.input_backward_flops(arch, "bfloat16", 2).values())
    assert total == want


def test_norm_bytes_from_the_shapes_match_the_program_calls():
    """K1's bytes (x read, y written) and the GroupNorm pullback's (x, dy
    read, dx written) summed over the norms of one forward, from the
    shapes, equal what the program's GroupNorm modules see."""
    import spec
    from free_hunch_tpu_torch.models.unet import create_model
    one_thread()
    cfg = spec.config("ffhq256-adm")["model"]
    cfg.update(TINY_MODEL)
    arch = ADM.arch_of(cfg)
    model = create_model(**cfg, remat=False).eval().requires_grad_(False)
    seen = []
    for m in model.modules():
        if type(m).__name__ == "GroupNorm32":
            m.register_forward_hook(lambda mod, a, o: seen.append(tuple(a[0].shape[1:])))
    with torch.no_grad():
        model(torch.zeros((1, 3, 32, 32)), torch.zeros((1,)))
    assert seen == list(ADM.norm_inputs(arch))
    shape = (8, 512, 256, 256)
    assert flops.k1_bytes(shape, 2) == 2 * 8 * 512 * 256 * 256 * 2
    assert flops.gn_backward_bytes(shape, 2) == 3 * 8 * 512 * 256 * 256 * 2

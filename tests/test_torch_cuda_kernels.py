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


# -- K1 on a height shard: the stats and apply entries (csrc/groupnorm.cu) -----

@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,silu,shards", [
    ((2, 256, 256, 256), torch.bfloat16, True, 2),
    ((8, 128, 256, 512), torch.bfloat16, True, 2),
    ((2, 256, 256, 256), torch.float32, True, 2),
    ((8, 8, 8, 1024), torch.bfloat16, False, 2),
    ((8, 32, 32, 512), torch.bfloat16, True, 4),
    ((3, 12, 7, 64), torch.float32, False, 3),
], ids=["in_norm", "decoder_concat_half", "out_norm_f32", "attn_8x8", "32px_4", "ragged_3"])
def test_shard_entries_and_merge_match_plain_on_the_card(shape, dtype, silu, shards):
    """The rows of one tensor cut into ``shards`` height shards in one
    process: each shard's stats entry, then each shard's apply entry on the
    stacked partials (it merges them in shard order), against the plain
    version of the whole tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, h, w, c = shape
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    parts = [x[:, i * h // shards:(i + 1) * h // shards].contiguous() for i in range(shards)]
    before = dict(gn.sharded_launches)
    stats = torch.stack([gn.shard_stats_cuda(p) for p in parts])
    y = torch.cat([gn.shard_apply_cuda(p, stats, g, b, 32, 1e-5, silu) for p in parts], dim=1)
    torch.cuda.synchronize()
    assert gn.sharded_launches == {k: v + shards for k, v in before.items()}
    want = gn.groupnorm_silu_plain(x, g, b, 32, 1e-5, silu)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
        assert float((y.float() - want.float()).abs().max()) <= 2 * float(ulp)


# -- K2: GroupNorm + affine + SiLU + int8 quantise (csrc/gn_quant.cu) ---------

def _gn_quant_inputs(shape, dtype, gen, offset=0.5):
    n, c = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + offset).to(dtype)
    g = torch.randn((n, c), generator=gen, device="cuda") * 0.2 + 1
    b = torch.randn((n, c), generator=gen, device="cuda") * 0.2
    return x, g, b


def check_gn_quant(x, g, b):
    """K2 against its plain version: the scales to 1e-6 relative, the codes
    equal except where y / s lies within rounding of a half-integer (the two
    compute y with other summation orders for the statistics): there they
    may differ by one, on at most 1e-4 of the codes. Where a group's |mean|
    is far above its std, f32 rounding of x - mean in either version is
    amplified by |mean| / std: the scale tolerance grows to 2 f32 epsilons
    times that ratio, and more codes lie within rounding of a tie (1e-3 of
    them where the ratio passes 10). Returns (max code difference, fraction
    of codes that differ, max relative scale error)."""
    from free_hunch_tpu_torch.ops import gn_quant as gq
    before = gq.launches
    xq, s = gq.gn_silu_quant(x, g, b, 32, 1e-5)
    torch.cuda.synchronize()
    assert gq.launches == before + 1
    wq, ws = gq.gn_silu_quant_plain(x, g, b, 32, 1e-5)
    assert xq.dtype == torch.int8 and xq.shape == x.shape and s.shape == ws.shape
    rel = float(((s - ws).abs() / ws).max())
    d = (xq.int() - wq.int()).abs()
    frac = float((d > 0).float().mean())
    xf = x.float()
    ratio = float(xf.mean().abs() / xf.std())
    assert rel <= max(1e-6, 2 * 2.0 ** -23 * ratio), (rel, ratio)
    assert int(d.max()) <= 1 and frac <= (1e-3 if ratio > 10 else 1e-4), (int(d.max()), frac)
    return int(d.max()), frac, rel


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", [
    ((8, 256, 256, 256), torch.bfloat16, 0.5),
    ((8, 64, 64, 1024), torch.bfloat16, 0.5),
    ((8, 8, 8, 2048), torch.bfloat16, 0.5),
    ((2, 32, 32, 64), torch.float32, 0.5),
    ((3, 5, 7, 96), torch.float32, 0.5),
    ((2, 16, 16, 256), torch.float32, 300.0),
], ids=["256px", "64px_1024", "8px_2048", "f32", "ragged_f32", "mean_over_std"])
def test_gn_quant_kernel_matches_plain_on_the_card(shape, dtype, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    check_gn_quant(*_gn_quant_inputs(shape, dtype, gen, offset))


@pytest.mark.cuda
def test_gn_quant_kernel_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import gn_quant as gq
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, g, b = _gn_quant_inputs((2, 4, 4, 48), torch.bfloat16, gen)
    with pytest.raises(ValueError, match="multiple"):
        gq.gn_silu_quant_cuda(x, g, b, 16, 1e-5)
    x, g, b = _gn_quant_inputs((2, 4, 4, 64), torch.bfloat16, gen)
    with pytest.raises(TypeError):
        gq.gn_silu_quant_cuda(x.half(), g, b)
    shifted = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")[1:1 + x.numel()]
    with pytest.raises(ValueError, match="aligned"):
        gq.gn_silu_quant_cuda(shifted.view(x.shape), g, b)


# -- K1 and K2 at every shape of one 256 px forward; K2's abs-max paths ------

def _forward_shapes():
    """(route, NHWC shape, itemsize) of each distinct GroupNorm call of one
    256 px forward at batch 8 (tests/test_torch_gn_plan.py lists them)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_gn_plan import norm_calls
    return sorted(set(norm_calls()), key=lambda k: (k[0], -k[1][1], -k[1][3], k[2]))


FORWARD_NORMS = _forward_shapes()
K2_SHAPES = [s for r, s, _ in FORWARD_NORMS if r == "k2"]
K1_SHAPES = sorted({(s, z) for _, s, z in FORWARD_NORMS}, key=lambda k: (-k[0][1], -k[0][3]))


def _ffhq_shapes():
    """(NHWC shape, itemsize) of each distinct GroupNorm call of the FFHQ
    UNet's forward (``models/ffhq_10m_setup.txt``: 128 channels, one res
    block, attention at 16 px) at batch 8: at 128 channels a group has 4, so
    a 16-byte bf16 vector of K1 spans two groups."""
    from test_torch_gn_plan import norm_calls
    return sorted({(s, z) for _, s, z in norm_calls(mc=128, blocks=1, attn_res=(16,))},
                  key=lambda k: (-k[0][1], -k[0][3]))


FFHQ_K1_SHAPES = _ffhq_shapes()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,itemsize", K1_SHAPES,
                         ids=[f"{s[1]}px_{s[3]}_{'f32' if z == 4 else 'bf16'}"
                              for s, z in K1_SHAPES])
def test_kernel_matches_plain_at_every_forward_shape(shape, itemsize):
    """K1 with and without SiLU at every distinct shape of one forward, on
    the path its planner takes: two bf16 ulps, or 1e-5 in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,itemsize", FFHQ_K1_SHAPES,
                         ids=[f"{s[1]}px_{s[3]}_{'f32' if z == 4 else 'bf16'}"
                              for s, z in FFHQ_K1_SHAPES])
def test_kernel_matches_plain_at_every_ffhq_forward_shape(shape, itemsize):
    """K1 at every distinct shape of the FFHQ UNet's forward at batch 8,
    with the same limits."""
    test_kernel_matches_plain_at_every_forward_shape(shape, itemsize)


# -- K1's backward: the input gradient (csrc/gn_backward.cuh) -----------------

def _close_to_twin(dx, want, dtype):
    """f32: rtol 1e-4 / atol 1e-5 (other orders of sums, __expf); bf16: both
    compute in f32 and round once, two bf16 ulps of the magnitude."""
    if dtype == torch.float32:
        torch.testing.assert_close(dx, want, rtol=1e-4, atol=1e-5)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
        err = float((dx.float() - want.float()).abs().max())
        assert err <= 2 * float(ulp), (err, float(ulp))


def check_backward(shape, itemsize, seed=12, groups=32, eps=1e-5):
    """The backward kernel at one shape, with and without SiLU: through the
    autograd Function (the forward's statistics where its two-pass path
    kept them) and alone with the statistics computed again (the cluster
    path), each against the plain twin, each bitwise the same on a second
    run, and one ``bwd_launches`` a call."""
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    for silu in (True, False):
        want = gn.groupnorm_silu_backward_plain(x, dy, g, b, groups, eps, silu)
        before = gn.bwd_launches
        got = []
        for _ in range(2):
            xg = x.detach().requires_grad_(True)
            y = gn.groupnorm_silu(xg, g, b, groups, eps, silu)
            got.append(torch.autograd.grad(y, xg, dy)[0])
        for _ in range(2):
            got.append(gn.groupnorm_silu_backward_cuda(x, dy, g, b, groups, eps, silu))
        torch.cuda.synchronize()
        assert gn.bwd_launches == before + 4
        assert torch.equal(got[0], got[1]) and torch.equal(got[2], got[3])
        for dx in (got[0], got[2]):
            assert dx.dtype == dtype and dx.shape == x.shape
            _close_to_twin(dx, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,itemsize", K1_SHAPES,
                         ids=[f"{s[1]}px_{s[3]}_{'f32' if z == 4 else 'bf16'}"
                              for s, z in K1_SHAPES])
def test_backward_kernel_matches_plain_at_every_forward_shape(shape, itemsize):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    check_backward(shape, itemsize)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,itemsize", FFHQ_K1_SHAPES,
                         ids=[f"{s[1]}px_{s[3]}_{'f32' if z == 4 else 'bf16'}"
                              for s, z in FFHQ_K1_SHAPES])
def test_backward_kernel_matches_plain_at_every_ffhq_forward_shape(shape, itemsize):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    check_backward(shape, itemsize)


def _ncsnpp_shapes():
    """(NHWC shape, groups, itemsize) of each distinct GroupNorm call of
    NCSN++'s forward at FFHQ 1024 px, batch 8 (min(C / 4, 32) groups; 16 to
    48 channels over 1M rows at 1024 px), in both types."""
    from test_torch_gn_plan import ncsnpp_norm_calls
    out = []
    for n, s, c, g in ncsnpp_norm_calls():
        side = int(round(s ** 0.5))
        out += [((n, side, side, c), g, z) for z in (2, 4)]
    return sorted(out, key=lambda k: (-k[0][1], -k[0][3], k[2]))


NCSNPP_K1_SHAPES = _ncsnpp_shapes()
NCSNPP_IDS = [f"ncsnpp_{s[1]}px_{s[3]}_g{g}_{'f32' if z == 4 else 'bf16'}"
              for s, g, z in NCSNPP_K1_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,itemsize", NCSNPP_K1_SHAPES, ids=NCSNPP_IDS)
def test_kernel_matches_plain_at_every_ncsnpp_forward_shape(shape, groups, itemsize):
    """K1 with and without SiLU at NCSN++'s groups and eps 1e-6: two bf16
    ulps, or 1e-5 in f32, as at the UNets' shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    for silu in (True, False):
        want = gn.groupnorm_silu_plain(x, g, b, groups, 1e-6, silu)
        y = gn.groupnorm_silu_cuda(x, g, b, groups, 1e-6, silu)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        else:
            ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
            assert float((y.float() - want.float()).abs().max()) <= 2 * float(ulp)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,itemsize", NCSNPP_K1_SHAPES, ids=NCSNPP_IDS)
def test_backward_kernel_matches_plain_at_every_ncsnpp_forward_shape(shape, groups, itemsize):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    check_backward(shape, itemsize, groups=groups, eps=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,itemsize", [
    ((3, 5, 7, 64), 4), ((3, 5, 7, 96), 2), ((2, 17, 13, 256), 2), ((1, 40, 40, 128), 4),
    ((2, 64, 64, 128), 2)], ids=["ragged_f32", "ragged_bf16", "ragged_17x13", "40px_f32",
                                 "64px_128"])
def test_backward_kernel_on_ragged_shapes(shape, itemsize):
    """Short last chunks, a group narrower than a 16-byte vector, calls
    whose forward takes K1's one-launch path (no statistics kept) at more
    than 128 rows a cluster block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    check_backward(shape, itemsize)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 8, 1024), (8, 32, 32, 512), (8, 32, 32, 1536)],
                         ids=["8px_1024", "32px_512", "32px_1536"])
def test_backward_kernel_two_pass_forced_on_a_small_call(shape):
    """The two-pass path forced where the planner takes the cluster path,
    with the statistics of K1's two-pass path; the cluster path with them
    and without: each holds the plain twin's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(13)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).bfloat16()
    dy = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    want = gn.groupnorm_silu_backward_plain(x, dy, g, b)
    _, stats = gn._groupnorm_launch(x, g, b, 32, 1e-5, True, path="two-pass", keep_stats=True)
    for path, st in (("cluster", None), ("cluster", stats), ("two-pass", stats)):
        _close_to_twin(gn.groupnorm_silu_backward_cuda(x, dy, g, b, stats=st, path=path), want,
                       torch.bfloat16)


@pytest.mark.cuda
def test_backward_kernel_time_lies_under_its_span():
    """The profiler puts the kernel's device time under the
    ``groupnorm_silu_backward`` range, which ``gn_bwd_roofline`` reads, and
    the tracer counts one kernel pullback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from torch.autograd import DeviceType
    from free_hunch_tpu_torch.utils import profiling
    gen = torch.Generator(device="cuda").manual_seed(14)
    for shape in ((8, 64, 64, 512), (8, 16, 16, 1024)):
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16().requires_grad_(True)
        g = torch.ones(shape[-1], device="cuda")
        b = torch.zeros(shape[-1], device="cuda")
        y = gn.groupnorm_silu(x, g, b)
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(y, x, torch.ones_like(y))
            torch.cuda.synchronize()
        spans = [e for e in prof.events() if e.device_type == DeviceType.CPU and
                 e.name == "groupnorm_silu_backward"]
        assert len(spans) == 1 and spans[0].device_time_total > 0, shape
        assert profiling.snapshot()["counts"] == {"gn_bwd.kernel": 1}


def _full_pass_agrees(x, g, b):
    """K2 as planned (the scale from the statistics' extremes, or on the
    cluster path the exact abs-max) against K2 forced through the two-pass
    path's full abs-max pass: bitwise equal codes and scales. Returns the
    flags."""
    from free_hunch_tpu_torch.ops import gn_quant as gq
    xq, s, flags = gq._gn_silu_quant_launch(x, g, b, 32, 1e-5)
    fq, fs, fflags = gq._gn_silu_quant_launch(x, g, b, 32, 1e-5, full=True, path="two-pass")
    torch.cuda.synchronize()
    assert bool(fflags.all())
    assert torch.equal(fs, s), (fs.flatten() - s.flatten()).abs().max()
    assert torch.equal(fq, xq)
    return flags


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K2_SHAPES, ids=[f"{s[1]}px_{s[3]}" for s in K2_SHAPES])
def test_gn_quant_kernel_matches_plain_at_every_forward_shape(shape):
    """K2 at every distinct shape of one fused-int8 forward: the plain
    version's check, no sample flagged, and the scale from the extremes
    equal to the full pass's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, g, b = _gn_quant_inputs(shape, torch.bfloat16, gen)
    check_gn_quant(x, g, b)
    assert not bool(_full_pass_agrees(x, g, b).any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((8, 32, 32, 512), torch.bfloat16),
    ((3, 5, 7, 96), torch.float32),
    ((2, 64, 64, 256), torch.float32),
], ids=["32px_bf16", "ragged_f32", "64px_f32"])
def test_gn_quant_kernel_flagged_path_on_the_card(shape, dtype):
    """Samples whose every t is negative (gamma / 5, beta / 10 - 1.28) have
    their abs-max in the SiLU's negative lobe: they are flagged, take the
    full pass, and hold the plain version's check; the others are not.
    Also negative gamma on one sample."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, g, b = _gn_quant_inputs(shape, dtype, gen)
    n = shape[0]
    g[0] *= 0.2
    b[0] = b[0] * 0.1 - 1.28
    g[n - 1] = -g[n - 1].abs()
    check_gn_quant(x, g, b)
    flags = _full_pass_agrees(x, g, b)
    assert flags.tolist() == [1] + [0] * (n - 1)


@pytest.mark.cuda
def test_gn_quant_kernel_ragged_last_chunk_and_constant_channels():
    """S = 17 * 13 rows leave the last chunk short; constant channels have
    min = max; gamma negative on half the channels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import gn_quant as gq
    from free_hunch_tpu_torch.ops.groupnorm import device_sms, gn_plan
    shape = (4, 17, 13, 256)
    plan = gn_plan(4, 17 * 13, 256, 32, 2, device_sms("cuda"), quant=True)
    assert plan.chunks * plan.rows > 17 * 13
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, g, b = _gn_quant_inputs(shape, torch.bfloat16, gen)
    x[..., ::7] = 0.75
    g[:, ::2] *= -1
    check_gn_quant(x, g, b)
    assert not bool(_full_pass_agrees(x, g, b).any())
    assert gq.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((8, 16, 16, 1024), torch.bfloat16),
    ((8, 32, 32, 512), torch.bfloat16),
    ((8, 8, 8, 2048), torch.bfloat16),
    ((3, 8, 8, 96), torch.float32),
], ids=["16px_1024", "32px_512", "8px_2048", "8px_96_f32"])
def test_cluster_path_equals_the_two_pass_path_bitwise(shape, dtype):
    """The one-launch path (csrc/gn_cluster.cuh) and the two-pass path cut
    into the same chunks compute the same arithmetic in the same order:
    K1's outputs (with and without SiLU) and K2's codes, scales and flags
    are bitwise equal, and each holds its plain version's check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import gn_quant as gq
    from free_hunch_tpu_torch.ops.groupnorm import device_sms, gn_plan
    n, h, w, c = shape
    size = torch.tensor([], dtype=dtype).element_size()
    assert gn_plan(n, h * w, c, 32, size, device_sms("cuda")).path == "cluster"
    gen = torch.Generator(device="cuda").manual_seed(9)
    x, g2, b2 = _gn_quant_inputs(shape, dtype, gen)
    g, b = g2[0].contiguous(), b2[0].contiguous()
    for silu in (True, False):
        y = gn._groupnorm_launch(x, g, b, 32, 1e-5, silu)
        y2 = gn._groupnorm_launch(x, g, b, 32, 1e-5, silu, path="two-pass")
        torch.cuda.synchronize()
        assert torch.equal(y, y2)
    before = gn.launches
    gn.groupnorm_silu(x, g, b, 32, 1e-5, True)
    assert gn.launches == before + 1
    xq, s, f = gq._gn_silu_quant_launch(x, g2, b2, 32, 1e-5)
    xq2, s2, f2 = gq._gn_silu_quant_launch(x, g2, b2, 32, 1e-5, path="two-pass")
    torch.cuda.synchronize()
    assert torch.equal(xq, xq2) and torch.equal(s, s2) and torch.equal(f, f2)
    check_gn_quant(x, g2, b2)


# -- K3: the int8 implicit-GEMM convolution (csrc/int8_conv.cu) --------------

def _int8(shape, gen):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


def check_int8_conv(xq, wk, pad, gen):
    """K3 against its plain version (float64 convolution, exact): the int32
    sums bitwise equal, and the f32 and bf16 outputs bitwise equal to the
    plain epilogue on those sums. One wrapper call counts one launch, split
    K and its epilogue kernel included."""
    from free_hunch_tpu_torch.ops import quant as q
    n, o = xq.shape[0], wk.shape[0]
    asc = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-3
    wsc = torch.rand(o, generator=gen, device="cuda") * 0.01 + 1e-3
    before = q.launches
    acc = q.int8_conv_cuda(xq, wk, None, None, pad, torch.int32)
    want = q.int8_conv_plain(xq, wk, None, None, pad, torch.int32)
    torch.cuda.synchronize()
    assert q.launches == before + 1
    assert torch.equal(acc, want)
    for dt in (torch.float32, torch.bfloat16):
        got = q.int8_conv_cuda(xq, wk, asc, wsc, pad, dt)
        assert torch.equal(got, q._epilogue(want, asc, wsc, dt)), dt
    return acc


def _plan(x_shape, wk_shape, pad):
    from free_hunch_tpu_torch.ops import quant as q
    n, h, w, i = x_shape
    o, kh, kw, _ = wk_shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return q.int8_conv_plan(n, h, w, i, o, kh, kw, pad, sms)


# (input, kernel size, O, pad, the plan's tile width and whether K is split)
K3_CASES = {
    "256_wide_tiles": ((8, 64, 64, 256), 3, 512, 1, 256, False),
    "128_wide_tiles": ((8, 32, 32, 256), 3, 384, 1, 128, False),
    "split_k_8px_1024": ((8, 8, 8, 1024), 3, 1024, 1, 256, True),
    "split_k_8px_2048": ((8, 8, 8, 2048), 3, 1024, 1, 256, True),
    "1x1_skip": ((8, 16, 16, 1024), 1, 512, 0, 128, True),
    "dense_qkv": ((8, 64, 1, 256), 1, 768, 0, 128, False),
    "dense_8px_proj_split": ((8, 64, 1, 1024), 1, 1024, 0, 128, True),
    "ragged_i16_o48": ((3, 9, 11, 16), 3, 48, 1, 128, False),
    "ragged_i80_o192": ((2, 13, 7, 80), 3, 192, 1, 128, True),
    "i48_3x3": ((4, 16, 16, 48), 3, 64, 1, 128, True),
    "wide_pad": ((2, 7, 5, 32), 3, 16, 2, 128, True),
    "small_i48": ((2, 6, 6, 48), 1, 32, 0, 128, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K3_CASES))
def test_int8_conv_kernel_matches_plain_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    x_shape, k, o, pad, bn, split = K3_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(3)
    xq, wk = _int8(x_shape, gen), _int8((o, k, k, x_shape[-1]), gen)
    plan = _plan(x_shape, wk.shape, pad)
    assert (plan.bn, plan.splits > 1) == (bn, split), plan
    check_int8_conv(xq, wk, pad, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("bn,splits", [(256, 1), (128, 1), (256, 3), (128, 8), (256, 72)])
def test_int8_conv_kernel_cuts_agree_bitwise_on_the_card(bn, splits):
    """Every cut of one 8 px call (tile width, K splits up to one per K
    block) gives the same int32 sums and outputs: integer addition is exact
    in any order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import quant as q
    gen = torch.Generator(device="cuda").manual_seed(7)
    xq, wk = _int8((8, 8, 8, 1024), gen), _int8((1024, 3, 3, 1024), gen)
    asc = torch.rand(8, generator=gen, device="cuda") * 0.01 + 1e-3
    wsc = torch.rand(1024, generator=gen, device="cuda") * 0.01 + 1e-3
    want = q.int8_conv_plain(xq, wk, None, None, 1, torch.int32)
    cut = (bn, splits)
    assert torch.equal(q._int8_conv_launch(xq, wk, None, None, 1, torch.int32, cut), want)
    got = q._int8_conv_launch(xq, wk, asc, wsc, 1, torch.bfloat16, cut)
    assert torch.equal(got, q._epilogue(want, asc, wsc, torch.bfloat16))
    with pytest.raises(ValueError, match="no cut"):
        q._int8_conv_launch(xq, wk, None, None, 1, torch.int32, (bn, 73))


@pytest.mark.cuda
def test_int8_conv_kernel_launch_cache_follows_the_weight():
    """The plan and the weights' tensor map are made once per weight and
    input shape: a repeated call reuses them, and a new weight of the same
    shape at a freed weight's address gets its own sums, not the old ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import quant as q
    gen = torch.Generator(device="cuda").manual_seed(8)
    xq = _int8((2, 8, 8, 64), gen)
    wk = _int8((32, 3, 3, 64), gen)
    ptr, entries = wk.data_ptr(), len(q._LAUNCHES)
    want = q.int8_conv_plain(xq, wk, None, None, 1, torch.int32)
    for _ in range(2):
        assert torch.equal(q.int8_conv_cuda(xq, wk, None, None, 1, torch.int32), want)
    assert len(q._LAUNCHES) == entries + 1
    del wk
    wk2 = _int8((32, 3, 3, 64), gen)
    want2 = q.int8_conv_plain(xq, wk2, None, None, 1, torch.int32)
    assert not torch.equal(want2, want)
    assert torch.equal(q.int8_conv_cuda(xq, wk2, None, None, 1, torch.int32), want2)
    if wk2.data_ptr() == ptr:   # the caching allocator's usual reuse: one entry serves both
        assert len(q._LAUNCHES) == entries + 1


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,k,o,pad", [
    ((8, 16, 16, 1024), 3, 512, 1),
    ((8, 8, 8, 2048), 3, 1024, 1),
    ((2, 9, 7, 48), 3, 80, 0),
], ids=["16px", "8px_split_k", "pad0_to_pad2"])
def test_int8_conv_kernel_pullback_matches_plain_on_the_card(x_shape, k, o, pad):
    """The int8 pullback's product: the cotangent (n, ho, wo, O) against the
    flipped, I/O-swapped weights ``wkT`` with padding k-1-pad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import quant as q
    gen = torch.Generator(device="cuda").manual_seed(6)
    n, h, w, i = x_shape
    qw = q.prepare_conv_weight(torch.randn((k, k, i, o), generator=gen, device="cuda"))
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    gq = _int8((n, ho, wo, o), gen)
    acc = check_int8_conv(gq, qw.wkT, k - 1 - pad, gen)
    assert acc.shape == (n, h, w, i)


@pytest.mark.cuda
def test_int8_conv_kernel_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import quant as q
    gen = torch.Generator(device="cuda").manual_seed(4)
    with pytest.raises(ValueError, match="multiples of 16"):
        q.int8_conv_cuda(_int8((1, 4, 4, 24), gen), _int8((16, 3, 3, 24), gen), None, None,
                         1, torch.int32)
    with pytest.raises(ValueError, match="stride"):
        q.int8_conv_cuda(_int8((1, 4, 4, 16), gen), _int8((16, 3, 3, 16), gen), None, None,
                         1, torch.int32, stride=2)
    with pytest.raises(ValueError, match="contiguous"):
        q.int8_conv_cuda(_int8((1, 16, 4, 4), gen).permute(0, 2, 3, 1),
                         _int8((16, 3, 3, 16), gen), None, None, 1, torch.int32)
    shifted = torch.empty(4 * 4 * 16 + 8, dtype=torch.int8, device="cuda")[1:1 + 256]
    with pytest.raises(ValueError, match="aligned"):
        q.int8_conv_cuda(shifted.view(1, 4, 4, 16), _int8((16, 3, 3, 16), gen), None, None,
                         1, torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        q.int8_conv_cuda(_int8((1, 4, 4, 16), gen).cpu(), _int8((16, 3, 3, 16), gen).cpu(),
                         None, None, 1, torch.int32)


@pytest.mark.cuda
def test_int8_layers_on_the_card_match_the_cpu():
    """int8_conv, its pullback and gn_quant_conv on the card (K2, K3)
    against the same functions on the CPU (plain versions), f32 operands:
    the int8 codes can differ by one at rounding ties (K2's y, the card's
    f32 arithmetic), so the outputs agree to a few quantisation steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import quant as q
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 8, 8, 64), generator=gen)
    w = torch.randn((3, 3, 64, 32), generator=gen) * 0.05
    gm = torch.randn((2, 64), generator=gen) * 0.1 + 1
    bt = torch.randn((2, 64), generator=gen) * 0.1
    ct = torch.randn((2, 8, 8, 32), generator=gen)
    for fn in (lambda u, d: q.int8_conv(u, w.to(d), 1),
               lambda u, d: q.gn_quant_conv(u, gm.to(d), bt.to(d), w.to(d), 1)):
        outs = []
        for dev in ("cpu", "cuda"):
            u = x.to(dev).requires_grad_(True)
            y = fn(u, dev)
            (g,) = torch.autograd.grad(y, u, ct.to(dev))
            outs.append((y.cpu(), g.cpu()))
        (y0, g0), (y1, g1) = outs
        y0, y1 = y0.detach(), y1.detach()
        torch.testing.assert_close(y1, y0, rtol=0, atol=0.02 * float(y0.abs().max()))
        torch.testing.assert_close(g1, g0, rtol=0, atol=0.02 * float(g0.abs().max()))


# -- the model axis's remainders: uneven and empty shards, K2's shard entries,
# -- K3's separate height and width padding -----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,silu,rows", [
    ((2, 12, 16, 64), torch.float32, True, (6, 0, 4, 2)),
    ((8, 96, 64, 256), torch.bfloat16, True, (40, 40, 16)),
    ((2, 3, 8, 512), torch.bfloat16, False, (1, 1, 1, 0, 0)),
], ids=["f32_with_an_empty_shard", "bf16_ragged_3", "deep_level_of_5"])
def test_k1_apply_entry_weights_unequal_and_zero_counts(shape, dtype, silu, rows):
    """Shards of unequal rows, one of none: each shard's stats entry (none
    launched for the empty one, whose partial is (0, 0, 0)), then each
    shard's apply entry on the stacked (mean, M2, count) partials, against
    the plain version of the whole tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    starts = [sum(rows[:i]) for i in range(len(rows))]
    parts = [x[:, s:s + r].contiguous() for s, r in zip(starts, rows)]
    before = dict(gn.sharded_launches)
    stats = torch.stack([gn.shard_stats_cuda(p) for p in parts])
    y = torch.cat([gn.shard_apply_cuda(p, stats, g, b, 32, 1e-5, silu) for p in parts], dim=1)
    torch.cuda.synchronize()
    filled = sum(r > 0 for r in rows)
    assert gn.sharded_launches == {k: v + filled for k, v in before.items()}
    if 0 in rows:
        assert float(stats[rows.index(0), ..., 2].abs().max()) == 0.0
    want = gn.groupnorm_silu_plain(x, g, b, 32, 1e-5, silu)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
        assert float((y.float() - want.float()).abs().max()) <= 2 * float(ulp)


def _k2_sharded_in_one_process(x, g, b, rows, full=False):
    """K2's shard entries on the height shards ``rows`` of x in one
    process: every shard's stats entry, the stacked partials, every shard's
    merge entry, the max of the shards' flagged abs-max (the group's
    max-merge) where a sample is flagged, every shard's apply entry; the
    codes concatenated and the scale (equal on every shard)."""
    from free_hunch_tpu_torch.ops import gn_quant as gq
    starts = [sum(rows[:i]) for i in range(len(rows))]
    shards = [x[:, s:s + r].contiguous() for s, r in zip(starts, rows)]
    parts = torch.stack([gq.shard_quant_stats_cuda(p) for p in shards])
    merged = [gq.shard_quant_merge_cuda(p, parts, g, b, full=full) for p in shards]
    flags = torch.stack([f for _, f, _ in merged])
    assert bool((flags == flags[0]).all())
    amax = torch.stack([a for _, _, a in merged]).amax(0)
    outs = [gq.shard_quant_apply_cuda(p, w, amax if bool(f.any()) else a, g, b)
            for p, (w, f, a) in zip(shards, merged)]
    scales = torch.stack([s for _, s in outs])
    assert bool((scales == scales[0]).all())
    return torch.cat([xq for xq, _ in outs], dim=1), scales[0], flags[0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,rows", [
    ((8, 256, 256, 256), torch.bfloat16, (128, 128)),
    ((8, 64, 64, 512), torch.bfloat16, (24, 24, 16)),
    ((2, 32, 32, 64), torch.float32, (16, 0, 16)),
    ((3, 5, 7, 96), torch.float32, (2, 2, 1)),
], ids=["in_norm_half", "ragged_3", "empty_shard_f32", "odd"])
def test_k2_shard_entries_match_plain_on_the_card(shape, dtype, rows):
    """K2's stats, merge and apply entries on the height shards of one
    tensor against the unsharded plain version (``check_gn_quant``'s
    limits: the scale to 1e-6 relative, a code off by one at a tie on at
    most 1e-4 of them); the flagged route (``full``: the full abs-max pass
    and the max-merge) gives the same codes and scale. With sample 0's
    affine in the SiLU's negative lobe that sample is flagged by itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import gn_quant as gq
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, g, b = _gn_quant_inputs(shape, dtype, gen)
    before = dict(gq.sharded_launches)
    xq, s, flags = _k2_sharded_in_one_process(x, g, b, rows)
    filled = sum(r > 0 for r in rows)
    assert gq.sharded_launches == dict(stats=before["stats"] + filled,
                                       merge=before["merge"] + len(rows),
                                       apply=before["apply"] + len(rows))
    wq, ws = gq.gn_silu_quant_plain(x, g, b, 32, 1e-5)
    assert float(((s - ws).abs() / ws).max()) <= 1e-6
    d = (xq.int() - wq.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-4
    fq, fs, fflags = _k2_sharded_in_one_process(x, g, b, rows, full=True)
    assert bool(fflags.all()) and torch.equal(fs, s) and torch.equal(fq, xq)
    gneg, bneg = g.clone(), b.clone()
    gneg[0] *= 0.2
    bneg[0] = bneg[0] * 0.1 - 1.28
    nq, ns, nflags = _k2_sharded_in_one_process(x, gneg, bneg, rows)
    wq, ws = gq.gn_silu_quant_plain(x, gneg, bneg, 32, 1e-5)
    assert int(nflags[0]) == 1 and float(((ns - ws).abs() / ws).max()) <= 1e-6
    d = (nq.int() - wq.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,o,pad", [
    ((8, 130, 256, 256), 256, (0, 1)),
    ((8, 34, 64, 512), 512, (0, 1)),
    ((2, 10, 8, 1024), 1024, (0, 1)),
    ((2, 9, 11, 48), 64, (1, 0)),
    ((3, 7, 5, 32), 16, (2, 1)),
], ids=["halo_256px_half", "halo_64px", "halo_8px_split", "width_only", "wide_height"])
def test_int8_conv_kernel_takes_separate_height_and_width_padding(x_shape, o, pad):
    """K3 with a height padding apart from its width padding (a halo'd
    shard's (0, 1)): bitwise its plain version, and the rows of a halo'd
    shard's output bitwise the unsharded output's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    from free_hunch_tpu_torch.ops import quant as q
    gen = torch.Generator(device="cuda").manual_seed(6)
    xq, wk = _int8(x_shape, gen), _int8((o, 3, 3, x_shape[-1]), gen)
    check_int8_conv(xq, wk, pad, gen)
    if pad == (0, 1):
        whole = q.int8_conv_cuda(xq, wk, None, None, 1, torch.int32)
        part = q.int8_conv_cuda(xq, wk, None, None, (0, 1), torch.int32)
        assert torch.equal(part, whole[:, 1:-1])

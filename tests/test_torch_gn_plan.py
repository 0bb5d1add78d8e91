"""K1's and K2's planner (``ops/groupnorm.py``, ``gn_plan``) over every
GroupNorm call of one 256 px UNet forward at batch 8, 2 and 1, the shapes
listed from the UNet's configuration by arithmetic alone (and the listing
checked against a small UNet's own calls): every plan covers every row of
a sample once with whole 16-byte vectors of a row per thread, fits the
block's threads and shared memory, and reads x at most twice."""
from collections import Counter

import pytest
import torch

from free_hunch_tpu_torch.models.unet import GroupNorm32, create_model
from free_hunch_tpu_torch.ops import groupnorm as gn

# the H100 SXM's SM count; on the card the wrappers pass the device's own
SMS = 132


def norm_calls(batch=8, res=256, mc=256, mult=(1, 1, 2, 2, 4, 4), blocks=2,
               attn_res=(32, 16, 8)):
    """(route, (n, h, w, c), itemsize) of every GroupNorm call of one
    forward of the ADM UNet (``models/256x256_diffusion_uncond_setup.txt``
    by default: ResBlock up/down sampling, scale-shift norm), in module
    order. ``route`` is "k2" for the two norms of a ResBlock without
    resampling (the fused-int8 torso's K2 calls) and "k1" for the rest; on
    the bf16 torso every call is K1. The final norm is f32, the rest bf16."""
    calls = []

    def norm(route, r, c, itemsize=2):
        calls.append((route, (batch, r, r, c), itemsize))

    def resblock(r, cin, cout, up=False, down=False):
        route = "k1" if up or down else "k2"
        norm(route, r, cin)                                 # before the resampling
        norm(route, r * 2 if up else r // 2 if down else r, cout)

    ch, r, chans = mc, res, [mc]
    for level, m in enumerate(mult):
        for _ in range(blocks):
            resblock(r, ch, m * mc)
            ch = m * mc
            if r in attn_res:
                norm("k1", r, ch)
            chans.append(ch)
        if level != len(mult) - 1:
            resblock(r, ch, ch, down=True)
            chans.append(ch)
            r //= 2
    resblock(r, ch, ch)
    norm("k1", r, ch)
    resblock(r, ch, ch)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(blocks + 1):
            resblock(r, ch + chans.pop(), m * mc)
            ch = m * mc
            if r in attn_res:
                norm("k1", r, ch)
            if level and i == blocks:
                resblock(r, ch, ch, up=True)
                r *= 2
    norm("k1", r, mc, 4)
    return calls


def test_the_listing_matches_a_small_unets_own_calls():
    """The same arithmetic for a small UNet with attention, up/down
    sampling and skips lists exactly the shapes its GroupNorm modules see."""
    model = create_model(image_size=32, num_channels=32, num_res_blocks=1,
                         channel_mult="1,2,2", attention_resolutions="16,8",
                         num_head_channels=16, dtype=torch.float32)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: seen.append(tuple(a[0].permute(0, 2, 3, 1).shape)))
        for m in model.modules() if isinstance(m, GroupNorm32)]
    with torch.no_grad():
        model(torch.zeros(2, 3, 32, 32), torch.full((2,), 10.0))
    for h in hooks:
        h.remove()
    listed = norm_calls(batch=2, res=32, mc=32, mult=(1, 2, 2), blocks=1, attn_res=(16, 8))
    assert [s for _, s, _ in listed] == seen


def test_the_listing_has_the_models_101_norms_and_64_fused_ones():
    calls = norm_calls()
    assert len(calls) == 101 and sum(r == "k2" for r, _, _ in calls) == 64
    # the largest K1 and K2 call: the decoder concat at 256 px
    assert max(s for _, s, _ in calls) == (8, 256, 256, 512)


# (n, rows, channels, itemsize, K2?) of every distinct call: every norm as
# K1 (the bf16 torso), the fused ones also as K2
SHAPES = sorted({(b, h * w, c, size, k2)
                 for b in (8, 2, 1)
                 for route, (_, h, w, c), size in norm_calls(batch=b)
                 for k2 in {False, route == "k2"}})


@pytest.mark.parametrize("n,s,c,itemsize,quant", SHAPES,
                         ids=[f"n{n}_s{s}_c{c}_{'f32' if z == 4 else 'bf16'}_{'k2' if q else 'k1'}"
                              for n, s, c, z, q in SHAPES])
def test_plan_covers_every_row_once_within_the_blocks_limits(n, s, c, itemsize, quant):
    plan = gn.gn_plan(n, s, c, 32, itemsize, SMS, quant)
    vec = 16 // itemsize
    # whole 16-byte vectors: tx threads span the row, at most 1024 threads
    assert plan.tx * vec == c and plan.ty >= 1 and plan.tx * plan.ty <= 1024
    # every row of a sample in exactly one chunk
    assert (plan.chunks - 1) * plan.rows < s <= plan.chunks * plan.rows
    assert plan.chunks <= 1024 and plan.lanes * 32 <= 1024
    part = (2 * plan.ty * c + plan.ty) * 4
    fits = -(-s // gn.CLUSTER_BLOCKS) * c * itemsize + part <= gn.CLUSTER_SMEM
    p = plan.chunks
    if plan.path == "cluster":
        # one cluster of at most 8 blocks a sample, each holding its chunk of
        # x and the statistics' partials in shared memory: x read once; the
        # chunks' partials merged in chunk order by every block, as the
        # two-pass path merges them when they are at most its lanes
        assert fits and plan.reads == 1 and p <= gn.CLUSTER_BLOCKS <= plan.lanes
        assert plan.smem == plan.rows * c * itemsize + part <= gn.CLUSTER_SMEM
        assert plan.scratch == (n if quant else 0)
        return
    # the two-pass path only where a sample's chunk does not fit a block
    assert plan.path == "two-pass" and plan.reads == 2 and not fits
    # each chunk at least one unrolled step of every thread row (K2: and 16
    # rows); the statistics pass's shared memory
    assert plan.rows >= min(s, 4 * plan.ty, 16 if quant else 1)
    assert plan.smem == ((4 if quant else 2) * plan.ty * c + plan.ty) * 4 <= gn.MAX_SHARED
    extra = 2 * n * p * c + n * p + n * plan.finals + n if quant else 0
    assert plan.scratch == 2 * n * p * 32 + 2 * n * 32 + extra
    # K2's finalize: every block of a sample has extremes to evaluate
    assert plan.finals >= 1 and (plan.finals - 1) * 1024 < max(p * c, 1024)
    if quant:
        # K2's per-(chunk, channel) extrema: at most a quarter of x's bytes
        assert 8 * p * c <= s * c * itemsize / 4


@pytest.mark.parametrize("quant", [False, True])
def test_forced_paths(quant):
    """The two-pass path forced where the cluster path fits is cut into the
    cluster path's chunks (so the two agree bitwise on the card); the
    cluster path cannot be forced where a sample does not fit."""
    cl = gn.gn_plan(8, 256, 1024, 32, 2, SMS, quant)
    two = gn.gn_plan(8, 256, 1024, 32, 2, SMS, quant, path="two-pass")
    assert cl.path == "cluster" and two.path == "two-pass" and two.reads == 2
    assert (two.rows, two.chunks, two.ty) == (cl.rows, cl.chunks, cl.ty)
    with pytest.raises(ValueError, match="no cluster path"):
        gn.gn_plan(8, 65536, 512, 32, 2, SMS, quant, path="cluster")


def test_the_small_calls_take_the_cluster_path():
    """At batch 8 every 8 and 16 px call, and the 32 px calls of up to 512
    channels, take the one-launch path; every call at 64 px and up, two
    passes."""
    for route, (n, h, w, c), size in norm_calls():
        for quant in {False, route == "k2"}:
            plan = gn.gn_plan(n, h * w, c, 32, size, SMS, quant)
            want = h <= 16 or (h == 32 and c <= 512)
            assert (plan.path == "cluster") == want, (h, c, plan.path)


@pytest.mark.parametrize("n", [8, 2, 1])
def test_large_calls_fill_the_sms(n):
    """At 64 px and up a call has two to four blocks per SM in each pass
    (whole rows per chunk round the four down), unless its chunks are
    already at their least rows; never more than four."""
    for _, (_, h, w, c), size in norm_calls(batch=n):
        plan = gn.gn_plan(n, h * w, c, 32, size, SMS)
        if plan.path == "cluster":
            continue
        assert n * plan.chunks < 4 * SMS + n
        if h >= 64:
            assert n * plan.chunks >= 2 * SMS or plan.rows == 4 * plan.ty


def test_plan_follows_the_sm_count_and_refuses_what_the_kernels_cannot_take():
    assert gn.gn_plan(8, 65536, 512, 32, 2, 66).chunks < gn.gn_plan(8, 65536, 512, 32, 2,
                                                                     132).chunks
    with pytest.raises(ValueError, match="multiple"):
        gn.gn_plan(2, 16, 100, 32, 2, SMS)
    with pytest.raises(ValueError, match="1024"):
        gn.gn_plan(2, 16, 16384, 32, 2, SMS)


def test_counts_of_distinct_shapes():
    """One forward at batch 8 has 19 distinct K1 shapes of (rows, channels,
    type), 29 with the SiLU flag, and 18 distinct K2 shapes, as the card's
    per-shape tables (``chip_smoke.py --gn``) list them."""
    calls = norm_calls()
    k1 = Counter((s, z) for _, s, z in calls)
    k2 = Counter(s for r, s, _ in calls if r == "k2")
    assert sum(k1.values()) == 101 and sum(k2.values()) == 64
    assert len(k1) == 19 and len(k2) == 18


# -- the backward kernel's planner (``gn_bwd_plan``) ---------------------------

def ffhq_norm_calls(batch=8):
    """Every GroupNorm call of one forward of the FFHQ UNet
    (``models/ffhq_10m_setup.txt``: 128 channels, one res block, attention
    at 16 px)."""
    return norm_calls(batch=batch, mc=128, blocks=1, attn_res=(16,))


# (n, rows, channels, itemsize) of every distinct norm of both models' forwards
BWD_SHAPES = sorted({(b, h * w, c, size)
                     for b in (8, 2, 1)
                     for calls in (norm_calls(batch=b), ffhq_norm_calls(batch=b))
                     for _, (_, h, w, c), size in calls})


@pytest.mark.parametrize("carried", [True, False], ids=["carried", "recomputed"])
@pytest.mark.parametrize("n,s,c,itemsize", BWD_SHAPES,
                         ids=[f"n{n}_s{s}_c{c}_{'f32' if z == 4 else 'bf16'}"
                              for n, s, c, z in BWD_SHAPES])
def test_bwd_plan_covers_every_row_once_within_the_blocks_limits(n, s, c, itemsize, carried):
    plan = gn.gn_bwd_plan(n, s, c, 32, itemsize, SMS, carried)
    vec = 16 // itemsize
    assert plan.tx * vec == c and plan.ty >= 1 and plan.tx * plan.ty <= 512
    assert (plan.chunks - 1) * plan.rows < s <= plan.chunks * plan.rows
    assert plan.smem == (2 * plan.ty * c + plan.ty) * 4 <= gn.MAX_SHARED - 12 * 1024
    assert plan.reads == (2 if carried else 3)
    if plan.path == "cluster":
        # one cluster of at most 8 blocks a sample, each at most 128 rows
        # where the statistics are carried; no scratch
        assert plan.chunks <= gn.CLUSTER_BLOCKS and plan.scratch == 0 and plan.ty <= plan.rows
        assert plan.rows <= 128 or not carried
        return
    assert plan.path == "two-pass" and carried and -(-s // gn.CLUSTER_BLOCKS) > 128
    # at least one unrolled step of every thread row; the apply pass's merge
    # takes a thread a group
    assert plan.rows >= 2 * plan.ty and plan.tx * plan.ty >= 32 and plan.chunks <= 1024
    # the chunk sums
    assert plan.scratch == 2 * n * plan.chunks * 32
    assert n * plan.chunks < 4 * SMS + n


@pytest.mark.parametrize("calls", [norm_calls, ffhq_norm_calls], ids=["imagenet", "ffhq"])
def test_bwd_small_calls_take_the_one_launch_path(calls):
    """At batch 8, with the statistics carried where K1's forward plan keeps
    them (its two-pass path), every call of 32 px or less takes the
    one-launch cluster path (ImageNet's 60 of 101 norms, FFHQ's 36 of 65)
    and so does a call whose forward took the one-launch path (FFHQ's two
    64 px norms of 128 channels); every other call of 64 px and up takes
    the two launches."""
    cluster = 0
    for _, (n, h, w, c), size in calls():
        carried = gn.gn_plan(n, h * w, c, 32, size, SMS).path == "two-pass"
        plan = gn.gn_bwd_plan(n, h * w, c, 32, size, SMS, carried)
        assert (plan.path == "cluster") == (h <= 32 or not carried), (h, c, plan.path)
        assert h > 32 or plan.path == "cluster"
        cluster += plan.path == "cluster"
    assert cluster == {101: 60, 65: 38}[len(calls())]


def test_bwd_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="multiple"):
        gn.gn_bwd_plan(2, 16, 100, 32, 2, SMS, True)
    with pytest.raises(ValueError, match="512"):
        gn.gn_bwd_plan(2, 16, 8192, 32, 2, SMS, True)
    with pytest.raises(ValueError, match="without the statistics"):
        gn.gn_bwd_plan(8, 65536, 512, 32, 2, SMS, False, path="two-pass")
    with pytest.raises(ValueError, match="no fast path"):
        gn.gn_bwd_plan(8, 64, 512, 32, 2, SMS, True, path="fast")
    # the two-pass merge needs a thread a group: 64 groups of 64 f32 channels
    # make blocks of 16 x 16 threads, enough; 1024 groups do not fit
    assert gn.gn_bwd_plan(2, 4096, 64, 64, 4, SMS, True).path == "two-pass"
    with pytest.raises(ValueError, match="groups"):
        gn.gn_bwd_plan(2, 4096, 1024, 1024, 4, SMS, True)
    # either path may be forced where it can run (to compare the two)
    assert gn.gn_bwd_plan(8, 64, 512, 32, 2, SMS, True, path="two-pass").path == "two-pass"
    assert gn.gn_bwd_plan(8, 65536, 512, 32, 2, SMS, True, path="cluster").path == "cluster"
    assert gn.gn_bwd_plan(8, 65536, 512, 32, 2, SMS, False).path == "cluster"


# -- NCSN++ at FFHQ 1024 px: min(C / 4, 32) groups, 16-1024 channels --------

def ncsnpp_norm_calls(batch=8):
    """(n, rows, channels, groups) of every distinct GroupNorm call of one
    forward of score_sde's NCSN++ at FFHQ 1024 px, from the benchmark
    family's ``norm_inputs`` (``benchmark/reference/ncsnpp.py``) of the
    configuration ``benchmark/configs/ffhq1024-ncsnpp.json``."""
    import importlib.util
    import json
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    name = "ncsnpp_reference"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, root / "benchmark" / "reference" / "ncsnpp.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    ref = sys.modules[name]
    cfg = json.loads((root / "benchmark" / "configs" / "ffhq1024-ncsnpp.json").read_text())
    return sorted({(batch, h * w, c, ref.groups(c))
                   for c, h, w in ref.norm_inputs(ref.arch_of(cfg["model"]))})


NCSNPP_SHAPES = [s + (z,) for s in ncsnpp_norm_calls() for z in (2, 4)]


@pytest.mark.parametrize("n,s,c,groups,itemsize", NCSNPP_SHAPES,
                         ids=[f"ncsnpp_s{s}_c{c}_g{g}_{'f32' if z == 4 else 'bf16'}"
                              for _, s, c, g, z in NCSNPP_SHAPES])
def test_ncsnpp_shapes_plan_forward_and_backward(n, s, c, groups, itemsize):
    """Both planners take every NCSN++ norm at batch 8 in either type: the
    forward's plan covers every row once in whole 16-byte vectors; the
    backward's two-pass path exactly where the forward kept its statistics
    and a cluster block would hold more than 128 rows, the one launch
    otherwise. Every call of 64 px and up is two passes both ways."""
    fwd = gn.gn_plan(n, s, c, groups, itemsize, SMS)
    assert fwd.tx * (16 // itemsize) == c and fwd.tx * fwd.ty <= 1024
    assert (fwd.chunks - 1) * fwd.rows < s <= fwd.chunks * fwd.rows
    carried = fwd.path == "two-pass"
    bwd = gn.gn_bwd_plan(n, s, c, groups, itemsize, SMS, carried)
    assert (bwd.chunks - 1) * bwd.rows < s <= bwd.chunks * bwd.rows
    many = -(-s // gn.CLUSTER_BLOCKS) > 128
    assert bwd.path == ("two-pass" if carried and many else "cluster")
    if s >= 64 * 64:
        assert fwd.path == bwd.path == "two-pass" or (c, s, itemsize) == (128, 4096, 2)


def test_ncsnpp_shapes_are_the_1024_px_models():
    """31 distinct (rows, channels); at 1024 px 16, 32 and 48 channels in
    4, 8 and 12 groups; the 16-channel bf16 call in blocks of 2 x 128
    threads, two passes."""
    calls = ncsnpp_norm_calls()
    assert len(calls) == 31
    assert {(c, g) for _, s, c, g in calls if s == 1024 * 1024} == {(16, 4), (32, 8), (48, 12)}
    plan = gn.gn_plan(8, 1024 * 1024, 16, 4, 2, SMS)
    assert (plan.path, plan.tx, plan.ty) == ("two-pass", 2, 128)

"""K3's planner (``ops/quant.py``, ``int8_conv_plan``) over every int8 product
of one 256 px fused-int8 UNet forward and its pullbacks at batch 8, the
shapes listed from the UNet's configuration by arithmetic alone: each cut
covers every output tile once, splits K into contiguous 16-byte-aligned
ranges that cover [0, K) exactly, sizes its workspace for its slabs, and
fills the SMs at the 8 and 16 px layers."""
import pytest

from free_hunch_tpu_torch.ops import quant as q

BATCH = 8
# the H100 SXM's SM count; on the card the wrapper passes the device's own
SMS = 132


def k3_calls(batch=BATCH, res=256, mc=256, mult=(1, 1, 2, 2, 4, 4), blocks=2,
             attn_res=(32, 16, 8)):
    """(input (n, h, w, i), weights (o, kh, kw, i), pad) of every int8
    product of one forward of the 256 px ADM UNet on the int8 torso
    (``models/256x256_diffusion_uncond_setup.txt``: ResBlock up/down
    sampling, 1x1 skips in int8), in module order; the attention qkv and
    proj_out products are 1x1 convolutions over (n, h*w, 1, c)."""
    calls = []

    def conv(r, cin, cout, k):
        calls.append(((batch, r, r, cin), (cout, k, k, cin), k // 2))

    def resblock(r, cin, cout, up=False, down=False):
        rc = r * 2 if up else r // 2 if down else r     # the convs run after resampling
        conv(rc, cin, cout, 3)
        conv(rc, cout, cout, 3)
        if cin != cout:
            conv(r, cin, cout, 1)

    def attn(r, c):
        calls.append(((batch, r * r, 1, c), (3 * c, 1, 1, c), 0))
        calls.append(((batch, r * r, 1, c), (c, 1, 1, c), 0))

    ch, r, chans = mc, res, [mc]
    for level, m in enumerate(mult):
        for _ in range(blocks):
            resblock(r, ch, m * mc)
            ch = m * mc
            if r in attn_res:
                attn(r, ch)
            chans.append(ch)
        if level != len(mult) - 1:
            resblock(r, ch, ch, down=True)
            chans.append(ch)
            r //= 2
    resblock(r, ch, ch)
    attn(r, ch)
    resblock(r, ch, ch)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(blocks + 1):
            resblock(r, ch + chans.pop(), m * mc)
            ch = m * mc
            if r in attn_res:
                attn(r, ch)
            if level and i == blocks:
                resblock(r, ch, ch, up=True)
                r *= 2
    return calls


def pullback(call):
    """The int8 pullback's product: the cotangent against the flipped,
    I/O-swapped weights, padding k-1-pad."""
    (n, h, w, i), (o, kh, kw, _), pad = call
    ho, wo = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
    return (n, ho, wo, o), (i, kh, kw, o), kh - 1 - pad


FORWARD = k3_calls()
SHAPES = sorted(set(FORWARD) | {pullback(c) for c in FORWARD})


def _id(call):
    (n, h, w, i), (o, kh, _, _), pad = call
    return f"{h}x{w}_{i}to{o}_k{kh}p{pad}"


def test_the_listed_forward_has_the_models_136_int8_products():
    assert len(FORWARD) == 136
    # qkv and proj_out at each of the 16 attention blocks (32, 16 and 8 px)
    assert sum(kh == 1 and w == 1 for (_, _, w, _), (_, kh, _, _), _ in FORWARD) == 32
    assert all(pullback(pullback(c)) == c for c in FORWARD)


@pytest.mark.parametrize("call", SHAPES, ids=[_id(c) for c in SHAPES])
def test_plan_cuts_the_call_exactly(call):
    (n, h, w, i), (o, kh, kw, _), pad = call
    plan = q.int8_conv_plan(n, h, w, i, o, kh, kw, pad, SMS)
    m, k = n * (h + 2 * pad - kh + 1) * (w + 2 * pad - kw + 1), kh * kw * i
    assert plan.bm == 128 and plan.bn in (128, 256)
    # the kernel's unit -> tile map: unit u sums K split u // tiles of tile
    # t = u % tiles, row tile t // n_tiles and column tile t % n_tiles; each
    # output element lies in exactly one tile, each tile in one unit per split
    tiles = plan.m_tiles * plan.n_tiles
    assert plan.units == tiles * plan.splits and plan.grid == min(plan.units, SMS)
    rows = [t // plan.n_tiles * plan.bm for t in range(tiles)]
    cols = [t % plan.n_tiles * plan.bn for t in range(tiles)]
    assert sorted(set(zip(rows, cols))) == sorted(zip(rows, cols))      # no tile twice
    assert sorted(set(rows)) == list(range(0, m, plan.bm))
    assert sorted(set(cols)) == list(range(0, o, plan.bn))
    # K splits: contiguous, non-empty, on 16-byte chunks, exactly [0, K)
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits and plan.k_blocks == -(-k // 128)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k0 < k1 and k0 % 16 == 0 and k1 % 16 == 0 for k0, k1 in ranges)
    # one int32 slab of the output's size per split, none without a split
    assert plan.workspace == (plan.splits * m * o if plan.splits > 1 else 0)


@pytest.mark.parametrize("res", [8, 16])
def test_small_layers_fill_the_sms(res):
    """Every product at 8 and 16 px gets at least ``SMS`` work units, or
    as many whole K splits as fit in one wave of them: one more split would
    start a second wave of short units, which measured slower on the card
    (PERF.md section 6)."""
    small = [c for c in SHAPES if c[0][1] * c[0][2] == res * res]
    assert small
    split = 0
    for (n, h, w, i), (o, kh, kw, _), pad in small:
        plan = q.int8_conv_plan(n, h, w, i, o, kh, kw, pad, SMS)
        tiles = plan.m_tiles * plan.n_tiles
        assert plan.units >= SMS or plan.units + tiles > SMS, plan
        assert plan.splits == 1 or plan.units <= SMS, plan
        split += plan.splits > 1
    assert split >= len(small) // 2


def test_large_layers_keep_one_split_and_wide_tiles():
    for (n, h, w, i), (o, kh, kw, _), pad in SHAPES:
        if h * w >= 64 * 64:
            plan = q.int8_conv_plan(n, h, w, i, o, kh, kw, pad, SMS)
            assert plan.splits == 1 and plan.units >= SMS, plan
            assert plan.bn == (256 if o % 256 == 0 else 128), plan


@pytest.mark.parametrize("cut", [(256, 1), (128, 5), (256, 72)])
def test_a_forced_cut_is_taken_as_given(cut):
    plan = q.int8_conv_plan(8, 8, 8, 1024, 1024, 3, 3, 1, SMS, cut)
    assert (plan.bn, plan.splits) == cut and plan.n_tiles == 1024 // cut[0]
    assert plan.workspace == (cut[1] * 512 * 1024 if cut[1] > 1 else 0)


@pytest.mark.parametrize("cut", [(256, 73), (256, 0), (64, 1)])
def test_the_planner_refuses_a_cut_the_kernel_lacks(cut):
    with pytest.raises(ValueError, match="no cut"):
        q.int8_conv_plan(8, 8, 8, 1024, 1024, 3, 3, 1, SMS, cut)
    with pytest.raises(ValueError, match="no cut"):       # no 256-wide tiles where O % 256 != 0
        q.int8_conv_plan(8, 8, 8, 1024, 384, 3, 3, 1, SMS, (256, 1))

"""Int8 convolutions and dense layers of the ADM UNet torso: the
hand-written Hopper kernel ``csrc/int8_conv.cu`` (K3), its plain PyTorch
version, the int8 autograd functions and the ``QuantConv``/``QuantDense``
modules.

Counterpart of ``free_hunch_tpu/ops/quant.py``:

* weights: symmetric per-output-channel int8 from the f32 master weights
  (``_quantize_weight`` :49-58); the modules quantise once per weight and
  cache the int8 operands in K3's layout;
* activations: symmetric per-sample int8 (``_quantize_act`` :61-77, the
  arithmetic in the input's dtype), or with a calibrated scalar scale
  (``_quantize_act_static`` :187-191);
* the product: exact int32 sums, then ``f32(acc) * (ascale * wscale)`` cast
  to the input's dtype. PyTorch has no CUDA int8 convolution, so on the card
  every product, dense ones included (as 1x1 convolutions over
  (n, t, 1, c)), is K3;
* the pullback (``_int8_conv_bwd`` :106-123): the per-channel weight scale
  is folded into the cotangent, which is quantised per sample, and the same
  int8 product runs on the flipped, I/O-swapped kernel with padding
  k-1-pad. The weight gradient is zero and a static scale has none: the
  guidance differentiates with respect to the input only (INFERENCE ONLY);
* ``gn_quant_conv`` (:366-411): K2 then K3 in the forward; the backward is
  the int8 transposed product to an f32 cotangent, then autograd of the
  plain f32 GroupNorm+affine+SiLU (``_gn_silu_ref_f32`` :348-363, kept in
  ``ops/gn_quant.py`` beside the quantiser it is the first half of).

On a height shard (``QuantConv(x, shard=(mg, rows))``, ``QuantDense(y,
mg=mg)``: each rank of the model group ``mg`` holds some rows of every
sample) the JAX semantics are the whole sample's: a dynamic per-sample
abs-max is max-merged over the group (``parallel/collectives.py::all_max``),
so every rank quantises with the whole sample's scale, bitwise the
unsharded one (a max is order-free); K2's shard entries merge its
statistics and extremes (``ops/gn_quant.py``). A 3x3 site then exchanges
one-row halos of the int8 CODES (a byte an element) and runs K3 with
height padding 0 and width padding 1 on the halo'd rows; its pullback
quantises the cotangent with the merged scale and exchanges the
cotangent's code halos the same way, which is the adjoint of the forward's
exchange (each halo row's contribution reaches the rank that sent it), with
int32 sums as exact as the unsharded ones. A static scale needs no merge.

Public functions keep the JAX package's layouts: NHWC activations, HWIO
conv weights, (I, O) dense weights.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from free_hunch_tpu_torch.ops.gn_quant import (_gn_silu_ref_f32, gn_silu_quant,
                                               gn_silu_quant_sharded,
                                               gn_silu_sharded_ref_f32)
from free_hunch_tpu_torch.ops.groupnorm import device_sms
from free_hunch_tpu_torch.parallel import collectives as coll
from free_hunch_tpu_torch.utils import profiling

# Calls that launched K3. Plain-version calls on CPU tensors do not count.
launches = 0

_OUT_MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


# -- quantisers ---------------------------------------------------------------

def _quantize_weight(w: torch.Tensor, reduce_dims: Tuple[int, ...]):
    """Symmetric per-output-channel int8: (wq, scale) with scale f32 of
    w's rank, size 1 along ``reduce_dims``."""
    amax = w.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.float()


def _abs_max(x: torch.Tensor) -> torch.Tensor:
    """Per-sample max |x| over all non-batch dims, f32 (n, 1, ..., 1); 0
    for a shard of no elements (a neutral for the max-merge)."""
    if x.numel() == 0:
        return torch.zeros((x.shape[0],) + (1,) * (x.dim() - 1), dtype=torch.float32,
                           device=x.device)
    return x.abs().float().amax(dim=tuple(range(1, x.dim())), keepdim=True)


def _quantize_act(x: torch.Tensor, mg=None):
    """Symmetric per-sample dynamic int8 over all non-batch dims; the
    elementwise arithmetic stays in x's dtype, the scale is f32 of shape
    (n, 1, ..., 1). On a shard (``mg``, its model group) the abs-max is the
    whole sample's, max-merged over the group."""
    amax = _abs_max(x)
    if mg is not None:
        amax = coll.all_max(amax, mg)
    scale = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
    inv = (1.0 / scale).to(x.dtype)
    xq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return xq, scale


def _quantize_act_static(x: torch.Tensor, ascale: torch.Tensor) -> torch.Tensor:
    """Quantise with a calibrated scalar scale: no reduction."""
    inv = (1.0 / ascale).to(x.dtype)
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)


# -- K3: the int8 product -----------------------------------------------------

def _epilogue(acc: torch.Tensor, ascale: torch.Tensor, wscale: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """f32(acc) * (ascale[n] * wscale[o]), cast to ``out_dtype``."""
    s = ascale.reshape(-1, 1, 1, 1) * wscale.reshape(1, 1, 1, -1)
    return (acc.float() * s).to(out_dtype)


def _pads(pad) -> Tuple[int, int]:
    """(height, width) padding from one int or a pair."""
    return (pad, pad) if isinstance(pad, int) else (int(pad[0]), int(pad[1]))


def int8_conv_plain(xq: torch.Tensor, wk: torch.Tensor, ascale: Optional[torch.Tensor],
                    wscale: Optional[torch.Tensor], pad,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3's plain version. xq (n, h, w, i) int8, wk (o, kh, kw, i) int8,
    ascale (n,) f32, wscale (o,) f32; ``pad`` one int or (height, width).
    The int32 sums are exact: a float64 convolution of the int8 values
    (every |sum| < 2^53; cuDNN is off so that no Winograd or FFT algorithm
    rounds). ``out_dtype`` int32 returns the sums; f32 or bf16 the
    dequantised output."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wk.permute(0, 3, 1, 2).double(),
                       padding=_pads(pad))
    acc = acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()
    if out_dtype == torch.int32:
        return acc
    return _epilogue(acc, ascale, wscale, out_dtype)


# K3's tiles: 128 output pixels by 256 or 128 output channels, K in blocks of
# 128 bytes. The planner fills the device's SMs, one block per SM (a block
# takes 211 KB of shared memory); the wrapper passes it the SM count of the
# device it launches on.
_BM, _BK = 128, 128
# the planner's time model, in microseconds, read off K3's device times on
# an H100 80GB HBM3 at 700 W (``python3 chip_smoke.py --k3``, its table of
# cuts; PERF.md section 6): a K block of a 256- or 128-wide tile in steady
# state, a unit's fixed cost (pipeline fill, epilogue), and the split-K
# epilogue kernel, fixed plus bytes of the slabs over the rate it reads them at
_US_PER_K_BLOCK = {256: 0.75, 128: 0.6}
_US_PER_UNIT = 5.0
_US_SPLIT_EPILOGUE, _SPLIT_BYTES_PER_US = 1.0, 7e6


class Int8ConvPlan(NamedTuple):
    """How K3 cuts one call: ``m_tiles`` x ``n_tiles`` output tiles of
    ``bm`` x ``bn``, and the ``k_blocks`` 128-byte K blocks cut into
    ``splits`` ranges; ``workspace`` int32 elements of split-K partial sums,
    one output-sized slab per split (0 without a split); ``grid`` persistent
    blocks, min(units, SMs)."""
    bm: int
    bn: int
    m_tiles: int
    n_tiles: int
    k_blocks: int
    splits: int
    workspace: int
    grid: int

    @property
    def units(self) -> int:
        """Work units of the launch, tiles times K splits: the persistent
        kernel runs ``grid`` blocks, each taking every grid-th unit."""
        return self.m_tiles * self.n_tiles * self.splits

    def k_ranges(self, k: int):
        """The [k0, k1) byte range of K that each split sums, as the kernel
        cuts it: split z takes blocks [z*KB//splits, (z+1)*KB//splits)."""
        kb, s = self.k_blocks, self.splits
        return [(min(k, z * kb // s * _BK), min(k, (z + 1) * kb // s * _BK)) for z in range(s)]


@functools.lru_cache(maxsize=4096)
def int8_conv_plan(n: int, h: int, w: int, i: int, o: int, kh: int, kw: int, pad,
                   sms: int, cut: Optional[Tuple[int, int]] = None) -> Int8ConvPlan:
    """K3's tile width and K splits for one shape on a device with ``sms``
    SMs: of 256-wide tiles (where O % 256 == 0) and 128-wide ones, each with
    1 to KB splits, the cut with the least modelled time (waves of ``sms``
    units times a unit's time, plus the split-K epilogue); ties go to fewer
    splits, then wider tiles. So the large layers keep one split, and the 8
    and 16 px layers, whose tiles fill a fraction of the SMs, split K to
    fill about one wave: splitting further would start a second wave of
    short units. ``cut`` = (bn, splits) forces a cut instead, to compare
    cuts; it raises if the kernel has no such cut of this shape. ``pad``:
    one int or (height, width) (a halo'd shard's (0, 1))."""
    ph, pw = _pads(pad)
    m = n * (h + 2 * ph - kh + 1) * (w + 2 * pw - kw + 1)
    kb = -(-kh * kw * i // _BK)
    mt = -(-m // _BM)
    cuts = [(bn, s) for s in range(1, kb + 1) for bn in ((256, 128) if o % 256 == 0 else (128,))]
    if cut is not None:
        if cut not in cuts:
            raise ValueError(f"int8_conv kernel: no cut {cut} (tile width, K splits) of this "
                             f"shape, which has {kb} K blocks")
        cuts = [cut]
    best, best_cost = None, None
    for bn, s in cuts:
        nt = -(-o // bn)
        waves = -(-mt * nt * s // sms)
        cost = waves * (-(-kb // s) * _US_PER_K_BLOCK[bn] + _US_PER_UNIT)
        if s > 1:
            cost += _US_SPLIT_EPILOGUE + 4 * s * m * o / _SPLIT_BYTES_PER_US
        if best_cost is None or cost < best_cost:
            best = Int8ConvPlan(_BM, bn, mt, nt, kb, s, s * m * o if s > 1 else 0,
                                min(mt * nt * s, sms))
            best_cost = cost
    return best


# negative error codes of csrc/int8_conv.cu
_K3_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
              -2: "cuTensorMapEncodeTiled refused the weight's tensor map",
              -3: "no kernel for that cut (tile width, splits)"}


class _K3Launch(NamedTuple):
    """What K3 needs for one weight at one input shape, made once: the cut,
    the output shape, and the addresses of the C entry point's shape
    arguments and of the weights' encoded tensor map (both kept alive
    here)."""
    plan: Int8ConvPlan
    out_shape: Tuple[int, int, int, int]
    shape: ctypes.Array
    wmap: ctypes.Array
    shape_ptr: int
    wmap_ptr: int


# K3's launches by (input shape, weight address, weight shape, pad, device):
# each weight's tensor map is encoded and each shape planned once, not per
# call. An entry holds only what its key determines (the map holds the
# weights' address and shape, the plan the shapes and the device's SM
# count), so it is never stale: a later weight at the same address and of
# the same shape has the same map.
_LAUNCHES: dict = {}
_LAUNCHES_MAX = 4096
_lib = None


def _k3_lib():
    """The K3 library with its entry points typed."""
    global _lib
    if _lib is None:
        from free_hunch_tpu_torch.ops import _nvcc
        lib = _nvcc.load("int8_conv")
        lib.fh_int8_conv_weight_map.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        lib.fh_int8_conv_weight_map.restype = ctypes.c_int
        lib.fh_int8_conv_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                                      ctypes.c_void_p]
        lib.fh_int8_conv_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def _k3_failed(err: int):
    return RuntimeError(f"int8_conv kernel launch failed: "
                        f"{_K3_ERRORS.get(err, f'CUDA error {err}')}")


def _k3_launch(x_shape, wk: torch.Tensor, pad, device: int,
               cut: Optional[Tuple[int, int]] = None) -> _K3Launch:
    """Check one shape, plan its cut (or take ``cut``) for the device's SM
    count, and encode the weights' tensor map at the cut's tile width."""
    if len(x_shape) != 4 or wk.dim() != 4:
        raise ValueError("int8_conv kernel needs contiguous (n, h, w, i) and (o, kh, kw, i)")
    n, h, w, i = x_shape
    o, kh, kw, wi = wk.shape
    ph, pw = _pads(pad)
    ho, wo = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    if wi != i or i % 16 or o % 16:
        raise ValueError(f"int8_conv kernel: I={i} (weights {wi}) and O={o} must agree "
                         f"and be multiples of 16")
    if ho < 1 or wo < 1 or max(ho, wo) >= 2 ** 15 or n * ho * wo >= 2 ** 31 or \
            n * h * w * i >= 2 ** 31:
        raise ValueError(f"int8_conv kernel: shape {tuple(x_shape)} x {tuple(wk.shape)} "
                         f"pad {pad} out of range")
    if wk.data_ptr() % 16:
        raise ValueError("int8_conv kernel needs 16-byte aligned operands")
    plan = int8_conv_plan(n, h, w, i, o, kh, kw, (ph, pw), device_sms(device), cut)
    wmap = ctypes.create_string_buffer(128)      # a CUtensorMap
    err = _k3_lib().fh_int8_conv_weight_map(wk.data_ptr(), o, kh * kw * i, plan.bn,
                                             ctypes.addressof(wmap))
    if err != 0:
        raise _k3_failed(err)
    shape = (ctypes.c_int * 12)(n, h, w, i, o, kh, kw, ph, pw, plan.bn, plan.splits, plan.grid)
    return _K3Launch(plan, (n, ho, wo, o), shape, wmap, ctypes.addressof(shape),
                     ctypes.addressof(wmap))


def _k3_check(xq, wk, ascale, wscale, out_dtype, stride) -> int:
    """The checks of every call: raises on operands the kernel does not
    take; returns the output mode."""
    if stride != 1:
        raise ValueError(f"int8_conv kernel is stride 1 only, got stride {stride}")
    if not (xq.is_cuda and wk.device == xq.device):
        raise ValueError("int8_conv_cuda needs CUDA tensors on one device")
    if xq.dtype != torch.int8 or wk.dtype != torch.int8:
        raise TypeError(f"int8_conv kernel takes int8 operands, got {xq.dtype}, {wk.dtype}")
    if not (xq.is_contiguous() and wk.is_contiguous()):
        raise ValueError("int8_conv kernel needs contiguous (n, h, w, i) and (o, kh, kw, i)")
    if xq.data_ptr() % 16:
        raise ValueError("int8_conv kernel needs 16-byte aligned operands")
    mode = _OUT_MODES.get(out_dtype)
    if mode is None:
        raise TypeError(f"int8_conv kernel writes int32, f32 or bf16, not {out_dtype}")
    if mode:
        for t, size in ((ascale, xq.shape[0]), (wscale, wk.shape[0])):
            if t is None or t.device != xq.device or t.dtype != torch.float32 or \
                    t.numel() != size or not t.is_contiguous():
                raise ValueError("ascale (n,) and wscale (o,) must be contiguous f32 "
                                 "on the operands' device")
    return mode


def _k3_enqueue(xq, rec: _K3Launch, ascale, wscale, mode: int, out_dtype, device: int):
    global launches
    out = torch.empty(rec.out_shape, device=xq.device, dtype=out_dtype)
    ws = torch.empty(rec.plan.workspace, device=xq.device, dtype=torch.int32) \
        if rec.plan.splits > 1 else None
    err = _lib.fh_int8_conv_forward(
        rec.shape_ptr, rec.wmap_ptr, xq.data_ptr(), ascale.data_ptr() if mode else None,
        wscale.data_ptr() if mode else None, out.data_ptr(),
        None if ws is None else ws.data_ptr(), mode,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise _k3_failed(err)
    launches += 1
    return out


def int8_conv_cuda(xq: torch.Tensor, wk: torch.Tensor, ascale: Optional[torch.Tensor],
                   wscale: Optional[torch.Tensor], pad,
                   out_dtype: torch.dtype = torch.float32, stride: int = 1) -> torch.Tensor:
    """Launch K3 as ``int8_conv_plan`` cuts the call. Same arguments as
    ``int8_conv_plain``; raises on anything the kernel does not take (I or
    O not a multiple of 16, stride != 1, non-contiguous or unaligned
    operands, CPU tensors). The plan and the weights' tensor map are made
    at a weight's first call at an input shape, and reused after."""
    mode = _k3_check(xq, wk, ascale, wscale, out_dtype, stride)
    device = xq.get_device()
    key = (xq.shape, wk.data_ptr(), wk.shape, _pads(pad), device)
    rec = _LAUNCHES.get(key)
    if rec is None:
        if len(_LAUNCHES) >= _LAUNCHES_MAX:
            _LAUNCHES.clear()
        rec = _LAUNCHES[key] = _k3_launch(xq.shape, wk, pad, device)
    return _k3_enqueue(xq, rec, ascale, wscale, mode, out_dtype, device)


def _int8_conv_launch(xq: torch.Tensor, wk: torch.Tensor, ascale: Optional[torch.Tensor],
                      wscale: Optional[torch.Tensor], pad, out_dtype: torch.dtype,
                      cut: Tuple[int, int]) -> torch.Tensor:
    """``int8_conv_cuda`` with the cut forced: ``cut`` = (tile width, K
    splits), to compare cuts; raises if the kernel has no such cut of this
    shape. Made anew at every call, not kept."""
    mode = _k3_check(xq, wk, ascale, wscale, out_dtype, 1)
    device = xq.get_device()
    rec = _k3_launch(xq.shape, wk, pad, device, cut)
    return _k3_enqueue(xq, rec, ascale, wscale, mode, out_dtype, device)


def int8_conv_nhwc(xq, wk, ascale, wscale, pad, out_dtype):
    """The int8 product: K3 on a CUDA tensor (or this raises), the plain
    version on a CPU tensor. A shard of no rows gives no rows, and
    launches nothing."""
    if xq.shape[1] == 0:
        wo = xq.shape[2] + 2 * _pads(pad)[1] - wk.shape[2] + 1
        return torch.zeros((xq.shape[0], 0, wo, wk.shape[0]), dtype=out_dtype,
                           device=xq.device)
    if xq.is_cuda:
        return int8_conv_cuda(xq.contiguous(), wk, ascale, wscale, pad, out_dtype)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wk, ascale, wscale, pad, out_dtype)
    raise ValueError(f"int8_conv: unsupported device {xq.device}")


# -- weights in K3's layout ---------------------------------------------------

class Int8Weight(NamedTuple):
    """A quantised conv or dense weight in K3's layout: the forward operand
    (O, kh, kw, I), the backward operand (I, kh, kw, O) of the flipped,
    I/O-swapped kernel, the per-channel scale (O,) and ones (I,), the
    backward's weight scale."""
    wk: torch.Tensor
    wkT: torch.Tensor
    wscale: torch.Tensor
    ones_in: torch.Tensor


def prepare_conv_weight(w: torch.Tensor) -> Int8Weight:
    """HWIO f32 master weights -> Int8Weight."""
    with torch.no_grad():
        wq, scale = _quantize_weight(w, (0, 1, 2))
        return Int8Weight(wk=wq.permute(3, 0, 1, 2).contiguous(),
                          wkT=wq.flip(0, 1).permute(2, 0, 1, 3).contiguous(),
                          wscale=scale.reshape(-1).contiguous(),
                          ones_in=torch.ones(w.shape[2], device=w.device))


# -- autograd -----------------------------------------------------------------

def _halo_pads(pad: int, halo) -> Tuple[int, int]:
    """K3's padding of a site: (pad, pad), or (0, pad) when its rows carry
    a one-row halo from each neighbour."""
    return (0, pad) if halo is not None else (pad, pad)


class _Int8Conv(torch.autograd.Function):
    """x (n, h, w, i) -> x.dtype (n, h, w, o). ``ascale`` None: dynamic
    per-sample activation scales; else a calibrated scalar (static). On a
    height shard ``mg`` is the model group (dynamic scales merged over it)
    and ``halo`` the ranks' rows at a 3x3 site (None for a 1x1 site or a
    dense layer), whose codes take one-row halos."""

    @staticmethod
    def forward(ctx, x, w, ascale, qw: Int8Weight, pad: int, mg=None, halo=None):
        if ascale is None:
            xq, asc = _quantize_act(x) if mg is None else _quantize_act(x, mg)
            asc = asc.reshape(-1)
        else:
            xq = _quantize_act_static(x, ascale)
            asc = ascale.float().reshape(1).expand(x.shape[0]).contiguous()
        if halo is not None:
            xq = coll.halo_rows(xq, mg, 1, halo)
        ctx.qw, ctx.pad, ctx.x_dtype, ctx.mg, ctx.halo = qw, pad, x.dtype, mg, halo
        ctx.w_shape, ctx.w_like = w.shape, (w.dtype, w.device)
        return int8_conv_nhwc(xq, qw.wk, asc, qw.wscale, _halo_pads(pad, halo), x.dtype)

    @staticmethod
    def backward(ctx, g):
        qw = ctx.qw
        dx = _int8_pullback(g, qw, ctx.pad, ctx.x_dtype) if ctx.mg is None else \
            _int8_pullback(g, qw, ctx.pad, ctx.x_dtype, ctx.mg, ctx.halo)
        need_w, need_s = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        dw = torch.zeros(ctx.w_shape, dtype=ctx.w_like[0], device=ctx.w_like[1]) \
            if need_w else None
        ds = torch.zeros((), dtype=torch.float32, device=g.device) if need_s else None
        return dx, dw, ds, None, None, None, None


def _int8_pullback(g: torch.Tensor, qw: Int8Weight, pad: int, out_dtype: torch.dtype,
                   mg=None, halo=None) -> torch.Tensor:
    """dx = conv(quantise(g * wscale), flipped I/O-swapped wq) * gscale: the
    weight scale folded into the cotangent makes the int8 transposed
    product exact bookkeeping. On a shard the cotangent's scale is merged
    over ``mg``, and at a halo'd site its codes take one-row halos: the
    transposed 3x3 product of a rank's rows reads the neighbours' edge rows
    of the cotangent, as the forward read their activations."""
    g_scaled = g * qw.wscale.to(g.dtype)
    gq, gscale = _quantize_act(g_scaled) if mg is None else _quantize_act(g_scaled, mg)
    if halo is not None:
        gq = coll.halo_rows(gq, mg, 1, halo)
    ph, pw = _halo_pads(pad, halo)
    kh, kw = qw.wk.shape[1:3]
    pad_t = (0 if halo is not None else kh - 1 - ph, kw - 1 - pw)
    return int8_conv_nhwc(gq, qw.wkT, gscale.reshape(-1), qw.ones_in, pad_t, out_dtype)


class _GNQuantConv(torch.autograd.Function):
    """silu(groupnorm(x) * gamma_nc + beta_nc) -> int8 -> int8 conv, bias
    not included. Backward: straight through the quantisation, exact
    through GroupNorm+affine+SiLU (recomputed from x). On a height shard
    (``mg``, ``halo`` as ``_Int8Conv``'s) the norm's statistics and the
    scale are the whole sample's (K2's shard entries), the codes take
    halos, and the backward differentiates the sharded f32 reference,
    whose all_reduces carry the gradient across the group."""

    @staticmethod
    def forward(ctx, x, gamma_nc, beta_nc, w, qw: Int8Weight, pad: int, groups: int,
                eps: float, mg=None, halo=None):
        if mg is None:
            xq, ascale = gn_silu_quant(x, gamma_nc, beta_nc, groups, eps)
        else:
            xq, ascale = gn_silu_quant_sharded(x, gamma_nc, beta_nc, groups, eps, mg)
        if halo is not None:
            xq = coll.halo_rows(xq, mg, 1, halo)
        ctx.save_for_backward(x, gamma_nc, beta_nc)
        ctx.qw, ctx.cfg, ctx.mg, ctx.halo = qw, (pad, groups, eps), mg, halo
        ctx.w_shape, ctx.w_like = w.shape, (w.dtype, w.device)
        return int8_conv_nhwc(xq, qw.wk, ascale.reshape(-1), qw.wscale,
                              _halo_pads(pad, halo), x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, gamma_nc, beta_nc = ctx.saved_tensors
        pad, groups, eps = ctx.cfg
        mg = ctx.mg
        need = ctx.needs_input_grad[:3]
        with profiling.span("gn_quant_conv_backward"):
            dy = _int8_pullback(g, ctx.qw, pad, torch.float32) if mg is None else \
                _int8_pullback(g, ctx.qw, pad, torch.float32, mg, ctx.halo)
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(r)
                       for t, r in zip((x, gamma_nc, beta_nc), need)]
                y = _gn_silu_ref_f32(*ins, groups, eps) if mg is None else \
                    gn_silu_sharded_ref_f32(*ins, groups, eps, mg)
                wanted = [t for t, r in zip(ins, need) if r]
                got = iter(torch.autograd.grad(y, wanted, dy)) if wanted else iter(())
        grads = [next(got) if r else None for r in need]
        if grads[0] is not None:
            grads[0] = grads[0].to(x.dtype)
        dw = torch.zeros(ctx.w_shape, dtype=ctx.w_like[0], device=ctx.w_like[1]) \
            if ctx.needs_input_grad[3] else None
        return (*grads, dw, None, None, None, None, None, None)


# -- the JAX package's functional surface -------------------------------------

def int8_conv(x, w, pad: int, qw: Optional[Int8Weight] = None):
    """Stride-1 conv, NHWC x HWIO f32 master weights -> x.dtype, int8
    forward and int8 pullback, dynamic activation scales."""
    return _Int8Conv.apply(x, w, None, qw or prepare_conv_weight(w), pad)


def int8_conv_static(x, w, ascale, pad: int, qw: Optional[Int8Weight] = None):
    """``int8_conv`` with a calibrated scalar activation scale."""
    return _Int8Conv.apply(x, w, ascale, qw or prepare_conv_weight(w), pad)


def _dense(x, w, ascale, qw, mg=None):
    lead = x.shape[:-1]
    x4 = x.reshape(x.shape[0], -1, 1, x.shape[-1])
    out = _Int8Conv.apply(x4, w, ascale, qw or prepare_conv_weight(w[None, None]), 0, mg)
    return out.reshape(*lead, -1)


def int8_dense(x, w, qw: Optional[Int8Weight] = None):
    """(n, ..., I) @ (I, O) f32 master weights -> x.dtype, int8 forward and
    pullback, per-sample activation scales."""
    return _dense(x, w, None, qw)


def int8_dense_static(x, w, ascale, qw: Optional[Int8Weight] = None):
    """``int8_dense`` with a calibrated scalar activation scale."""
    return _dense(x, w, ascale, qw)


def gn_quant_conv(x, gamma_nc, beta_nc, w, pad: int, groups: int = 32, eps: float = 1e-5,
                  qw: Optional[Int8Weight] = None):
    """silu(groupnorm(x) * gamma_nc + beta_nc) -> int8 -> int8 conv.
    x (n, h, w, cin) in the torso dtype, gamma_nc/beta_nc (n, cin) f32
    (FiLM folded by the caller), w (k, k, cin, cout) f32. Returns x.dtype
    (n, h, w, cout), bias not included."""
    return _GNQuantConv.apply(x, gamma_nc, beta_nc, w, qw or prepare_conv_weight(w), pad,
                              groups, eps)


# -- modules ------------------------------------------------------------------

MODES = ("dynamic", "static", "calib")


class _QuantSite:
    """What QuantConv and QuantDense share: the mode, the torso dtype, the
    cached int8 weight, the static scale buffer and the calibration
    abs-max."""

    def _init_site(self, mode: str, dtype: torch.dtype):
        if mode not in MODES:
            raise ValueError(f"quant mode {mode!r} not in {MODES}")
        self.mode, self.compute_dtype = mode, dtype
        # static mode: the stage's scale, written by the preconditioner
        self.register_buffer("act_scale", torch.ones(()), persistent=False)
        # calib mode: this site's batch abs-max, max-reduced across calls
        self.amax: Optional[torch.Tensor] = None
        self._int8: Optional[Int8Weight] = None
        self._int8_key = None

    def _master(self) -> torch.Tensor:
        raise NotImplementedError

    def int8_weight(self) -> Int8Weight:
        """The int8 operands, quantised once from the f32 master weights and
        again only when the weights change (in place or moved)."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device, w.dtype)
        if self._int8_key != key:
            if w.dtype != torch.float32:
                raise TypeError("quantised sites keep f32 master weights, got "
                                f"{w.dtype}")
            self._int8 = prepare_conv_weight(self._master())
            self._int8_key = key
        return self._int8

    def _scale_arg(self, xc, mg=None):
        """None (dynamic scales) or the static scalar; records the abs-max
        in calib mode (on a shard, the whole batch's, max-merged over the
        model group ``mg``)."""
        if self.mode == "static":
            return self.act_scale
        if self.mode == "calib":
            with torch.no_grad():
                a = _abs_max(xc).amax()
                if mg is not None:
                    a = coll.all_max(a, mg)
                self.amax = a if self.amax is None else torch.maximum(self.amax, a)
        return None


class QuantConv(nn.Conv2d, _QuantSite):
    """Stride-1 int8 conv with the reference conv's parameters (weight
    (O, I, kh, kw), bias) kept in f32, so state dicts load unchanged.
    Takes and returns NCHW (channels-last in memory) in the torso dtype.

    mode: 'dynamic' per-sample scales; 'static' the calibrated scalar in
    ``act_scale``; 'calib' dynamic compute plus the batch abs-max in
    ``amax``. ``forward(x, gn=(gamma_nc, beta_nc))`` is the fused route:
    GroupNorm+affine+SiLU+quantise (K2) feeding the conv.
    ``forward(x, shard=(mg, rows))``: x is this rank's rows of a height
    shard over the model group ``mg``, whose ranks hold ``rows`` rows
    (module docstring)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 mode: str = "dynamic", dtype: torch.dtype = torch.bfloat16):
        nn.Conv2d.__init__(self, in_channels, out_channels, kernel_size,
                           padding=kernel_size // 2)
        self._init_site(mode, dtype)

    def _master(self):
        return self.weight.permute(2, 3, 1, 0)      # HWIO view

    def forward(self, x, gn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                shard=None):
        xc = x.permute(0, 2, 3, 1).to(self.compute_dtype)
        pad = self.padding[0]
        mg, halo = (None, None) if shard is None else \
            (shard[0], tuple(shard[1]) if self.kernel_size[0] > 1 else None)
        if gn is not None:
            if self.mode != "dynamic":
                raise ValueError("the fused GroupNorm route runs in dynamic mode only")
            out = _GNQuantConv.apply(xc, gn[0], gn[1], self._master(), self.int8_weight(),
                                     pad, 32, 1e-5, mg, halo)
        else:
            out = _Int8Conv.apply(xc, self._master(), self._scale_arg(xc, mg),
                                  self.int8_weight(), pad, mg, halo)
        out = out + self.bias.to(self.compute_dtype)
        return out.permute(0, 3, 1, 2)


class QuantDense(nn.Conv1d, _QuantSite):
    """int8 dense layer with the reference 1x1 conv1d parameters (weight
    (O, I, 1), bias) kept in f32. Takes (n, t, I), returns (n, t, O) in the
    torso dtype. Modes as in ``QuantConv``; ``forward(y, mg=mg)``: y is
    this rank's positions of a height shard over the model group ``mg``."""

    def __init__(self, in_features: int, out_features: int, mode: str = "dynamic",
                 dtype: torch.dtype = torch.bfloat16):
        nn.Conv1d.__init__(self, in_features, out_features, 1)
        self._init_site(mode, dtype)

    def _master(self):
        return self.weight[..., 0].t()[None, None]    # (1, 1, I, O) view

    def forward(self, y, mg=None):
        yc = y.to(self.compute_dtype)
        n, t, i = yc.shape
        out = _Int8Conv.apply(yc.reshape(n, t, 1, i), self._master(), self._scale_arg(yc, mg),
                              self.int8_weight(), 0, mg)
        return out.reshape(n, t, -1) + self.bias.to(self.compute_dtype)

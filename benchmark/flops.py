"""The yardstick's arithmetic: the operations a guided call needs and the
bytes its GroupNorms move, from a configuration's shapes alone.

Operations count two per multiply-add of every product: convolutions,
linear layers, attention's two matmuls; the DCT and low-rank products of
the covariance algebra. Elementwise work, norms, softmax and FFTs are not
counted. They are split by the precision the configuration states for
them: the torso's products in its type (bfloat16 here), the rest in
float32 (the time embedding, attention's logits, the final conv, the
covariance algebra). A vjp cell adds one backward to the input: each
product on the path from the input once more (a convolution's or linear
layer's input gradient), attention twice more for each of its matmuls.
Recomputation (remat) is implementation, not model work: not counted.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from reference import unet as ref_unet

# published peaks of one NVIDIA H100 SXM (dense): operations/s by the type
# the products run in, HBM bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def torso_products(precision: dict) -> str:
    """The type the torso's products run in: ``precision.torso_products``
    (an int8 torso's: "int8"), else the torso's type."""
    return precision.get("torso_products", precision["torso"])


def _conv(cin, cout, k, hw_out):
    return 2 * cin * cout * k * k * hw_out


def _specs(lay: dict) -> list:
    """Every layer spec of ``ref_unet.blocks``, in the forward's order."""
    return [s for b in lay["input"] for s in b] + lay["middle"] + \
        [s for b in lay["output"] for s in b]


def forward(arch: ref_unet.Arch, torso: str, batch: int = 1) -> Dict[str, float]:
    """{precision: FLOPs} of one denoiser forward at ``batch``."""
    f = Counter()
    mc, ted = arch.num_channels, 4 * arch.num_channels
    f["float32"] += 2 * mc * ted + 2 * ted * ted           # time embedding
    lay = ref_unet.blocks(arch)
    for s in _specs(lay):
        r = s["res"]
        if s["kind"] == "conv":
            f[torso] += _conv(s["cin"], s["cout"], 3, r * r)
        elif s["kind"] == "res":
            ro = r * 2 if s["updown"] == "up" else (r // 2 if s["updown"] == "down" else r)
            cin, cout = s["cin"], s["cout"]
            f[torso] += _conv(cin, cout, 3, ro * ro) + _conv(cout, cout, 3, ro * ro)
            f[torso] += 2 * ted * (2 * cout if arch.use_scale_shift_norm else cout)
            if cin != cout:
                f[torso] += _conv(cin, cout, 1, ro * ro)
        else:
            c, t = s["ch"], r * r
            f[torso] += 2 * t * c * 3 * c + 2 * t * c * c     # qkv, proj_out
            f["float32"] += 2 * t * t * c                      # q k^T, f32 logits
            f[torso] += 2 * t * t * c                          # weights @ v
    f["float32"] += _conv(lay["final_ch"], arch.out_channels, 3, arch.image_size ** 2)
    return {k: v * batch for k, v in f.items()}


def input_backward(arch: ref_unet.Arch, torso: str, batch: int = 1) -> Dict[str, float]:
    """{precision: FLOPs} of the pullback to the input (no weight
    gradients): each product's input gradient, attention's matmuls twice,
    nothing for the embeddings, which do not depend on the input."""
    f = Counter(forward(arch, torso, 1))
    mc, ted = arch.num_channels, 4 * arch.num_channels
    f["float32"] -= 2 * mc * ted + 2 * ted * ted
    for s in _specs(ref_unet.blocks(arch)):
        if s["kind"] == "res":
            f[torso] -= 2 * ted * (2 * s["cout"] if arch.use_scale_shift_norm else s["cout"])
        elif s["kind"] == "attn":
            c, t = s["ch"], s["res"] ** 2
            f["float32"] += 2 * t * t * c
            f[torso] += 2 * t * t * c
    return {k: v * batch for k, v in f.items()}


def norm_inputs(arch: ref_unet.Arch) -> List[Tuple[int, int, int]]:
    """(C, H, W) of every GroupNorm's input in one forward, in order."""
    out = []
    lay = ref_unet.blocks(arch)
    for s in _specs(lay):
        r = s["res"]
        if s["kind"] == "res":
            ro = r * 2 if s["updown"] == "up" else (r // 2 if s["updown"] == "down" else r)
            out += [(s["cin"], r, r), (s["cout"], ro, ro)]
        elif s["kind"] == "attn":
            out.append((s["ch"], r, r))
    out.append((lay["final_ch"], arch.image_size, arch.image_size))
    return out


def k1_bytes(shape, itemsize: int) -> int:
    """One GroupNorm(+SiLU) call: x read once, y (x's type) written once."""
    n = 1
    for s in shape:
        n *= s
    return 2 * n * itemsize


def gn_backward_bytes(shape, itemsize: int) -> int:
    """One GroupNorm's pullback to its input: x and dy read once, dx
    written once, all in x's type."""
    return 3 * k1_bytes(shape, itemsize) // 2


class Algebra:
    """The covariance algebra's float32 products for a (batch, 3, res, res)
    image and capacity K: one basis change, one covariance matvec, a
    Woodbury inverse, the products fixed per guided call and per CG
    iteration. ``dct`` whether the basis is the 2-D DCT."""

    def __init__(self, batch: int, res: int, capacity: int, dct: bool):
        d = 3 * res * res
        self.basis = batch * 3 * 4 * res ** 3 if dct else 0    # two matmuls a channel
        lowrank = batch * (4 * capacity * d + 2 * capacity ** 2)
        self.matvec = 2 * self.basis + lowrank                 # to the basis, U M U^T, back
        gram = batch * 2 * capacity ** 2 * d
        # basis changes of prev_x, prev_mean, x_t, x0; two Woodbury inverses
        # in the time update, one in the transport and its matvec; the
        # secant's matvec; the Gram matrix and diag(U M U^T) of the
        # preconditioner; the CG's first residual; the covariance gradient
        self.per_call = 4 * self.basis + 3 * gram + lowrank + lowrank + 2 * gram + \
            2 * self.matvec

    def flops(self, calls: int, cg_iterations: int) -> float:
        return calls * self.per_call + cg_iterations * self.matvec

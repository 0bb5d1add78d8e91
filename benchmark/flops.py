"""The yardstick's arithmetic that no denoiser family owns: the card's
peaks, the bytes a GroupNorm call and its pullback move, and the
covariance algebra's operations for a guided call.

A denoiser's own operations are its family's frozen counts
(``reference/<family>.py``: ``forward_flops``, ``input_backward_flops``,
``norm_inputs``), split by the precision the configuration states for
them. Operations count two per multiply-add; elementwise work, norms,
softmax and FFTs are not counted. The covariance algebra runs in float32.
"""
from __future__ import annotations

# published peaks of one NVIDIA H100 SXM (dense): operations/s by the type
# the products run in, HBM bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def torso_products(precision: dict) -> str:
    """The type the torso's products run in: ``precision.torso_products``
    (an int8 torso's: "int8"), else the torso's type."""
    return precision.get("torso_products", precision["torso"])


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

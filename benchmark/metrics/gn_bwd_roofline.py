"""The GroupNorm backward (``ops/groupnorm.py``'s pullback): the least
time it could take, each norm's x and dy read once and dx written once
over the card's HBM bandwidth, as a share of the device time under the
program's ``groupnorm_silu_backward`` ranges in the traced stretch. It
counts the algorithm's bytes, whatever implements it."""
import flops


def read(ctx):
    tr, nb = ctx.get("trace"), ctx.get("norm_bytes") or {}
    t = sum(tr.spans.get("groupnorm_silu_backward", [])) if tr is not None else 0.0
    if not nb.get("bwd") or t <= 0:
        return None
    return 100.0 * nb["bwd"] / flops.HBM_BYTES_PER_S / t

"""K1 (``csrc/groupnorm.cu``, ``gn_stats.cuh``, ``gn_cluster.cuh``): the
least time its calls could take, each GroupNorm call's x read once and y
written once at its shape and type over the card's HBM bandwidth, as a
share of the device time of K1's kernels (by name) in the traced stretch.
Bound by bytes: K1 does about 20 instructions per 4 or 8 bytes."""
import flops

NAMES = ("gn_stats", "gn_finalize", "gn_apply", "gn_cluster")


def read(ctx):
    tr, nb = ctx.get("trace"), ctx.get("norm_bytes") or {}
    if tr is None or not nb.get("k1"):
        return None
    t = tr.kernel_seconds(lambda n: any(k in n for k in NAMES) and "gnq" not in n)
    return 100.0 * nb["k1"] / flops.HBM_BYTES_PER_S / t if t > 0 else None

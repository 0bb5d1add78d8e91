"""The share of the traced stretch in which no operation ran on the card:
one minus the union of its kernels' and copies' intervals over the
stretch's length."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

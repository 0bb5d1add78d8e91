"""The readings behind chip_smoke.py's own band for the linear-Gaussian
oracle's trace ratio (``LG_LIMITS``, phase 8a).

Runs 8a's vjp run on the CPU at ``--shape``: the sound pipeline over
``--seeds``, then, at seed 0, the pipeline with every matmul of
``ops/dct.py`` rounding its image operand (not the basis matrix) to each of
``--bits`` mantissa bits (``chip_smoke.dct_rounded``). Each run is held to
the exact posterior of its own measurement, formed outside the rounding.

    python -m tests._torch_oracle_band                  # 8a's (3, 32, 32)
    python -m tests._torch_oracle_band --shape 3,8,8    # the CPU tests' size

prints one JSON line per run: its statistics and the limits it breaks."""
import argparse
import contextlib
import json
import tempfile

import chip_smoke as cs
from free_hunch_tpu_torch.analysis import linear_gaussian as lg


def reading(shape: tuple, seed: int, bits=None) -> dict:
    """8a's vjp run drawn from ``seed``, its DCT's image operand rounded to
    ``bits`` mantissa bits where given."""
    v = lg.make_smooth_spectrum(shape, decades=4.0, v_max=30.0)
    rounded = contextlib.nullcontext() if bits is None else cs.dct_rounded(bits, "data")
    with tempfile.TemporaryDirectory() as tmp, rounded:
        samples, y, op, diag = cs.linear_gaussian_run("vjp", seed, "cpu", tmp, shape)
    B = lg.idct_basis_matrix(shape, "cpu")
    mu, Sig = lg.exact_posterior(lg.dense_operator_matrix(op, shape), B, v, y, cs.LG_SIGMA_Y)
    s = dict(cs.linear_gaussian_stats(samples, mu, Sig, B), cov_resets=diag["cov_resets"])
    return dict(shape=list(shape), seed=seed, bits=bits, **s, breaks=cs.limits_broken("vjp", s))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="3,32,32")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--bits", default="12,12.25,12.5,12.75,13")
    args = ap.parse_args()
    shape = tuple(int(c) for c in args.shape.split(","))
    for seed in (int(c) for c in args.seeds.split(",")):
        print(json.dumps(reading(shape, seed)), flush=True)
    for bits in (float(c) for c in args.bits.split(",")):
        print(json.dumps(reading(shape, 0, bits)), flush=True)

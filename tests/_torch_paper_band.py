"""The readings behind phase 9's 32 px witness (chip_smoke.py,
``PAPER_REF_CASES`` at ``PAPER_REF_STEPS`` Heun steps): how far the
driver's final samples move, as a share of the witness's sample limit
(``PAPER_SAMPLE_ABS``), for the witness's four cases and for the settings it
leaves out (the motion blur with the 256 px DCT-diagonal prior truncated to
32 px, at 3 and 5 steps, and with the flat prior at 3 steps).

With ``--device cpu`` each case runs on the CPU, then again with every
denoiser output multiplied by (1 + nudge N(0, 1)) for each of ``--nudges``,
a stand-in for another device's rounding; with ``--device cuda`` the case
runs on the card against the CPU. Also printed: whether the CG counts agree.

    python -m tests._torch_paper_band                  # CPU, nudges 1e-8, 1e-7, 1e-6
    PYTHONPATH=. python tests/_torch_paper_band.py --device cuda
                                                       # the card against the CPU

prints one JSON line per case."""
import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke as cs

MOTION = cs.PAPER_REF_CASES["motion_blur"]
CASES = {**{f"witness {name}": dict(over, num_steps=cs.PAPER_REF_STEPS)
            for name, over in cs.PAPER_REF_CASES.items()},
         "motion blur, truncated DCT prior, 3 steps": dict(
             MOTION, image_base_covariance="dct_diagonal", num_steps=3),
         "motion blur, truncated DCT prior, 5 steps": dict(
             MOTION, image_base_covariance="dct_diagonal", num_steps=5),
         "motion blur, flat prior, 3 steps": dict(MOTION, num_steps=3)}


def share(a: dict, b: dict) -> float:
    """The largest final-sample difference over the limit."""
    return max(float(np.abs(x - y).max()) for x, y in zip(a["samples"], b["samples"])) \
        / cs.PAPER_SAMPLE_ABS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--nudges", default="1e-8,1e-7,1e-6")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        ref = cs.DriverReference(args.seed, Path(tmp))
        for i, (name, case) in enumerate(CASES.items()):
            cpu = ref.run("cpu", f"cpu{i}", case=case)
            if args.device == "cuda":
                card = ref.run("cuda", f"card{i}", case=case)
                out = dict(card=round(share(cpu, card), 4),
                           niter_equal=card["niter"] == cpu["niter"])
            else:
                out = {}
                for j, nudge in enumerate(float(v) for v in args.nudges.split(",")):
                    moved = ref.run("cpu", f"nudge{i}_{j}", nudge=nudge, case=case)
                    out[f"nudge {nudge:g}"] = round(share(cpu, moved), 4)
                    out[f"niter_equal {nudge:g}"] = moved["niter"] == cpu["niter"]
            print(json.dumps(dict(case=name, **out)), flush=True)


if __name__ == "__main__":
    main()

"""The paper's evaluation commands, run through the port's driver.

Counterpart of ``scripts/run_paper_configs.sh``: its commands are the table
``COMMANDS`` (name -> options in ``config_default.json``'s key surface), each
run as ``generate_conditional.cmdline`` with the options every command shares
(steps, images, dataset, sigma_s 0.1, batch) and ``--outdir=<out>/<name>``.
A comparison grid of the DPS, PiGDM and Free Hunch motion-blur runs
(``tools/image_visualisation.py``) closes a run that made them, as the
script's does. Two more entries run the guidance gradients the
script leaves at its default: ``freehunch_blur_covariance`` (the covariance
gradient, no vjp through the UNet) and ``freehunch_blur_hybrid`` (the vjp
below ``guidance_vjp_below``, the covariance gradient above it).

Usage:
  python -m free_hunch_tpu_torch.tools.paper_configs [NAME ...] [--out out]
      [--steps 30] [--images 10] [--batch 1] [--data data/imagenet/]
      [--device cuda] [--<key>=<value> ...]

Without names it runs the script's ten commands. ``STEPS``, ``IMAGES``,
``DATA`` and ``BATCH`` in the environment set the defaults of ``--steps``,
``--images``, ``--data`` and ``--batch``, as they do for the script. Any
other ``--<key>=<value>`` goes to every command, e.g.
``--allow_random_init=true`` to run without the pretrained checkpoints.
"""
from __future__ import annotations

import argparse
import os

_FREE_HUNCH = ["--conditioning_mechanism=online_covariance"]
SWEEP_OPERATORS = ("gaussian_blur", "super_resolution", "inpainting")
SWEEP_PRIORS = ("identity", "dct_diagonal")

COMMANDS = {
    # (2) ImageNet-256 random inpainting with DPS
    "dps_inpainting": ["--conditioning_mechanism=dps", "--operator_name=inpainting",
                       "--inpainting_type=random", "--inpainting_prob_lower=0.6",
                       "--inpainting_prob_upper=0.8", "--cond_scaling=0.4"],
    # (3a) gaussian blur with PiGDM
    "pigdm_blur": ["--conditioning_mechanism=pigdm", "--operator_name=gaussian_blur",
                   "--pigdm_posthoc_scaling=true"],
    # (3b) 4x super-resolution with DDNM+ (the driver doubles the steps)
    "ddnm_sr": ["--conditioning_mechanism=ddnm", "--operator_name=super_resolution",
                "--scale_factor=4"],
    # (4) Free Hunch on motion blur, the paper's headline configuration
    "freehunch_motion": _FREE_HUNCH + ["--operator_name=motion_blur",
                                       "--image_base_covariance=dct_diagonal",
                                       "--solver_type=customcuda",
                                       "--space_step_update_threshold=10.0",
                                       "--space_step_update_lower_threshold=1.0"],
    # (5) the sweep: dense (identity) against memory-efficient (DCT) covariance
    **{f"sweep_{op}_{ibc}": _FREE_HUNCH + [f"--operator_name={op}",
                                           f"--image_base_covariance={ibc}"]
       for op in SWEEP_OPERATORS for ibc in SWEEP_PRIORS},
    # the guidance gradients besides the vjp, on the gaussian blur
    "freehunch_blur_covariance": _FREE_HUNCH + ["--operator_name=gaussian_blur",
                                                "--image_base_covariance=dct_diagonal",
                                                "--guidance_gradient=covariance"],
    "freehunch_blur_hybrid": _FREE_HUNCH + ["--operator_name=gaussian_blur",
                                            "--image_base_covariance=dct_diagonal",
                                            "--guidance_gradient=hybrid",
                                            "--guidance_vjp_below=2.0"],
}
# the script's commands, in its order
SCRIPT_COMMANDS = tuple(COMMANDS)[:10]
# the runs of the script's comparison grid
GRID_RUNS = ("dps_inpainting", "pigdm_blur", "freehunch_motion")
GRID_IMAGES = 6


def command(name: str, out: str, steps: int = 30, images: int = 10,
            data: str = "data/imagenet/", batch: int = 1, extra=()) -> list:
    """The driver's argument list of one entry: its output directory, the
    options every command takes (the script's ``$COMMON``), its own, then
    ``extra``."""
    return ([f"--outdir={out}/{name}", f"--num_steps={steps}", f"--total_images={images}",
             f"--dataset_path={data}", "--noise_sigma=0.1", f"--batch_size={batch}"]
            + COMMANDS[name] + list(extra))


def main(argv=None, device=None) -> dict:
    """Run the chosen entries; returns name -> the driver's totals."""
    from free_hunch_tpu_torch.data import png
    from free_hunch_tpu_torch.generate_conditional import cmdline
    from free_hunch_tpu_torch.tools import image_visualisation

    env = os.environ
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", help=f"entries of {sorted(COMMANDS)}; "
                   "default: the script's ten")
    p.add_argument("--out", default="out")
    p.add_argument("--steps", type=int, default=int(env.get("STEPS", 30)))
    p.add_argument("--images", type=int, default=int(env.get("IMAGES", 10)))
    p.add_argument("--batch", type=int, default=int(env.get("BATCH", 1)))
    p.add_argument("--data", default=env.get("DATA", "data/imagenet/"))
    p.add_argument("--device", default=device)
    args, extra = p.parse_known_args(argv)
    names = args.names or list(SCRIPT_COMMANDS)
    unknown = sorted(set(names) - set(COMMANDS))
    if unknown:
        p.error(f"unknown entries {unknown}; known: {sorted(COMMANDS)}")
    results = {}
    for name in names:
        results[name] = cmdline(command(name, args.out, args.steps, args.images, args.data,
                                        args.batch, extra), device=args.device)
    ran = [os.path.join(args.out, n) for n in GRID_RUNS if n in results]
    if ran:
        canvas, labels = image_visualisation.build_grid(ran, GRID_IMAGES)
        path = os.path.join(args.out, "comparison.png")
        png.write_png(path, canvas)
        print(f"comparison grid, rows {labels}: {path}")
    return results


if __name__ == "__main__":
    main()

"""The port's counterpart of ``scripts/run_paper_configs.sh``
(``free_hunch_tpu_torch/tools/paper_configs.py``):

(a) its table equals the script's commands: bash itself expands the script
    (``$COMMON``, the sweep loop, the ``STEPS``/``IMAGES``/``DATA``/``BATCH``
    defaults and overrides) with ``python`` replaced by a function that
    prints its arguments, and each ``generate_conditional.py`` command is
    compared with the table's entry, option by option;
(b) every entry builds, at 32 px, the same operator kwargs, schedule,
    covariance capacity and mechanism in the port's ``Evaluator`` as in the
    JAX package's (no sampling);
(c) every entry runs end to end through the port's driver on the CPU at
    32 px (2 images, 2 steps, f32): finite totals and the artifact layout.
"""
import dataclasses
import json
import os
import subprocess

import jax
import numpy as np
import pytest

from free_hunch_tpu import config as jcfg
from free_hunch_tpu.eval import Evaluator as JEvaluator
from free_hunch_tpu.eval_ddnm import DDNMEvaluator as JDDNMEvaluator
from free_hunch_tpu_torch import config as tcfg
from free_hunch_tpu_torch.data import png
from free_hunch_tpu_torch.eval import Evaluator as TEvaluator
from free_hunch_tpu_torch.eval_ddnm import DDNMEvaluator as TDDNMEvaluator
from free_hunch_tpu_torch.tools import paper_configs as pc
from tests._torch_parity import one_thread  # noqa: F401
from tests.test_torch_eval import setup32  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "run_paper_configs.sh")
DATA = os.path.join(ROOT, "data", "imagenet")
SEP = "\x1f"


def script_commands(env: dict) -> list:
    """Each command the script runs, as its argument list, expanded by bash
    with ``env`` added to the environment."""
    shim = f'python() {{ printf "%s{SEP}" "$@"; printf "\\n"; }}; source "{SCRIPT}"'
    out = subprocess.run(["bash", "-c", shim], capture_output=True, text=True, check=True,
                         env={**os.environ, **env}, cwd=ROOT, timeout=60).stdout
    return [line.rstrip(SEP).split(SEP) for line in out.splitlines() if line]


def options(argv) -> dict:
    """--key=value tokens as a dict; every token must be one."""
    assert all(a.startswith("--") and "=" in a for a in argv), argv
    out = dict(a[2:].split("=", 1) for a in argv)
    assert len(out) == len(argv), "an option given twice"
    return out


def driver_commands(env: dict) -> dict:
    """name -> options of the script's generate_conditional.py commands."""
    cmds = [c for c in script_commands(env) if c[0] == "generate_conditional.py"]
    got = {}
    for c in cmds:
        opts = options(c[1:])
        name = os.path.basename(opts["outdir"])
        assert opts["outdir"] == f"out/{name}" and name not in got
        got[name] = opts
    return got


ENVS = {"defaults": {}, "overrides": dict(STEPS="3", IMAGES="2", BATCH="2", DATA="d/")}


def _table(env: dict, name: str) -> dict:
    kw = dict(steps=int(env.get("STEPS", 30)), images=int(env.get("IMAGES", 10)),
              batch=int(env.get("BATCH", 1)), data=env.get("DATA", "data/imagenet/"))
    return options(pc.command(name, "out", **kw))


@pytest.mark.parametrize("env", list(ENVS.values()), ids=list(ENVS))
def test_the_script_runs_the_tables_commands_in_order(env):
    got = driver_commands(env)
    assert list(got) == list(pc.SCRIPT_COMMANDS)
    assert set(pc.COMMANDS) - set(pc.SCRIPT_COMMANDS) == {"freehunch_blur_covariance",
                                                          "freehunch_blur_hybrid"}
    grid = [c for c in script_commands(env) if c[0] == "create_image_visualisation.py"]
    assert len(grid) == 1
    args = grid[0][1:]
    runs = args[args.index("--runs") + 1:args.index("--num_images")]
    assert runs == [f"out/{n}" for n in pc.GRID_RUNS]
    assert int(args[args.index("--num_images") + 1]) == pc.GRID_IMAGES


@pytest.mark.parametrize("env", list(ENVS.values()), ids=list(ENVS))
@pytest.mark.parametrize("name", pc.SCRIPT_COMMANDS)
def test_each_entry_equals_the_scripts_command(env, name):
    assert _table(env, name) == driver_commands(env)[name]


def test_the_gradient_entries_are_the_blur_sweep_with_a_gradient():
    base = _table({}, "sweep_gaussian_blur_dct_diagonal")
    for name, extra in (("freehunch_blur_covariance", dict(guidance_gradient="covariance")),
                        ("freehunch_blur_hybrid", dict(guidance_gradient="hybrid",
                                                       guidance_vjp_below="2.0"))):
        got = _table({}, name)
        assert got == dict(base, outdir=f"out/{name}", **extra)
    # the hybrid entry's threshold is the driver's default
    assert tcfg.load_config(argv=["--outdir=o"])["guidance_vjp_below"] == 2.0


# -- (b) the same driver objects as the JAX package -----------------------------

def _argv(name, setup, outdir):
    return pc.command(name, outdir, steps=2, images=2, data=DATA, batch=2) + [
        f"--openai_setup_path={setup}",
        f"--openai_state_dict_path={os.path.join(os.path.dirname(setup), 'missing.pt')}",
        "--allow_random_init=true", "--dtype=float32", "--mesh_shape=data:1"]


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=1e-6)
    return a == b


@pytest.mark.parametrize("name", list(pc.COMMANDS))
def test_each_entry_builds_what_the_jax_driver_builds(name, setup32, tmp_path):
    argv = _argv(name, setup32, str(tmp_path))
    ddnm = name == "ddnm_sr"
    with jax.enable_x64(False):
        jev = (JDDNMEvaluator if ddnm else JEvaluator)(jcfg.load_config(argv=argv))
    tev = (TDDNMEvaluator if ddnm else TEvaluator)(tcfg.load_config(argv=argv), device="cpu")
    assert tev.operator_kwargs == jev.operator_kwargs
    assert set(tev.xs) == set(jev.xs)
    for k in tev.xs:
        np.testing.assert_allclose(np.asarray(tev.xs[k], np.float64),
                                   np.asarray(jev.xs[k], np.float64), rtol=1e-6, atol=0)
    assert float(tev.sigma0_scaled) == pytest.approx(float(jev.sigma0_scaled), rel=1e-6)
    assert tev.model.cfg.remat == jev.model.cfg.remat
    assert (tev.seeds, tev.batch_size, list(tev.indices)) == \
        (jev.seeds, jev.batch_size, list(jev.indices))
    if ddnm:
        assert (tev.num_steps, tev.sigma_y, tev.eta) == (jev.num_steps, jev.sigma_y, jev.eta)
        assert type(tev._svd_template).__name__ == type(jev._svd_template).__name__
        return
    assert tev._cov_capacity(tev.opts) == jev._cov_capacity(jev.opts)
    tm, jm = tev._mech_builder(tev._template_op), jev._mech_builder(jev._template_op)
    assert type(tm).__name__ == type(jm).__name__
    jfields = {f.name for f in dataclasses.fields(jm)}
    skip = {"forward_operator", "model_group"}
    compared = 0
    for f in dataclasses.fields(tm):
        if f.name in skip:
            continue
        assert f.name in jfields, f.name
        assert _close(getattr(tm, f.name), getattr(jm, f.name)), \
            (f.name, getattr(tm, f.name), getattr(jm, f.name))
        compared += 1
    # every option of the entry reached the mechanism or the operator
    for key, value in options(pc.COMMANDS[name]).items():
        if key in ("conditioning_mechanism", "operator_name", "inpainting_type",
                   "inpainting_prob_lower", "inpainting_prob_upper", "scale_factor"):
            continue
        assert str(getattr(tm, key)).lower() == value.lower() or \
            getattr(tm, key) == pytest.approx(float(value)), key
    assert compared >= 6


# -- (c) end to end through the port's driver -----------------------------------

@pytest.mark.parametrize("name", list(pc.COMMANDS))
def test_each_entry_runs_through_the_ports_driver(name, setup32, tmp_path):
    extra = [f"--openai_setup_path={setup32}",
             f"--openai_state_dict_path={os.path.join(os.path.dirname(setup32), 'missing.pt')}",
             "--allow_random_init=true", "--dtype=float32", "--mesh_shape=data:1"]
    results = pc.main([name, "--out", str(tmp_path), "--steps", "2", "--images", "2",
                       "--batch", "2", "--data", DATA] + extra, device="cpu")
    out = tmp_path / name
    totals = results[name]
    assert all(np.isfinite(totals[k]) for k in ("psnr", "ssim", "lpips"))
    assert totals["images"] == 2 and totals["lpips_is_proxy"] is True
    assert json.loads((out / "results.json").read_text())["images"] == 2
    for sub in ("images", "cond_images", "forward_images"):
        names = sorted(p.name for p in (out / sub).glob("*.png"))
        assert names == ["000000_000000.png", "000001_000000.png"], (sub, names)
    assert png.read_png(str(out / "images" / "000000_000000.png")).shape == (32, 32, 3)
    assert len((out / "metrics_rank00.jsonl").read_text().splitlines()) == 1
    config = json.loads((out / "config.json").read_text())
    assert config["num_steps"] == (4 if name == "ddnm_sr" else 2)
    assert (out / "results.txt").read_text().startswith("PSNR: ")
    assert "PSNR:" in (out / "output.log").read_text()
    assert (tmp_path / "comparison.png").exists() == (name in pc.GRID_RUNS)


def test_the_grid_closes_a_run_of_its_commands(setup32, tmp_path):
    extra = [f"--openai_setup_path={setup32}",
             f"--openai_state_dict_path={os.path.join(os.path.dirname(setup32), 'missing.pt')}",
             "--allow_random_init=true", "--dtype=float32", "--mesh_shape=data:1"]
    pc.main(list(pc.GRID_RUNS) + ["--out", str(tmp_path), "--steps", "2", "--images", "2",
                                  "--batch", "2", "--data", DATA] + extra, device="cpu")
    grid = png.read_png(str(tmp_path / "comparison.png"))
    # ground truth, measurement and the three runs; two images, 32 px, 4 px gaps
    assert grid.shape == (5 * 36 + 4, 2 * 36 + 4, 3)
    with pytest.raises(SystemExit):
        pc.main(["no_such_entry", "--out", str(tmp_path)], device="cpu")

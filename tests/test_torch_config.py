"""The port's config (``free_hunch_tpu_torch/config.py`` and its JSON
schema) against the JAX package's ``free_hunch_tpu/config.py`` and YAML:
the same schema and defaults, and equal results of ``load_config`` and
``get_job_name_params`` on the cases of ``tests/test_driver.py``, both CLI
forms and the typed-error message."""
import json
import os

import pytest
import yaml

from free_hunch_tpu import config as J
from free_hunch_tpu_torch import config as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_json_schema_and_defaults_equal_the_yaml():
    with open(os.path.join(ROOT, "free_hunch_tpu", "config_default.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(ROOT, "free_hunch_tpu_torch", "config_default.json")) as f:
        got = json.load(f)
    assert got == want
    assert list(got["schema"]) == list(want["schema"])


PROGRAMMATIC = [
    dict(outdir="/tmp/x", num_steps="30", S_churn="0.5", seeds="1,2,3", clip_x0_mean="true"),
    dict(outdir="/tmp/x", seeds=[1, 2], num_steps=12, cond_scaling=None),
    dict(outdir="/tmp/x", S_max="inf", max_rtol="0.5", remat="no", cov_capacity=16),
    dict(outdir="/tmp/x", dataset_path=None, dataset="ffhq", data_subset="test"),
]


@pytest.mark.parametrize("args", PROGRAMMATIC)
def test_load_config_programmatic_matches_jax(args):
    got, want = T.load_config(args=dict(args)), J.load_config(args=dict(args))
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


ARGVS = [
    ["--outdir=/tmp/x", "--num_steps=7", "--S_churn", "0.25", "--seeds", "4,5"],
    ["--outdir", "/tmp/y", "--conditioning_mechanism=online_covariance", "--dtype=float32",
     "--save_videos", "true", "--noise_sigma=0.05"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_load_config_cli_forms_match_jax(argv):
    got = T.load_config(argv=list(argv))
    assert got == J.load_config(argv=list(argv))
    assert got.outdir.startswith("/tmp/")


def test_cli_values_are_typed():
    opts = T.load_config(argv=ARGVS[0])
    assert opts.num_steps == 7 and isinstance(opts.num_steps, int)
    assert opts.S_churn == 0.25 and opts.seeds == [4, 5]


@pytest.mark.parametrize("argv", [["--outdir=/tmp/x", "--num_steps"],
                                  ["--outdir=/tmp/x", "stray"]])
def test_a_dangling_flag_exits_like_jax(argv):
    with pytest.raises(SystemExit):
        J.load_config(argv=list(argv))
    with pytest.raises(SystemExit):
        T.load_config(argv=list(argv))


def test_a_bad_typed_value_raises_the_same_clean_error():
    args = dict(outdir="/tmp/x", num_steps="many")
    with pytest.raises(ValueError) as je:
        J.load_config(args=dict(args))
    with pytest.raises(ValueError) as te:
        T.load_config(args=dict(args))
    assert str(te.value) == str(je.value)
    assert str(te.value).startswith("Invalid type for 'num_steps'")


@pytest.mark.parametrize("mech", ["dps", "pigdm", "tmpd", "ddnm", "online_covariance",
                                  "diffpir"])
def test_job_name_params_match_jax(mech):
    cfg = dict(T.load_config(args=dict(outdir="/tmp/x")), conditioning_mechanism=mech)
    assert T.get_job_name_params(cfg) == J.get_job_name_params(cfg)


def test_job_name_params_unknown_mechanism_raises():
    cfg = dict(T.load_config(args=dict(outdir="/tmp/x")), conditioning_mechanism="nope")
    with pytest.raises(ValueError, match="Unknown conditioning mechanism"):
        T.get_job_name_params(cfg)

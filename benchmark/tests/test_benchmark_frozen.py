"""The adm family's path held to values taken before the family interface
existed: the seeded weights of the tiny UNet (sha256), the parameter
layout, the frozen counts and the check's schedule of both configurations
at their published sizes, and the steps the check samples in each cell."""
import hashlib
import json

import numpy as np
import pytest
import torch

from _tiny import ADM, TINY_MODEL

import harness  # noqa: E402
import spec  # noqa: E402
import weights as weights_mod  # noqa: E402
from reference import freehunch as ref_fh  # noqa: E402

WEIGHTS = {"bfloat16": "4a555c08563eb1e3bc39bf3ad4bed26f0ffcc89fae1df70962b603eba2858426",
           "float32": "2e33f80acfb40d643d91e8a733d16626c734d5db2348f989dae66f0be1adf25d"}
LAYOUT = {"imagenet256-adm": (566, 552_814_086,
                              "5ba9f3129c12d08fbb844955b39e3b2a48289a0d8a9274d66896866dba816978"),
          "ffhq256-adm": (362, 93_563_910,
                          "df722dea0c475cf0e5d5145b61eb685a132d7837e33603c288855ca6ac4d46b5")}
COUNTS = {"imagenet256-adm": (
    {"float32": 7_904_690_176, "bfloat16": 2_231_760_846_848},
    {"float32": 13_992_198_144, "bfloat16": 2_237_745_070_080},
    101, "f4edf55b918c2638c40fa95b8664e10d7a670322487b80875bdbfcea90e35ca1"),
    "ffhq256-adm": (
    {"float32": 1_112_145_920, "bfloat16": 386_822_045_696},
    {"float32": 1_317_011_456, "bfloat16": 387_008_430_080},
    65, "5abe837a8334337a842feab12008c79dc8a2dc71763b0e9b79ef1d58621cd087")}
SCHEDULE = ("3fc7497786d7b0472a3f2dae1210467d35f75dcd27e0d46018971959e06058f3",
            80.28779602050781, 34)
STEPS = {0: [13, 25, 29], 1952503716: [14, 26, 29], 2 ** 31 + 77: [17, 27, 28],
         4294967311: [18, 25, 29]}


def digest(w):
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(LAYOUT))
@pytest.mark.parametrize("torso", sorted(WEIGHTS))
def test_the_tiny_weights_are_bitwise_the_same(config, torso):
    cfg = spec.config(config)
    model = dict(cfg["model"], **TINY_MODEL)
    w = weights_mod.make(ADM.param_shapes(ADM.arch_of(model)), 0, "cpu",
                         dict(cfg["precision"], torso=torso))
    assert digest(w) == WEIGHTS[torso]


@pytest.mark.parametrize("config", sorted(LAYOUT))
def test_the_parameter_layout_and_counts_are_the_same(config):
    cfg = spec.config(config)
    assert spec.family(cfg) == "adm" and spec.reference(cfg) is ADM
    arch = ADM.arch_of(cfg["model"])
    shapes = ADM.param_shapes(arch)
    n, total, sha = LAYOUT[config]
    assert len(shapes) == n and sum(int(np.prod(s)) for _, s, _ in shapes) == total
    assert hashlib.sha256(json.dumps([[k, list(s)] for k, s, _ in shapes]).encode()
                          ).hexdigest() == sha
    fwd, bwd, n_norms, norms_sha = COUNTS[config]
    assert ADM.forward_flops(arch, "bfloat16", 1) == fwd
    assert ADM.input_backward_flops(arch, "bfloat16", 1) == bwd
    norms = ADM.norm_inputs(arch)
    assert len(norms) == n_norms
    assert hashlib.sha256(json.dumps(norms).encode()).hexdigest() == norms_sha


@pytest.mark.parametrize("cell", sorted(spec.names("workloads")))
def test_the_schedule_and_the_sampled_steps_are_the_same(cell):
    c = spec.cell(cell)
    arch = ADM.arch_of(c["config"]["model"])
    sched = ref_fh.schedule(30, ADM.snap_grid(arch), ADM.sigma_range(arch))
    h = hashlib.sha256()
    for k in ("sigma_hat", "h", "sigma_prime", "c1", "c2", "use_heun"):
        h.update(np.ascontiguousarray(sched[k]).tobytes())
    assert (h.hexdigest(), sched["sigma0"], ref_fh.cov_capacity(sched)) == SCHEDULE
    for seed, steps in STEPS.items():
        assert harness.sampled_steps(seed, sched, c["check"]["bands"]) == steps

"""Phase 8 of chip_smoke.py (the exact-posterior oracles) with the CPU in
place of the card, at a CPU size: the linear-Gaussian oracle on (3, 8, 8)
images (d = 192) with the phase's n = 256 and 40 Heun steps, and the GMM
posterior at the phase's own size. A sound sampler reads inside every
limit; a sampler with the guidance switched off, an exact posterior formed
with the wrong noise level, runs that disagree, the trace ratio of the JAX
package's lost-precision reading and a covariance reset read outside them.
The precision controls are in test_torch_chip_smoke_oracle_controls.py.

The readings these tests print are the CPU's; the card's are in PERF.md."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from free_hunch_tpu_torch.analysis import gmm_guided as gg
from tests._torch_parity import one_thread  # noqa: F401

SHAPE = (3, 8, 8)


@pytest.fixture(scope="module")
def sound():
    """The sound oracle's three runs, once (observed on the CPU: z_max
    0.189, z_median 0.045, mean_rel_l2 0.063, var_ratio_median 1.005,
    trace_ratio 1.014 in both gradient modes)."""
    return cs.linear_gaussian_oracle(0, "cpu", shape=SHAPE)


def test_sound_linear_gaussian_oracle_reads_inside_the_limits(sound):
    stats, diags, bad = sound
    assert bad == [], bad
    assert set(stats) == set(cs.LG_RUNS)
    for diag in diags.values():
        n = diag["cg_niter"].numpy()
        assert n.shape == (cs.LG_STEPS, 2) and (n[:, 0] > 0).all()


@pytest.mark.parametrize("wrong", ["guidance_off", "exact_posterior_with_twice_sigma_y"])
def test_wrong_linear_gaussian_inputs_break_the_limits(wrong):
    """No guidance samples the prior (its mean far from the posterior's:
    z_max past 0.5); the exact posterior for sigma_y = 0.2 is another
    posterior (observed: z_max 0.559, z_median 0.135 and mean_rel_l2 0.252
    outside their limits)."""
    kw = (dict(mechanism_kwargs=dict(cond_scaling=0.0)) if wrong == "guidance_off"
          else dict(exact_sigma_y=2 * cs.LG_SIGMA_Y))
    stats, _, bad = cs.linear_gaussian_oracle(0, "cpu", shape=SHAPE, runs=("vjp",), **kw)
    print(wrong, bad)
    key = "z_max" if wrong == "guidance_off" else "mean_rel_l2"
    assert any(b.startswith(f"vjp: {key}") for b in bad), bad


def test_runs_that_disagree_break_the_limit(sound):
    stats = {m: dict(s) for m, s in sound[0].items()}
    stats["covariance"]["trace_ratio"] += 0.16
    stats["covariance"]["mean_rel_l2"] += 0.06
    bad = cs.linear_gaussian_failures(stats)
    differs = [b for b in bad if b.startswith("covariance differs from vjp:")]
    assert len(differs) == 2, bad
    # the shifted trace ratio is past the card's band as well
    assert [b for b in bad if b not in differs] == [
        f"covariance: trace_ratio {stats['covariance']['trace_ratio']:.4g} outside (0.98, 1.04)"]


def test_the_lost_precision_trace_ratio_breaks_only_the_card_band(sound):
    """1.17, the reading of the JAX package's oracle before its precision
    fix, passes every limit of its test and breaks the card's band."""
    s = dict(sound[0]["vjp"], trace_ratio=1.17)
    assert cs.limits_broken("vjp", s) == ["vjp: trace_ratio 1.17 outside (0.98, 1.04)"]


def test_a_covariance_reset_breaks_the_limit(sound):
    """A sound run resets no covariance state; a rounded DCT does."""
    s = dict(sound[0]["vjp"], cov_resets=1)
    assert cs.limits_broken("vjp", s) == ["vjp: cov_resets 1 outside (None, 1)"]


def test_a_control_that_reads_inside_every_limit_fails_the_phase(sound):
    control = next(iter(cs.LG_CONTROLS))
    bad = cs.linear_gaussian_failures({"vjp": sound[0]["vjp"], control: sound[0]["vjp"]})
    assert bad == [f"{control}: inside every limit, which cannot see it"], bad


@pytest.mark.parametrize("guided", [True, False], ids=["sound", "guidance_off"])
def test_gmm_posterior_limits(guided):
    """At the phase's n = 1024 and 40 steps: the sound sampler within
    tests/test_gmm_guided.py's limits (observed on the CPU: mean error
    0.052, observed coordinate 0.088 off 1.8), the unguided one outside
    them (the prior's mean, 0.4, is 1.4 from the posterior's)."""
    samples, posterior = gg.sample_gmm_posterior(
        cs.oracle_gmm(), np.asarray(cs.GMM_MASK, np.float32), np.asarray(cs.GMM_Y, np.float32),
        cs.GMM_SIGMA_Y, n=cs.GMM_N, num_steps=cs.GMM_STEPS,
        generator=torch.Generator().manual_seed(0), device="cpu",
        mechanism_kwargs=None if guided else dict(cond_scaling=0.0))
    s = cs.gmm_stats(samples, posterior)
    bad = cs.gmm_failures(s)
    print(guided, s, bad)
    if guided:
        assert bad == [], bad
    else:
        assert any(b.startswith("mean error") for b in bad), bad

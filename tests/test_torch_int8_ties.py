"""The unsharded int8 port parts from the JAX package only at rounding
ties. On two inputs other than tests/test_torch_unet_int8.py's, each
torso's first site with a differing activation code differs only in codes
whose scaled values lie within 1e-3 of the JAX package's (float rounding
across a half-integer); what follows inherits it (tests/_torch_int8_ties.py
runs 5 seeds x 3 noise levels)."""
import pytest

from tests import _torch_int8_ties as ties
from tests._torch_parity import one_thread  # noqa: F401


@pytest.mark.parametrize("torso,seed,sigma", [("int8", 11, 5.0), ("int8_static", 12, 50.0)])
def test_the_first_differing_codes_sit_at_rounding_ties(torso, seed, sigma):
    r = (ties.dynamic_case if torso == "int8" else ties.static_case)(seed, sigma)
    print(r)
    assert r["sites"] == 27 and r["first"] is not None, r
    assert r["first"]["differ"] == r["first"]["at_tie"] and r["first"]["away"] == 0, r

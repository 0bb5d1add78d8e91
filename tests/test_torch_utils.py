"""The port's small utilities (``free_hunch_tpu_torch/utils/misc.py``,
``utils/dynamic.py`` and ``parallel/dist.py``) against the JAX package's:
the same host seeding, shape checks, infinite sampler streams, parameter
summary, dotted-name calls and URL test, the profiler span, and a world of
one with and without an initialised process group."""
import random

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from free_hunch_tpu.parallel import dist as jdist
from free_hunch_tpu.utils import dynamic as jdyn
from free_hunch_tpu.utils import misc as jmisc
from free_hunch_tpu_torch.parallel import dist
from free_hunch_tpu_torch.utils import dynamic, misc
from tests._torch_parity import one_thread  # noqa: F401


@pytest.mark.parametrize("seed,rank", [(0, 0), (7, 3), (2**20, 1)])
def test_set_random_seed_seeds_the_host_generators_as_jax(seed, rank):
    jmisc.set_random_seed(seed, rank)
    want = (np.random.rand(4), random.random())
    gen = misc.set_random_seed(seed, rank)
    assert np.array_equal(np.random.rand(4), want[0]) and random.random() == want[1]
    again = misc.set_random_seed(seed, rank)
    assert gen.device.type == "cpu"
    assert torch.equal(torch.randn(5, generator=gen), torch.randn(5, generator=again))


@pytest.mark.parametrize("shape,ref", [((2, 3), (2, 3)), ((2, 3), (None, 3)),
                                       ((2, 3), (2, 4)), ((2, 3), (2, 3, 1)), ((5,), (None,))])
def test_assert_shape_agrees_with_jax(shape, ref):
    def outcome(fn):
        try:
            fn(np.zeros(shape), ref)
        except AssertionError as e:
            return str(e)
        return None

    assert outcome(misc.assert_shape) == outcome(jmisc.assert_shape)
    assert outcome(misc.assert_shape) == outcome(lambda a, r: misc.assert_shape(
        torch.zeros(a.shape), r))


@pytest.mark.parametrize("size,rank,replicas,shuffle,seed,window", [
    (10, 0, 1, True, 0, 0.5), (7, 1, 3, True, 5, 0.5), (13, 0, 2, False, 0, 0.5),
    (9, 2, 4, True, 1, 0.0), (1, 0, 1, True, 0, 1.0)])
def test_infinite_sampler_streams_equal_jax(size, rank, replicas, shuffle, seed, window):
    kw = dict(rank=rank, num_replicas=replicas, shuffle=shuffle, seed=seed, window_size=window)
    got, want = iter(misc.InfiniteSampler(size, **kw)), iter(jmisc.InfiniteSampler(size, **kw))
    assert [next(got) for _ in range(60)] == [next(want) for _ in range(60)]


@pytest.mark.parametrize("size,window", [(0, 0.5), (4, 1.5), (4, -0.1)])
def test_infinite_sampler_refuses_what_jax_refuses(size, window):
    with pytest.raises(AssertionError):
        jmisc.InfiniteSampler(size, window_size=window)
    with pytest.raises(ValueError):
        misc.InfiniteSampler(size, window_size=window)


@pytest.mark.parametrize("max_rows", [40, 1])
def test_param_summary_equals_jax_on_the_same_tensors(max_rows, capsys):
    """A module's named parameters against the flax dict of the same
    shapes: equal counts and, with '.' read as '/', the same table."""
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Conv2d(4, 6, 3))
    params = {i: {k: np.zeros(tuple(v.shape), np.float32) for k, v in m.named_parameters()}
              for i, m in enumerate(net)}
    params = {str(k): v for k, v in params.items()}
    assert misc.count_parameters(net) == jmisc.count_parameters(params) == 4 * 3 + 4 + 6 * 4 * 9 + 6
    got = misc.print_param_summary(net, max_rows)
    want = jmisc.print_param_summary(params, max_rows)
    assert got.replace(".", "/") == want
    assert capsys.readouterr().out == got + "\n" + want + "\n"


def test_profiled_function_is_a_named_profiler_span():
    @misc.profiled_function
    def scaled_sum(x, k=2):
        return (x * k).sum()

    assert scaled_sum.__name__ == jmisc.profiled_function(scaled_sum).__name__ == "scaled_sum"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = scaled_sum(torch.ones(3), k=3)
        with misc.profiled_region("outer_region"):
            torch.ones(2).sum()
    assert float(out) == 9.0
    names = {e.key for e in prof.key_averages()}
    assert {"scaled_sum", "outer_region"} <= names


@pytest.mark.parametrize("name,args,kwargs", [
    ("numpy.add", (2, 3), {}), ("math.hypot", (3.0, 4.0), {}),
    ("numpy.linalg.norm", ([3.0, 4.0],), {"ord": 1})])
def test_call_func_by_name_equals_jax(name, args, kwargs):
    assert dynamic.call_func_by_name(*args, func_name=name, **kwargs) == \
        jdyn.call_func_by_name(*args, func_name=name, **kwargs)


@pytest.mark.parametrize("obj", ["http://x/y.pkl", "file:///tmp/a", "gs://b/c", "/tmp/a.npz",
                                 "data/imagenet", "HTTP://x", "", None, 3])
def test_is_url_equals_jax(obj):
    assert dynamic.is_url(obj) == jdyn.is_url(obj)


def test_a_world_of_one_with_and_without_a_process_group(tmp_path, capsys):
    assert not tdist.is_initialized()
    dist.init()
    assert (dist.get_rank(), dist.get_world_size()) == (jdist.get_rank(), jdist.get_world_size()) \
        == (0, 1)
    dist.print0("rank zero says", 1)
    dist.barrier()
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                             world_size=1, rank=0)
    try:
        assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
        dist.print0("again")
        dist.barrier()
    finally:
        tdist.destroy_process_group()
    assert capsys.readouterr().out == "rank zero says 1\nagain\n"

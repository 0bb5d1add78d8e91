"""Shared fixtures of the port parity tests (tests/test_torch_*.py): the
32 px f32 UNet of tests/test_sampler_e2e.py with identical weights in the
JAX package and in the port, on the bf16/f32 torso or an int8 one."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.models.unet import UNetConfig as JConfig
from free_hunch_tpu.models.unet import UNetModel as JUNet
from free_hunch_tpu_torch.models.convert import state_dict_from_flax
from free_hunch_tpu_torch.models.unet import UNetConfig, UNetModel

RES = 32


def tiny_cfg_kwargs():
    return dict(image_size=RES, in_channels=3, model_channels=32, out_channels=6,
                num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
                num_heads=2, num_head_channels=16)


def _randomize_zero_leaves(params, scale=0.1, seed=0):
    """numpy twin of the JAX package's randomize_zero_leaves: every all-zero
    leaf (zero-initialised out convs, proj_out, biases) becomes fan-in-scaled
    noise, so the UNet's output is not the degenerate F(x) == 0."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        leaf = np.asarray(leaf)
        if leaf.size and not np.abs(leaf).max():
            fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else leaf.shape[0]
            return (rng.normal(size=leaf.shape) * scale / np.sqrt(max(fan_in, 1))
                    ).astype(np.float32)
        return leaf
    return jax.tree.map(fill, params)


@functools.lru_cache(maxsize=1)
def tiny_pair():
    """(jax model, flax params, torch model) with identical f32 weights."""
    jm = JUNet(JConfig(**tiny_cfg_kwargs(), dtype=jnp.float32, remat=False))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 3, RES, RES), jnp.float32),
                              jnp.zeros((1,), jnp.float32))
    params = _randomize_zero_leaves(params)
    cfg = UNetConfig(**tiny_cfg_kwargs(), dtype=torch.float32, remat=False)
    tm = UNetModel(cfg)
    tm.load_state_dict(state_dict_from_flax(params, cfg))
    tm.eval().requires_grad_(False)
    return jm, jax.tree.map(jnp.asarray, params), tm


def quant_pair(quant, fused=False, dtype="f32", remat=False, quant_1x1=True):
    """(jax model, flax params, torch model) of ``tiny_pair``'s weights on
    an int8 torso (``quant``), in f32 or bf16. ``fused``: the port's
    ``fused_gn_quant``, the JAX package's FREE_HUNCH_FUSED_GN_QUANT=1;
    ``quant_1x1=False``: the JAX package's FREE_HUNCH_QUANT_1X1=0. The caller
    sets those switches while the JAX model traces."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    _, params, ref = tiny_pair()
    jm = JUNet(JConfig(**tiny_cfg_kwargs(), dtype=jdt, remat=False, quant=quant))
    cfg = UNetConfig(**tiny_cfg_kwargs(), dtype=tdt, remat=remat, quant=quant,
                     fused_gn_quant=fused, quant_1x1=quant_1x1)
    tm = UNetModel(cfg)
    tm.load_state_dict(ref.state_dict())
    tm.eval().requires_grad_(False)
    return jm, params, tm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's torch work: its ops are small,
    and the test workers run side by side on the machine's cores, where
    each worker's full thread pool would spin against the others'
    (measured 9-16x slower than alone). Imported by a test module, it
    applies to that module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

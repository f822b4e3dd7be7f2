"""STDiT3 of the PyTorch port against the JAX model: the tiny model of
tests/test_torch_parity.py, the same params (via from_jax) and numpy inputs,
fp32 at 2e-4; and the from_jax / convert_stdit3 round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.models.transformers import stdit3 as J
from videosys_tpu.utils.convert import convert_stdit3
from videosys_tpu_torch.models.transformers import stdit3 as P
from videosys_tpu_torch.utils.from_jax import stdit3_from_jax

TOL = 2e-4
SIZES = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8)
B, T, H, W, L = 2, 3, 8, 8, 8


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 4, T, H, W)).astype(np.float32)
    t = np.array([500.0, 130.0], np.float32)
    y = rng.standard_normal((B, L, 16)).astype(np.float32)
    jm = J.STDiT3(J.STDiT3Config(**SIZES))
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(y), height=256.0, width=256.0)
    # random, non-trivial values for every leaf (zero-init biases included)
    leaves, tree = jax.tree.flatten(params)
    leaves = [np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
              for a in leaves]
    params = jax.tree.unflatten(tree, leaves)
    pm = P.STDiT3(P.STDiT3Config(**SIZES))
    pm.load_state_dict({k: torch.tensor(v)
                        for k, v in stdit3_from_jax(params).items()})
    return jm, params, pm.eval(), (x, t, y)


@pytest.mark.parametrize("with_x_mask", [False, True])
def test_stdit3_matches_jax(models, with_x_mask):
    jm, params, pm, (x, t, y) = models
    kv_mask = np.arange(L)[None] < np.array([[5], [8]])
    x_mask = np.array([[True, True, False], [True, False, False]])
    fps = np.array([24.0, 24.0], np.float32)
    kw = dict(height=256.0, width=256.0)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                    kv_mask=jnp.asarray(kv_mask),
                    x_mask=jnp.asarray(x_mask) if with_x_mask else None,
                    fps=jnp.asarray(fps), **kw)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
                 kv_mask=torch.from_numpy(kv_mask),
                 x_mask=torch.from_numpy(x_mask) if with_x_mask else None,
                 fps=torch.from_numpy(fps), **kw)
    assert got.shape == (B, 8, T, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_state_dict_round_trip(models):
    _, params, pm, _ = models
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    back = convert_stdit3(sd, depth=SIZES["depth"])
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))

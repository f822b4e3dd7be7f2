"""Shared modules of the PyTorch port against the JAX package's modules, the
same numpy inputs and the same parameters (carried over by
`utils.from_jax.convert`), in fp32 at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.models.modules import blocks as jb
from videosys_tpu.models.modules import embeddings as je
from videosys_tpu.models.modules import normalization as jn
from videosys_tpu_torch.models.modules import blocks as tb
from videosys_tpu_torch.models.modules import embeddings as te
from videosys_tpu_torch.models.modules import normalization as tn
from videosys_tpu_torch.utils.from_jax import STDIT3_RENAMES, convert

TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init(module, *args, seed=0, **kw):
    return module.init(jax.random.key(seed), *args, **kw)


def _load(module, params):
    sd = convert(params["params"], STDIT3_RENAMES)
    module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return module


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("num_heads", [0, 3])
def test_rms_norm(num_heads):
    x = _rand((2, 5, 24), 0)
    dim = 24 // num_heads if num_heads else 24
    jm = jn.RMSNorm(dim, num_heads=num_heads)
    params = _init(jm, jnp.asarray(x))
    params = jax.tree.map(lambda a: a * 0 + _rand(a.shape, 1), params)
    want = jm.apply(params, jnp.asarray(x))
    got = _load(tn.RMSNorm(dim, num_heads=num_heads), params)(torch.from_numpy(x))
    _close(got, want)


def test_layer_norm_and_modulate():
    x, shift, scale = _rand((2, 3, 4, 16), 0), _rand((2, 1, 1, 16), 1), _rand((2, 1, 1, 16), 2)
    want = jn.t2i_modulate(jn.layer_norm(jnp.asarray(x)), jnp.asarray(shift),
                           jnp.asarray(scale))
    got = tn.t2i_modulate(tn.layer_norm(torch.from_numpy(x)),
                          torch.from_numpy(shift), torch.from_numpy(scale))
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 6, 5, 16), (1, 3, 4, 5, 8)])
def test_group_norm(shape):
    x = _rand(shape, 0) * 3 + 1  # channel-last, as the JAX module takes it
    jm = jn.GroupNormMXU(num_groups=4, epsilon=1e-5)
    params = {"params": {"scale": _rand(shape[-1:], 1),
                         "bias": _rand(shape[-1:], 2)}}
    want = jm.apply(params, jnp.asarray(x))
    tm = _load(tn.GroupNorm(4, shape[-1], eps=1e-5), params)
    got = tm(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    _close(got.movedim(1, -1), want)


def test_rope_tables_and_apply():
    pos = np.arange(7, dtype=np.float32)
    freqs = te.rope_freqs(8)
    np.testing.assert_array_equal(freqs, je.rope_freqs(8))
    cos, sin = te.rope_channel_tables(pos, freqs, 3)
    jcos, jsin = je.rope_channel_tables(pos, je.rope_freqs(8), 3)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    x = _rand((2, 7, 24), 0)
    want = je.apply_rope_channel(jnp.asarray(x), jcos, jsin)
    got = te.apply_rope_channel(torch.from_numpy(x), cos, sin)
    _close(got, want, tol=0)


def test_embedders():
    t = np.array([999.0, 3.5], np.float32)
    # the two libraries' fp32 exp differ by an ulp in the frequencies; at
    # t ~ 1000 that moves cos/sin by up to ~1e-4
    _close(te.timestep_embedding(torch.from_numpy(t), 256),
           je.timestep_embedding(jnp.asarray(t), 256), tol=1e-4)
    np.testing.assert_array_equal(te.pos_embed_2d(32, 3, 5, scale=1.5, base_size=4),
                                  je.pos_embed_2d(32, 3, 5, scale=1.5, base_size=4))
    jm = je.SizeEmbedder(16)
    params = _init(jm, jnp.asarray(t), 2)
    want = jm.apply(params, jnp.asarray(t), 2)
    _close(_load(te.SizeEmbedder(16), params)(torch.from_numpy(t), 2), want)

    x = _rand((1, 3, 5, 6, 4), 1)  # [B, T, H, W, C] for the JAX module
    jm = je.PatchEmbed3D((1, 2, 2), embed_dim=8)
    params = _init(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = _load(te.PatchEmbed3D((1, 2, 2), 4, 8), params)
    _close(tm(torch.from_numpy(np.moveaxis(x, -1, 1).copy())), want)


def test_self_attention_with_rope():
    B, N, C, H = 3, 6, 24, 2
    x = _rand((B, N, C), 0)
    rope = je.rope_channel_tables(np.arange(N, dtype=np.float32),
                                  je.rope_freqs(C // H), H)
    jm = jb.SelfAttention(dim=C, num_heads=H, rope_channel=rope)
    params = _init(jm, jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1 * _rand(a.shape, 7), params)
    want = jm.apply(params, jnp.asarray(x))
    tm = _load(tb.SelfAttention(C, H), params)
    _close(tm(torch.from_numpy(x), rope_channel=rope), want)
    # one token: the identity over v
    want1 = jm.apply(params, jnp.asarray(x[:, :1]))
    _close(tm(torch.from_numpy(x[:, :1].copy())), want1)


def test_cross_attention_frame_repeat_and_mask():
    B, frames, N, L, C, H = 2, 3, 5, 7, 16, 2
    x = _rand((B * frames, N, C), 0)
    cond = _rand((B, L, C), 1)
    mask = np.arange(L)[None] < np.array([[3], [7]])
    jm = jb.MultiHeadCrossAttention(dim=C, num_heads=H)
    params = _init(jm, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    params = jax.tree.map(lambda a: a + 0.1 * _rand(a.shape, 8), params)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    tm = _load(tb.MultiHeadCrossAttention(C, H), params)
    got = tm(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(mask))
    _close(got, want)

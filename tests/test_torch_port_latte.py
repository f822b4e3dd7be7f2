"""The PyTorch port's Latte against the JAX package on the CPU (fp32, tiny
sizes, 2e-4): the LatteT2V forward (dense, with Open-Sora-Plan v1.1's
RoPE, with the "geglu" feed-forward), params carried by `latte_from_jax`
and back by the JAX package's `convert_latte` (the reference key names);
PAB step by step against JAX's cached forward, with spatial, temporal,
cross and MLP slots, read steps running none of what they read; the whole
`VideoSysEngine.generate` dense and with PAB, fed JAX's latents (video
within one uint8 level); and loading a diffusers-layout snapshot written
here, its missing and unexpected keys named."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videosys_tpu.pipelines.latte.pipeline_latte as JP
import videosys_tpu.utils.jit as jjit
import videosys_tpu_torch
from videosys_tpu.core.pab import PABStepPlan as JPlan
from videosys_tpu.core.pab import build_plans as j_build_plans
from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JVAE
from videosys_tpu.models.transformers import latte as J
from videosys_tpu.utils.convert import convert_latte, convert_vae2d
from videosys_tpu_torch.core.pab import PABStepPlan, build_plans
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
from videosys_tpu_torch.models.transformers import latte as P
from videosys_tpu_torch.utils.from_jax import latte_from_jax, vae2d_from_jax
from videosys_tpu_torch.utils.safetensors_io import save_file

TOL = 2e-4
# tests/test_latte.py's tiny configuration
SIZES = dict(num_layers=2, num_heads=2, head_dim=16, caption_channels=16,
             video_length=4, sample_size=8)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, num_groups=4)
VARIANTS = {"dense": dict(), "rope": dict(use_rope=True),
            "geglu": dict(activation_fn="geglu")}


def perturbed(params, seed: int = 0):
    """Flax params as numpy, each leaf moved by noise so that no scale or
    table is the identity."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32), params)


def inputs(seed: int = 0, B: int = 2, T: int = 4, H: int = 16, W: int = 16,
           L: int = 6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 4, T, H, W)).astype(np.float32)
    t = np.array([500.0, 720.0][:B], np.float32)
    y = rng.standard_normal((B, L, 16)).astype(np.float32)
    mask = np.array([[True] * 4 + [False] * 2, [True] * 6][:B])
    return x, t, y, mask


def state(module) -> dict:
    return {k: v.numpy() for k, v in module.state_dict().items()}


def carried(sd: dict, params, from_jax) -> dict:
    """from_jax carries `params` (made from `sd`) back to `sd` unchanged."""
    back = from_jax(params)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])
    return {k: torch.from_numpy(v) for k, v in back.items()}


def models(variant: str):
    """The port's seeded weights, perturbed, and the same weights as JAX
    params by the JAX package's converter (JAX compiles no init)."""
    kw = dict(SIZES, **VARIANTS[variant])
    torch.manual_seed(0)
    pm = P.LatteT2V(P.LatteConfig(**kw))
    sd = perturbed(state(pm))
    params = convert_latte(sd, depth=SIZES["num_layers"])
    pm.load_state_dict(carried(sd, params, latte_from_jax))
    return kw, params, pm.eval()


def run_port(pm, x, t, y, mask, **kw):
    with torch.no_grad():
        return pm(torch.from_numpy(x), torch.from_numpy(t),
                  torch.from_numpy(y), kv_mask=torch.from_numpy(mask), **kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_parity_and_key_names(variant):
    kw, params, pm = models(variant)
    x, t, y, mask = inputs(1)
    jm = J.LatteT2V(J.LatteConfig(**kw))
    want = np.asarray(jm.apply(params, x, t, y, kv_mask=mask))
    got = run_port(pm, x, t, y, mask).numpy()
    assert got.shape == want.shape == (2, 8, 4, 16, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the port's state_dict carries the reference's names: the JAX
    # package's converter reads it into params that give the same output
    back = convert_latte(pm.state_dict(), depth=SIZES["num_layers"])
    np.testing.assert_allclose(
        got, np.asarray(jm.apply(back, x, t, y, kv_mask=mask)), atol=TOL,
        rtol=TOL)


@pytest.mark.parametrize("variant", ["dense", "rope"])
def test_position_tables_made_once_per_shape(variant, monkeypatch):
    """The sincos tables (and v1.1's RoPE tables) are made once per shape
    and device and kept as tensors: a second forward makes none and gives
    the same output."""
    _, _, pm = models(variant)
    x, t, y, mask = inputs(1)
    made = []
    for name in ("pos_embed_2d", "pos_embed_1d", "rope_axis_tables"):
        fn = getattr(P, name)
        monkeypatch.setattr(P, name, lambda *a, fn=fn, **k: made.append(1)
                            or fn(*a, **k))
    first = run_port(pm, x, t, y, mask)
    n = len(made)
    assert n > 0 and torch.equal(first, run_port(pm, x, t, y, mask))
    assert len(made) == n
    (pos, temp, ropes), = pm._tables.values()
    assert torch.is_tensor(pos) and torch.is_tensor(temp)
    assert (ropes is None) == (variant == "dense")
    if ropes is not None:
        assert all(torch.is_tensor(a) for ab in ropes for a in ab)


def test_latte_from_jax_round_trip():
    """latte_from_jax inverts convert_latte exactly, every key and value."""
    _, _, pm = models("dense")
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    back = latte_from_jax(convert_latte(sd, depth=SIZES["num_layers"]))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def pab_config():
    """Every slot kind on a 10-step DDIM ladder (900, 800, ..., 0): the
    attention branches in (100, 800) and MLP rows kept after 800 and 700."""
    return JP.LattePABConfig(
        mlp_spatial_broadcast_config={800: {"block": [0, 1], "skip_count": 2}},
        mlp_temporal_broadcast_config={700: {"block": [1], "skip_count": 1}})


def test_pab_steps_like_jax():
    pab = pab_config()
    kw, params, pm = models("dense")
    ladder = np.arange(900, -1, -100).astype(np.float32)
    plans = build_plans(pab, ladder, SIZES["num_layers"])
    jplans = j_build_plans(pab, ladder, SIZES["num_layers"], None)
    assert [p.__dict__ for p in plans] == [p.__dict__ for p in jplans]
    # the ladder reads every slot kind on some step
    assert any(p.spatial for p in plans) and any(p.temporal for p in plans)
    assert any(p.cross for p in plans) and any(any(p.mlp_spatial_use)
                                               for p in plans)
    jcache = J.LatteT2V(J.LatteConfig(**kw), pab_config=pab).init_cache(
        2, 4, 64)
    cache = pm.init_cache(pab, 2, 4, 64)
    assert cache.slots["spatial"]["mlp"].shape[0] == 2  # rows of blocks 0, 1
    calls = []
    for block in list(pm.transformer_blocks) + list(
            pm.temporal_transformer_blocks):
        for name in ("attn1", "attn2", "ff"):
            if hasattr(block, name):
                getattr(block, name).register_forward_hook(
                    lambda m, a, o, n=name, b=block: calls.append((b, n)))
    for i, (plan, jplan) in enumerate(zip(plans[:6], jplans[:6])):
        x, _, y, mask = inputs(10 + i)
        t = np.full((2,), ladder[i], np.float32)
        jm = J.LatteT2V(J.LatteConfig(**kw), plan=jplan, pab_config=pab)
        want, jcache = jm.apply(params, x, t, y, kv_mask=mask,
                                pab_cache=jcache)
        calls.clear()
        got = run_port(pm, x, t, y, mask, plan=plan, pab_cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=f"step {i}")
        # a read branch runs no norm, GEMM or attention
        for d, (s_blk, t_blk) in enumerate(zip(
                pm.transformer_blocks, pm.temporal_transformer_blocks)):
            ran = {(b, n) for b, n in calls}
            assert ((s_blk, "attn1") in ran) == (not plan.spatial)
            assert ((s_blk, "attn2") in ran) == (not plan.cross)
            assert ((t_blk, "attn1") in ran) == (not plan.temporal)
            assert ((s_blk, "ff") in ran) == (
                not (plan.mlp_spatial_use and plan.mlp_spatial_use[d]))
            assert ((t_blk, "ff") in ran) == (
                not (plan.mlp_temporal_use and plan.mlp_temporal_use[d]))


def jax_latents(seed: int, shape):
    """JAX generate's initial latent draw."""
    _, zkey = jax.random.split(jax.random.key(seed))
    return np.array(jax.random.normal(zkey, shape, jnp.float32))


@pytest.mark.parametrize("pab", [False, True])
def test_generate_like_jax(pab, monkeypatch):
    """The whole tiny generate on the same params and latents: the final
    latents at 2e-4 of their largest magnitude (the perturbed weights drive
    them to ~60), the uint8 video within one level."""
    req = dict(num_inference_steps=5 if pab else 3, video_length=4,
               height=16, width=16, seed=3)
    engine = videosys_tpu_torch.VideoSysEngine(
        videosys_tpu_torch.LatteConfig(
            model_path=None, dtype="fp32", enable_pab=pab,
            pab_config=pab_config(), transformer_config=P.LatteConfig(**SIZES),
            vae_config=VAE),
        device="cpu")
    pipe = engine.pipeline
    pipe.keep_latents = True
    # the port's seeded weights, perturbed, given to JAX by the JAX
    # package's converters (JAX compiles no init)
    sd = {"transformer": perturbed(state(pipe.transformer)),
          "vae": perturbed(state(pipe.vae), 1)}
    params = {"transformer": convert_latte(sd["transformer"],
                                           depth=SIZES["num_layers"]),
              "vae": convert_vae2d(sd["vae"], len(VAE["block_out_channels"]))}
    pipe.transformer.load_state_dict(carried(
        sd["transformer"], params["transformer"], latte_from_jax))
    pipe.vae.load_state_dict(carried(sd["vae"], params["vae"],
                                     vae2d_from_jax))
    jcfg = JP.LatteConfig(model_path=None, dtype="fp32", enable_pab=pab,
                          pab_config=pab_config(),
                          transformer_config=J.LatteConfig(**SIZES))
    jpipe = JP.LattePipeline(jcfg, vae=JVAE(**VAE), params=params)
    seen = []
    # run the JAX VAE decode eagerly to see the latents it is given
    monkeypatch.setattr(jjit, "jit_method", lambda obj, name, static_argnums=():
                        lambda p, f: seen.append(np.asarray(f)) or getattr(obj, name)(p, f))
    want = jpipe.generate("a cat playing piano", **req).video
    z = jax_latents(3, pipe.latent_shape(4, 16, 16))
    got = engine.generate("a cat playing piano", latents=torch.from_numpy(z),
                          **req).video
    frames = np.swapaxes(pipe.last_latents, 1, 2).reshape(4, 4, 8, 8)
    want_z = np.moveaxis(seen[0], -1, 1)
    np.testing.assert_allclose(frames, want_z, rtol=0,
                               atol=TOL * np.abs(want_z).max())
    assert got.shape == want.shape == (1, 4, 16, 16, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert pipe.last_text_kv_len == 64  # the 120-token stub, bucketed


def test_snapshot_loads_and_names_bad_keys(tmp_path):
    """A diffusers-layout snapshot (transformer/, vae/) written here loads
    into the pipeline bit for bit; a missing and an unexpected key are
    named."""
    src = videosys_tpu_torch.LattePipeline(
        videosys_tpu_torch.LatteConfig(
            model_path=None, dtype="fp32",
            transformer_config=P.LatteConfig(**SIZES), vae_config=VAE),
        device="cpu", seed=1)
    snap = tmp_path / "Latte-1"
    for name in ("transformer", "vae"):
        os.makedirs(snap / name)
        save_file(dict(getattr(src, name).state_dict()),
                  str(snap / name / "diffusion_pytorch_model.safetensors"),
                  {"format": "pt"})
    cfg = videosys_tpu_torch.LatteConfig(
        model_path=str(snap), dtype="fp32",
        transformer_config=P.LatteConfig(**SIZES), vae_config=VAE)
    stub = StubTextEncoder(16, 120, device="cpu")
    pipe = videosys_tpu_torch.LattePipeline(cfg, text_encoder=stub,
                                            device="cpu")
    for name in ("transformer", "vae"):
        want = getattr(src, name).state_dict()
        got = getattr(pipe, name).state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    sd = dict(src.transformer.state_dict())
    sd["transformer_blocks.0.attn1.to_q.extra"] = sd.pop(
        "transformer_blocks.0.attn1.to_q.bias")
    save_file(sd, str(snap / "transformer" /
                      "diffusion_pytorch_model.safetensors"), {"format": "pt"})
    with pytest.raises(RuntimeError, match=r"to_q\.bias") as err:
        videosys_tpu_torch.LattePipeline(cfg, text_encoder=stub, device="cpu")
    assert "to_q.extra" in str(err.value)

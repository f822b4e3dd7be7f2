"""The PyTorch port's Open-Sora-Plan against the JAX package on the CPU
(fp32, tiny sizes, 2e-4): the v1.2 transformer with 3D RoPE and with its
sincos tables, params carried by `osp_v120_from_jax` and back by the JAX
package's `convert_osp_v120`; v1.2 PAB (a write step, then a read step
that runs no attention); the v1.1 config; the PNDM and Euler-Ancestral
step sequences (the latter fed JAX's draws through `draw`); both
pipelines' `generate` fed JAX's latents and draws (video within one uint8
level); and loading the snapshot layout (`29x480p/`, `65x512x512/`,
`vae/`) from files written here, bad keys named."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videosys_tpu.pipelines.open_sora_plan.pipeline_open_sora_plan as JP
import videosys_tpu_torch
from videosys_tpu.core.pab import PABStepPlan as JPlan
from videosys_tpu.models.autoencoders.autoencoder_causal_vae import CausalVAE as JVAE
from videosys_tpu.models.autoencoders.autoencoder_causal_vae import (
    CausalVAEConfig as JVAECfg,
)
from videosys_tpu.models.transformers import open_sora_plan_v110 as J110
from videosys_tpu.models.transformers import open_sora_plan_v120 as J
from videosys_tpu.schedulers import euler_ancestral as jea
from videosys_tpu.schedulers import pndm as jpndm
from videosys_tpu.utils.convert import (
    convert_causal_vae,
    convert_latte,
    convert_osp_v120,
)
from videosys_tpu_torch.core.pab import PABStepPlan
from videosys_tpu_torch.models.autoencoders.autoencoder_causal_vae import (
    CausalVAEConfig as PVAECfg,
)
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
from videosys_tpu_torch.models.transformers import open_sora_plan_v110 as P110
from videosys_tpu_torch.models.transformers import open_sora_plan_v120 as P
from videosys_tpu_torch.models.transformers.latte import LatteConfig as PLatteCfg
from videosys_tpu_torch.schedulers import euler_ancestral as pea
from videosys_tpu_torch.schedulers import pndm as ppndm
from videosys_tpu_torch.utils.from_jax import (
    causal_vae_from_jax,
    latte_from_jax,
    osp_v120_from_jax,
)
from videosys_tpu_torch.utils.safetensors_io import save_file

TOL = 2e-4
# tests/test_open_sora_plan.py's tiny configurations
V120 = dict(num_layers=2, num_heads=2, head_dim=24, caption_channels=32,
            sample_size=(8, 8), sample_size_t=3)
V110 = dict(num_layers=2, num_heads=2, head_dim=24, caption_channels=32,
            sample_size=16, video_length=3)
VAE = dict(hidden_size=8, hidden_size_mult=(1, 2), num_res_blocks=1,
           encoder_resnet_blocks=("ResnetBlock3D",) * 2,
           encoder_spatial_downsample=("SpatialDownsample2x", ""),
           encoder_temporal_downsample=("TimeDownsample2x", ""),
           decoder_resnet_blocks=("ResnetBlock3D",) * 2,
           decoder_spatial_upsample=("", "SpatialUpsample2x"),
           decoder_temporal_upsample=("", "TimeUpsample2x"))


def perturbed(params, seed: int = 0, scale: float = 0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(
        np.shape(a)).astype(np.float32), params)


def inputs(seed: int = 0, B: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 4, 3, 16, 16)).astype(np.float32)
    enc = rng.standard_normal((B, 8, 32)).astype(np.float32)
    t = np.array([500.5, 720.25][:B], np.float32)
    mask = np.array([[True] * 5 + [False] * 3, [True] * 8][:B])
    return x, enc, t, mask


def state(module) -> dict:
    return {k: v.numpy() for k, v in module.state_dict().items()}


def carried(sd: dict, params, from_jax) -> dict:
    """from_jax carries `params` (made from `sd`) back to `sd` unchanged."""
    back = from_jax(params)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])
    return {k: torch.from_numpy(v) for k, v in back.items()}


def v120_models(use_rope: bool):
    """The port's seeded weights, perturbed, and the same weights as JAX
    params by the JAX package's converter (JAX compiles no init)."""
    torch.manual_seed(0)
    pm = P.OpenSoraPlanV120Transformer(P.OpenSoraPlanV120Config(
        **V120, use_rope=use_rope))
    sd = perturbed(state(pm))
    params = convert_osp_v120(sd, depth=V120["num_layers"])
    pm.load_state_dict(carried(sd, params, osp_v120_from_jax))
    return params, pm.eval()


def run_port(pm, x, enc, t, mask, **kw):
    with torch.no_grad():
        return pm(torch.from_numpy(x), torch.from_numpy(enc),
                  torch.from_numpy(t), kv_mask=torch.from_numpy(mask), **kw)


@pytest.mark.parametrize("use_rope", [True, False])
def test_v120_forward_parity_and_key_names(use_rope):
    params, pm = v120_models(use_rope)
    jm = J.OpenSoraPlanV120Transformer(J.OpenSoraPlanV120Config(
        **V120, use_rope=use_rope))
    x, enc, t, mask = inputs(1)
    want = np.asarray(jm.apply(params, x, enc, t, kv_mask=mask))
    got = run_port(pm, x, enc, t, mask).numpy()
    assert got.shape == want.shape == (2, 4, 3, 16, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    back = convert_osp_v120(pm.state_dict(), depth=V120["num_layers"])
    np.testing.assert_allclose(
        got, np.asarray(jm.apply(back, x, enc, t, kv_mask=mask)), atol=TOL,
        rtol=TOL)
    rt = osp_v120_from_jax(back)
    assert set(rt) == set(pm.state_dict())


@pytest.mark.parametrize("use_rope", [True, False])
def test_v120_position_tables_made_once_per_shape(use_rope, monkeypatch):
    """The 3D RoPE (or sincos) tables are made once per shape and device
    and kept as tensors: a second forward makes none and gives the same
    output; another frame count makes its own."""
    _, pm = v120_models(use_rope)
    x, enc, t, mask = inputs(1)
    made = []
    for name in ("rope_3d_tables", "pos_embed_1d"):
        fn = getattr(P, name)
        monkeypatch.setattr(P, name, lambda *a, fn=fn, **k: made.append(1)
                            or fn(*a, **k))
    first = run_port(pm, x, enc, t, mask)
    n = len(made)
    assert n > 0 and torch.equal(first, run_port(pm, x, enc, t, mask))
    assert len(made) == n
    (table,) = pm._tables.values()
    assert all(torch.is_tensor(a) for a in table)
    run_port(pm, x[:, :, :2], enc, t, mask)
    assert len(made) > n and len(pm._tables) == 2


def test_v120_pab_write_then_read_like_jax():
    pab = JP.OpenSoraPlanV120PABConfig()
    params, pm = v120_models(True)
    cfg = J.OpenSoraPlanV120Config(**V120)
    x, enc, t, mask = inputs(2)
    N = 3 * 8 * 8
    jm = J.OpenSoraPlanV120Transformer(cfg, pab_config=pab)
    want1, jcache = jm.apply(params, x, enc, t, kv_mask=mask,
                             pab_cache=jm.init_cache(2, N))
    cache = pm.init_cache(pab, 2, N)
    got1 = run_port(pm, x, enc, t, mask, plan=PABStepPlan(
        save_spatial=True, save_cross=True), pab_cache=cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=TOL,
                               rtol=TOL)
    for slot, jslot in (("attn", "spatial"), ("cross", "cross")):
        np.testing.assert_allclose(cache.slots["spatial"][slot].numpy(),
                                   np.asarray(jcache[jslot]), atol=TOL,
                                   rtol=TOL)
    x2, enc2, t2, mask2 = inputs(3)
    jread = J.OpenSoraPlanV120Transformer(
        cfg, plan=JPlan(spatial=True, cross=True), pab_config=pab)
    want2, _ = jread.apply(params, x2, enc2, t2, kv_mask=mask2,
                           pab_cache=jcache)
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1))
             for b in pm.transformer_blocks for m in (b.attn1, b.attn2)]
    got2 = run_port(pm, x2, enc2, t2, mask2, plan=PABStepPlan(
        spatial=True, cross=True), pab_cache=cache)
    for h in hooks:
        h.remove()
    assert not calls
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("ttype", ["65x512x512", "221x512x512"])
def test_v110_config_like_jax(ttype):
    want = dataclasses.asdict(J110.OpenSoraPlanV110Config(ttype, use_rope=True))
    got = dataclasses.asdict(P110.OpenSoraPlanV110Config(ttype, use_rope=True))
    want.pop("dtype"), got.pop("dtype")
    assert got == want
    assert got["video_length"] == {"65x512x512": 17, "221x512x512": 56}[ttype]
    assert P110.OpenSoraPlanV110Transformer is videosys_tpu_torch.pipelines \
        .open_sora_plan.pipeline_open_sora_plan.OpenSoraPlanV110Transformer


@pytest.mark.parametrize("skip_prk", [False, True])
def test_pndm_steps_like_jax(skip_prk):
    """The ladder, the PRK warm-up and the PLMS steps with their history,
    on the same model outputs; a second set_timesteps starts afresh."""
    js = jpndm.PNDMScheduler(jpndm.PNDMConfig(skip_prk_steps=skip_prk))
    ps = ppndm.PNDMScheduler(ppndm.PNDMConfig(skip_prk_steps=skip_prk))
    rng = np.random.default_rng(0)
    for _ in range(2):  # the state is reset by set_timesteps
        ts = ps.set_timesteps(6)
        np.testing.assert_array_equal(ts, js.set_timesteps(6))
        zj = zp = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
        zj, zp = jnp.asarray(zj), torch.from_numpy(zp)
        for t in ts:
            out = rng.standard_normal(zp.shape).astype(np.float32)
            zj = js.step(jnp.asarray(out), int(t), zj)
            zp = ps.step(torch.from_numpy(out), int(t), zp)
            np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-5,
                                       rtol=1e-5)
        assert ps.counter == len(ts)


def test_euler_ancestral_steps_like_jax():
    """Sigmas, init_noise_sigma, scale_model_input and the steps with JAX's
    noise fed through `draw` (asked for on every step but the last, whose
    sigma_up is 0)."""
    js, ps = jea.EulerAncestralScheduler(), pea.EulerAncestralScheduler()
    ts = ps.set_timesteps(5)
    np.testing.assert_array_equal(ts, js.set_timesteps(5))
    np.testing.assert_array_equal(ps.sigmas, js.sigmas)
    assert ps.init_noise_sigma == js.init_noise_sigma
    rng = np.random.default_rng(1)
    shape = (1, 4, 3, 4, 4)
    z = rng.standard_normal(shape).astype(np.float32) * ps.init_noise_sigma
    zj, zp = jnp.asarray(z), torch.from_numpy(z)
    key = jax.random.key(4)
    for i in range(len(ts)):
        np.testing.assert_allclose(ps.scale_model_input(zp, i).numpy(),
                                   np.asarray(js.scale_model_input(zj, i)),
                                   rtol=1e-6)
        out = rng.standard_normal(shape).astype(np.float32)
        key, sub = jax.random.split(key)
        noise = np.array(jax.random.normal(sub, shape, jnp.float32))
        asked = []
        zp = ps.step(torch.from_numpy(out), i, zp, lambda name, s: (
            asked.append(name), torch.from_numpy(noise))[1])
        zj = js.step(jnp.asarray(out), i, zj, key=sub)
        assert asked == (["ancestral"] if i < len(ts) - 1 else [])
        np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-5,
                                   rtol=1e-5)


class JaxDraws:
    """JAX generate's draws: the initial latent, then (v1.2) one ancestral
    noise per step, from its split sequence."""

    def __init__(self, seed: int, shape, steps: int):
        rng = jax.random.key(seed)
        rng, zkey = jax.random.split(rng)
        self.z = np.array(jax.random.normal(zkey, shape, jnp.float32))
        self.noise = {}
        for i in range(steps):
            rng, nkey = jax.random.split(rng)
            self.noise[f"euler/{i}/ancestral"] = np.array(
                jax.random.normal(nkey, shape, jnp.float32))

    def __call__(self, name, shape):
        return torch.from_numpy(self.noise[name])


@pytest.mark.parametrize("version,ttype,pab,steps", [
    ("v110", "65x512x512", False, 4), ("v120", "29x480p", True, 6)])
def test_generate_like_jax(version, ttype, pab, steps):
    """The tiny generate on the same params, latents and draws: the final
    latents at 2e-4 of their largest magnitude, the video (cropped to the
    type's frames) within one uint8 level."""
    jt = (J110.OpenSoraPlanV110Config(**V110) if version == "v110"
          else J.OpenSoraPlanV120Config(**V120))
    jvae_cfg = (JVAECfg(**VAE) if version == "v110"
                else JVAECfg(**VAE, encoder_attention="AttnBlock3DFix",
                             decoder_attention="AttnBlock3DFix"))
    pt = (P110.OpenSoraPlanV110Config(**V110) if version == "v110"
          else P.OpenSoraPlanV120Config(**V120))
    pvae_cfg = PVAECfg(**{f.name: getattr(jvae_cfg, f.name)
                          for f in dataclasses.fields(PVAECfg)})
    engine = videosys_tpu_torch.VideoSysEngine(
        videosys_tpu_torch.OpenSoraPlanConfig(
            version=version, transformer_type=ttype, dtype="fp32",
            enable_tiling=False, enable_pab=pab, transformer_config=pt,
            vae_config=pvae_cfg),
        device="cpu")
    pipe = engine.pipeline
    pipe.keep_latents = True
    # the port's seeded weights, perturbed, given to JAX by the JAX
    # package's converters (JAX compiles no init)
    convert, from_jax = ((convert_latte, latte_from_jax) if version == "v110"
                         else (convert_osp_v120, osp_v120_from_jax))
    sd = {"transformer": perturbed(state(pipe.transformer), scale=0.05),
          "vae": perturbed(state(pipe.vae), 1, scale=0.05)}
    params = {"transformer": convert(sd["transformer"], depth=2),
              "vae": convert_causal_vae(sd["vae"], jvae_cfg)}
    pipe.transformer.load_state_dict(carried(
        sd["transformer"], params["transformer"], from_jax))
    pipe.vae.load_state_dict(carried(
        sd["vae"], params["vae"],
        lambda p: causal_vae_from_jax(p, pvae_cfg)))
    jcfg = JP.OpenSoraPlanConfig(
        version=version, transformer_type=ttype, dtype="fp32",
        enable_tiling=False, enable_pab=pab, transformer_config=jt,
        vae=JVAE(jvae_cfg, version=version))
    jpipe = JP.OpenSoraPlanPipeline(jcfg, params=params)
    seen = []
    decode = jpipe.vae.decode
    jpipe.vae.decode = lambda p, z: seen.append(np.asarray(z)) or decode(p, z)
    want = jpipe.generate("sunset over the sea", num_inference_steps=steps,
                          seed=2).video
    draws = JaxDraws(2, pipe.latent_shape(), len(
        pipe.scheduler.set_timesteps(steps)))
    got = engine.generate("sunset over the sea", num_inference_steps=steps,
                          seed=2, latents=torch.from_numpy(draws.z),
                          draw=draws).video
    np.testing.assert_allclose(pipe.last_latents, seen[0], rtol=0,
                               atol=TOL * np.abs(seen[0]).max())
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.shape[1] == min(int(ttype.split("x")[0]), 5)
    assert pipe.last_text_kv_len == 64


@pytest.mark.parametrize("version,ttype", [("v120", "29x480p"),
                                           ("v110", "65x512x512")])
def test_snapshot_loads_and_names_bad_keys(tmp_path, version, ttype):
    """An Open-Sora-Plan snapshot (`{transformer_type}/`, `vae/`) written
    here loads bit for bit; a dropped key and an extra one are named."""
    tcfg = (PLatteCfg(**V110) if version == "v110"
            else P.OpenSoraPlanV120Config(**V120))
    kw = dict(version=version, transformer_type=ttype, dtype="fp32",
              transformer_config=tcfg, vae_config=PVAECfg(**VAE))
    src = videosys_tpu_torch.OpenSoraPlanPipeline(
        videosys_tpu_torch.OpenSoraPlanConfig(**kw), device="cpu", seed=1)
    snap = tmp_path / "Open-Sora-Plan"
    for name, folder in (("transformer", ttype), ("vae", "vae")):
        os.makedirs(snap / folder)
        save_file(dict(getattr(src, name).state_dict()),
                  str(snap / folder / "diffusion_pytorch_model.safetensors"),
                  {"format": "pt"})
    cfg = videosys_tpu_torch.OpenSoraPlanConfig(**kw, transformer=str(snap))
    stub = StubTextEncoder(32, 512, device="cpu")
    pipe = videosys_tpu_torch.OpenSoraPlanPipeline(cfg, text_encoder=stub,
                                                   device="cpu")
    for name in ("transformer", "vae"):
        want, got = (getattr(m, name).state_dict() for m in (src, pipe))
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    sd = dict(src.vae.state_dict())
    sd["decoder.conv_in.conv.extra"] = sd.pop("decoder.conv_in.conv.bias")
    save_file(sd, str(snap / "vae" / "diffusion_pytorch_model.safetensors"),
              {"format": "pt"})
    with pytest.raises(RuntimeError, match=r"conv_in\.conv\.bias") as err:
        videosys_tpu_torch.OpenSoraPlanPipeline(cfg, text_encoder=stub,
                                                device="cpu")
    assert "conv_in.conv.extra" in str(err.value)

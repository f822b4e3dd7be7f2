"""The PyTorch port's CogVideoX transformer, schedulers and pipeline against
the JAX package on the CPU (fp32, tiny sizes): the transformer in its 2b
(3D sincos) and 5b (3D RoPE) variants, params carried by
`cogvideox_from_jax` and back by the JAX package's `convert_cogvideox` (the
reference key names); a PAB write step and a read step against the JAX
cache; the DDIM ladder and step exactly, the DPM step on both branches with
injected noise; and the whole `VideoSysEngine.generate` with DDIM and DPM,
dense and with PAB, fed JAX's latents and draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videosys_tpu.pipelines.cogvideox.pipeline_cogvideox as JP
import videosys_tpu_torch
from videosys_tpu.core.pab import PABStepPlan as JPlan
from videosys_tpu_torch.core import pipeline as core_pipeline
from videosys_tpu.models.autoencoders.autoencoder_cogvideox import (
    CogVideoXVAEConfig as JVAECfg,
)
from videosys_tpu.models.transformers import cogvideox as J
from videosys_tpu.schedulers import ddim as jd
from videosys_tpu.schedulers import dpm_cogvideox as jdpm
from videosys_tpu.utils.convert import convert_cogvideox, convert_cogvideox_vae
from videosys_tpu_torch.core.pab import PABStepPlan
from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import (
    CogVideoXVAEConfig as PVAECfg,
)
from videosys_tpu_torch.models.transformers import cogvideox as P
from videosys_tpu_torch.schedulers import ddim as pd
from videosys_tpu_torch.schedulers import dpm_cogvideox as pdpm
from videosys_tpu_torch.utils.from_jax import cogvideox_from_jax, cogvideox_vae_from_jax

TOL = 2e-4
# examples/inference/cogvideox/sample.py:_config(tiny=True), two layers
SIZES = dict(num_layers=2, num_heads=2, head_dim=16, in_channels=4,
             out_channels=4, time_embed_dim=16, text_embed_dim=16,
             max_text_seq_length=8)
VAE = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
           layers_per_block=1, norm_num_groups=4)
VARIANTS = {"2b": False, "5b": True}


def perturbed(params, seed: int = 0):
    """Flax params as numpy, each leaf moved by noise so that the norms'
    scales and biases are not the identity."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32), params)


def inputs(seed: int = 0, B: int = 2, F: int = 3, H: int = 8, W: int = 8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, 4, H, W)).astype(np.float32)
    enc = rng.standard_normal((B, 8, 16)).astype(np.float32)
    t = np.array([500.0, 720.0][:B], np.float32)
    return x, enc, t


def state(module) -> dict:
    return {k: v.numpy() for k, v in module.state_dict().items()}


def carried(sd: dict, params, from_jax) -> dict:
    """from_jax carries `params` (made from `sd`) back to `sd` unchanged."""
    back = from_jax(params)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])
    return {k: torch.from_numpy(v) for k, v in back.items()}


def models(rope: bool, pab=None):
    """The port's seeded weights, perturbed, and the same weights as JAX
    params by the JAX package's converter (JAX compiles no init)."""
    jcfg = J.CogVideoXConfig(**SIZES, use_rotary_positional_embeddings=rope)
    jm = J.CogVideoXTransformer3D(jcfg, pab_config=pab)
    torch.manual_seed(0)
    pm = P.CogVideoXTransformer3D(
        P.CogVideoXConfig(**SIZES, use_rotary_positional_embeddings=rope))
    sd = perturbed(state(pm))
    params = convert_cogvideox(sd, depth=SIZES["num_layers"])
    pm.load_state_dict(carried(sd, params, cogvideox_from_jax))
    return jcfg, jm, params, pm


def run_port(pm, x, enc, t, **kw):
    with torch.no_grad():
        return pm(torch.from_numpy(x), torch.from_numpy(enc),
                  torch.from_numpy(t), **kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_transformer_parity_and_key_names(variant):
    _, jm, params, pm = models(VARIANTS[variant])
    x, enc, t = inputs(1)
    want = np.asarray(jm.apply(params, x, enc, t))
    got = run_port(pm, x, enc, t).numpy()
    assert got.shape == want.shape == (2, 3, 4, 8, 8)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the port's state_dict carries the reference's names: the JAX
    # package's converter reads it into params that give the same output
    back = convert_cogvideox({k: v for k, v in pm.state_dict().items()},
                             depth=SIZES["num_layers"])
    np.testing.assert_allclose(got, np.asarray(jm.apply(back, x, enc, t)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_pab_write_then_read_like_jax(variant):
    """A write step fills the cache as JAX's does (the joint slot holds the
    text rows then the video rows); a read step on other inputs reads it,
    runs no attention, and gives JAX's broadcast output."""
    pab = JP.CogVideoXPABConfig()
    jcfg, jm, params, pm = models(VARIANTS[variant], pab)
    x, enc, t = inputs(2)
    N, L = 3 * 4 * 4, 8
    jcache = jm.init_cache(B=2, N_video=N, L=L)
    want1, jcache = jm.apply(params, x, enc, t, pab_cache=jcache)
    cache = pm.init_cache(pab, 2, N, L)
    assert cache.slots["spatial"]["attn"].dtype == torch.float32
    got1 = run_port(pm, x, enc, t, plan=PABStepPlan(save_spatial=True),
                    pab_cache=cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=TOL,
                               rtol=TOL)
    slot = cache.slots["spatial"]["attn"].numpy()
    np.testing.assert_allclose(slot[:, :, L:], np.asarray(jcache["attn_x"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(slot[:, :, :L], np.asarray(jcache["attn_enc"]),
                               atol=TOL, rtol=TOL)

    x2, enc2, t2 = inputs(3)
    jread = J.CogVideoXTransformer3D(jcfg, plan=JPlan(spatial=True),
                                     pab_config=pab)
    want2, _ = jread.apply(params, x2, enc2, t2, pab_cache=jcache)
    calls = []
    hooks = [b.attn1.register_forward_hook(lambda *a: calls.append(1))
             for b in pm.transformer_blocks]
    got2 = run_port(pm, x2, enc2, t2, plan=PABStepPlan(spatial=True),
                    pab_cache=cache)
    for h in hooks:
        h.remove()
    assert not calls
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(cache.slots["spatial"]["attn"].numpy(), slot)


DDIM_KW = dict(prediction_type="v_prediction", snr_shift_scale=3.0,
               rescale_betas_zero_snr=True, timestep_spacing="trailing",
               beta_start=0.00085, beta_end=0.012,
               beta_schedule="scaled_linear", set_alpha_to_one=True)


@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
def test_ddim_ladder_and_step_exact(spacing):
    kw = dict(DDIM_KW, timestep_spacing=spacing)
    js, ps = jd.DDIMScheduler(jd.DDIMConfig(**kw)), pd.DDIMScheduler(
        pd.DDIMConfig(**kw))
    np.testing.assert_array_equal(ps.alphas_cumprod, js.alphas_cumprod)
    ts = ps.set_timesteps(50)
    np.testing.assert_array_equal(ts, js.set_timesteps(50))
    rng = np.random.default_rng(0)
    out, z = (rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)
              for _ in range(2))
    for t in (int(ts[0]), int(ts[25]), int(ts[-1])):  # the last: alpha 1
        got = ps.step(torch.from_numpy(out), t, torch.from_numpy(z)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            js.step(jnp.asarray(out), t, jnp.asarray(z))))


def test_dpm_step_both_branches():
    """The first step returns the first-order sample; later steps the
    second-order one, with the second noise; noises drawn in a fixed order
    through `draw`, JAX's draws fed in."""
    js, ps = jdpm.CogVideoXDPMScheduler(), pdpm.CogVideoXDPMScheduler()
    ts = ps.set_timesteps(5)
    js.set_timesteps(5)
    rng = np.random.default_rng(1)
    shape = (1, 3, 4, 4, 4)
    out, z, old = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(3))
    skey = jax.random.key(7)
    noises = {"first": np.array(jax.random.normal(skey, shape)),
              "second": np.array(jax.random.normal(
                  jax.random.fold_in(skey, 1), shape))}
    # the last step (t = 199 of 5) has no previous alpha: first order
    for i, old_x0, want_asked in ((0, None, ["first"]),
                                  (2, old, ["first", "second"]),
                                  (4, old, ["first"])):
        t_back = int(ts[i - 1]) if i else None
        asked = []

        def draw(name, s):
            asked.append(name)
            return torch.from_numpy(noises[name])

        got, x0 = ps.step(torch.from_numpy(out), None if old_x0 is None
                          else torch.from_numpy(old_x0), int(ts[i]), t_back,
                          torch.from_numpy(z), draw)
        want, wx0 = js.step(jnp.asarray(out), None if old_x0 is None
                            else jnp.asarray(old_x0), int(ts[i]), t_back,
                            jnp.asarray(z), skey)
        assert asked == want_asked
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_array_equal(x0.numpy(), np.asarray(wx0))


def jax_draws(seed: int, shape, steps: int):
    """JAX generate's draws: the initial latent, then per step the DPM noise
    and its fold-in (pipeline_cogvideox.py's split sequence)."""
    rng = jax.random.key(seed)
    rng, zkey = jax.random.split(rng)
    z = np.array(jax.random.normal(zkey, shape, jnp.float32))
    draws = {}
    for i in range(steps):
        rng, skey = jax.random.split(rng)
        draws[f"dpm/{i}/first"] = np.array(jax.random.normal(skey, shape))
        draws[f"dpm/{i}/second"] = np.array(jax.random.normal(
            jax.random.fold_in(skey, 1), shape))
    return z, draws


@pytest.mark.parametrize("scheduler,pab,steps", [
    ("ddim", False, 2), ("ddim", True, 4), ("dpm", False, 3), ("dpm", True, 4)])
def test_generate_like_jax(scheduler, pab, steps):
    """The whole tiny generate, the same params, latents and draws: the
    final latents at 2e-4, the uint8 video within one level. With PAB the
    4-step ladder (999, 749, 499, 249) reads on steps 1 and 3."""
    rope = scheduler == "dpm"  # the 5b widths serve with DPM
    kw = dict(model_path="", dtype="fp32", scheduler=scheduler,
              enable_pab=pab, vae_tiling=False)
    peng = videosys_tpu_torch.VideoSysEngine(
        videosys_tpu_torch.CogVideoXConfig(
            **kw, transformer_config=P.CogVideoXConfig(
                **SIZES, use_rotary_positional_embeddings=rope),
            vae_config=PVAECfg(**VAE)),
        device="cpu")
    pipe = peng.pipeline
    pipe.keep_latents = True
    # the port's seeded weights, perturbed, given to JAX by the JAX
    # package's converters (JAX compiles no init)
    sd = {"transformer": perturbed(state(pipe.transformer)),
          "vae": perturbed(state(pipe.vae), 1)}
    params = {"transformer": convert_cogvideox(sd["transformer"],
                                               depth=SIZES["num_layers"]),
              "vae": convert_cogvideox_vae(
                  sd["vae"], len(VAE["block_out_channels"]),
                  VAE["layers_per_block"])}
    pipe.transformer.load_state_dict(carried(
        sd["transformer"], params["transformer"], cogvideox_from_jax))
    pipe.vae.load_state_dict(carried(sd["vae"], params["vae"],
                                     cogvideox_vae_from_jax))
    jpipe = JP.CogVideoXPipeline(JP.CogVideoXConfig(
        **kw, transformer_config=J.CogVideoXConfig(
            **SIZES, use_rotary_positional_embeddings=rope),
        vae_config=JVAECfg(**VAE)), params=params)
    seen = []
    decode = jpipe.vae.decode
    jpipe.vae.decode = lambda p, lat: seen.append(np.asarray(lat)) or decode(p, lat)
    req = dict(num_inference_steps=steps, num_frames=9, height=32, width=32,
               seed=5, use_dynamic_cfg=scheduler == "dpm")
    want = jpipe.generate("a dog running on the beach", **req).video
    z, draws = jax_draws(5, pipe.latent_shape(9, 32, 32), steps)
    got = peng.generate("a dog running on the beach",
                        latents=torch.from_numpy(z),
                        noise=lambda name, shape: torch.from_numpy(draws[name]),
                        **req).video
    lat = np.swapaxes(pipe.last_latents, 1, 2) / pipe.vae.config.scaling_factor
    np.testing.assert_allclose(lat, seen[0], atol=TOL, rtol=TOL)
    assert got.shape == want.shape == (1, 9, 32, 32, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert set(pipe.last_timings) == {"text", "denoise", "vae", "postprocess"}


def test_config_raises_and_seeded_draws():
    """num_gpus > 1 needs a process group (VideoSysEngine spawns the
    ranks), no CPU fallback, a configured text encoder is never replaced by
    the stub; a seeded DPM generate (two noises a step) draws the same
    sequence twice."""
    tiny = dict(model_path="", dtype="fp32", vae_tiling=False,
                transformer_config=P.CogVideoXConfig(**SIZES),
                vae_config=PVAECfg(**VAE))
    with pytest.raises(RuntimeError, match="initialize"):
        videosys_tpu_torch.CogVideoXPipeline(
            videosys_tpu_torch.CogVideoXConfig(num_gpus=2, **tiny),
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            videosys_tpu_torch.CogVideoXPipeline(
                videosys_tpu_torch.CogVideoXConfig(**tiny))
    with pytest.raises(RuntimeError, match="model_path=None"):
        videosys_tpu_torch.CogVideoXPipeline(
            videosys_tpu_torch.CogVideoXConfig(
                **dict(tiny, model_path="/nonexistent/CogVideoX-2b")),
            device="cpu")
    pipe = videosys_tpu_torch.CogVideoXPipeline(
        videosys_tpu_torch.CogVideoXConfig(**dict(tiny, scheduler="dpm")),
        device="cpu")
    req = dict(num_inference_steps=3, num_frames=9, height=16, width=16)
    a = pipe.generate("a cat", seed=3, **req).video
    np.testing.assert_array_equal(a, pipe.generate("a cat", seed=3, **req).video)
    assert a.shape == (1, 9, 16, 16, 3)


@pytest.mark.parametrize("pab", [False, True])
def test_cpu_offload_matches_resident(pab, monkeypatch):
    """`cpu_offload` keeps the transformer and the VAE on the host and
    fetches each for its phase (the transformer once for the whole denoise,
    the PAB cache beside it): the video equals the resident one bit for
    bit, each fetch finds the other module on its host tensors, and every
    weight is back on them after `generate`."""
    kw = dict(model_path="", dtype="fp32", vae_tiling=False, enable_pab=pab,
              transformer_config=P.CogVideoXConfig(**SIZES),
              vae_config=PVAECfg(**VAE))
    req = dict(num_inference_steps=4, num_frames=9, height=16, width=16,
               seed=2)
    resident = videosys_tpu_torch.CogVideoXPipeline(
        videosys_tpu_torch.CogVideoXConfig(**kw), device="cpu", seed=1)
    offloaded = videosys_tpu_torch.CogVideoXPipeline(
        videosys_tpu_torch.CogVideoXConfig(**kw, cpu_offload=True),
        device="cpu", seed=1)
    modules = {"transformer": offloaded.transformer, "vae": offloaded.vae}
    host = {id(p): p.data_ptr() for m in modules.values()
            for p in m.parameters()}

    def on_host(module):
        return all(p.data_ptr() == host[id(p)] for p in module.parameters())

    fetched = []

    def hook(name, module, seconds, nbytes):
        assert all(on_host(m) for m in modules.values() if m is not module)
        assert all(p.data_ptr() != host[id(p)] for p in module.parameters())
        fetched.append(name)

    monkeypatch.setattr(core_pipeline, "FETCH_HOOKS", [hook])
    got = offloaded.generate("a cat", **req).video
    assert fetched == ["transformer", "vae"]
    assert all(on_host(m) for m in modules.values())
    np.testing.assert_array_equal(got, resident.generate("a cat", **req).video)

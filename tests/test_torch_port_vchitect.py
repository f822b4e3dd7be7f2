"""The PyTorch port's Vchitect-2.0 against the JAX package on the CPU (fp32,
tiny sizes, 2e-4): the flow-match Euler ladder and step (shift 1 and 3);
the VchitectXLTransformer forward with four frames and with one (the
temporal term zeroed), params carried by `vchitect_from_jax` and back by
the JAX package's `convert_vchitect` (the reference key names); PAB step by
step against JAX's cached forward, read steps running none of what they
read; the word-hash stub encoder byte for byte; the whole
`VideoSysEngine.generate` dense and with PAB, fed JAX's latents (video
within one uint8 level); and loading a diffusers-layout snapshot written
here."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videosys_tpu.pipelines.vchitect.pipeline_vchitect as JP
import videosys_tpu.utils.jit as jjit
import videosys_tpu_torch
from videosys_tpu.core.pab import build_plans as j_build_plans
from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JVAE
from videosys_tpu.models.transformers import vchitect as J
from videosys_tpu.schedulers import flow_match_euler as JS
from videosys_tpu.utils.convert import convert_vae2d, convert_vchitect
from videosys_tpu_torch.core.pab import build_plans
from videosys_tpu_torch.models.transformers import vchitect as P
from videosys_tpu_torch.pipelines.vchitect import pipeline_vchitect as PP
from videosys_tpu_torch.schedulers import flow_match_euler as PS
from videosys_tpu_torch.utils.checkpoint import load_torch_checkpoint
from videosys_tpu_torch.utils.from_jax import vae2d_from_jax, vchitect_from_jax
from videosys_tpu_torch.utils.safetensors_io import save_file

TOL = 2e-4
# tests/test_vchitect.py's tiny configuration
SIZES = dict(num_layers=3, num_heads=2, head_dim=16, joint_attention_dim=32,
             pooled_projection_dim=24, sample_size=8, pos_embed_max_size=12)
VAE = dict(mid_block_add_attention=False, latent_channels=16,
           block_out_channels=(8, 16), layers_per_block=1, num_groups=4)
PROMPT = "a ship sailing at dawn"


def perturbed(params, seed: int = 0):
    """Flax params as numpy, each leaf moved by noise so that no scale or
    table is the identity."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32), params)


def inputs(seed: int = 0, F: int = 4, L: int = 6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, F, 16, 16, 16)).astype(np.float32),
            rng.standard_normal((1, L, 32)).astype(np.float32),
            rng.standard_normal((1, 24)).astype(np.float32),
            np.array([500.0], np.float32))


def state(module) -> dict:
    return {k: v.numpy() for k, v in module.state_dict().items()}


def carried(sd: dict, params, from_jax) -> dict:
    """from_jax carries `params` (made from `sd`) back to `sd` unchanged."""
    back = from_jax(params)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])
    return {k: torch.from_numpy(v) for k, v in back.items()}


@pytest.fixture(scope="module")
def models():
    """(JAX params, the port's model with them), built once: the port's
    seeded weights, perturbed, as JAX params by the JAX package's converter
    (JAX compiles no init)."""
    torch.manual_seed(0)
    pm = P.VchitectXLTransformer(P.VchitectModelConfig(**SIZES))
    sd = perturbed(state(pm))
    params = convert_vchitect(sd, depth=SIZES["num_layers"])
    pm.load_state_dict(carried(sd, params, vchitect_from_jax))
    return params, pm.eval()


def run_port(pm, x, enc, pooled, t, **kw):
    with torch.no_grad():
        return pm(*(torch.from_numpy(a) for a in (x, enc, pooled, t)), **kw)


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_flow_match_like_jax(shift):
    js = JS.FlowMatchEulerScheduler(JS.FlowMatchEulerConfig(shift=shift))
    ps = PS.FlowMatchEulerScheduler(PS.FlowMatchEulerConfig(shift=shift))
    np.testing.assert_array_equal(ps.set_timesteps(25), js.set_timesteps(25))
    np.testing.assert_array_equal(ps.sigmas, js.sigmas)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    v = rng.standard_normal((2, 3, 4)).astype(np.float32)
    x0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    for i in (0, 7, 24):
        np.testing.assert_allclose(
            ps.step(torch.from_numpy(v), i, torch.from_numpy(x)).numpy(),
            np.asarray(js.step(jnp.asarray(v), i, jnp.asarray(x))),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            ps.scale_noise(torch.from_numpy(x0), torch.from_numpy(v), i).numpy(),
            np.asarray(js.scale_noise(jnp.asarray(x0), jnp.asarray(v), i)),
            rtol=1e-6, atol=1e-6)
    assert ps.scale_model_input(torch.from_numpy(x), 3) is not None


@pytest.mark.parametrize("frames", [4, 1])
def test_forward_parity_and_key_names(models, frames):
    params, pm = models
    x, enc, pooled, t = inputs(1, F=frames)
    apply = jax.jit(J.VchitectXLTransformer(J.VchitectModelConfig(**SIZES)).apply)
    want = np.asarray(apply(params, x, enc, pooled, t))
    got = run_port(pm, x, enc, pooled, t).numpy()
    assert got.shape == want.shape == (1, frames, 16, 16, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if frames == 1:
        return
    # the port's state_dict carries the reference's names: the JAX
    # package's converter reads it into params that give the same output
    back = convert_vchitect(pm.state_dict(), depth=SIZES["num_layers"])
    np.testing.assert_allclose(
        got, np.asarray(apply(back, x, enc, pooled, t)), atol=TOL, rtol=TOL)


def test_single_frame_runs_no_temporal_attention(models, monkeypatch):
    """One frame: the temporal branch is zero in JAX; the port skips it
    (two attentions a block) and its weights do not matter."""
    params, pm = models
    x, enc, pooled, t = inputs(2, F=1)
    calls = []
    sdpa = P.scaled_dot_product_attention
    monkeypatch.setattr(P, "scaled_dot_product_attention",
                        lambda *a, **k: calls.append(a[0].shape) or sdpa(*a, **k))
    got = run_port(pm, x, enc, pooled, t)
    assert len(calls) == 2 * SIZES["num_layers"]
    zeroed = P.VchitectXLTransformer(P.VchitectModelConfig(**SIZES)).eval()
    zeroed.load_state_dict({k: torch.zeros_like(v) if "temp" in k else v
                            for k, v in pm.state_dict().items()})
    assert torch.equal(got, run_port(zeroed, x, enc, pooled, t))


def test_vchitect_from_jax_round_trip(models):
    """vchitect_from_jax inverts convert_vchitect exactly, every key and
    value."""
    _, pm = models
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    back = vchitect_from_jax(convert_vchitect(sd, depth=SIZES["num_layers"]))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_pab_steps_like_jax(models):
    """A 10-step ladder (900, 800, ..., 0) under Vchitect's PAB config: the
    plans equal JAX's, every step's output equals JAX's cached forward
    (the cache in the model dtype) within 2e-4 of its largest magnitude (a
    read step adds the branch outputs, rounded at another step's inputs,
    to this step's: 2.2e-4 on outputs up to 7.5, where the dense forward
    at the same inputs reads 4.9e-5), and a read branch runs none of its
    projections or attention."""
    params, pm = models
    pab = JP.VchitectPABConfig()
    ladder = np.arange(900, -1, -100).astype(np.float32)
    depth = SIZES["num_layers"]
    plans = build_plans(pab, ladder, depth)
    jplans = j_build_plans(pab, ladder, depth, None)
    assert [p.__dict__ for p in plans] == [p.__dict__ for p in jplans]
    assert all(any(getattr(p, b) for p in plans)
               for b in ("spatial", "temporal", "cross"))
    F, S, L = 4, 64, 6
    jcache = J.VchitectXLTransformer(J.VchitectModelConfig(**SIZES),
                                     pab_config=pab).init_cache(1, F, S, L)
    cache = pm.init_cache(pab, 1, F, S, L)
    assert {b: tuple(s) for b, s in cache.slots.items()} == {
        "spatial": ("attn", "cross"), "temporal": ("attn",)}
    assert cache.slots["spatial"]["attn"].shape == (depth - 1, 1, F, S + L, 32)
    calls = []
    for blk in pm.transformer_blocks:
        for name in ("to_q", "to_q_cross", "to_q_temp"):
            getattr(blk.attn, name).register_forward_hook(
                lambda m, a, o, n=name, b=blk: calls.append((b, n)))
    for i, (plan, jplan) in enumerate(zip(plans[:8], jplans[:8])):
        x, enc, pooled, _ = inputs(10 + i, F=F, L=L)
        t = np.array([ladder[i]], np.float32)
        jm = J.VchitectXLTransformer(J.VchitectModelConfig(**SIZES),
                                     plan=jplan, pab_config=pab)
        want, jcache = jm.apply(params, x, enc, pooled, t, pab_cache=jcache)
        calls.clear()
        got = run_port(pm, x, enc, pooled, t, plan=plan, pab_cache=cache)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=f"step {i}")
        ran = set(calls)
        for d, blk in enumerate(pm.transformer_blocks):
            dense = d == depth - 1  # the last block never reads the cache
            assert ((blk, "to_q") in ran) == (dense or not plan.spatial)
            assert ((blk, "to_q_cross") in ran) == (dense or not plan.cross)
            assert ((blk, "to_q_temp") in ran) == (dense or not plan.temporal)


def test_stub_encoder_byte_equal_to_jax():
    jstub = JP.DualStubTextEncoder(joint_dim=64, pooled_dim=24, t5_len=12)
    pstub = PP.DualStubTextEncoder(joint_dim=64, pooled_dim=24, t5_len=12,
                                   device="cpu")
    texts = [PROMPT, "", "word " * 100]
    for want, got in zip(jstub.encode_dual(texts), pstub.encode_dual(texts)):
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


def jax_latents(seed: int, shape):
    """JAX generate's initial latent draw."""
    _, zkey = jax.random.split(jax.random.key(seed))
    return np.array(jax.random.normal(zkey, shape, jnp.float32))


@pytest.mark.parametrize("pab", [False, True])
def test_generate_like_jax(pab, monkeypatch, tmp_path):
    """The whole tiny generate on the same params and latents: the final
    latents at 2e-4 of their largest magnitude, the uint8 video within one
    level. The PAB run's ladder (8 steps) reads every branch."""
    req = dict(num_inference_steps=8 if pab else 3, width=32, height=32,
               frames=4, seed=3)
    engine = videosys_tpu_torch.VideoSysEngine(
        videosys_tpu_torch.VchitectConfig(
            model_path=None, dtype="fp32", enable_pab=pab,
            transformer_config=P.VchitectModelConfig(**SIZES),
            vae_config=VAE),
        device="cpu")
    pipe = engine.pipeline
    pipe.keep_latents = True
    # the port's seeded weights, perturbed, given to JAX by the JAX
    # package's converters (JAX compiles no init)
    sd = {"transformer": perturbed(state(pipe.transformer)),
          "vae": perturbed(state(pipe.vae), 1)}
    params = {"transformer": convert_vchitect(sd["transformer"],
                                              depth=SIZES["num_layers"]),
              "vae": convert_vae2d(sd["vae"], len(VAE["block_out_channels"]))}
    pipe.transformer.load_state_dict(carried(
        sd["transformer"], params["transformer"], vchitect_from_jax))
    pipe.vae.load_state_dict(carried(sd["vae"], params["vae"],
                                     vae2d_from_jax))
    jcfg = JP.VchitectConfig(model_path=None, dtype="fp32", enable_pab=pab,
                             transformer_config=J.VchitectModelConfig(**SIZES),
                             vae=JVAE(**VAE))
    jpipe = JP.VchitectXLPipeline(jcfg, params=params)
    seen = []
    # run the JAX VAE decode eagerly to see the latents it is given
    monkeypatch.setattr(jjit, "jit_method", lambda obj, name, static_argnums=():
                        lambda p, f: seen.append(np.asarray(f)) or getattr(obj, name)(p, f))
    want = jpipe.generate(PROMPT, **req).video
    z = jax_latents(3, pipe.latent_shape(4, 32, 32))
    got = engine.generate(PROMPT, latents=torch.from_numpy(z), **req).video
    frames = pipe.last_latents[0] / PP.VAE_SCALING + PP.VAE_SHIFT
    want_z = np.moveaxis(seen[0], -1, 1)
    np.testing.assert_allclose(frames, want_z, rtol=0,
                               atol=TOL * np.abs(want_z).max())
    assert got.shape == want.shape == (1, 4, 32, 32, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if pab:
        plans = build_plans(engine.config.pab_config, np.asarray(
            pipe.scheduler.timesteps, np.float32), SIZES["num_layers"])
        assert all(any(getattr(p, b) for p in plans)
                   for b in ("spatial", "temporal", "cross"))
        assert pipe.last_pab_cache_bytes == 2 * 3 * 2 * 4 * (64 + 333) * 32 * 4
    assert pipe.save_video(got[0], str(tmp_path / "v")).endswith(
        (".mp4", ".gif"))


def test_snapshot_loads_transformer_only(tmp_path, monkeypatch):
    """A diffusers-layout snapshot's `transformer/` loads bit for bit, its
    depth read from the keys; the VAE stays random (the JAX package loads
    none); a path without weights raises as `require_weights` does."""
    src = videosys_tpu_torch.VchitectXLPipeline(
        videosys_tpu_torch.VchitectConfig(
            model_path=None, dtype="fp32",
            transformer_config=P.VchitectModelConfig(**SIZES), vae_config=VAE),
        device="cpu", seed=1)
    snap = tmp_path / "Vchitect-2.0-2B"
    os.makedirs(snap / "transformer")
    save_file(dict(src.transformer.state_dict()),
              str(snap / "transformer" / "diffusion_pytorch_model.safetensors"),
              {"format": "pt"})
    loaded = load_torch_checkpoint(str(snap), "vchitect")
    assert set(loaded) == {"transformer"}
    # the snapshot's widths are the tiny ones; its depth comes from the keys
    monkeypatch.setattr(PP, "VchitectModelConfig", lambda **kw:
                        P.VchitectModelConfig(**{**SIZES, "num_layers": 18,
                                                 **kw}))
    pipe = videosys_tpu_torch.VchitectXLPipeline(
        videosys_tpu_torch.VchitectConfig(model_path=str(snap), dtype="fp32",
                                          vae_config=VAE), device="cpu")
    assert pipe.model_config.num_layers == SIZES["num_layers"]
    want = src.transformer.state_dict()
    got = pipe.transformer.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert isinstance(pipe.text_encoder, PP.DualStubTextEncoder)
    with pytest.raises(FileNotFoundError, match="transformer weights"):
        videosys_tpu_torch.VchitectXLPipeline(
            videosys_tpu_torch.VchitectConfig(model_path=str(tmp_path / "none")),
            device="cpu")
    # num_gpus > 1 builds its groups over the default process group: none
    # exists here (VideoSysEngine spawns the ranks)
    with pytest.raises(RuntimeError, match="initialize"):
        videosys_tpu_torch.VchitectXLPipeline(
            videosys_tpu_torch.VchitectConfig(model_path=None, num_gpus=2),
            device="cpu")


def test_cpu_offload_equals_resident():
    """`cpu_offload` keeps the modules on the host and fetches each for its
    phase: the same video as every module resident, and the weights back
    on their host tensors."""
    from videosys_tpu_torch.core import pipeline as core

    def make(offload):
        return videosys_tpu_torch.VideoSysEngine(
            videosys_tpu_torch.VchitectConfig(
                model_path=None, dtype="fp32", cpu_offload=offload,
                enable_pab=True,
                transformer_config=P.VchitectModelConfig(**SIZES),
                vae_config=VAE), device="cpu", seed=2)

    req = dict(num_inference_steps=4, width=32, height=32, frames=4, seed=1)
    resident = make(False).generate(PROMPT, **req).video
    engine = make(True)
    host = [p.data_ptr() for p in engine.pipeline.transformer.parameters()]
    fetched = []
    core.FETCH_HOOKS.append(lambda name, *a: fetched.append(name))
    try:
        video = engine.generate(PROMPT, **req).video
    finally:
        core.FETCH_HOOKS.pop()
    assert fetched == ["transformer", "vae"]
    assert np.array_equal(video, resident)
    assert [p.data_ptr() for p in engine.pipeline.transformer.parameters()] == host

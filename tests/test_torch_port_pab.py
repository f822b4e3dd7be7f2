"""PAB (Pyramid Attention Broadcast) of the PyTorch port against the JAX
package: the step plans, STDiT3's cache slots (a write step, then a read
step, for every slot kind), read steps that skip their work, the cache
dtype, and a whole tiny PAB-on `generate` fed the same initial noise. fp32
with the cache in the model dtype, whole models at 2e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videosys_tpu
import videosys_tpu_torch
import videosys_tpu_torch.models.modules.blocks as p_blocks
from videosys_tpu.core import pab as J
from videosys_tpu.models.autoencoders import autoencoder_open_sora as JA
from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JKL
from videosys_tpu.models.autoencoders.vae_temporal import VAETemporal as JT
from videosys_tpu.models.transformers import stdit3 as JS
from videosys_tpu.utils.convert import (
    convert_stdit3,
    convert_vae2d,
    convert_vae_temporal,
)
from videosys_tpu_torch.core import pab as P
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as PA
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D as PKL
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal as PT
from videosys_tpu_torch.models.transformers import stdit3 as PS
from videosys_tpu_torch.pipelines.open_sora.data_process import get_image_size
from videosys_tpu_torch.schedulers.rflow import RFlowConfig, RFlowScheduler
from videosys_tpu_torch.utils.from_jax import open_sora_vae_from_jax, stdit3_from_jax

TOL = 2e-4
SIZES = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8, patch_size=(1, 2, 2))
SPATIAL = dict(mid_block_add_attention=False, block_out_channels=(8, 8, 8, 16),
               layers_per_block=1, num_groups=4)
TEMPORAL = dict(filters=8, num_res_blocks=1, num_groups=4)

# the three ladders the JAX package's bench.py serves, beside the reference
# ladder's two extensions alone
LADDERS = {
    "reference": {},
    "heavy": dict(spatial_range=3, temporal_range=6, cross_range=8),
    "mlp_range": dict(mlp_range=2),
    "pair": dict(pair_broadcast=True, pair_range=3, pair_threshold=(250, 950)),
}


def ladder(resolution, aspect_ratio, num_frames, steps=30):
    h, w = get_image_size(resolution, aspect_ratio)
    return RFlowScheduler(RFlowConfig(num_sampling_steps=steps)
                          ).prepare_timesteps(h, w, num_frames)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("where", ["480p_2s", "144p"])
@pytest.mark.parametrize("name", sorted(LADDERS))
def test_build_plans_equal_jax(name, where, dtype):
    ts = (ladder("480p", "9:16", 51) if where == "480p_2s"
          else ladder("144p", "1:1", 17))
    jdt, pdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "fp32": (jnp.float32, torch.float32)}[dtype]
    assert P.quantize_timesteps(ts, pdt) == J.quantize_timesteps(ts, jdt)
    want = J.build_plans(videosys_tpu.OpenSoraPABConfig(**LADDERS[name]),
                         ts, 28, jdt)
    got = P.build_plans(videosys_tpu_torch.OpenSoraPABConfig(**LADDERS[name]),
                        ts, 28, pdt)
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]
    assert any(p.spatial or p.pair for p in got)  # the ladder broadcasts
    if name == "reference" and where == "480p_2s":
        # bf16 rounding puts 864, 788 and 676 on the ladder: the MLP rows
        # are used in bf16 only
        assert any(p.any_mlp for p in got) == (dtype == "bf16")


def test_cache_dtype_maps_and_rejects():
    pm = PS.STDiT3(PS.STDiT3Config(**SIZES))
    pab = P.PABConfig(spatial_broadcast=True)
    assert pm.init_cache(pab, 2, 3, 16).slots["spatial"]["attn"].dtype \
        == torch.float32
    for name, dtype in (("float8_e4m3fn", torch.float8_e4m3fn),
                        ("bfloat16", torch.bfloat16)):
        pab = P.PABConfig(spatial_broadcast=True, cache_dtype=name)
        assert P.cache_torch_dtype(name) is dtype
        cache = pm.init_cache(pab, 2, 3, 16)
        assert cache.slots["spatial"]["attn"].dtype is dtype
        assert cache.nbytes == 2 * 2 * 3 * 16 * 32 * dtype.itemsize
    with pytest.raises(ValueError, match="float8_e4m3"):
        P.PABConfig(cache_dtype="float8_e4m3")
    with pytest.raises(ValueError):
        videosys_tpu_torch.OpenSoraPABConfig(cache_dtype="float8_e4m3")


B, T, H, W, L = 2, 3, 8, 8, 8
# (PABConfig, write-step plan, read-step plan) for every slot kind
SLOT_KINDS = {
    "component": (
        dict(spatial_broadcast=True, spatial_threshold=(100, 900),
             temporal_broadcast=True, temporal_threshold=(100, 900),
             cross_broadcast=True, cross_threshold=(100, 900)),
        dict(save_spatial=True, save_temporal=True, save_cross=True),
        dict(spatial=True, temporal=True, cross=True)),
    "mlp_dict": (
        dict(mlp_broadcast=True,
             mlp_spatial_broadcast_config={500: {"block": [1], "skip_count": 1}},
             mlp_temporal_broadcast_config={500: {"block": [0, 1],
                                                  "skip_count": 1}}),
        dict(mlp_spatial_save=(False, True), mlp_spatial_use=(False, False),
             mlp_temporal_save=(True, True), mlp_temporal_use=(False, False)),
        dict(mlp_spatial_save=(False, False), mlp_spatial_use=(False, True),
             mlp_temporal_save=(False, False), mlp_temporal_use=(True, False))),
    "mlp_range": (
        dict(mlp_broadcast=True, mlp_threshold=(100, 900), mlp_range=2),
        dict(save_mlp=True), dict(mlp=True)),
    "pair": (
        dict(pair_broadcast=True, pair_threshold=(100, 900), pair_range=2),
        dict(save_pair=True), dict(pair=True)),
}


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, B, 4, T, H, W)).astype(np.float32)
    y = rng.standard_normal((B, L, 16)).astype(np.float32)
    # the port's seeded weights, perturbed, given to JAX by the JAX
    # package's converter and carried back by from_jax (no init program)
    torch.manual_seed(0)
    pm = PS.STDiT3(PS.STDiT3Config(**SIZES))
    sd = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in pm.state_dict().items()}
    params = convert_stdit3(sd, SIZES["depth"])
    pm.load_state_dict({k: torch.tensor(v)
                        for k, v in stdit3_from_jax(params).items()})
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    kw = dict(kv_mask=np.arange(L)[None] < np.array([[5], [8]]),
              x_mask=np.array([[True, True, False], [True, False, False]]),
              fps=np.full((B,), 24.0, np.float32))
    return params, pm.eval(), x, y, kw


def _step_inputs(x, y, kw, i, x_mask):
    t = np.array([[700.0, 650.0], [600.0, 550.0]], np.float32)[i]
    args = (x[i], t, y)
    kwargs = {k: v for k, v in kw.items() if x_mask or k != "x_mask"}
    return args, kwargs


@pytest.mark.parametrize("kind", sorted(SLOT_KINDS))
def test_cache_write_then_read_matches_jax(models, kind):
    """A write step (at step 0's inputs) and a read step (at step 1's),
    both with condition frames (x_mask): the outputs and every written slot
    equal the JAX model's."""
    params, pm, x, y, kw = models
    cfg, write, read = SLOT_KINDS[kind]
    jcfg = JS.STDiT3Config(**SIZES)
    jcache = JS.STDiT3(jcfg, pab_config=J.PABConfig(**cfg)).init_cache(B, T, 16)
    cache = pm.init_cache(P.PABConfig(**cfg), B, T, 16)
    assert jax.tree.map(np.shape, jcache) == {
        b: {s: tuple(v.shape) for s, v in slots.items()}
        for b, slots in cache.slots.items()}
    for i, plan in enumerate((write, read)):
        args, kwargs = _step_inputs(x, y, kw, i, True)
        jm = JS.STDiT3(jcfg, plan=J.PABStepPlan(**plan),
                       pab_config=J.PABConfig(**cfg))
        want, jcache = jm.apply(params, *map(jnp.asarray, args),
                                height=256.0, width=256.0, pab_cache=jcache,
                                **{k: jnp.asarray(v) for k, v in kwargs.items()})
        with torch.no_grad():
            got = pm(*map(torch.from_numpy, args), height=256.0, width=256.0,
                     plan=P.PABStepPlan(**plan), pab_cache=cache,
                     **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)
        for b, slots in cache.slots.items():
            for s, v in slots.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(jcache[b][s]),
                                           atol=TOL, rtol=TOL, err_msg=f"{b}/{s}")
        if i == 0:
            assert sum(float(v.abs().sum()) for slots in cache.slots.values()
                       for v in slots.values()) > 0


def _count_calls(pm):
    """Counters of module calls by kind, and of attention-op calls."""
    counts = {"attn": 0, "cross_attn": 0, "mlp": 0, "sdpa": 0}
    hooks = []
    for blocks in (pm.spatial_blocks, pm.temporal_blocks):
        for blk in blocks:
            for name in ("attn", "cross_attn", "mlp"):
                def hook(*_, name=name):
                    counts[name] += 1
                hooks.append(getattr(blk, name).register_forward_pre_hook(hook))
    return counts, hooks


@pytest.mark.parametrize("kind,want", [
    ("component", {"attn": 0, "cross_attn": 0, "mlp": 4, "sdpa": 0}),
    ("mlp_dict", {"attn": 4, "cross_attn": 4, "mlp": 2, "sdpa": 8}),
    ("mlp_range", {"attn": 4, "cross_attn": 4, "mlp": 0, "sdpa": 8}),
    ("pair", {"attn": 0, "cross_attn": 0, "mlp": 0, "sdpa": 0}),
])
def test_read_step_skips_work(models, kind, want, monkeypatch):
    """A read step makes no call into the attention or MLP it reads from
    the cache; a write step computes everything (2 pairs: 4 blocks, each
    with self- and cross-attention)."""
    _, pm, x, y, kw = models
    cfg, write, read = SLOT_KINDS[kind]
    counts, hooks = _count_calls(pm)
    sdpa = p_blocks.scaled_dot_product_attention

    def counted(*a, **k):
        counts["sdpa"] += 1
        return sdpa(*a, **k)

    monkeypatch.setattr(p_blocks, "scaled_dot_product_attention", counted)
    cache = pm.init_cache(P.PABConfig(**cfg), B, T, 16)
    args, kwargs = _step_inputs(x, y, kw, 0, False)
    args = tuple(map(torch.from_numpy, args))
    kwargs = {k: torch.from_numpy(v) for k, v in kwargs.items()}
    try:
        with torch.no_grad():
            for plan, expect in ((write, {"attn": 4, "cross_attn": 4, "mlp": 4,
                                          "sdpa": 8}), (read, want)):
                for k in counts:
                    counts[k] = 0
                pm(*args, plan=P.PABStepPlan(**plan), pab_cache=cache, **kwargs)
                assert counts == expect
    finally:
        for h in hooks:
            h.remove()


@pytest.fixture(scope="module")
def engines():
    steps = 6
    jcfg = videosys_tpu.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None,
        num_sampling_steps=steps, dtype="fp32",
        transformer_config=JS.STDiT3Config(**SIZES))
    jvae = JA.OpenSoraVAE(JA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=4),
                          spatial=JKL(**SPATIAL), temporal=JT(**TEMPORAL))
    pcfg = videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None,
        num_sampling_steps=steps, dtype="fp32",
        transformer_config=PS.STDiT3Config(**SIZES))
    torch.manual_seed(0)
    pvae = PA.OpenSoraVAE(PA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=4),
                          spatial=PKL(**SPATIAL), temporal=PT(**TEMPORAL))
    peng = videosys_tpu_torch.VideoSysEngine(pcfg, vae=pvae, device="cpu")
    peng.pipeline.keep_latents = True
    # the port's seeded weights, given to JAX by the JAX package's
    # converters and carried back unchanged by from_jax (no init program)
    sd = {name: {k: v.numpy() for k, v in m.state_dict().items()}
          for name, m in (("transformer", peng.pipeline.transformer),
                          ("vae", peng.pipeline.vae))}
    part = {p: {k[len(p):]: v for k, v in sd["vae"].items()
                if k.startswith(p)}
            for p in ("spatial_vae.module.", "temporal_vae.")}
    params = {"transformer": convert_stdit3(sd["transformer"], SIZES["depth"]),
              "vae": {"spatial": convert_vae2d(
                          part["spatial_vae.module."],
                          len(SPATIAL["block_out_channels"])),
                      "temporal": convert_vae_temporal(part["temporal_vae."],
                                                       4, 1)}}
    for name, back in (("transformer", stdit3_from_jax(params["transformer"])),
                       ("vae", open_sora_vae_from_jax(params["vae"]))):
        assert back.keys() == sd[name].keys()
        for k, v in back.items():
            np.testing.assert_array_equal(v, sd[name][k])
    jpipe = videosys_tpu.OpenSoraPipeline(jcfg, vae=jvae, params=params)
    jpipe.keep_latents = True
    return jpipe, peng


@pytest.mark.parametrize("name", ["reference", "mlp_range", "pair"])
def test_pab_generate_matches_jax(engines, name):
    """PAB-on generate, the same initial noise: latents at 2e-4, the video
    within one level. The 6-step 144p 17-frame ladder (fp32) is
    [1000, 807, 626, 456, 295, 143]; the reference ladder's MLP rows are
    keyed on it."""
    jpipe, peng = engines
    over = dict(LADDERS[name])
    if name == "reference":
        over.update(mlp_spatial_broadcast_config={
                        807: {"block": [0, 1], "skip_count": 2}},
                    mlp_temporal_broadcast_config={
                        626: {"block": [1], "skip_count": 1},
                        1000: {"block": [0], "skip_count": 3}})
    jpipe._config.enable_pab = peng.pipeline._config.enable_pab = True
    jpipe._config.pab_config = videosys_tpu.OpenSoraPABConfig(**over)
    peng.pipeline._config.pab_config = videosys_tpu_torch.OpenSoraPABConfig(**over)
    jpipe._step_fns = {}  # its step programs hold the PAB config they saw
    seed = 4
    kw = dict(resolution="144p", aspect_ratio="1:1", num_frames=17, seed=seed)
    want = jpipe.generate("waves at dusk", **kw).video
    _, zk = jax.random.split(jax.random.key(seed))
    t_lat, h, w = peng.pipeline.vae.get_latent_size((17, 192, 192))
    z = np.array(jax.random.normal(zk, (1, 4, t_lat, h, w), jnp.float32))
    got = peng.generate("waves at dusk", latents=torch.from_numpy(z), **kw).video
    plans = P.build_plans(peng.pipeline._config.pab_config,
                          peng.pipeline.scheduler.prepare_timesteps(192, 192, 17),
                          SIZES["depth"], torch.float32)
    assert sum(p.spatial or p.pair for p in plans) >= 2
    if name == "reference":
        assert any(any(p.mlp_spatial_use) for p in plans)
    np.testing.assert_allclose(peng.pipeline.last_latents, jpipe.last_latents,
                               atol=TOL, rtol=TOL)
    assert got.shape == want.shape == (1, 17, 192, 192, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

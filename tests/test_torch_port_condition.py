"""Condition frames and loops of the PyTorch port against the JAX package:
the VAE encoders and `OpenSoraVAE.encode` given the same noises, the
encoder weights carried by from_jax, the mask-strategy helpers, the masked
denoise step (with and without a PAB cache), and whole tiny conditioned and
`loop=2` generates fed JAX's draws, reproduced from the seed by the JAX
pipeline's own split sequence. fp32, whole models at 2e-4. The weights are
the port's seeded ones, given to JAX by the JAX package's converters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videosys_tpu
import videosys_tpu_torch
from videosys_tpu.core.pab import PABStepPlan as JPlan
from videosys_tpu.models.autoencoders import autoencoder_open_sora as JA
from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JKL
from videosys_tpu.models.autoencoders.vae_temporal import VAETemporal as JT
from videosys_tpu.models.transformers.stdit3 import STDiT3 as JSTDiT3
from videosys_tpu.models.transformers.stdit3 import STDiT3Config as JCfg
from videosys_tpu.pipelines.open_sora import mask_strategy as jms
from videosys_tpu.utils.convert import (
    convert_stdit3,
    convert_vae2d,
    convert_vae_temporal,
)
from videosys_tpu_torch.core.pab import PABStepPlan as PPlan
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as PA
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D as PKL
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal as PT
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config as PCfg
from videosys_tpu_torch.pipelines.open_sora import mask_strategy as pms
from videosys_tpu_torch.utils.from_jax import open_sora_vae_from_jax, stdit3_from_jax

TOL = 2e-4
SIZES = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8, patch_size=(1, 2, 2))
SPATIAL = dict(block_out_channels=(8, 16), layers_per_block=1, num_groups=4)
# the pipelines' VAE: 8x space, so that 144p gives a 12 x 12 token grid
PIPE_SPATIAL = dict(SPATIAL, block_out_channels=(8, 8, 8, 16))
TEMPORAL = dict(filters=8, num_res_blocks=1, num_groups=4)
STEPS = 3  # sampling steps of the tiny pipelines


def channel_last_normal(key, shape):
    """JAX's draw for a port tensor of `shape` [N, C, *rest]: the VAE draws
    channel-last, so draw [N, *rest, C] and move the channel axis."""
    n = np.array(jax.random.normal(key, (shape[0],) + shape[2:] + (shape[1],)))
    return torch.from_numpy(np.moveaxis(n, -1, 1))


def encode_noise(key):
    """The draws of JAX's OpenSoraVAE.encode(params, x, key) by the port's
    names: r1, r2 = split(key); spatial from r1, chunk i from
    fold_in(r2, i)."""
    r1, r2 = jax.random.split(key)

    def noise(name, shape):
        if name == "spatial":
            return channel_last_normal(r1, shape)
        i = int(name.split("/")[1])
        return channel_last_normal(jax.random.fold_in(r2, i), shape)
    return noise


def vaes(attention, spatial=SPATIAL):
    jv = JA.OpenSoraVAE(JA.OpenSoraVAEConfig(micro_frame_size=17,
                                             micro_batch_size=4),
                        spatial=JKL(mid_block_add_attention=attention, **spatial),
                        temporal=JT(**TEMPORAL))
    torch.manual_seed(0)
    pv = PA.OpenSoraVAE(PA.OpenSoraVAEConfig(micro_frame_size=17,
                                             micro_batch_size=4),
                        spatial=PKL(mid_block_add_attention=attention, **spatial),
                        temporal=PT(**TEMPORAL))
    return jv, pv.eval()


def state(module) -> dict:
    return {k: v.numpy() for k, v in module.state_dict().items()}


def vae_params(sd: dict, spatial=SPATIAL) -> dict:
    """A port VAE state_dict as the JAX VAE's params (the JAX package's
    converters); from_jax carries them back unchanged."""
    part = {p: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
            for p in ("spatial_vae.module.", "temporal_vae.")}
    params = {"spatial": convert_vae2d(part["spatial_vae.module."],
                                       len(spatial["block_out_channels"])),
              "temporal": convert_vae_temporal(part["temporal_vae."], 4, 1)}
    assert_same(open_sora_vae_from_jax(params), sd)
    return params


def assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k])


@pytest.fixture(scope="module")
def vae_pair():
    """The tiny VAE with its mid attention, JAX and port, the same (the
    port's seeded) weights: JAX compiles no init program."""
    jv, pv = vaes(True)
    return jv, vae_params(state(pv)), pv


def test_encode_matches_jax(vae_pair):
    """Encoder2D (moments), EncoderTemporal (encode_moments) and the whole
    OpenSoraVAE.encode (18 frames: two temporal chunks, the second of one
    frame) given JAX's noises; the weights come through from_jax."""
    jv, params, pv = vae_pair
    num_frames = 18
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (1, 3, num_frames, 16, 24)).astype(np.float32)
    frames = np.moveaxis(x[0], 0, -1)  # [T, H, W, 3]
    want = np.asarray(jv.spatial.apply(params["spatial"], jnp.asarray(frames),
                                       method="encode"))
    with torch.no_grad():
        got = pv.spatial_vae.module.encode(torch.from_numpy(x[0]).transpose(0, 1))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 1),
                               atol=TOL, rtol=TOL)

    lat = rng.standard_normal((1, 4, 7, 8, 12)).astype(np.float32)
    jm, jl = jv.temporal.apply(params["temporal"],
                               jnp.asarray(np.moveaxis(lat, 1, -1)),
                               method="encode_moments")
    with torch.no_grad():
        pm, pl = pv.temporal_vae.encode_moments(torch.from_numpy(lat))
    for g, w in ((pm, jm), (pl, jl)):
        assert g.shape == (1, 4, 2, 8, 12)  # 7 frames front-padded to 8
        np.testing.assert_allclose(g.numpy(), np.moveaxis(np.asarray(w), -1, 1),
                                   atol=TOL, rtol=TOL)

    key = jax.random.key(3)
    want = np.asarray(jv.encode(params, jnp.asarray(x), key))
    got = pv.encode(torch.from_numpy(x), encode_noise(key)).numpy()
    assert got.shape == want.shape == (
        1, 4, pv.get_latent_size((num_frames, 16, 24))[0], 8, 12)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_vae_state_dict_round_trip(vae_pair):
    """The port's whole VAE state_dict, encoders included, carries the
    reference checkpoint's key names: the JAX package's converters read
    every key into the params the JAX VAE runs on, and from_jax turns those
    back into the state_dict."""
    _, params, pv = vae_pair
    sd = state(pv)
    back = vae_params(sd)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))
    assert_same(open_sora_vae_from_jax(back), sd)


@pytest.mark.parametrize("strategy,loop_i,align", [
    ("0,0,0,0,3,0.25", 0, None),
    ("1,0,0,0,3,0", 0, None),               # another loop's group
    ("0,0,0,0,2,0.3;1,1,-5,0,5,0", 1, None),
    ("0,1,-3,-4,2,0.5", 0, None),            # negative starts
    ("0,0,-2,7,4,0", 0, None),               # clipped to the target's end
    ("0,1,3,2,3,0.1", 0, 5),                 # align snaps both starts
    ("0,1,-4,8,2,0", 0, 5),
    ("0", 0, 5),
    ("", 0, None),
])
def test_mask_strategy_equals_jax(strategy, loop_i, align):
    assert pms.parse_mask_strategy(strategy) == jms.parse_mask_strategy(strategy)
    for value, point, max_value in ((7, 5, 20), (8, 5, 20), (13, 5, 15),
                                    (3, 5, 10), (0, 5, 1)):
        assert pms.find_nearest_point(value, point, max_value) == \
            jms.find_nearest_point(value, point, max_value)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 4, 10, 2, 2)).astype(np.float32)
    refs = [[rng.standard_normal((4, n, 2, 2)).astype(np.float32)
             for n in (6, 9)] for _ in range(2)]
    strategies = [strategy, "0,1,1,5,3,0.5"]
    wz, wm = jms.apply_mask_strategy(z, refs, strategies, loop_i, align=align)
    gz, gm = pms.apply_mask_strategy(
        torch.from_numpy(z), [[torch.from_numpy(r) for r in rr] for rr in refs],
        strategies, loop_i, align=align)
    np.testing.assert_array_equal(gz.numpy(), wz)
    assert (gm is None) == (wm is None)
    if wm is not None:
        np.testing.assert_array_equal(gm.numpy(), wm)
    assert pms.dframe_to_frame(5) == jms.dframe_to_frame(5) == 17


def test_append_generated_equals_jax(vae_pair):
    jv, params, pv = vae_pair
    clip = np.random.default_rng(3).uniform(-1, 1, (1, 3, 18, 16, 24)
                                            ).astype(np.float32)
    key = jax.random.key(5)
    ref0 = np.ones((4, 5, 8, 12), np.float32)
    wr, ws = jms.append_generated(jv, params, jnp.asarray(clip), [[ref0]],
                                  ["0,0,0,0,1,0.5"], 1, 5, 0.25, key)
    gr, gs = pms.append_generated(pv, torch.from_numpy(clip),
                                  [[torch.from_numpy(ref0)]], ["0,0,0,0,1,0.5"],
                                  1, 5, 0.25, encode_noise(key))
    assert gs == ws == ["0,0,0,0,1,0.5;1,1,-5,0,5,0.25"]
    assert len(gr[0]) == len(wr[0]) == 2
    assert gr[0][1].shape == (4, 6, 8, 12)
    np.testing.assert_allclose(gr[0][1].numpy(), wr[0][1], atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def engines():
    """The tiny pipelines on the same (the port's seeded) weights."""
    jvae, pvae = vaes(False, PIPE_SPATIAL)
    pcfg = videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None, num_sampling_steps=STEPS,
        dtype="fp32", transformer_config=PCfg(**SIZES))
    peng = videosys_tpu_torch.VideoSysEngine(pcfg, vae=pvae, device="cpu")
    peng.pipeline.keep_latents = True
    sd = state(peng.pipeline.transformer)
    params = {"transformer": convert_stdit3(sd, SIZES["depth"]),
              "vae": vae_params(state(peng.pipeline.vae), PIPE_SPATIAL)}
    assert_same(stdit3_from_jax(params["transformer"]), sd)
    jcfg = videosys_tpu.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None, num_sampling_steps=STEPS,
        dtype="fp32", transformer_config=JCfg(**SIZES))
    jpipe = videosys_tpu.OpenSoraPipeline(jcfg, vae=jvae, params=params)
    jpipe.keep_latents = True
    return jpipe, peng


@pytest.mark.parametrize("with_pab", [False, True])
def test_masked_step_matches_jax(engines, with_pab):
    """Two masked steps on the same (z, mask, noise_added, noise): frames
    past their edit threshold are noised once, the others stay clamped.
    With PAB the first step writes the cache and the second reads it."""
    jpipe, peng = engines
    pipe = peng.pipeline
    Bz, T, h, w, L = 2, 5, 8, 8, 8
    rng = np.random.default_rng(4)
    z = rng.standard_normal((Bz, 4, T, h, w)).astype(np.float32)
    y_all = rng.standard_normal((2 * Bz, L, 16)).astype(np.float32)
    kv_all = np.tile(np.arange(L)[None] < np.array([[5], [8]]), (2, 1))
    mask = np.array([[0.0, 0.3, 1.0, 0.75, 0.5],
                     [1.0, 1.0, 0.6, 0.0, 0.71]], np.float32)
    fps = np.full((Bz,), 24.0, np.float32)
    pab = dict(spatial_broadcast=True, spatial_threshold=(100, 900),
               cross_broadcast=True, cross_threshold=(100, 900))
    steps = [(JPlan(), PPlan())] * 2
    jcache = cache = None
    if with_pab:
        steps = [(JPlan(save_spatial=True, save_cross=True),
                  PPlan(save_spatial=True, save_cross=True)),
                 (JPlan(spatial=True, cross=True), PPlan(spatial=True, cross=True))]
        jpab = videosys_tpu.OpenSoraPABConfig(**pab)
        jcache = JSTDiT3(JCfg(**SIZES), pab_config=jpab).init_cache(2 * Bz, T, 16)
        cache = pipe.transformer.init_cache(
            videosys_tpu_torch.OpenSoraPABConfig(**pab), 2 * Bz, T, 16)
    jpipe._config.enable_pab = with_pab
    jpipe._config.pab_config = videosys_tpu.OpenSoraPABConfig(**pab)
    jpipe._step_fns = {}
    jz, jadded = jnp.asarray(z), jnp.asarray(mask >= 1.0)
    pz, padded = torch.from_numpy(z), torch.from_numpy(mask >= 1.0)
    for i, ((jplan, pplan), t) in enumerate(zip(steps, (640.0, 450.0))):
        nkey = jax.random.key(10 + i)
        eps = np.array(jax.random.normal(nkey, z.shape, jnp.float32))
        fn = jpipe._get_masked_step_fn(jplan, 64.0, 64.0, 7.0)
        jz, jcache, jadded = fn(jpipe.params["transformer"], jz, t, 0.13,
                                jnp.asarray(y_all), jnp.asarray(kv_all),
                                jnp.asarray(fps), jcache, jnp.asarray(mask),
                                jadded, nkey)
        with torch.no_grad():
            pz, padded = pipe._masked_step(
                pz, t, 0.13, torch.from_numpy(y_all), torch.from_numpy(kv_all),
                torch.from_numpy(fps), 64.0, 64.0, 7.0, torch.from_numpy(mask),
                padded, torch.from_numpy(eps), plan=pplan, cache=cache)
        np.testing.assert_array_equal(padded.numpy(), np.asarray(jadded))
        np.testing.assert_allclose(pz.numpy(), np.asarray(jz), atol=TOL, rtol=TOL)
    # frames that never passed their threshold are the input's
    frozen = mask * 1000.0 < 450.0
    np.testing.assert_array_equal(pz.numpy()[frozen[:, None].repeat(4, 1)],
                                  z[frozen[:, None].repeat(4, 1)])


class JaxDraws:
    """The JAX pipeline's draws for one prompt, by the port's names:
    rng = key(seed); the reference's encode key, then per loop the loop
    encode's key (loop > 0), the initial noise, and one key a masked step,
    each split off rng in that order."""

    def __init__(self, seed, shape, steps, loop=1, reference=False):
        self.shape, keys, rng = shape, {}, jax.random.key(seed)
        if reference:
            rng, keys["reference"] = jax.random.split(rng)
        for loop_i in range(loop):
            if loop_i > 0:
                rng, keys[f"loop{loop_i}"] = jax.random.split(rng)
            rng, keys[f"latents/{loop_i}"] = jax.random.split(rng)
            if reference or loop_i > 0:
                for i in range(steps):
                    rng, keys[f"mask/{loop_i}/{i}"] = jax.random.split(rng)
        self.keys, self.loop = keys, loop

    def latents(self):
        return [torch.from_numpy(np.array(jax.random.normal(
            self.keys[f"latents/{i}"], self.shape, jnp.float32)))
            for i in range(self.loop)]

    def __call__(self, name, shape):
        if name.startswith("mask/"):
            return torch.from_numpy(np.array(jax.random.normal(
                self.keys[name], shape, jnp.float32)))
        prefix, _, rest = name.partition("/")
        return encode_noise(self.keys[prefix])(rest, shape)


@pytest.mark.parametrize("case", ["reference", "loop2"])
def test_conditioned_generate_matches_jax(engines, case):
    """A generate conditioned on a pixel-array reference (mask strategy
    "0": latent frame 0 frozen) and a loop=2 generate (the second clip
    conditioned on the first's last 5 latent frames), both fed JAX's draws:
    the last loop's latents at 2e-4, the video within one level."""
    jpipe, peng = engines
    jpipe._config.enable_pab = peng.pipeline._config.enable_pab = False
    jpipe._step_fns = {}
    seed = 6
    kw = dict(resolution="144p", aspect_ratio="1:1", num_frames=17, seed=seed)
    if case == "reference":
        kw.update(reference=np.random.default_rng(7).uniform(
            -1, 1, (3, 1, 192, 192)).astype(np.float32), mask_strategy="0")
    else:
        kw.update(loop=2, condition_frame_length=5)
    want = jpipe.generate("a moving square", **kw).video
    t_lat, h, w = peng.pipeline.vae.get_latent_size((17, 192, 192))
    draws = JaxDraws(seed, (1, 4, t_lat, h, w), STEPS, kw.get("loop", 1),
                     case == "reference")
    got = peng.generate("a moving square", latents=draws.latents(),
                        noise=draws, **kw).video
    np.testing.assert_allclose(peng.pipeline.last_latents, jpipe.last_latents,
                               atol=TOL, rtol=TOL)
    # loop 2 adds its 17 frames less the 17 of its 5 condition latents
    assert got.shape == want.shape == (1, 17, 192, 192, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert set(peng.pipeline.last_timings) == {
        "text", "denoise", "vae", "postprocess"}


def test_path_reference_raises(engines):
    _, peng = engines
    with pytest.raises(NotImplementedError, match="_resize_crop"):
        peng.generate("x", resolution="144p", aspect_ratio="1:1",
                      num_frames=17, seed=0, reference="frame.png")

"""The PyTorch port's Open-Sora slice against the JAX package: the rflow
ladders, the stub text encoder, text-KV bucketing, the whole tiny
`VideoSysEngine.generate` (same params via from_jax, same initial noise),
the copied framework-free files, and the port's import isolation."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videosys_tpu
import videosys_tpu.pipelines.open_sora.data_process as j_data
import videosys_tpu.utils.video as j_video
import videosys_tpu_torch
import videosys_tpu_torch.pipelines.open_sora.data_process as p_data
import videosys_tpu_torch.utils.video as p_video
from videosys_tpu.models.autoencoders import autoencoder_open_sora as JA
from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JKL
from videosys_tpu.models.autoencoders.vae_temporal import VAETemporal as JT
from videosys_tpu.models.text_encoders.t5 import StubTextEncoder as JStub
from videosys_tpu.models.transformers.stdit3 import STDiT3Config as JCfg
from videosys_tpu.pipelines.common import bucket_text_kv as j_bucket
from videosys_tpu.schedulers import rflow as jr
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as PA
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D as PKL
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal as PT
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder as PStub
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config as PCfg
from videosys_tpu_torch.pipelines.common import bucket_text_kv as p_bucket
from videosys_tpu_torch.schedulers import rflow as pr
from videosys_tpu_torch.utils.from_jax import open_sora_vae_from_jax, stdit3_from_jax

TOL = 2e-4
SIZES = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8, patch_size=(1, 2, 2))
SPATIAL = dict(mid_block_add_attention=False, block_out_channels=(8, 16),
               layers_per_block=1, num_groups=4)
TEMPORAL = dict(filters=8, num_res_blocks=1, num_groups=4)


@pytest.mark.parametrize("res,ar,frames", [("480p", "9:16", 51),
                                           ("144p", "1:1", 1),
                                           ("720p", "16:9", 102)])
def test_rflow_ladders_and_cfg(res, ar, frames):
    h, w = p_data.get_image_size(res, ar)
    js = jr.RFlowScheduler(jr.RFlowConfig(num_sampling_steps=30))
    ps = pr.RFlowScheduler(pr.RFlowConfig(num_sampling_steps=30))
    ts = ps.prepare_timesteps(h, w, frames)
    np.testing.assert_array_equal(ts, js.prepare_timesteps(h, w, frames))
    np.testing.assert_array_equal(ps.prepare_dts(ts), js.prepare_dts(ts))
    rng = np.random.default_rng(0)
    a, b, z = (rng.standard_normal((2, 4, 3, 5, 5)).astype(np.float32)
               for _ in range(3))
    v = ps.apply_cfg(torch.from_numpy(a), torch.from_numpy(b), 7.0)
    np.testing.assert_array_equal(
        v.numpy(), np.asarray(js.apply_cfg(jnp.asarray(a), jnp.asarray(b), 7.0)))
    np.testing.assert_array_equal(
        ps.step(torch.from_numpy(z), v, ts[3] / 1000).numpy(),
        np.asarray(js.step(jnp.asarray(z), jnp.asarray(v.numpy()), ts[3] / 1000)))


def test_stub_encoder_and_bucketing_bit_equal():
    texts = ["a red square aesthetic score: 6.5.", "", "waves " * 80]
    for L in (8, 300):
        jy, jm = JStub(16, L).encode(texts)
        py, pm = PStub(16, L, device="cpu").encode(texts)
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        jy2, jm2, jl = j_bucket(jy, jm, L)
        py2, pm2, pl = p_bucket(py, pm, L)
        assert pl == jl
        np.testing.assert_array_equal(py2.numpy(), np.asarray(jy2))
        np.testing.assert_array_equal(pm2.numpy(), np.asarray(jm2))
    short = PStub(16, 300, device="cpu").encode(["one two"])
    assert p_bucket(*short, 300)[2] == 64


@pytest.fixture(scope="module")
def engines():
    jcfg = videosys_tpu.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None, num_sampling_steps=4,
        dtype="fp32", transformer_config=JCfg(**SIZES))
    jvae = JA.OpenSoraVAE(JA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=4),
                          spatial=JKL(**SPATIAL), temporal=JT(**TEMPORAL))
    # the JAX pipeline that videosys_tpu.VideoSysEngine(jcfg, vae=jvae) wraps
    jpipe = videosys_tpu.OpenSoraPipeline(jcfg, vae=jvae)
    jpipe.keep_latents = True
    jparams = jpipe.params

    pcfg = videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None, num_sampling_steps=4,
        dtype="fp32", transformer_config=PCfg(**SIZES))
    pvae = PA.OpenSoraVAE(PA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=4),
                          spatial=PKL(**SPATIAL), temporal=PT(**TEMPORAL))
    peng = videosys_tpu_torch.VideoSysEngine(
        pcfg, vae=pvae, device="cpu",
        params={"transformer": stdit3_from_jax(jparams["transformer"]),
                "vae": open_sora_vae_from_jax(jparams["vae"])})
    peng.pipeline.keep_latents = True
    return jpipe, peng


@pytest.mark.parametrize("num_frames", [1, 18])
def test_generate_matches_jax(engines, num_frames):
    jpipe, peng = engines
    seed = 3
    kw = dict(resolution="144p", aspect_ratio="1:1", num_frames=num_frames,
              seed=seed)
    want = jpipe.generate("waves at dusk", **kw).video
    # the JAX pipeline's draw: split the per-prompt key once, normal(f32)
    t_lat, h, w = peng.pipeline.vae.get_latent_size((num_frames, 192, 192))
    _, zk = jax.random.split(jax.random.key(seed))
    z = np.array(jax.random.normal(zk, (1, 4, t_lat, h, w), jnp.float32))
    got = peng.generate("waves at dusk", latents=torch.from_numpy(z), **kw).video
    np.testing.assert_allclose(peng.pipeline.last_latents,
                               jpipe.last_latents,
                               atol=TOL, rtol=TOL)
    assert got.shape == want.shape == (1, num_frames, 192, 192, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert set(peng.pipeline.last_timings) == {
        "text", "denoise", "vae", "postprocess"}


def test_generate_draws_seeded_noise(engines):
    _, peng = engines
    kw = dict(resolution="144p", aspect_ratio="1:1", num_frames=1)
    a = peng.generate(["x", "y"], seed=5, **kw).video
    b = peng.generate("y", seed=6, **kw).video
    # batch-size-dependent reduction order may move a pixel by one level
    assert np.abs(a[1:].astype(int) - b.astype(int)).max() <= 1


def test_unported_options_raise():
    # PAB is served; a cache dtype torch has no type for raises at config time
    assert videosys_tpu_torch.OpenSoraConfig(enable_pab=True).enable_pab
    with pytest.raises(ValueError, match="float8_e4m3"):
        videosys_tpu_torch.OpenSoraConfig(
            enable_pab=True, pab_config=videosys_tpu_torch.OpenSoraPABConfig(
                cache_dtype="float8_e4m3"))
    cfg = videosys_tpu_torch.OpenSoraConfig(transformer=None, vae=None,
                                            text_encoder=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            videosys_tpu_torch.OpenSoraPipeline(cfg)


@pytest.mark.parametrize("mod_j,mod_p,extra", [
    (j_data, p_data, "resolution_data.json"),
    (j_video, p_video, None),
])
def test_copies_equal_originals(mod_j, mod_p, extra):
    fj, fp = Path(mod_j.__file__), Path(mod_p.__file__)
    assert fp.read_bytes() == fj.read_bytes()
    if extra:
        assert (fp.parent / extra).read_bytes() == (fj.parent / extra).read_bytes()


def test_port_imports_no_jax():
    """The port imports no JAX and nothing of the JAX package; the modules
    that read weights import neither transformers nor safetensors, so the
    port runs where neither is installed."""
    code = ("import sys, videosys_tpu_torch, videosys_tpu_torch.utils.from_jax,"
            " videosys_tpu_torch.training.train, videosys_tpu_torch.training.ckpt,"
            " videosys_tpu_torch.training.datasets, videosys_tpu_torch.core.pab,"
            " videosys_tpu_torch.pipelines.open_sora.mask_strategy,"
            " videosys_tpu_torch.models.autoencoders.vae2d,"
            " videosys_tpu_torch.models.autoencoders.vae_temporal,"
            " videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox,"
            " videosys_tpu_torch.models.transformers.cogvideox,"
            " videosys_tpu_torch.pipelines.cogvideox.pipeline_cogvideox,"
            " videosys_tpu_torch.schedulers.ddim,"
            " videosys_tpu_torch.schedulers.dpm_cogvideox,"
            " videosys_tpu_torch.models.transformers.latte,"
            " videosys_tpu_torch.models.transformers.open_sora_plan_v110,"
            " videosys_tpu_torch.models.transformers.open_sora_plan_v120,"
            " videosys_tpu_torch.models.autoencoders.autoencoder_causal_vae,"
            " videosys_tpu_torch.pipelines.latte.pipeline_latte,"
            " videosys_tpu_torch.pipelines.open_sora_plan.pipeline_open_sora_plan,"
            " videosys_tpu_torch.schedulers.pndm,"
            " videosys_tpu_torch.schedulers.euler_ancestral,"
            " videosys_tpu_torch.models.text_encoders.t5,"
            " videosys_tpu_torch.models.text_encoders.clip,"
            " videosys_tpu_torch.models.transformers.vchitect,"
            " videosys_tpu_torch.pipelines.vchitect.pipeline_vchitect,"
            " videosys_tpu_torch.schedulers.flow_match_euler,"
            " videosys_tpu_torch.eval.metrics, videosys_tpu_torch.eval.pab_eval,"
            " videosys_tpu_torch.eval.batch_eval,"
            " videosys_tpu_torch.utils.checkpoint,"
            " videosys_tpu_torch.utils.safetensors_io;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'videosys_tpu',"
            " 'transformers', 'safetensors', 'tokenizers')];"
            "assert not bad, bad")
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True)

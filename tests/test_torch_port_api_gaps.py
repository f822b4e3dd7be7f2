"""The parts of the JAX package's public API that the PyTorch port gained
last, each against its JAX counterpart on the CPU (fp32, inputs from a
numpy seed): CogVideoX's VAE `encode` and its posterior moments (13 and 9
frames: the first frame kept apart by each temporal downsampling), the
diffusers schedulers' `add_noise`, `save_video` on every pipeline class, a
VAE supplied through the config, `profile_trace`,
`load_stdit3_torch_checkpoint` and the top-level `ParallelConfig`."""

import os

import imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videosys_tpu
import videosys_tpu_torch
from videosys_tpu.models.autoencoders import autoencoder_cogvideox as JC
from videosys_tpu.pipelines.cogvideox import pipeline_cogvideox as JPC
from videosys_tpu.pipelines.latte import pipeline_latte as JPL
from videosys_tpu.pipelines.open_sora import pipeline_open_sora as JPO
from videosys_tpu.pipelines.open_sora_plan import pipeline_open_sora_plan as JPP
from videosys_tpu.pipelines.vchitect import pipeline_vchitect as JPV
from videosys_tpu.schedulers import ddim as jddim
from videosys_tpu.schedulers import euler_ancestral as jea
from videosys_tpu.schedulers import pndm as jpndm
from videosys_tpu.utils import checkpoint as jckpt
from videosys_tpu.utils.convert import convert_cogvideox_vae, convert_stdit3
from videosys_tpu_torch.core import parallel as ppar
from videosys_tpu_torch.models.autoencoders import autoencoder_causal_vae as PCV
from videosys_tpu_torch.models.autoencoders import autoencoder_cogvideox as PC
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
from videosys_tpu_torch.models.transformers import open_sora_plan_v120 as P120
from videosys_tpu_torch.models.transformers.latte import LatteConfig as PLatte
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3, STDiT3Config
from videosys_tpu_torch.models.transformers.vchitect import VchitectModelConfig
from videosys_tpu_torch.schedulers import ddim as pddim
from videosys_tpu_torch.schedulers import euler_ancestral as pea
from videosys_tpu_torch.schedulers import pndm as ppndm
from videosys_tpu_torch.utils import checkpoint as pckpt
from videosys_tpu_torch.utils.safetensors_io import save_file
from videosys_tpu_torch.utils.timing import profile_trace

TOL = 2e-4  # whole models, relative L2 (tests/test_torch_parity.py:72)
NOISE_TOL = 1e-6  # add_noise, relative to the largest magnitude
# tests/test_torch_port_cogvideox_vae.py's tiny VAE
COG_VAE = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
               layers_per_block=1, norm_num_groups=4)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def cog_vaes():
    """The JAX VAE, its params, and the port's VAE holding the same
    weights: the port's seeded weights, moved off the identity norms, as
    JAX params by the JAX package's converter and back by from_jax."""
    from videosys_tpu_torch.utils.from_jax import cogvideox_vae_from_jax

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    pv = PC.AutoencoderKLCogVideoX(PC.CogVideoXVAEConfig(**COG_VAE)).eval()
    sd = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in pv.state_dict().items()}
    params = convert_cogvideox_vae(sd, len(COG_VAE["block_out_channels"]),
                                   COG_VAE["layers_per_block"])
    pv.load_state_dict({k: torch.from_numpy(v) for k, v in
                        cogvideox_vae_from_jax(params).items()}, strict=True)
    return JC.AutoencoderKLCogVideoX(JC.CogVideoXVAEConfig(**COG_VAE)), \
        params, pv


@pytest.mark.parametrize("frames,latent_frames", [(13, 4), (9, 3)])
def test_cogvideox_encode_like_jax(cog_vaes, frames, latent_frames):
    """The moments equal JAX's encoder's, and the sample equals JAX's
    `encode` when the port is given JAX's noise (drawn channel-last)."""
    jv, params, pv = cog_vaes
    x = np.random.default_rng(frames).uniform(
        -1, 1, (1, 3, frames, 32, 32)).astype(np.float32)
    noise_shape = (1, latent_frames, 4, 4, COG_VAE["latent_channels"])
    rng = jax.random.key(frames)
    want = np.asarray(jv.encode(params, jnp.asarray(x), rng))
    moments = jax.jit(jv.encoder.apply)(
        params["encoder"], jnp.transpose(jnp.asarray(x), (0, 2, 3, 4, 1)))
    j_mean, j_logvar = (np.moveaxis(np.asarray(m), -1, 1)
                        for m in jnp.split(moments, 2, axis=-1))
    # JAX's draw in encode: normal(rng, mean.shape), channel-last
    noise = np.moveaxis(np.array(jax.random.normal(rng, noise_shape)), -1, 1)
    with torch.no_grad():
        mean, logvar = (t.numpy() for t in pv.moments(torch.from_numpy(x)))
        got = pv.encode(torch.from_numpy(x), torch.from_numpy(noise)).numpy()
    shape = (1, COG_VAE["latent_channels"], latent_frames, 4, 4)
    assert mean.shape == logvar.shape == got.shape == want.shape == shape
    assert rel_l2(mean, j_mean) <= TOL
    assert rel_l2(logvar, np.clip(j_logvar, -30.0, 20.0)) <= TOL
    assert rel_l2(got, want) <= TOL


def test_cogvideox_encode_draws_from_its_generator(cog_vaes):
    """Without noise the sample is drawn from the generator given (the
    same seed gives the same latent); with neither, encode raises."""
    _, _, pv = cog_vaes
    x = torch.rand(1, 3, 5, 16, 16) * 2 - 1
    with torch.no_grad():
        a, b = (pv.encode(x, generator=torch.Generator().manual_seed(3))
                for _ in range(2))
        mean, _ = pv.moments(x)
        with pytest.raises(ValueError, match="generator"):
            pv.encode(x)
    assert torch.equal(a, b) and not torch.equal(a, mean)


def ddim_pair(**cfg):
    return (jddim.DDIMScheduler(jddim.DDIMConfig(**cfg)),
            pddim.DDIMScheduler(pddim.DDIMConfig(**cfg)))


def euler_pair():
    j, p = jea.EulerAncestralScheduler(), pea.EulerAncestralScheduler()
    j.set_timesteps(50)
    p.set_timesteps(50)
    return j, p


# each scheduler pair with a scalar and a batch of timesteps (step indices
# for Euler-Ancestral): the last training step, and Euler's first index,
# last step and final sigma (0)
SCHEDULERS = {
    "ddim": (ddim_pair, 999, [0, 500, 999]),
    # CogVideoX's: the SNR shift and the zero-SNR last step
    "ddim_cogvideox": (lambda: ddim_pair(
        beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
        snr_shift_scale=3.0, rescale_betas_zero_snr=True), 999, [0, 500, 999]),
    "pndm": (lambda: (jpndm.PNDMScheduler(), ppndm.PNDMScheduler()), 999,
             [0, 1, 999]),
    "euler_ancestral": (euler_pair, 0, [0, 49, 50]),
}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_add_noise_like_jax(name, batched):
    make, scalar, batch = SCHEDULERS[name]
    js, ps = make()
    t = batch if batched else scalar
    rng = np.random.default_rng(4)
    B = len(t) if batched else 2
    x0, eps = (rng.standard_normal((B, 4, 3, 8, 8)).astype(np.float32)
               for _ in range(2))
    want = np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(eps),
                                   np.asarray(t)))
    got = ps.add_noise(torch.from_numpy(x0), torch.from_numpy(eps),
                       torch.as_tensor(t))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=NOISE_TOL,
                               atol=NOISE_TOL * np.abs(want).max())


def read_video(path):
    """(frame count, frames per second) of a written video."""
    frames = imageio.mimread(path)
    meta = imageio.get_reader(path).get_meta_data()
    fps = meta["fps"] if "fps" in meta else 1000.0 / meta["duration"]
    return len(frames), round(fps, 3)


@pytest.mark.parametrize("port,jax_cls", [
    (videosys_tpu_torch.OpenSoraPipeline, JPO.OpenSoraPipeline),
    (videosys_tpu_torch.CogVideoXPipeline, JPC.CogVideoXPipeline),
    (videosys_tpu_torch.LattePipeline, JPL.LattePipeline),
    (videosys_tpu_torch.OpenSoraPlanPipeline, JPP.OpenSoraPlanPipeline),
    (videosys_tpu_torch.VchitectXLPipeline, JPV.VchitectXLPipeline)],
    ids=lambda c: c.__name__)
def test_save_video_like_jax(tmp_path, port, jax_cls):
    """Each family's pipeline class writes `generate`'s video as JAX's does:
    the same file, frame count and default fps (Latte and Vchitect 8, the
    others 24). Open-Sora v1.2 and v1.1 share OpenSoraPlanPipeline."""
    video = np.random.default_rng(5).integers(
        0, 256, (1, 6, 16, 24, 3), dtype=np.uint8)
    got = port.save_video(object.__new__(port), video,
                          str(tmp_path / "port" / "clip"))
    want = jax_cls.save_video(object.__new__(jax_cls), video,
                              str(tmp_path / "jax" / "clip"))
    assert os.path.basename(got) == os.path.basename(want)
    assert read_video(got) == read_video(want)
    assert read_video(got)[0] == 6


def latte_pipeline(vae=None, config_vae=None):
    return videosys_tpu_torch.LattePipeline(videosys_tpu_torch.LatteConfig(
        model_path=None, dtype="fp32", vae=config_vae,
        transformer_config=PLatte(num_layers=2, num_heads=2, head_dim=16,
                                  caption_channels=16, video_length=4,
                                  sample_size=8)), vae=vae, device="cpu")


OSP_VAE = dict(hidden_size=8, hidden_size_mult=(1, 2), num_res_blocks=1,
               encoder_resnet_blocks=("ResnetBlock3D",) * 2,
               encoder_spatial_downsample=("SpatialDownsample2x", ""),
               encoder_temporal_downsample=("TimeDownsample2x", ""),
               decoder_resnet_blocks=("ResnetBlock3D",) * 2,
               decoder_spatial_upsample=("", "SpatialUpsample2x"),
               decoder_temporal_upsample=("", "TimeUpsample2x"))
OSP_T = dict(num_layers=2, num_heads=2, head_dim=24, caption_channels=32)


def osp_pipeline(version, vae=None, config_vae=None):
    tcfg = (PLatte(sample_size=16, video_length=3, **OSP_T)
            if version == "v110" else
            P120.OpenSoraPlanV120Config(sample_size=(8, 8), sample_size_t=3,
                                        **OSP_T))
    return videosys_tpu_torch.OpenSoraPlanPipeline(
        videosys_tpu_torch.OpenSoraPlanConfig(
            version=version, dtype="fp32", vae=config_vae,
            transformer_type="65x512x512" if version == "v110" else "29x480p",
            transformer_config=tcfg), vae=vae, device="cpu")


def vchitect_pipeline(vae=None, config_vae=None):
    return videosys_tpu_torch.VchitectXLPipeline(
        videosys_tpu_torch.VchitectConfig(
            model_path=None, dtype="fp32", vae=config_vae,
            transformer_config=VchitectModelConfig(
                num_layers=3, num_heads=2, head_dim=16, joint_attention_dim=32,
                pooled_projection_dim=24, sample_size=8,
                pos_embed_max_size=12)), vae=vae, device="cpu")


def vae2d(latent_channels=4):
    return AutoencoderKL2D(latent_channels=latent_channels,
                           block_out_channels=(8, 16), layers_per_block=1,
                           num_groups=4, mid_block_add_attention=False)


FAMILIES = {
    "latte": (latte_pipeline, vae2d),
    "osp_v110": (lambda **kw: osp_pipeline("v110", **kw),
                 lambda: PCV.CausalVAE(PCV.CausalVAEConfig(**OSP_VAE), "v110")),
    "osp_v120": (lambda **kw: osp_pipeline("v120", **kw),
                 lambda: PCV.CausalVAE(PCV.CausalVAEConfig(**OSP_VAE), "v120")),
    "vchitect": (vchitect_pipeline, lambda: vae2d(16)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_vae_is_held(family):
    """The pipeline holds the VAE the config gives, itself (in the
    pipeline's dtype, on its device, without gradients); the pipeline's
    `vae=` argument comes first, as in JAX. Open-Sora-Plan switches tiling
    on a given VAE as on its own (JAX's :148-149)."""
    build, make_vae = FAMILIES[family]
    given, argument = make_vae(), make_vae()
    pipe = build(config_vae=given)
    assert pipe.vae is given
    assert not any(p.requires_grad for p in given.parameters())
    assert build(vae=argument, config_vae=given).vae is argument
    if family.startswith("osp"):
        assert given.use_tiling
        assert given.tile_overlap_factor == pipe._config.tile_overlap_factor


def test_profile_trace_writes_a_trace(tmp_path):
    """A Chrome trace file appears under logdir, also when the block
    raises; the context yields logdir."""
    logdir = str(tmp_path / "trace")
    with profile_trace(logdir) as d:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert d == logdir
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(logdir, files[0])) > 0
    with pytest.raises(RuntimeError, match="inside"):
        with profile_trace(logdir):
            raise RuntimeError("inside")
    assert len(os.listdir(logdir)) == 2


STDIT3 = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
              model_max_length=8, patch_size=(1, 2, 2))


def test_load_stdit3_torch_checkpoint_like_jax(tmp_path):
    """A reference-layout STDiT3 checkpoint written here loads back bit for
    bit; at a smaller depth both packages keep the first blocks, at a
    larger one both raise KeyError; an empty directory gives None."""
    torch.manual_seed(0)
    sd = STDiT3(STDiT3Config(**STDIT3)).state_dict()
    path = str(tmp_path / "stdit3")
    os.makedirs(path)
    save_file(sd, os.path.join(path, "model.safetensors"))
    got = pckpt.load_stdit3_torch_checkpoint(path, depth=2)
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    one = pckpt.load_stdit3_torch_checkpoint(path, depth=1)
    assert not any(k.startswith(("spatial_blocks.1.", "temporal_blocks.1."))
                   for k in one)
    assert len(one) < len(sd)
    want = jckpt.load_stdit3_torch_checkpoint(path, depth=1)
    mine = convert_stdit3({k: v.numpy() for k, v in one.items()}, depth=1)
    jax.tree.map(np.testing.assert_array_equal, mine, want)
    for load in (pckpt.load_stdit3_torch_checkpoint,
                 jckpt.load_stdit3_torch_checkpoint):
        with pytest.raises(KeyError):
            load(path, depth=3)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert pckpt.load_stdit3_torch_checkpoint(empty) is None
    assert jckpt.load_stdit3_torch_checkpoint(empty) is None


def test_parallel_config_exported():
    assert videosys_tpu_torch.ParallelConfig is ppar.ParallelConfig
    assert "ParallelConfig" in videosys_tpu_torch.__all__
    for n, cp in ((1, False), (4, False), (4, True), (8, True)):
        got = videosys_tpu_torch.ParallelConfig.from_world_size(n, cp)
        want = videosys_tpu.ParallelConfig.from_world_size(n, cp)
        assert (got.dp_size, got.cp_size, got.sp_size) == \
            (want.dp_size, want.cp_size, want.sp_size)

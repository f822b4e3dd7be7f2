"""DSP sequence parallelism and the CFG split over cp in the port: Latte-1,
Open-Sora-Plan v1.1 (LatteT2V with RoPE) and Vchitect-2.0, on gloo ranks
on the CPU.

`VideoSysEngine(config(num_gpus=2, enable_cp=...), device="cpu")` spawns
one worker; the test process is rank 0. Each world is spawned once (the
module fixture `worlds`) and serves a 4-step request fed JAX's initial
latent, dense and under PAB (read steps included). The sizes force every pad: an odd
frame count (5 or 3 latent frames, padded to 6 or 4, the pad frames masked
as keys in the temporal rows), an odd token count where the temporal
switch shards tokens (15 and 25 patches; Vchitect's S + L = 14 + 333 =
347). sp=2's dense rank 0 latents are held against the JAX pipeline under
`build_mesh(ParallelConfig(sp_size=2))` and every world's against the
port's world 1 (fp32, 2e-4 of the latents' largest magnitude); every rank's
latents are bit-equal. Vchitect's cross-attention reads frame 0's context,
which lives on sp rank 0 only: `frame0_context` holds each rank's rows
against world 1's with a context that differs per frame.

The JAX imports are inside the fixtures: the workers import this module to
find the functions `_run_workers` sends them, and need no JAX.
"""

import os

import numpy as np
import pytest
import torch

import videosys_tpu_torch
from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.pab import build_plans
from videosys_tpu_torch.models.autoencoders.autoencoder_causal_vae import (
    CausalVAEConfig as PCausalCfg,
)
from videosys_tpu_torch.models.transformers import latte as PL
from videosys_tpu_torch.models.transformers import open_sora_plan_v110 as P110
from videosys_tpu_torch.models.transformers import vchitect as PV
from videosys_tpu_torch.pipelines.vchitect import pipeline_vchitect as PPV

TOL = 2e-4
STEPS = 4
PROMPT = "a ship sailing at dawn"
# 5 latent frames (padded to 6) of 6 x 10 latents: 3 x 5 = 15 patches
LATTE = dict(num_layers=2, num_heads=2, head_dim=16, caption_channels=16,
             video_length=5, sample_size=8)
VAE2D = dict(block_out_channels=(8, 16), layers_per_block=1, num_groups=4)
LATTE_REQ = dict(num_inference_steps=STEPS, video_length=5, height=12,
                 width=20, seed=3)
# 3 latent frames (padded to 4) of 10 x 10 latents: 5 x 5 = 25 patches
V110 = dict(num_layers=2, num_heads=2, head_dim=24, caption_channels=32,
            sample_size=10, video_length=3, use_rope=True)
CAUSAL_VAE = dict(hidden_size=8, hidden_size_mult=(1, 2), num_res_blocks=1,
                  encoder_resnet_blocks=("ResnetBlock3D",) * 2,
                  encoder_spatial_downsample=("SpatialDownsample2x", ""),
                  encoder_temporal_downsample=("TimeDownsample2x", ""),
                  decoder_resnet_blocks=("ResnetBlock3D",) * 2,
                  decoder_spatial_upsample=("", "SpatialUpsample2x"),
                  decoder_temporal_upsample=("", "TimeUpsample2x"))
OSP_REQ = dict(num_inference_steps=STEPS, seed=2)
# 5 frames (padded to 6) of 4 x 14 latents: 2 x 7 = 14 patches, S + L = 347
VCHITECT = dict(num_layers=3, num_heads=2, head_dim=16, joint_attention_dim=32,
                pooled_projection_dim=24, sample_size=8, pos_embed_max_size=12)
VCH_VAE = dict(mid_block_add_attention=False, latent_channels=16,
               block_out_channels=(8, 16), layers_per_block=1, num_groups=4)
VCH_REQ = dict(num_inference_steps=STEPS, frames=5, height=8, width=28, seed=3)
# world: (family, num_gpus, enable_cp); sp=2 is also held against JAX
WORLDS = {"latte_sp2": ("latte", 2, False), "latte_cp2": ("latte", 2, True),
          "osp110_sp2": ("osp110", 2, False),
          "vchitect_sp2": ("vchitect", 2, False),
          "vchitect_cp2": ("vchitect", 2, True)}
FAMILIES = ("latte", "osp110", "vchitect")


def port_config(family: str, **kw):
    if family == "latte":
        return videosys_tpu_torch.LatteConfig(
            model_path=None, dtype="fp32",
            transformer_config=PL.LatteConfig(**LATTE), vae_config=VAE2D,
            **kw)
    if family == "osp110":
        return videosys_tpu_torch.OpenSoraPlanConfig(
            version="v110", transformer_type="65x512x512", dtype="fp32",
            enable_tiling=False,
            transformer_config=P110.OpenSoraPlanV110Config(**V110),
            vae_config=PCausalCfg(**CAUSAL_VAE), **kw)
    return videosys_tpu_torch.VchitectConfig(
        model_path=None, dtype="fp32",
        transformer_config=PV.VchitectModelConfig(**VCHITECT),
        vae_config=VCH_VAE, **kw)


REQUESTS = {"latte": LATTE_REQ, "osp110": OSP_REQ, "vchitect": VCH_REQ}


def latent_shape(family: str, pipe):
    if family == "latte":
        return pipe.latent_shape(5, 12, 20)
    if family == "osp110":
        return pipe.latent_shape()
    return pipe.latent_shape(5, 8, 28)


def as_jax_decode_input(family: str, z: np.ndarray) -> np.ndarray:
    """The port's final latents in the layout (and scaling) the JAX
    pipeline hands its VAE decode."""
    if family == "latte":  # [B*T, h, w, C]
        B, C, T, h, w = z.shape
        return np.moveaxis(np.swapaxes(z, 1, 2).reshape(B * T, C, h, w), 1, -1)
    if family == "vchitect":  # [F, h, w, C], SD3 scaling and shift
        return np.moveaxis(z[0] / PPV.VAE_SCALING + PPV.VAE_SHIFT, 1, -1)
    return z


# --- run on every rank (sent by `_run_workers`) --------------------------- #

def exchange_counts(pipeline):
    return dict(par.EXCHANGE)


def set_pab(pipeline, on: bool):
    """Switch PAB on this rank's pipeline (its own copy of the config)."""
    pipeline._config.enable_pab = on


def frame0_context(pipeline):
    """Vchitect's joint attention (spatial and cross; no temporal term) on
    this rank's 2 of 4 frames, with a context that differs per frame:
    against world 1's rows of the same frames with the broadcast of frame
    0's context, and without it (each rank's own first frame)."""
    torch.manual_seed(0)
    attn = PV.VchitectJointAttention(PV.VchitectModelConfig(
        num_layers=1, num_heads=2, head_dim=8))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 4, 6, 16), generator=gen)
    enc = torch.randn((1, 4, 5, 16), generator=gen)
    r = pipeline.groups.axis(par.SP_AXIS).rank
    mine = slice(2 * r, 2 * r + 2)
    with torch.no_grad():
        want = attn(x, enc, None)
        local = attn(x[:, mine], enc[:, mine], None)
        with par.use_groups(pipeline.groups):
            got = attn(x[:, mine], enc[:, mine], None)
    return {"rank": r,
            "err": max(float((g - w[:, mine]).abs().max())
                       for g, w in zip(got, want)),
            "err_without": max(float((g - w[:, mine]).abs().max())
                               for g, w in zip(local, want))}


# --- fixtures --------------------------------------------------------------- #

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every rank computes on one CPU thread (the ranks share this CPU;
    equal thread counts give equal rounding, so latents can be held
    bit-equal across ranks)."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"  # read by the spawned workers
    yield
    torch.set_num_threads(threads)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def jax_side(family: str, params: dict, shape):
    """The JAX pipeline under its sp=2 mesh on the port's weights (given by
    the JAX package's converters), dense (its PAB step programs would
    double this file's compile time): the input of its VAE decode (its
    final latents) and its initial latent draw."""
    import jax
    import jax.numpy as jnp

    import videosys_tpu.utils.jit as jjit
    from videosys_tpu.core import parallel as jpar
    from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JVAE
    from videosys_tpu.utils import convert

    mesh = jpar.build_mesh(jpar.ParallelConfig(sp_size=2))
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        # run the JAX VAE decode eagerly to see the latents it is given
        mp.setattr(jjit, "jit_method", lambda obj, name, static_argnums=():
                   lambda p, f: seen.append(np.asarray(f))
                   or getattr(obj, name)(p, f))
        if family == "latte":
            import videosys_tpu.pipelines.latte.pipeline_latte as JP
            from videosys_tpu.models.transformers import latte as J

            jpipe = JP.LattePipeline(JP.LatteConfig(
                model_path=None, dtype="fp32",
                transformer_config=J.LatteConfig(**LATTE)),
                vae=JVAE(**VAE2D), mesh=mesh, params={
                    "transformer": convert.convert_latte(
                        params["transformer"], depth=LATTE["num_layers"]),
                    "vae": convert.convert_vae2d(
                        params["vae"], len(VAE2D["block_out_channels"]))})
        elif family == "osp110":
            import videosys_tpu.pipelines.open_sora_plan.pipeline_open_sora_plan as JP
            from videosys_tpu.models.autoencoders.autoencoder_causal_vae import (
                CausalVAE as JCausal,
            )
            from videosys_tpu.models.autoencoders.autoencoder_causal_vae import (
                CausalVAEConfig as JCausalCfg,
            )
            from videosys_tpu.models.transformers import open_sora_plan_v110 as J

            jvae = JCausalCfg(**CAUSAL_VAE)
            jpipe = JP.OpenSoraPlanPipeline(JP.OpenSoraPlanConfig(
                version="v110", transformer_type="65x512x512", dtype="fp32",
                enable_tiling=False,
                transformer_config=J.OpenSoraPlanV110Config(**V110),
                vae=JCausal(jvae, version="v110")), mesh=mesh, params={
                    "transformer": convert.convert_latte(
                        params["transformer"], depth=V110["num_layers"]),
                    "vae": convert.convert_causal_vae(params["vae"], jvae)})
            decode = jpipe.vae.decode
            jpipe.vae.decode = lambda p, z: seen.append(np.asarray(z)) \
                or decode(p, z)
        else:
            import videosys_tpu.pipelines.vchitect.pipeline_vchitect as JP
            from videosys_tpu.models.transformers import vchitect as J

            jpipe = JP.VchitectXLPipeline(JP.VchitectConfig(
                model_path=None, dtype="fp32",
                transformer_config=J.VchitectModelConfig(**VCHITECT),
                vae=JVAE(**VCH_VAE)), mesh=mesh, params={
                    "transformer": convert.convert_vchitect(
                        params["transformer"], depth=VCHITECT["num_layers"]),
                    "vae": convert.convert_vae2d(
                        params["vae"], len(VCH_VAE["block_out_channels"]))})
        jpipe.generate(PROMPT, **REQUESTS[family])
    _, zkey = jax.random.split(jax.random.key(REQUESTS[family]["seed"]))
    return seen[0], np.array(jax.random.normal(zkey, shape, jnp.float32))


@pytest.fixture(scope="module")
def worlds():
    """Per family the port's world 1 (in this process) and the JAX
    pipeline under its sp=2 mesh (dense) on the same seeded weights; per
    world and mode (dense, PAB) every rank's latents and rank 0's video,
    fed JAX's initial latent; the frame-0 check on the Vchitect sp=2
    world's ranks."""
    out = {}
    for family in FAMILIES:
        torch.manual_seed(0)
        one = videosys_tpu_torch.VideoSysEngine(port_config(family),
                                                device="cpu")
        pipe = one.pipeline
        pipe.keep_latents = True
        params = {name: {k: v.numpy() for k, v in
                         getattr(pipe, name).state_dict().items()}
                  for name in ("transformer", "vae")}
        jax_z, z = jax_side(family, params, latent_shape(family, pipe))
        req = dict(REQUESTS[family], latents=torch.from_numpy(z))
        out[family] = dict(jax=jax_z)
        for pab in (False, True):
            set_pab(pipe, pab)
            video = one.generate(PROMPT, **req).video
            out[family, pab] = (video, pipe.last_latents)
        plans = build_plans(one.config.pab_config, np.asarray(
            pipe.scheduler.set_timesteps(STEPS), np.float32),
            pipe.model_config.depth)
        out[family]["reads"] = sum(p.spatial or p.temporal or p.cross
                                   for p in plans)
        for name, (fam, n, cp) in WORLDS.items():
            if fam != family:
                continue
            eng = videosys_tpu_torch.VideoSysEngine(
                port_config(family, num_gpus=n, enable_cp=cp), params=params,
                device="cpu")
            try:
                eng._run_workers(setattr, "keep_latents", True)
                for pab in (False, True):
                    eng._run_workers(set_pab, pab)
                    video = eng.generate(PROMPT, **req).video
                    out[name, pab] = (
                        video, eng._run_workers(getattr, "last_latents"))
                out[name] = eng._run_workers(exchange_counts)
                if name == "vchitect_sp2":
                    out["frame0"] = eng._run_workers(frame0_context)
            finally:
                eng.shutdown()
    return out


# --- tests ------------------------------------------------------------------ #

@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("pab", [False, True], ids=["dense", "pab"])
def test_world_matches_world1(worlds, world, pab):
    """Every world's latents equal world 1's within 2e-4 of their largest
    magnitude on every rank, bit for bit across ranks; rank 0 alone returns
    the video, within one level of world 1's. The PAB request read the
    cache on some steps."""
    family, n, _ = WORLDS[world]
    video, lats = worlds[world, pab]
    want_video, want = worlds[family, pab]
    assert len(lats) == n and np.isfinite(lats[0]).all()
    for lat in lats[1:]:
        np.testing.assert_array_equal(lat, lats[0])
    np.testing.assert_allclose(lats[0], want, rtol=0,
                               atol=TOL * np.abs(want).max())
    assert video.shape == want_video.shape
    assert np.abs(video.astype(int) - want_video.astype(int)).max() <= 1
    assert worlds[family]["reads"] > 0
    # sp exchanged on every rank, cp gathered the guidance halves; Vchitect's
    # cp ranks replicate its B = 1 forwards and exchange nothing
    replicated = world == "vchitect_cp2"
    assert all((e["calls"] == 0) == replicated for e in worlds[world][1:])


@pytest.mark.parametrize("family", FAMILIES)
def test_sp2_matches_jax_mesh(worlds, family):
    """sp=2 on gloo ranks against the JAX pipeline under its sp=2 mesh,
    with the frame and token pads exercised (GSPMD pads on its own)."""
    got = as_jax_decode_input(family, worlds[f"{family}_sp2", False][1][0])
    want = worlds[family]["jax"]
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_vchitect_frame0_context_reaches_every_rank(worlds):
    """Frame 0's context lives on sp rank 0 only: with its broadcast both
    ranks' rows equal world 1's; without it rank 1 would attend to its own
    first frame's context."""
    by_rank = {r["rank"]: r for r in worlds["frame0"]}
    assert set(by_rank) == {0, 1}
    for r in by_rank.values():
        assert r["err"] < 1e-5, r
    assert by_rank[0]["err_without"] < 1e-5
    assert by_rank[1]["err_without"] > 1e-2

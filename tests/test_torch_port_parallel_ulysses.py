"""Ulysses sequence parallelism in the port, CogVideoX-2b (3D sincos),
CogVideoX-5b (3D RoPE) and Open-Sora-Plan v1.2, on gloo ranks on the CPU.

`VideoSysEngine(config(num_gpus=2), device="cpu")` spawns one worker; the
test process is rank 0. Each family's world is spawned once (the module
fixture `worlds`) and serves a 4-step request fed JAX's draws, dense and
under PAB (the 4-step ladders read the cache on steps 1 and 3). The sizes force every pad: 3 heads (padded to 4
for the head all-to-all) and 45 video tokens (padded to 46, the pad masked
as keys). Rank 0's dense latents are held against the JAX pipeline under
`build_mesh(ParallelConfig(sp_size=2))` on the suite's 8-device CPU
backend, both modes' against the port's world 1 (fp32, 2e-4 of the latents'
largest magnitude); every rank's latents are bit-equal. The new collectives
are checked alone: the identity on one rank, round trips on two.

The JAX imports are inside the fixtures: the workers import this module to
find the functions and the draw objects `_run_workers` sends them, and
need no JAX.
"""

import os

import numpy as np
import pytest
import torch

import videosys_tpu_torch
from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.models.autoencoders.autoencoder_causal_vae import (
    CausalVAEConfig as PCausalCfg,
)
from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import (
    CogVideoXVAEConfig as PCogVAECfg,
)
from videosys_tpu_torch.models.transformers import cogvideox as PC
from videosys_tpu_torch.models.transformers import open_sora_plan_v120 as P12

TOL = 2e-4
STEPS = 4
PROMPT = "a dog running on the beach"
# 3 heads: padded to 4 at sp=2; 9 frames at 48 x 80 -> 3 x (3 x 5) = 45
# video tokens, padded to 46
COG = dict(num_layers=2, num_heads=3, head_dim=16, in_channels=4,
           out_channels=4, time_embed_dim=16, text_embed_dim=16,
           max_text_seq_length=8)
COG_VAE = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
               layers_per_block=1, norm_num_groups=4)
COG_REQ = dict(num_frames=9, height=48, width=80, seed=5)
# 3 latent frames of 6 x 10 -> 3 x (3 x 5) = 45 tokens; 3 heads of 24
V120 = dict(num_layers=2, num_heads=3, head_dim=24, caption_channels=32,
            sample_size=(6, 10), sample_size_t=3)
OSP_VAE = dict(hidden_size=8, hidden_size_mult=(1, 2), num_res_blocks=1,
               encoder_resnet_blocks=("ResnetBlock3D",) * 2,
               encoder_spatial_downsample=("SpatialDownsample2x", ""),
               encoder_temporal_downsample=("TimeDownsample2x", ""),
               decoder_resnet_blocks=("ResnetBlock3D",) * 2,
               decoder_spatial_upsample=("", "SpatialUpsample2x"),
               decoder_temporal_upsample=("", "TimeUpsample2x"),
               encoder_attention="AttnBlock3DFix",
               decoder_attention="AttnBlock3DFix")
FAMILIES = ("cog2b", "cog5b", "osp120")


def port_config(family: str, **kw):
    if family == "osp120":
        return videosys_tpu_torch.OpenSoraPlanConfig(
            version="v120", transformer_type="29x480p", dtype="fp32",
            enable_tiling=False,
            transformer_config=P12.OpenSoraPlanV120Config(**V120),
            vae_config=PCausalCfg(**OSP_VAE), **kw)
    rope = family == "cog5b"  # the 5b serves with DPM
    return videosys_tpu_torch.CogVideoXConfig(
        model_path="", dtype="fp32", scheduler="dpm" if rope else "ddim",
        vae_tiling=False,
        transformer_config=PC.CogVideoXConfig(
            **COG, use_rotary_positional_embeddings=rope),
        vae_config=PCogVAECfg(**COG_VAE), **kw)


def request(family: str) -> dict:
    if family == "osp120":
        return dict(num_inference_steps=STEPS, seed=2)
    return dict(COG_REQ, num_inference_steps=STEPS,
                use_dynamic_cfg=family == "cog5b")


class Draws:
    """JAX's per-step draws by name (picklable: sent to every rank)."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def __call__(self, name, shape):
        return torch.from_numpy(self.arrays[name])


# --- run on every rank (sent by `_run_workers`) --------------------------- #

def exchange_counts(pipeline):
    return dict(par.EXCHANGE)


def set_pab(pipeline, on: bool):
    """Switch PAB on this rank's pipeline (its own copy of the config)."""
    pipeline._config.enable_pab = on


def round_trips(pipeline):
    """Each new collective and its inverse on this rank's shard: equal bit
    for bit, and each shard the slice of the whole it stands for."""
    groups = pipeline.groups
    gen = torch.Generator().manual_seed(11)  # the same whole on every rank
    whole = torch.randn((2, 6, 3, 3, 4), generator=gen)  # [B, N, 3, H, D]
    text = torch.randn((2, 5, 3, 4), generator=gen)  # [B, L, H, D]
    with par.use_groups(groups):
        sp, r = par.axis_size(), groups.axis(par.SP_AXIS).rank
        mine = par.shard_tokens(whole)
        heads = par.ulysses_shard_heads(mine)
        padded = par.pad_to_multiple(whole, 3, sp)
        hp = padded.shape[3] // sp
        own = torch.full((3,), float(r))
        return {
            "tokens": torch.equal(mine, whole.chunk(sp, 1)[r]),
            "heads": torch.equal(heads, padded[:, :, :, r * hp:(r + 1) * hp]),
            "seq": torch.equal(par.ulysses_shard_seq(heads, 3), mine),
            "text": torch.equal(par.gather_heads(par.split_heads(text), 3),
                                text),
            "broadcast": torch.equal(par.broadcast(own, 0),
                                     torch.zeros(3)),
            "odd": tuple(par.shard_tokens(whole[:, :5]).shape),
            "shapes": (tuple(mine.shape), tuple(heads.shape))}


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
    double this file's compile time): its final latents in the port's
    layout,
    and its draws (the initial latent and, per step, the DPM or ancestral
    noise of its split sequence)."""
    import jax
    import jax.numpy as jnp

    from videosys_tpu.core import parallel as jpar

    mesh = jpar.build_mesh(jpar.ParallelConfig(sp_size=2))
    seen = []
    rng = jax.random.key(request(family)["seed"])
    rng, zkey = jax.random.split(rng)
    z = np.array(jax.random.normal(zkey, shape, jnp.float32))
    draws = {}
    if family == "osp120":
        import videosys_tpu.pipelines.open_sora_plan.pipeline_open_sora_plan as JP
        from videosys_tpu.models.autoencoders.autoencoder_causal_vae import (
            CausalVAE as JVAE,
        )
        from videosys_tpu.models.autoencoders.autoencoder_causal_vae import (
            CausalVAEConfig as JVAECfg,
        )
        from videosys_tpu.models.transformers import open_sora_plan_v120 as J
        from videosys_tpu.utils.convert import convert_causal_vae, convert_osp_v120

        jvae_cfg = JVAECfg(**OSP_VAE)
        jparams = {"transformer": convert_osp_v120(params["transformer"],
                                                   depth=V120["num_layers"]),
                   "vae": convert_causal_vae(params["vae"], jvae_cfg)}
        jpipe = JP.OpenSoraPlanPipeline(JP.OpenSoraPlanConfig(
            version="v120", transformer_type="29x480p", dtype="fp32",
            enable_tiling=False,
            transformer_config=J.OpenSoraPlanV120Config(**V120),
            vae=JVAE(jvae_cfg, version="v120")), params=jparams, mesh=mesh)
        decode = jpipe.vae.decode
        jpipe.vae.decode = lambda p, lat: seen.append(np.asarray(lat)) \
            or decode(p, lat)
        jpipe.generate(PROMPT, **request(family))
        for i in range(STEPS):
            rng, nkey = jax.random.split(rng)
            draws[f"euler/{i}/ancestral"] = np.array(
                jax.random.normal(nkey, shape, jnp.float32))
        return seen[0], z, draws

    import videosys_tpu.pipelines.cogvideox.pipeline_cogvideox as JP
    from videosys_tpu.models.autoencoders.autoencoder_cogvideox import (
        CogVideoXVAEConfig as JVAECfg,
    )
    from videosys_tpu.models.transformers import cogvideox as J
    from videosys_tpu.utils.convert import convert_cogvideox, convert_cogvideox_vae

    rope = family == "cog5b"
    jparams = {"transformer": convert_cogvideox(params["transformer"],
                                                depth=COG["num_layers"]),
               "vae": convert_cogvideox_vae(
                   params["vae"], len(COG_VAE["block_out_channels"]),
                   COG_VAE["layers_per_block"])}
    jpipe = JP.CogVideoXPipeline(JP.CogVideoXConfig(
        model_path="", dtype="fp32", scheduler="dpm" if rope else "ddim",
        vae_tiling=False,
        transformer_config=J.CogVideoXConfig(
            **COG, use_rotary_positional_embeddings=rope),
        vae_config=JVAECfg(**COG_VAE)), params=jparams, mesh=mesh)
    decode = jpipe.vae.decode
    jpipe.vae.decode = lambda p, lat: seen.append(np.asarray(lat)) \
        or decode(p, lat)
    jpipe.generate(PROMPT, **request(family))
    for i in range(STEPS):
        rng, skey = jax.random.split(rng)
        draws[f"dpm/{i}/first"] = np.array(jax.random.normal(skey, shape))
        draws[f"dpm/{i}/second"] = np.array(jax.random.normal(
            jax.random.fold_in(skey, 1), shape))
    # JAX decodes [B, C, F, h, w] / scaling: back to the port's latent
    scaling = PCogVAECfg(**COG_VAE).scaling_factor
    return np.swapaxes(seen[0], 1, 2) * scaling, z, draws


@pytest.fixture(scope="module")
def worlds():
    """Per family: the port's world 1 (in this process) and its sp=2 world
    on the same seeded weights, both fed JAX's draws, and the JAX
    pipeline's latents under its sp=2 mesh; the round trips on the cog2b
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
        shape = (pipe.latent_shape() if family == "osp120" else
                 pipe.latent_shape(COG_REQ["num_frames"], COG_REQ["height"],
                                   COG_REQ["width"]))
        jax_latents, z, draws = jax_side(family, params, shape)
        feed = dict(latents=torch.from_numpy(z),
                    **{"draw" if family == "osp120" else "noise":
                       Draws(draws)})
        world1 = {}
        for pab in (False, True):
            set_pab(pipe, pab)
            world1[pab] = (one.generate(PROMPT, **request(family),
                                        **feed).video, pipe.last_latents)
        eng = videosys_tpu_torch.VideoSysEngine(
            port_config(family, num_gpus=2), params=params, device="cpu")
        try:
            eng._run_workers(setattr, "keep_latents", True)
            sp2 = {}
            for pab in (False, True):
                eng._run_workers(set_pab, pab)
                sp2[pab] = (eng.generate(PROMPT, **request(family),
                                         **feed).video,
                            eng._run_workers(getattr, "last_latents"))
            exchange = eng._run_workers(exchange_counts)
            if family == "cog2b":
                out["round_trips"] = eng._run_workers(round_trips)
        finally:
            eng.shutdown()
        out[family] = dict(jax=jax_latents, world1=world1, sp2=sp2,
                           exchange=exchange)
    return out


# --- tests ------------------------------------------------------------------ #

def test_collectives_are_identity_on_one_rank():
    """No groups, or groups of one rank: each new helper returns its input
    (no copy), a pad to a multiple of 1 too; `broadcast` carries a
    gradient to its source."""
    x = torch.randn(2, 5, 3, 3, 4)
    one = par.Axis(None, (0,), 0)
    groups = par.Groups(par.ParallelConfig(), 0,
                        {a: one for a in par.MESH_AXES}, None,
                        torch.device("cpu"))
    for g in (None, groups):
        with par.use_groups(g):
            for f in (par.shard_tokens, par.ulysses_shard_heads,
                      par.split_heads, lambda t: par.ulysses_shard_seq(t, 3),
                      lambda t: par.gather_heads(t, 3),
                      lambda t: par.broadcast(t, 0),
                      lambda t: par.pad_to_multiple(t, 1, 1)):
                assert f(x) is x
    padded = par.pad_to_multiple(x, 3, 2)
    assert padded.shape == (2, 5, 3, 4, 4)
    assert torch.equal(padded[:, :, :, :3], x) and not padded[:, :, :, 3].any()
    two = par.Axis(None, (0, 1), 0)
    with pytest.MonkeyPatch.context() as mp:  # this rank is the source
        mp.setattr(par.dist, "broadcast", lambda t, src, group=None: None)
        mp.setattr(par.dist, "reduce", lambda t, dst, group=None: None)
        y = par.broadcast(x.requires_grad_(), 0, two)
        (2 * y).sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, torch.full_like(x, 2))


def test_collectives_round_trip_on_two_ranks(worlds):
    """On two gloo ranks: the token shard, the head all-to-all (3 heads
    padded to 4) and its inverse, the text heads' split and gather, and a
    broadcast from sp rank 0."""
    results = worlds["round_trips"]
    assert len(results) == 2
    for r in results:
        assert r["tokens"] and r["heads"] and r["seq"] and r["text"], r
        assert r["broadcast"], r
        assert r["odd"] == (2, 3, 3, 3, 4)  # 5 tokens padded to 6
        assert r["shapes"] == ((2, 3, 3, 3, 4), (2, 6, 3, 2, 4))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("pab", [False, True], ids=["dense", "pab"])
def test_sp2_matches_world1(worlds, family, pab):
    """sp=2 on gloo ranks against the port's world 1, every rank's latents
    bit-equal; rank 0 alone returns the video, within one level of world
    1's; the ranks exchanged (the head all-to-alls ran)."""
    w = worlds[family]
    video, lats = w["sp2"][pab]
    want_video, want = w["world1"][pab]
    assert len(lats) == 2 and np.isfinite(lats[0]).all()
    for lat in lats[1:]:
        np.testing.assert_array_equal(lat, lats[0])
    np.testing.assert_allclose(lats[0], want, rtol=0,
                               atol=TOL * np.abs(want).max())
    assert video.shape == want_video.shape
    assert np.abs(video.astype(int) - want_video.astype(int)).max() <= 1
    assert all(e["calls"] > 0 for e in w["exchange"])


@pytest.mark.parametrize("family", FAMILIES)
def test_sp2_matches_jax_mesh(worlds, family):
    """sp=2's rank 0 latents (dense) against the JAX pipeline under its
    sp=2 mesh, which pads the 45 tokens and 3 heads on its own."""
    w = worlds[family]
    got, want = w["sp2"][False][1][0], w["jax"]
    assert want.shape == got.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())

"""The port's parallel serving, `videosys_tpu_torch/core/parallel.py` and the
engine's ranks, against the JAX package on gloo ranks on the CPU.

`VideoSysEngine(OpenSoraConfig(num_gpus=N, enable_cp=...), device="cpu")`
spawns N - 1 worker processes; the test process is rank 0. Each world is
spawned once (the module fixture `worlds`) and runs every case there: a
17-frame request (T = 5 latent frames and a 9 x 15 token grid, S = 135:
both odd, so sp=2 pads both) fed JAX's noise, an image (T = 1: the batch
switch) and a request conditioned on a reference frame (`x_mask`), both
drawn from the seed on every rank. sp=2 is held against the JAX pipeline
under its sp=2 mesh on the suite's 8-device CPU backend; cp=2 and
cp=2 x sp=2 against the port's own world 1, which the other tests hold to
JAX. fp32, latents at 2e-4.

The JAX imports are inside the fixtures: the workers import this module to
find the functions `_run_workers` sends them, and need no JAX.
"""

import os
import time

import numpy as np
import pytest
import torch

import videosys_tpu_torch
from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.engine import WorkerError
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as PA
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D as PKL
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal as PT
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config as PCfg
from videosys_tpu_torch.utils.watchdog import Watchdog

TOL = 2e-4
STEPS = 3
SIZES = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8, patch_size=(1, 2, 2))
# 8x space: 144p 5:8 (151 x 241) -> latents 18 x 30 -> 9 x 15 tokens
SPATIAL = dict(mid_block_add_attention=False, block_out_channels=(8, 8, 8, 16),
               layers_per_block=1, num_groups=4)
TEMPORAL = dict(filters=8, num_res_blocks=1, num_groups=4)
PROMPT = "waves at dusk"
KW = dict(resolution="144p", aspect_ratio="5:8", seed=3)
HEIGHT, WIDTH = 151, 241
CASES = {
    "video": dict(num_frames=17),
    "image": dict(num_frames=1),
    "reference": dict(num_frames=17, mask_strategy="0",
                      reference=np.random.default_rng(7).uniform(
                          -1, 1, (3, 1, HEIGHT, WIDTH)).astype(np.float32)),
}
WORLDS = {"sp2": (2, False), "cp2": (2, True), "cp2sp2": (4, True)}


def port_config(**kw):
    return videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None,
        num_sampling_steps=STEPS, dtype="fp32",
        transformer_config=PCfg(**SIZES), **kw)


def port_vae():
    return PA.OpenSoraVAE(PA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=4),
                          spatial=PKL(**SPATIAL), temporal=PT(**TEMPORAL))


# --- run on every rank (sent by `_run_workers`) --------------------------- #

def switch_twice(pipeline):
    """Each DSP switch and its inverse, on this rank's S shard: the pair is
    the identity bit for bit, and the T shard is the slice of the whole."""
    groups = pipeline.groups
    gen = torch.Generator().manual_seed(groups.rank)
    x = torch.randn((3, 4, 6, 5), generator=gen)  # [B, T, S / sp, C]
    with par.use_groups(groups):
        t_shard = par.shard_temporal(x)
        whole = par.gather(x, 2)
        b_shard = par.shard_batch_over_all(x[:, :1])
        return {"temporal": torch.equal(par.shard_spatial(t_shard), x),
                "slice": torch.equal(t_shard, par.split(whole, 1)),
                "batch": torch.equal(par.unshard_batch(b_shard, 3), x[:, :1]),
                "shapes": (tuple(t_shard.shape), tuple(b_shard.shape))}


def heartbeat(pipeline):
    """One beat of this rank's watchdog: an all-reduce over the monitor
    group, which every rank answers."""
    return Watchdog(groups=pipeline.groups).beat_fn()


def generate_or_raise(pipeline, *args, **kwargs):
    """Rank 0 generates (and blocks in the first all-to-all); the others
    raise before they reach it."""
    if pipeline.groups.rank != 0:
        raise ValueError("injected worker fault")
    return pipeline.generate(*args, **kwargs)


# --- fixtures --------------------------------------------------------------- #

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every rank, the test process too, computes on one CPU thread: the
    ranks share this CPU, and equal thread counts give the ranks' CPU
    kernels equal rounding, so that their latents can be held bit-equal."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"  # read by the spawned workers
    yield
    torch.set_num_threads(threads)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def reference():
    """The port's world 1 and the JAX pipeline under its sp=2 mesh on the
    same (the port's seeded) weights, given to JAX by the JAX package's
    converters: the JAX latents of the video case (fed JAX's draw) and
    world 1's video and latents of every case."""
    import jax
    import jax.numpy as jnp

    import videosys_tpu
    from videosys_tpu.core import parallel as jpar
    from videosys_tpu.models.autoencoders import autoencoder_open_sora as JA
    from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JKL
    from videosys_tpu.models.autoencoders.vae_temporal import VAETemporal as JT
    from videosys_tpu.models.transformers.stdit3 import STDiT3Config as JCfg
    from videosys_tpu.utils.convert import (
        convert_stdit3,
        convert_vae2d,
        convert_vae_temporal,
    )

    torch.manual_seed(0)
    one = videosys_tpu_torch.OpenSoraPipeline(port_config(), vae=port_vae(),
                                              device="cpu")
    one.keep_latents = True
    params = {name: {k: v.numpy() for k, v in m.state_dict().items()}
              for name, m in (("transformer", one.transformer),
                              ("vae", one.vae))}
    part = {p: {k[len(p):]: v for k, v in params["vae"].items()
                if k.startswith(p)}
            for p in ("spatial_vae.module.", "temporal_vae.")}
    jparams = {"transformer": convert_stdit3(params["transformer"],
                                             SIZES["depth"]),
               "vae": {"spatial": convert_vae2d(
                           part["spatial_vae.module."],
                           len(SPATIAL["block_out_channels"])),
                       "temporal": convert_vae_temporal(
                           part["temporal_vae."], 4,
                           TEMPORAL["num_res_blocks"])}}
    jcfg = videosys_tpu.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None,
        num_sampling_steps=STEPS, dtype="fp32",
        transformer_config=JCfg(**SIZES))
    jvae = JA.OpenSoraVAE(JA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=4),
                          spatial=JKL(**SPATIAL), temporal=JT(**TEMPORAL))
    mesh = jpar.build_mesh(jpar.ParallelConfig(sp_size=2))
    jpipe = videosys_tpu.OpenSoraPipeline(jcfg, vae=jvae, params=jparams,
                                          mesh=mesh)
    jpipe.keep_latents = True
    jpipe.generate(PROMPT, **KW, **CASES["video"])
    # the JAX pipeline's draw: split the per-prompt key once, normal(f32)
    t_lat, h, w = one.vae.get_latent_size((17, HEIGHT, WIDTH))
    _, zk = jax.random.split(jax.random.key(KW["seed"]))
    z = torch.from_numpy(np.array(jax.random.normal(
        zk, (1, 4, t_lat, h, w), jnp.float32)))
    world1 = {}
    for case, kw in CASES.items():
        extra = dict(latents=z) if case == "video" else {}
        video = one.generate(PROMPT, **KW, **kw, **extra).video
        world1[case] = (video, one.last_latents)
    return dict(params=params, latents=z, jax=np.asarray(jpipe.last_latents),
                world1=world1)


@pytest.fixture(scope="module")
def worlds(reference):
    """Each world spawned once, every case run there: per (world, case) rank
    0's video and every rank's latents; every rank's latents of an image
    generated without a seed; the switch and heartbeat results and the
    failure check on sp=2."""
    out = {}
    for name, (n, cp) in WORLDS.items():
        eng = videosys_tpu_torch.VideoSysEngine(
            port_config(num_gpus=n, enable_cp=cp), vae=port_vae(),
            params=reference["params"], device="cpu")
        try:
            eng._run_workers(setattr, "keep_latents", True)
            for case, kw in CASES.items():
                extra = (dict(latents=reference["latents"])
                         if case == "video" else {})
                video = eng.generate(PROMPT, **KW, **kw, **extra).video
                out[name, case] = (video,
                                   eng._run_workers(getattr, "last_latents"))
            # no seed: each rank's own numpy would draw another one
            eng.generate(PROMPT, resolution=KW["resolution"],
                         aspect_ratio=KW["aspect_ratio"], **CASES["image"])
            out[name, "unseeded"] = eng._run_workers(getattr, "last_latents")
            out[name, "switch"] = eng._run_workers(switch_twice)
            out[name, "heartbeat"] = eng._run_workers(heartbeat)
            if name == "sp2":
                t0 = time.perf_counter()
                try:
                    eng._run_workers(generate_or_raise, PROMPT, **KW,
                                     **CASES["image"])
                    out["failure"] = None
                except WorkerError as e:
                    out["failure"] = (str(e), time.perf_counter() - t0)
        finally:
            eng.shutdown()
    return out


# --- tests ------------------------------------------------------------------ #

@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("enable_cp", [False, True])
def test_parallel_config_equals_jax(n, enable_cp):
    from videosys_tpu.core import parallel as jpar

    got = par.ParallelConfig.from_world_size(n, enable_cp)
    want = jpar.ParallelConfig.from_world_size(n, enable_cp)
    assert sizes_of(got) == sizes_of(want)
    assert got.world_size == want.world_size == n


def sizes_of(cfg):
    return cfg.dp_size, cfg.cp_size, cfg.sp_size


@pytest.mark.parametrize("dp,cp,sp", [(1, 1, 8), (1, 2, 4), (2, 2, 2),
                                      (2, 1, 4), (1, 2, 1)])
def test_rank_layout_equals_build_mesh(dp, cp, sp):
    """Rank r sits where `build_mesh` puts device r; each group is a line
    of that grid along its axis."""
    import jax

    from videosys_tpu.core import parallel as jpar

    cfg = par.ParallelConfig(dp, cp, sp)
    mesh = jpar.build_mesh(jpar.ParallelConfig(dp, cp, sp), jax.devices())
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    np.testing.assert_array_equal(par.rank_layout(cfg), ids)
    for axis in par.MESH_AXES:
        k = mesh.axis_names.index(axis)
        lines = np.moveaxis(ids, k, -1).reshape(-1, mesh.devices.shape[k])
        assert par.axis_lines(cfg, axis) == lines.tolist()


def test_helpers_are_identity_on_one_rank():
    """No groups, or groups of one rank: every helper returns its input and
    the pad multiple is 1; a collective carries a gradient (its backward
    runs the reverse exchange, counted under its own keys)."""
    x = torch.randn(2, 3, 5, 4)
    one = par.Axis(None, (0,), 0)
    groups = par.Groups(par.ParallelConfig(), 0,
                        {a: one for a in par.MESH_AXES}, None,
                        torch.device("cpu"))
    for g in (None, groups):
        with par.use_groups(g):
            assert par.token_pad_multiple() == 1
            for f in (par.shard_temporal, par.shard_spatial,
                      par.shard_batch_over_all, lambda t: par.split(t, 0),
                      lambda t: par.gather(t, 0, par.CP_AXIS),
                      lambda t: par.unshard_batch(t, 2)):
                assert f(x) is x
    two = par.Axis(None, (0, 1), 0)
    exchanges = []

    def exchange(recv, send, group=None):  # this rank's own chunks back
        exchanges.append(tuple(send.shape))
        recv.copy_(send)

    par.reset_exchange()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(par.dist, "all_to_all_single", exchange)
        y = par.all_to_all(x.requires_grad_(), 0, 2, two)
        y.sum().backward()
    assert y.requires_grad and torch.equal(x.grad, torch.ones_like(x))
    assert exchanges == [(2, 1, 3, 5, 4), (2, 1, 3, 5, 4)]
    assert (par.EXCHANGE["calls"], par.EXCHANGE["backward_calls"]) == (1, 1)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("case", list(CASES))
def test_world_matches_world1(reference, worlds, world, case):
    """Every world's latents equal world 1's within 2e-4 on every rank, bit
    for bit across ranks (the image and reference cases draw their noise
    from the seed on each rank: every rank draws the same); rank 0 alone
    returns the video, within one level of world 1's."""
    video, lats = worlds[world, case]
    want_video, want = reference["world1"][case]
    assert len(lats) == WORLDS[world][0]
    assert np.isfinite(want).all() and np.isfinite(lats[0]).all()
    for lat in lats:
        np.testing.assert_array_equal(lat, lats[0])
    np.testing.assert_allclose(lats[0], want, atol=TOL, rtol=TOL)
    assert video.shape == want_video.shape
    assert np.abs(video.astype(int) - want_video.astype(int)).max() <= 1


@pytest.mark.parametrize("world", list(WORLDS))
def test_unseeded_ranks_draw_the_same(worlds, world):
    """generate without a seed: rank 0 draws it and sends it to the other
    ranks, so every rank starts from the same noise and their latents are
    bit-equal."""
    lats = worlds[world, "unseeded"]
    assert len(lats) == WORLDS[world][0]
    assert np.isfinite(lats[0]).all()
    for lat in lats[1:]:
        np.testing.assert_array_equal(lat, lats[0])


def test_sp2_matches_jax_mesh(reference, worlds):
    """sp=2 on gloo ranks against the JAX pipeline under its sp=2 mesh, with
    the T and S padding both exercised (T 5 -> 6, S 135 -> 136)."""
    _, lats = worlds["sp2", "video"]
    assert lats[0].shape == (1, 4, 5, 18, 30)
    assert np.isfinite(reference["jax"]).all()
    np.testing.assert_allclose(lats[0], reference["jax"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("world", list(WORLDS))
def test_switch_twice_is_identity(worlds, world):
    n, cp = WORLDS[world]
    sp = n // 2 if cp else n
    for r in worlds[world, "switch"]:
        assert r["temporal"] and r["slice"] and r["batch"], r
        assert r["shapes"] == ((3, 4 // sp, 6 * sp, 5),
                               (-(-3 // sp), 1, 6 * sp, 5))
    assert worlds[world, "heartbeat"] == [float(n)] * n


def test_worker_fault_fails_the_call(worlds):
    """A worker that raises fails the driver's call with its error, while
    the driver is blocked in a collective, long before the timeout."""
    failure = worlds["failure"]
    assert failure is not None, "the call returned"
    message, seconds = failure
    assert "rank 1 raised" in message and "injected worker fault" in message
    assert seconds < par.DEFAULT_TIMEOUT_S / 10


def test_watchdog_beats_and_detects_hang():
    """One rank: the beat is a device op; a beat that misses its deadline
    calls on_hang (JAX: tests/test_training.py:424)."""
    wd = Watchdog(interval=0.05, timeout=10.0)
    with wd:
        time.sleep(0.3)
    assert wd.beats >= 1 and wd.hangs == 0
    hangs = []
    wd = Watchdog(interval=0.05, timeout=0.1,
                  beat_fn=lambda: time.sleep(1.0),
                  on_hang=lambda t: hangs.append(t))
    with wd:
        time.sleep(0.5)
    assert hangs, "hang was not detected"

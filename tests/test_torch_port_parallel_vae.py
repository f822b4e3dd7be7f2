"""The split Open-Sora VAE of the port (`OpenSoraVAE` under process groups:
the 2D stage over frames, the temporal stage over latent rows with halo
convolutions and group norms summed over the rows' line) on gloo ranks on
the CPU, against JAX's VAE under its sp=2 and cp=2 x sp=2 meshes on the
suite's 8-device CPU backend and against the port's world 1.

The video has 19 frames (6 latent frames; 19 frames split over 2 or 4
ranks leave a pad frame) of 40 x 48 pixels (5 x 6 latents: 5 rows over 2
ranks pad one row, over 4 ranks three, one rank holding pad rows only).
Each world is spawned once (the module fixture `worlds`); the encode is fed
JAX's draws by the port's names. fp32: latents and values at 2e-4 of their
largest magnitude (the whole-model tolerance of the parity tests), the
uint8 video within one level.

The JAX imports are inside the fixtures: the workers import this module to
find the functions the driver sends them, and need no JAX.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.engine import Ranks
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as PA
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D as PKL
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal as PT
from videosys_tpu_torch.models.modules.normalization import GroupNorm

TOL = 2e-4
SPATIAL = dict(mid_block_add_attention=False, block_out_channels=(8, 8, 8, 16),
               layers_per_block=1, num_groups=4)
TEMPORAL = dict(filters=8, num_res_blocks=1, num_groups=4)
FRAMES, HEIGHT, WIDTH = 19, 40, 48
LATENT = (1, 4, 6, 5, 6)  # [B, C, t, h, w] of 19 x 40 x 48
WORLDS = {"sp2": par.ParallelConfig(1, 1, 2),
          "cp2sp2": par.ParallelConfig(1, 2, 2)}


def port_vae():
    return PA.OpenSoraVAE(PA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=2),
                          spatial=PKL(**SPATIAL), temporal=PT(**TEMPORAL))


class Draws:
    """Named draws (numpy arrays) for `OpenSoraVAE.encode`'s `noise`."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __call__(self, name, shape):
        out = torch.from_numpy(self.arrays[name])
        assert tuple(out.shape) == tuple(shape), (name, shape)
        return out


def run_vae(vae, inputs):
    """Encode, decode and the uint8 chunks of one rank (or world 1)."""
    x, draws, z = (torch.from_numpy(inputs["x"]), Draws(inputs["draws"]),
                   torch.from_numpy(inputs["z"]))
    chunks = vae.decode_chunks_u8(z, FRAMES)
    return {"latents": vae.encode(x, draws).numpy(),
            "video": vae.decode(z, FRAMES).numpy(),
            "u8": [c.numpy() for c in chunks]}


# --- on every rank -------------------------------------------------------- #

def setup_vae_rank(rank, world_size, address, backend, timeout, device,
                   config, state):
    par.initialize(rank, world_size, address, backend=backend, device=device,
                   timeout=timeout)
    vae = port_vae()
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return SimpleNamespace(groups=par.build_groups(config, device), vae=vae)


def vae_case(target, inputs):
    with par.use_groups(target.groups):
        return run_vae(target.vae, inputs)


def row_norm_case(target, x):
    """GroupNorm over this rank's rows of an uneven split."""
    with par.use_groups(target.groups):
        xt = torch.from_numpy(x)
        local, rows = par.shard_vae_rows(xt)
        norm = GroupNorm(2, 4, eps=1e-5)
        with torch.no_grad():
            norm.weight.copy_(torch.linspace(0.5, 1.5, 4))
            norm.bias.copy_(torch.linspace(-1, 1, 4))
        out = norm(local, rows)
        return {"out": out.detach().numpy(), "valid": rows.valid,
                "rank": rows.axis.rank}


# --- fixtures --------------------------------------------------------------- #

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every rank computes on one CPU thread (the ranks share this CPU)."""
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
def inputs():
    """Seeded weights, pixels and latents, and JAX's encode draws of
    key(5) by the port's names (JAX draws channel-last)."""
    import jax

    torch.manual_seed(0)
    state = {k: v.numpy() for k, v in port_vae().state_dict().items()}
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (1, 3, FRAMES, HEIGHT, WIDTH)).astype(np.float32)
    z = rng.standard_normal(LATENT).astype(np.float32)
    r1, r2 = jax.random.split(jax.random.key(5))
    h, w = HEIGHT // 8, WIDTH // 8
    spatial = np.array(jax.random.normal(r1, (FRAMES, h, w, 4)))
    draws = {"spatial": spatial.transpose(0, 3, 1, 2).copy()}
    for i, t in ((0, 5), (17, 1)):
        d = np.array(jax.random.normal(jax.random.fold_in(r2, i),
                                       (1, t, h, w, 4)))
        draws[f"temporal/{i}"] = d.transpose(0, 4, 1, 2, 3).copy()
    return {"state": state, "x": x, "z": z, "draws": draws, "key": 5}


@pytest.fixture(scope="module")
def world1(inputs):
    vae = port_vae()
    vae.load_state_dict({k: torch.from_numpy(v)
                         for k, v in inputs["state"].items()})
    return vae, run_vae(vae, inputs)


@pytest.fixture(scope="module")
def jax_worlds(inputs):
    """JAX's VAE on the port's weights under each world's mesh."""
    import jax
    import jax.numpy as jnp

    from videosys_tpu.core import parallel as jpar
    from videosys_tpu.models.autoencoders import autoencoder_open_sora as JA
    from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JKL
    from videosys_tpu.models.autoencoders.vae_temporal import VAETemporal as JT
    from videosys_tpu.utils.convert import convert_vae2d, convert_vae_temporal

    part = {p: {k[len(p):]: v for k, v in inputs["state"].items()
                if k.startswith(p)}
            for p in ("spatial_vae.module.", "temporal_vae.")}
    params = {"spatial": convert_vae2d(part["spatial_vae.module."],
                                       len(SPATIAL["block_out_channels"])),
              "temporal": convert_vae_temporal(
                  part["temporal_vae."], 4, TEMPORAL["num_res_blocks"])}
    out = {}
    for name, cfg in WORLDS.items():
        jvae = JA.OpenSoraVAE(JA.OpenSoraVAEConfig(micro_frame_size=17,
                                                   micro_batch_size=2),
                              spatial=JKL(**SPATIAL), temporal=JT(**TEMPORAL))
        mesh = jpar.build_mesh(jpar.ParallelConfig(cfg.dp_size, cfg.cp_size,
                                                   cfg.sp_size))
        with jpar.use_mesh(mesh):
            lat = jvae.encode(params, jnp.asarray(inputs["x"]),
                              jax.random.key(inputs["key"]))
            video = np.asarray(jvae.decode(params, jnp.asarray(inputs["z"]),
                                           FRAMES))
        # JAX's decode_chunks_u8 math (_decode_chunk_u8) on its decode
        u8 = np.clip((np.clip(video, -1, 1) + 1) / 2 * 255 + 0.5, 0, 255
                     ).astype(np.uint8).transpose(0, 2, 3, 4, 1)
        out[name] = {"latents": np.asarray(lat), "video": video,
                     "u8": [u8[:, :17], u8[:, 17:]]}
    return out


@pytest.fixture(scope="module")
def worlds(inputs):
    """Each world spawned once: every rank's encode, decode and uint8
    chunks; every rank's row-sharded group norm of an uneven split."""
    norm_x = np.random.default_rng(9).standard_normal(
        (2, 4, 3, 5, 6)).astype(np.float32)
    out = {"norm_x": norm_x}
    for name, cfg in WORLDS.items():
        ranks = Ranks()
        ranks._spawn(cfg.world_size, setup_vae_rank, (cfg, inputs["state"]),
                     ["cpu"] * cfg.world_size, "gloo", 300.0)
        try:
            out[name] = ranks._run_workers(vae_case, inputs)
            out[name, "norm"] = ranks._run_workers(row_norm_case, norm_x)
        finally:
            ranks.shutdown()
    return out


def close(got, want, tol=TOL):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


# --- tests ------------------------------------------------------------------ #

@pytest.mark.parametrize("world", list(WORLDS))
def test_split_vae_matches_jax_mesh(world, worlds, jax_worlds):
    """Every rank's latents and decoded values equal JAX's under the same
    mesh within 2e-4; rank 0's uint8 chunks within one level."""
    want = jax_worlds[world]
    for rank, got in enumerate(worlds[world]):
        close(got["latents"], want["latents"])
        close(got["video"], want["video"])
    u8 = worlds[world][0]["u8"]
    assert [c.shape for c in u8] == [c.shape for c in want["u8"]] == [
        (1, 17, HEIGHT, WIDTH, 3), (1, 2, HEIGHT, WIDTH, 3)]
    for g, w in zip(u8, want["u8"]):
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


@pytest.mark.parametrize("world", list(WORLDS))
def test_split_vae_matches_world1(world, worlds, world1):
    """Every rank's results equal world 1's within 2e-4 (the uint8 video
    within one level), and the video is on rank 0 alone."""
    _, want = world1
    ranks = worlds[world]
    assert len(ranks) == WORLDS[world].world_size
    for got in ranks:
        close(got["latents"], want["latents"])
        close(got["video"], want["video"])
    for g, w in zip(ranks[0]["u8"], want["u8"]):
        assert g.shape == w.shape
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    assert all(r["u8"] == [] for r in ranks[1:])


def test_world1_matches_jax(world1, jax_worlds):
    """The unsplit port against JAX's VAE (the sp=2 mesh computes JAX's
    one-device values): the anchor of the world-1 comparisons."""
    _, got = world1
    want = jax_worlds["sp2"]
    close(got["latents"], want["latents"])
    close(got["video"], want["video"])


def test_one_rank_groups_change_nothing(world1, inputs):
    """Groups of one rank (and none) give world 1's results bit for bit:
    the unsplit path is the one-card path."""
    vae, want = world1
    one = par.Axis(None, (0,), 0)
    groups = par.Groups(par.ParallelConfig(), 0,
                        {a: one for a in par.MESH_AXES + (par.CPSP_AXIS,
                                                          par.WORLD_AXIS)},
                        None, torch.device("cpu"))
    with par.use_groups(groups):
        got = run_vae(vae, inputs)
    for key in ("latents", "video"):
        assert np.array_equal(got[key], want[key])
    assert all(np.array_equal(g, w) for g, w in zip(got["u8"], want["u8"]))


@pytest.mark.parametrize("world", list(WORLDS))
def test_row_sharded_group_norm(world, worlds):
    """GroupNorm over 5 rows split over the world's cp x sp line (the pad
    rows left out of the sums and the count) equals the whole axis's on
    each rank's real rows."""
    x = torch.from_numpy(worlds["norm_x"])
    norm = GroupNorm(2, 4, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, 4))
        norm.bias.copy_(torch.linspace(-1, 1, 4))
        want = norm(x).numpy()
    n = WORLDS[world].cp_size * WORLDS[world].sp_size
    local = -(-5 // n)
    for r, got in enumerate(worlds[world, "norm"]):
        assert got["rank"] == r
        v = got["valid"]
        assert v == max(0, min(local, 5 - r * local))
        if v:  # a rank of pad rows only has nothing to compare
            close(got["out"][:, :, :, :v],
                  want[:, :, :, r * local:r * local + v], 1e-5)

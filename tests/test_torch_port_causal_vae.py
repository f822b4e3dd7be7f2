"""The PyTorch port's Open-Sora-Plan causal VAE against the JAX package on
the CPU (fp32, tiny widths, 2e-4): encode (the posterior mean, and a sample
fed JAX's noise through `draw`) and decode for v1.1's ops with its pre-fix
attention, v1.2's (the fixed attention, Downsample, Spatial2xTime2x3D) and
the residual time ops, params carried by `causal_vae_from_jax` and back by
the JAX package's `convert_causal_vae`; the temporal chunk plan; the tiled
decode and encode against JAX's tiled codec; and the causality of
`CausalConv3d` and the time pool."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.models.autoencoders import autoencoder_causal_vae as J
from videosys_tpu.utils.convert import convert_causal_vae
from videosys_tpu_torch.models.autoencoders import autoencoder_causal_vae as P
from videosys_tpu_torch.utils.from_jax import causal_vae_from_jax

TOL = 2e-4
# tests/test_open_sora_plan.py's tiny configurations, and one with the
# residual time ops, per-frame 2D resnets and 2D convs in and out
BASE = dict(hidden_size=8, hidden_size_mult=(1, 2), num_res_blocks=1,
            encoder_resnet_blocks=("ResnetBlock3D",) * 2,
            decoder_resnet_blocks=("ResnetBlock3D",) * 2)
CONFIGS = {
    "v110": ("v110", dict(
        encoder_spatial_downsample=("SpatialDownsample2x", ""),
        encoder_temporal_downsample=("TimeDownsample2x", ""),
        decoder_spatial_upsample=("", "SpatialUpsample2x"),
        decoder_temporal_upsample=("", "TimeUpsample2x"))),
    "v120": ("v120", dict(
        encoder_attention="AttnBlock3DFix", decoder_attention="AttnBlock3DFix",
        encoder_spatial_downsample=("Downsample", "Spatial2xTime2x3DDownsample"),
        encoder_temporal_downsample=("", ""),
        decoder_spatial_upsample=("Spatial2xTime2x3DUpsample", "SpatialUpsample2x"),
        decoder_temporal_upsample=("", ""))),
    "res_ops": ("v110", dict(
        encoder_conv_in="Conv2d", decoder_conv_out="Conv2d",
        encoder_attention="AttnBlock", decoder_attention="AttnBlock",
        encoder_resnet_blocks=("ResnetBlock2D", "ResnetBlock3D"),
        decoder_resnet_blocks=("ResnetBlock3D", "ResnetBlock2D"),
        encoder_spatial_downsample=("SpatialDownsample2x", ""),
        encoder_temporal_downsample=("TimeDownsampleRes2x", ""),
        decoder_spatial_upsample=("", "SpatialUpsample2x"),
        decoder_temporal_upsample=("", "TimeUpsampleRes2x"))),
}


def perturbed(params, seed: int = 0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32), params)


def vaes(name: str):
    """The port's seeded weights, perturbed, and the same weights as JAX
    params by the JAX package's converter (JAX compiles no init); from_jax
    carries them back unchanged."""
    version, kw = CONFIGS[name]
    jcfg = J.CausalVAEConfig(**{**BASE, **kw})
    jvae = J.CausalVAE(jcfg, version=version)
    pcfg = P.CausalVAEConfig(**{**BASE, **kw})
    torch.manual_seed(0)
    pvae = P.CausalVAE(pcfg, version=version)
    sd = perturbed({k: v.numpy() for k, v in pvae.state_dict().items()})
    params = convert_causal_vae(sd, jcfg)
    back = causal_vae_from_jax(params, pcfg)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])
    pvae.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()})
    return jcfg, jvae, params, pvae.eval()


def pixels(seed: int = 1, T: int = 5, H: int = 16, W: int = 16):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((1, 3, T, H, W))).astype(np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_decode_like_jax(name):
    jcfg, jvae, params, pvae = vaes(name)
    x = pixels()
    with torch.no_grad():
        mean = pvae.encode(torch.from_numpy(x), sample=False)
        want = np.asarray(jvae.encode(params, x, sample=False))
        assert mean.shape == want.shape and mean.shape[:3] == (1, 4, 3)
        np.testing.assert_allclose(mean.numpy(), want, atol=TOL, rtol=TOL)
        # a posterior sample with JAX's noise (drawn channel-last there)
        key = jax.random.key(7)
        noise = np.array(jax.random.normal(key, np.moveaxis(want, 1, -1).shape))
        z = pvae.encode(torch.from_numpy(x), draw=lambda n, s: torch.from_numpy(
            np.moveaxis(noise, -1, 1)))
        np.testing.assert_allclose(
            z.numpy(), np.asarray(jvae.encode(params, x, rng=key)), atol=TOL,
            rtol=TOL)
        out = pvae.decode(z)
        want = np.asarray(jvae.decode(params, jnp.asarray(z.numpy())))
        assert out.shape == want.shape == (1, 3, 5, 16, 16)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    # the reference's key names: the JAX converter reads the port's
    # state_dict into params with the same decode
    back = convert_causal_vae(pvae.state_dict(), jcfg)
    np.testing.assert_allclose(
        np.asarray(jvae.decode(back, jnp.asarray(z.numpy()))), want, atol=TOL,
        rtol=TOL)


@pytest.mark.parametrize("t,size", [(1, 3), (5, 3), (8, 9), (17, 17), (24, 9),
                                    (7, 4), (25, 9)])
def test_t_chunks_like_jax(t, size):
    jvae = J.CausalVAE(J.CausalVAEConfig(**BASE, **CONFIGS["v110"][1]))
    assert P.CausalVAE._t_chunks(t, size) == jvae._t_chunks(t, size)


def small_tiles(vae):
    """Tiles small enough that the tiny codec is cut in time and space."""
    vae.use_tiling = True
    vae.tile_latent_min_size = 4
    vae.tile_sample_min_size = 8
    vae.tile_latent_min_size_t = 3
    vae.tile_sample_min_size_t = 5
    vae.tile_overlap_factor = 0.25


def test_tiled_codec_like_jax():
    """v1.2's tiled decode of [1, 4, 5, 12, 12] latents (two temporal
    chunks, 3 x 3 tiles blended) and tiled encode of 9 x 24 x 24 pixels,
    against JAX's tiled codec."""
    _, jvae, params, pvae = vaes("v120")
    small_tiles(jvae)
    small_tiles(pvae)
    rng = np.random.default_rng(2)
    z = (0.5 * rng.standard_normal((1, 4, 5, 12, 12))).astype(np.float32)
    x = pixels(3, T=9, H=24, W=24)
    with torch.no_grad():
        out = pvae.decode(torch.from_numpy(z)).numpy()
        enc = pvae.encode(torch.from_numpy(x), sample=False).numpy()
    want = np.asarray(jvae.decode(params, z))
    assert out.shape == want.shape == (1, 3, 9, 24, 24)
    np.testing.assert_allclose(out, want, atol=TOL, rtol=TOL)
    want = np.asarray(jvae.encode(params, x, sample=False))
    assert enc.shape == want.shape
    np.testing.assert_allclose(enc, want, atol=TOL, rtol=TOL)


def test_causal_conv3d_and_time_pool_are_causal():
    """Output frame t depends on input frames <= t only (first-frame
    replication in place of zero padding); the encoder as a whole is not
    causal, since its GroupNorm statistics span time, as the reference's."""
    torch.manual_seed(0)
    conv = P.CausalConv3d(3, 6)
    x = torch.randn(1, 3, 5, 8, 8)
    x2 = x.clone()
    x2[:, :, 3:] = -x2[:, :, 3:]
    with torch.no_grad():
        y1, y2 = conv(x), conv(x2)
        assert torch.equal(y1[:, :, :3], y2[:, :, :3])
        assert (y1[:, :, 3:] - y2[:, :, 3:]).abs().max() > 1e-3
        d1, d2 = P.TimeDownsample2x()(x), P.TimeDownsample2x()(x2)
        assert torch.equal(d1[:, :, :2], d2[:, :, :2])  # frames 0 and 0..2
        assert d1.shape[2] == 3


def test_config_like_jax():
    """The released configs' fields and tile sizes equal JAX's."""
    for jc, pc in ((J.CausalVAEConfig(), P.CausalVAEConfig()),
                   (J.CausalVAEConfig.v120(), P.CausalVAEConfig.v120())):
        want = dataclasses.asdict(jc)
        want.pop("dtype")
        assert dataclasses.asdict(pc) == want
    for version in ("v110", "v120"):
        jv = J.CausalVAE(J.CausalVAEConfig(**BASE, **CONFIGS[version][1]),
                         version=version)
        pv = P.CausalVAE(P.CausalVAEConfig(**BASE, **CONFIGS[version][1]),
                         version=version)
        for attr in ("tile_sample_min_size", "tile_sample_min_size_t",
                     "tile_overlap_factor", "tile_latent_min_size",
                     "time_down", "tile_latent_min_size_t"):
            assert getattr(pv, attr) == getattr(jv, attr), attr

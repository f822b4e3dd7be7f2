"""The PyTorch port's CogVideoX causal 3D VAE against the JAX package on the
CPU (fp32, tiny widths, params carried by `cogvideox_vae_from_jax`): the
streamed decode at an odd latent length (chunks (0, 3), (3, 5): the first
takes the remainder; nearest resizes of odd frame counts), the whole-axis
decode, a tiled decode with tiles small enough to tile and blend, the
encoder with its first-frame-aware temporal downsampling, and the
reference key names (the JAX package's
`convert_cogvideox_vae` reads the port's state_dict)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.models.autoencoders import autoencoder_cogvideox as J
from videosys_tpu.utils.convert import convert_cogvideox_vae
from videosys_tpu_torch.models.autoencoders import autoencoder_cogvideox as P
from videosys_tpu_torch.utils.from_jax import cogvideox_vae_from_jax

TOL = 2e-4
# tests/test_cogvideox_pipeline.py's tiny VAE; 6 x 6 latent tiles with 1/6
# overlaps step 5 latents and blend 8 pixels, so 16 latents tile as 6, 6, 6, 1
SIZES = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
             layers_per_block=1, norm_num_groups=4, tile_latent_min_height=6,
             tile_latent_min_width=6, tile_overlap_factor_width=1 / 6)


@pytest.fixture(scope="module")
def vaes():
    jv = J.AutoencoderKLCogVideoX(J.CogVideoXVAEConfig(**SIZES))
    rng = np.random.default_rng(0)
    # the port's seeded weights, moved off the identity norms so the scales
    # and biases count, as JAX params by the JAX package's converter (JAX
    # compiles no init); from_jax carries them back unchanged
    torch.manual_seed(0)
    pv = P.AutoencoderKLCogVideoX(P.CogVideoXVAEConfig(**SIZES))
    sd = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in pv.state_dict().items()}
    params = convert_cogvideox_vae(sd, len(SIZES["block_out_channels"]),
                                   SIZES["layers_per_block"])
    back = cogvideox_vae_from_jax(params)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])
    pv.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()},
                       strict=True)
    return jv, params, pv


def latent(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode,shape,frames", [
    ("streamed", (1, 4, 5, 4, 4), 17), ("whole", (1, 4, 3, 4, 4), 9),
    ("tiled", (1, 4, 3, 16, 16), 9)])
def test_decode_like_jax(vaes, mode, shape, frames):
    """`decode` streams (and tiles); the decoder alone is the whole-axis
    decode."""
    jv, params, pv = vaes
    jv.use_tiling = pv.use_tiling = mode == "tiled"
    z = latent(shape)
    want = np.asarray(jv.decode(params, jnp.asarray(z),
                                streaming=mode != "whole"))
    with torch.no_grad():
        zt = torch.from_numpy(z)
        got = (pv.decoder(zt) if mode == "whole" else pv.decode(zt)).numpy()
    assert got.shape == want.shape == (1, 3, frames, 8 * shape[3],
                                       8 * shape[4])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_streamed_decode_is_per_chunk(vaes):
    """Streaming keeps per-chunk norm statistics, as the reference does: it
    differs from the whole-axis decode of the same latent."""
    _, _, pv = vaes
    pv.use_tiling = False
    z = torch.from_numpy(latent((1, 4, 5, 4, 4)))
    with torch.no_grad():
        streamed = pv.decode(z)
        whole = pv.decoder(z)
    assert streamed.shape == whole.shape
    assert (streamed - whole).abs().max() > 1e-3


def encoder_moments(jv, params, pv):
    """(port, JAX) encoder moments of one 9-frame clip: 1 + 8/4 = 3 latent
    frames (the first frame kept apart by each temporal downsampling)."""
    x = np.random.default_rng(2).uniform(-1, 1, (1, 3, 9, 32, 32)).astype(
        np.float32)
    want = jv.encoder.apply(params["encoder"],
                            jnp.transpose(jnp.asarray(x), (0, 2, 3, 4, 1)))
    with torch.no_grad():
        got = pv.encoder(torch.from_numpy(x)).numpy()
    return got, np.asarray(jnp.transpose(want, (0, 4, 1, 2, 3)))


def test_encoder_like_jax(vaes):
    got, want = encoder_moments(*vaes)
    assert got.shape == want.shape == (1, 8, 3, 4, 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_reference_key_names(vaes):
    """The JAX package's converter reads the port's state_dict into params
    on which JAX decodes and encodes as the port does."""
    jv, _, pv = vaes
    jv.use_tiling = pv.use_tiling = False
    back = convert_cogvideox_vae(dict(pv.state_dict()), n_blocks=4,
                                 layers_per_block=SIZES["layers_per_block"])
    z = latent((1, 4, 3, 4, 4), 4)
    with torch.no_grad():
        got = pv.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(jv.decode(back, jnp.asarray(z))),
                               atol=TOL, rtol=TOL)
    got, want = encoder_moments(jv, back, pv)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

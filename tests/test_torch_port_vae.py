"""Open-Sora VAE decode of the PyTorch port against the JAX VAE: the tiny VAE
of tests/test_pipeline_open_sora.py, with and without the mid-block
attention, the same params and latents. fp32 decode at 2e-4, the uint8 video
within one level. The port's seeded weights go to JAX by the JAX package's
converters (the reference checkpoint's key names) and come back unchanged
through from_jax; JAX compiles no init program."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.models.autoencoders import autoencoder_open_sora as J
from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JKL
from videosys_tpu.models.autoencoders.vae_temporal import VAETemporal as JT
from videosys_tpu.utils.convert import convert_vae2d, convert_vae_temporal
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as P
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D as PKL
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal as PT
from videosys_tpu_torch.utils.from_jax import open_sora_vae_from_jax

TOL = 2e-4
SPATIAL = dict(block_out_channels=(8, 16), layers_per_block=1, num_groups=4)
TEMPORAL = dict(filters=8, num_res_blocks=1, num_groups=4)


def jax_vae(attention):
    return J.OpenSoraVAE(
        J.OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
        spatial=JKL(mid_block_add_attention=attention, **SPATIAL),
        temporal=JT(**TEMPORAL))


def port_vae(attention):
    return P.OpenSoraVAE(
        P.OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
        spatial=PKL(mid_block_add_attention=attention, **SPATIAL),
        temporal=PT(**TEMPORAL))


def jax_params(pv):
    """The port VAE's weights as the JAX VAE's params; from_jax carries
    them back unchanged."""
    sd = {k: v.numpy() for k, v in pv.state_dict().items()}

    def part(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    params = {"spatial": convert_vae2d(part("spatial_vae.module."),
                                       len(SPATIAL["block_out_channels"])),
              "temporal": convert_vae_temporal(
                  part("temporal_vae."), 4, TEMPORAL["num_res_blocks"])}
    back = open_sora_vae_from_jax(params)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])
    return params


@pytest.mark.parametrize("attention,num_frames", [(False, 18), (True, 5)])
def test_decode_matches_jax(attention, num_frames):
    jv = jax_vae(attention)
    torch.manual_seed(0)
    pv = port_vae(attention).eval()
    params = jax_params(pv)
    t_lat, h, w = pv.get_latent_size((num_frames, 16, 24))
    assert [t_lat, h, w] == jv.get_latent_size((num_frames, 16, 24))
    z = np.random.default_rng(1).standard_normal(
        (1, 4, t_lat, h, w)).astype(np.float32)

    want = np.asarray(jv.decode(params, jnp.asarray(z), num_frames))
    with torch.no_grad():
        got = pv.decode(torch.from_numpy(z), num_frames).numpy()
    assert got.shape == want.shape == (1, 3, num_frames, 16, 24)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    want_u8 = np.concatenate([np.asarray(c) for c in
                              jv.decode_chunks_u8(params, jnp.asarray(z),
                                                  num_frames)], axis=1)
    with torch.no_grad():
        got_u8 = torch.cat(pv.decode_chunks_u8(torch.from_numpy(z),
                                               num_frames), dim=1).numpy()
    assert got_u8.dtype == np.uint8 and got_u8.shape == want_u8.shape
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1

"""Open-Sora v1.2 video VAE: the 2D spatial VAE (8x space) and the causal
temporal VAE (4x time), with 17-frame temporal chunks and a frame
micro-batch for the spatial encoder and decoder.

Port of `videosys_tpu/models/autoencoders/autoencoder_open_sora.py`. The
state_dict keys follow the reference VideoAutoencoderPipeline
(`spatial_vae.module.*`, `temporal_vae.*`). `encode` samples both
posteriors; its draws come from `noise(name, shape)`: "spatial", then
"temporal/{i}" for the chunk starting at frame i.

Under process groups (`parallel.use_groups`) the VAE splits over the cp x
sp ranks of the rank's dp index, as JAX's does over its mesh
(`videosys_tpu/models/autoencoders/autoencoder_open_sora.py:95-115, 162,
222, 234`): the 2D stage over frames (each rank a block of the B*T frames,
in micro-batches of `micro_batch_size`: the micro-batch of the line grows
with its size), the temporal stage over latent rows (`shard_vae_rows`:
halo convolutions, group norms summed over the line), one all-to-all at
the seam between them. Each draw is made whole on every rank, which keeps
its own frames or rows of it: world 1's values. `encode` returns the whole
latents on every rank, `decode` the whole video on every rank,
`decode_chunks_u8` the video on the line's first rank (an empty list on
the others). With no groups, or one rank, every step of the split is
the identity: the same calls as one process makes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal
from videosys_tpu_torch.utils.timing import VAE_CHUNK, span

SHIFT = (-0.10, 0.34, 0.27, 0.98)
SCALE = (3.85, 2.32, 2.33, 3.06)
SPATIAL_SCALING = 0.18215

# noise(name, shape) -> a standard normal draw of that shape
Noise = Callable[[str, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OpenSoraVAEConfig:
    micro_frame_size: int = 17
    micro_batch_size: Optional[int] = 4
    latent_channels: int = 4


class _Holder(nn.Module):
    """Gives the spatial VAE the reference's `spatial_vae.module.` prefix."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module


class OpenSoraVAE(nn.Module):
    """Composition of AutoencoderKL2D and VAETemporal; computes in the
    dtype of its parameters."""

    def __init__(self, config: OpenSoraVAEConfig = OpenSoraVAEConfig(),
                 spatial: Optional[AutoencoderKL2D] = None,
                 temporal: Optional[VAETemporal] = None):
        super().__init__()
        self.config = config
        self.spatial_vae = _Holder(spatial or AutoencoderKL2D())
        self.temporal_vae = temporal or VAETemporal()
        # 17 pixel frames -> 5 latent frames
        self.micro_z_frame_size = -(-config.micro_frame_size // 4)
        sf = 2 ** (len(self.spatial_vae.module.block_out_channels) - 1)
        self.patch_size = (self.temporal_vae.time_downsample_factor, sf, sf)
        self.out_channels = config.latent_channels

    @property
    def dtype(self) -> torch.dtype:
        return self.temporal_vae.post_quant_conv.conv.weight.dtype

    def get_latent_size(self, input_size: Tuple[int, int, int]) -> list:
        """(T, H, W) pixels -> latent sizes, with the chunked time math."""
        T, H, W = input_size
        mf = self.config.micro_frame_size
        tdf, sf = self.patch_size[0], self.patch_size[1]
        if T is None:
            t_lat = None
        elif mf is None:
            t_lat = -(-T // tdf)
        else:
            t_lat = (T // mf) * self.micro_z_frame_size
            rem = T % mf
            if rem > 0:
                t_lat += -(-rem // tdf)
        return [t_lat, H // sf if H else None, W // sf if W else None]

    @staticmethod
    def _draw(noise: Noise, name: str, shape, like):
        return noise(name, tuple(shape)).to(like.device, like.dtype)

    def _map_frames(self, fn, frames):
        """`fn` over [N, C, H, W] frames in micro-batches."""
        mbs = self.config.micro_batch_size or frames.shape[0]
        return torch.cat([fn(frames[i:i + mbs])
                          for i in range(0, frames.shape[0], mbs)], dim=0)

    def spatial_encode(self, x, noise: Noise, rows: Optional[par.RowShard]):
        """x: [B, 3, T, H, W] -> sampled 2D latents [B, 4, T, h, w] scaled
        by 0.18215: this rank's frames in micro-batches, returned as its
        latent rows (the seam; every row on one rank)."""
        B, C, T, H, W = x.shape
        frames, N = par.shard_frames(x.transpose(1, 2).reshape(B * T, C, H,
                                                                W))
        moments = self._map_frames(self.spatial_vae.module.encode, frames)
        mean, logvar = moments.chunk(2, dim=1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        eps = self._draw(noise, "spatial", (N,) + mean.shape[1:], mean)
        z = (mean + std * par.shard_frames(eps)[0]) * SPATIAL_SCALING
        return par.frames_to_rows(z, rows, B, T)

    @torch.no_grad()
    def encode(self, x, noise: Noise):
        """x: [B, 3, T, H, W] pixels -> normalized latents
        [B, 4, T_lat, h, w], each temporal chunk of `micro_frame_size`
        frames encoded on its own."""
        x = x.to(self.dtype)
        h = x.shape[3] // self.patch_size[1]
        rows = par.vae_rows(h)
        x_z = self.spatial_encode(x, noise, rows)
        T = x_z.shape[2]
        mf = self.config.micro_frame_size or T
        z_list = []
        with par.use_rows(rows):
            for i in range(0, T, mf):
                mean, logvar = self.temporal_vae.encode_moments(
                    x_z[:, :, i:i + mf])
                eps = self._draw(noise, f"temporal/{i}",
                                 mean.shape[:3] + (h,) + mean.shape[4:], mean)
                eps = par.shard_vae_rows(eps)[0]
                z_list.append(mean + torch.exp(0.5 * logvar) * eps)
        z = par.gather_rows(torch.cat(z_list, dim=2), rows)
        shift = torch.tensor(SHIFT, dtype=z.dtype, device=z.device)
        scale = torch.tensor(SCALE, dtype=z.dtype, device=z.device)
        return (z - shift[:, None, None, None]) / scale[:, None, None, None]

    def spatial_decode(self, x_z, rows: Optional[par.RowShard],
                       everywhere: bool = True):
        """Row-sharded 2D latents [B, 4, T, h/n, w] -> pixels
        [B, T, 3, H, W] frame-major: the seam, this rank's frames through
        the 2D decoder in micro-batches, and their gather (None off the
        line's first rank unless `everywhere`)."""
        B = x_z.shape[0]
        frames, N = par.rows_to_frames(x_z, rows)
        out = self._map_frames(self.spatial_vae.module.decode,
                               frames / SPATIAL_SCALING)
        out = par.gather_frames(out, N, everywhere)
        return None if out is None else out.reshape(B, -1, *out.shape[1:])

    def _unnormalize(self, z):
        z = z.to(self.dtype)
        shift = torch.tensor(SHIFT, dtype=z.dtype, device=z.device)
        scale = torch.tensor(SCALE, dtype=z.dtype, device=z.device)
        return z * scale[:, None, None, None] + shift[:, None, None, None]

    def _chunks(self, z, num_frames: int):
        """(latent chunk, pixel frames) pairs of the temporal decode."""
        mf = self.config.micro_frame_size
        if mf is None:
            return [(z, num_frames)]
        out, remaining = [], num_frames
        for i in range(0, z.shape[2], self.micro_z_frame_size):
            out.append((z[:, :, i:i + self.micro_z_frame_size],
                        min(mf, remaining)))
            remaining -= mf
        return out

    @torch.no_grad()
    def decode(self, z, num_frames: int):
        """z: [B, C, T_lat, h, w] normalized latents -> pixels
        [B, 3, num_frames, H, W] in [-1, 1] (not clipped)."""
        z, rows = par.shard_vae_rows(self._unnormalize(z))
        with par.use_rows(rows):
            x_z = torch.cat([self.temporal_vae.decode(c, nf)
                             for c, nf in self._chunks(z, num_frames)], dim=2)
        return self.spatial_decode(x_z, rows).transpose(1, 2)

    @torch.no_grad()
    def decode_chunks_u8(self, z, num_frames: int) -> List[torch.Tensor]:
        """Decode one temporal chunk at a time to uint8 [B, nf, H, W, 3]
        video; equal to decode() followed by the uint8 conversion."""
        z, rows = par.shard_vae_rows(self._unnormalize(z))
        outs = []
        for c, nf in self._chunks(z, num_frames):
            with span(VAE_CHUNK):
                with par.use_rows(rows):
                    x_z = self.temporal_vae.decode(c, nf)
                x = self.spatial_decode(x_z, rows, everywhere=False)
                if x is None:  # the video's owner is the line's first rank
                    continue
                x = x.permute(0, 1, 3, 4, 2)
                u8 = torch.clamp((torch.clamp(x, -1, 1) + 1) / 2 * 255 + 0.5,
                                 0, 255)
                outs.append(u8.to(torch.uint8))
        return outs

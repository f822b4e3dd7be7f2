"""CogVideoX's causal 3D VAE, layout [B, C, T, H, W].

Port of `videosys_tpu/models/autoencoders/autoencoder_cogvideox.py`. Module
names follow the reference checkpoint's state_dict (diffusers'
`AutoencoderKLCogVideoX`: `decoder.up_blocks.{i}.resnets.{j}.norm1.conv_y.conv`,
`decoder.up_blocks.{i}.upsamplers.0.conv`, `encoder.down_blocks.{i}...`).

* A causal conv pads the front of the time axis by replicating the first
  frame (kt - 1 copies), or, when streaming, with the previous chunk's last
  raw input frames (`StreamCache`).
* Temporal downsampling averages frame pairs and upsampling repeats frames,
  the first frame kept apart for odd lengths. Resizes are nearest with
  half-pixel centres ("nearest-exact"), as `jax.image.resize` does.
* Every decoder norm is a `SpatialNorm3D`, conditioned on the latent.
* `decode` streams the latent frames two at a time (the first chunk takes
  the remainder) with the causal convs' caches threaded between chunks, so
  norms see per-chunk statistics, as the reference's default decode does;
  with tiling on, each spatial tile is streamed and the tiles are blended
  linearly.
* `encode` runs the encoder over the whole clip (no streaming, no tiling,
  as the JAX package's `_encode_impl`) and samples the posterior.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.models.modules.normalization import GroupNorm
from videosys_tpu_torch.utils.timing import VAE_TILE, span

# causal conv -> its previous chunk's last raw input frames
StreamCache = Dict[nn.Module, torch.Tensor]


class CausalConv3dCog(nn.Module):
    """Conv3d with a replicate-first-frame front pad in time (or the
    streamed previous frames), zero padding in space, stride (s, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 time_stride: int = 1):
        super().__init__()
        kt, kh, kw = kernel_size
        self.time_pad = kt - time_stride
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                              stride=(time_stride, 1, 1),
                              padding=(0, kh // 2, kw // 2))

    def forward(self, x, cache: Optional[StreamCache] = None):
        p = self.time_pad
        if p > 0:
            prev = cache.get(self) if cache is not None else None
            if prev is not None and prev.shape[2] == p:
                front = prev.to(x.dtype)
            else:
                front = x[:, :, :1].expand(-1, -1, p, -1, -1)
            if cache is not None:
                cache[self] = x[:, :, -p:]
            x = torch.cat([front, x], dim=2)
        return self.conv(x)


def resize_nearest(x, t: int, h: int, w: int):
    """Nearest resize of [B, C, T, H, W] with half-pixel centres."""
    return F.interpolate(x, size=(t, h, w), mode="nearest-exact")


class SpatialNorm3D(nn.Module):
    """GroupNorm(f) * conv_y(zq) + conv_b(zq), zq resized to f (the first
    frame apart when f has an odd frame count above one)."""

    def __init__(self, f_channels: int, zq_channels: int, groups: int = 32):
        super().__init__()
        self.norm_layer = GroupNorm(groups, f_channels, eps=1e-6)
        self.conv_y = CausalConv3dCog(zq_channels, f_channels, (1, 1, 1))
        self.conv_b = CausalConv3dCog(zq_channels, f_channels, (1, 1, 1))

    def forward(self, f, zq, cache: Optional[StreamCache] = None):
        Tf, Hf, Wf = f.shape[2:]
        if Tf > 1 and Tf % 2 == 1:
            zq = torch.cat([resize_nearest(zq[:, :, :1], 1, Hf, Wf),
                            resize_nearest(zq[:, :, 1:], Tf - 1, Hf, Wf)], 2)
        else:
            zq = resize_nearest(zq, Tf, Hf, Wf)
        return self.norm_layer(f) * self.conv_y(zq, cache) \
            + self.conv_b(zq, cache)


class ResnetBlock3DCog(nn.Module):
    """norm, SiLU, causal conv, twice, plus a 1x1x1 shortcut conv when the
    width changes; the norms are SpatialNorm3D when `zq_channels` is set."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6, zq_channels: Optional[int] = None):
        super().__init__()

        def norm(c):
            if zq_channels is not None:
                return SpatialNorm3D(c, zq_channels, groups)
            return GroupNorm(groups, c, eps=eps)

        self.spatial = zq_channels is not None
        self.norm1 = norm(in_channels)
        self.conv1 = CausalConv3dCog(in_channels, out_channels)
        self.norm2 = norm(out_channels)
        self.conv2 = CausalConv3dCog(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv3d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def _norm(self, norm, h, zq, cache):
        return norm(h, zq, cache) if self.spatial else norm(h)

    def forward(self, x, zq=None, cache: Optional[StreamCache] = None):
        h = self.conv1(F.silu(self._norm(self.norm1, x, zq, cache)), cache)
        h = self.conv2(F.silu(self._norm(self.norm2, h, zq, cache)), cache)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _per_frame(conv: nn.Conv2d, x):
    """A Conv2d on every frame of [B, C, T, H, W]."""
    B, C, T, H, W = x.shape
    y = conv(x.transpose(1, 2).reshape(B * T, C, H, W))
    return y.reshape(B, T, *y.shape[1:]).transpose(1, 2)


class Downsample3DCog(nn.Module):
    """Optional temporal average of frame pairs (the first frame kept for an
    odd count), then a zero pad (0, 1) and a stride-2 3x3 conv per frame."""

    def __init__(self, in_channels: int, out_channels: int,
                 compress_time: bool = False):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=2)

    def forward(self, x):
        T = x.shape[2]
        if self.compress_time and T > 1:
            if T % 2 == 1:
                rest = x[:, :, 1:]
                x = torch.cat([x[:, :, :1],
                               (rest[:, :, 0::2] + rest[:, :, 1::2]) / 2.0], 2)
            else:
                x = (x[:, :, 0::2] + x[:, :, 1::2]) / 2.0
        return _per_frame(self.conv, F.pad(x, (0, 1, 0, 1)))


class Upsample3DCog(nn.Module):
    """Nearest x2 in space (and in time with `compress_time`, the first
    frame kept single for an odd count), then a 3x3 conv per frame."""

    def __init__(self, in_channels: int, out_channels: int,
                 compress_time: bool = False):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        T, H, W = x.shape[2:]
        if self.compress_time and T > 1 and T % 2 == 1:
            x = torch.cat([resize_nearest(x[:, :, :1], 1, 2 * H, 2 * W),
                           resize_nearest(x[:, :, 1:], 2 * (T - 1), 2 * H,
                                          2 * W)], 2)
        elif self.compress_time and T > 1:
            x = resize_nearest(x, 2 * T, 2 * H, 2 * W)
        else:
            x = resize_nearest(x, T, 2 * H, 2 * W)
        return _per_frame(self.conv, x)


class _Block(nn.Module):
    """A down or up stage: `resnets` and an optional sampler (the
    reference's `downsamplers.0` / `upsamplers.0`)."""

    def __init__(self, resnets, sampler_name: str, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _MidBlock(nn.Module):
    def __init__(self, resnets):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)


def _time_compress_levels(ratio: int) -> int:
    return {4: 2, 2: 1, 1: 0}[ratio]


class CogVideoXEncoder3D(nn.Module):
    """[B, 3, T, H, W] -> moments [B, 2 * latent, T', H/8, W/8]."""

    def __init__(self, in_channels: int = 3, latent_channels: int = 16,
                 block_out_channels: Tuple[int, ...] = (128, 256, 256, 512),
                 layers_per_block: int = 3, norm_num_groups: int = 32,
                 temporal_compression_ratio: int = 4):
        super().__init__()
        ch = tuple(block_out_channels)
        tcl = _time_compress_levels(temporal_compression_ratio)
        g = norm_num_groups
        self.conv_in = CausalConv3dCog(in_channels, ch[0])
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, c in enumerate(ch):
            resnets = [ResnetBlock3DCog(prev if j == 0 else c, c, g)
                       for j in range(layers_per_block)]
            down = (Downsample3DCog(c, c, compress_time=i < tcl)
                    if i < len(ch) - 1 else None)
            self.down_blocks.append(_Block(resnets, "downsamplers", down))
            prev = c
        self.mid_block = _MidBlock([ResnetBlock3DCog(prev, prev, g)
                                    for _ in range(2)])
        self.norm_out = GroupNorm(g, prev, eps=1e-6)
        self.conv_out = CausalConv3dCog(prev, 2 * latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        for res in self.mid_block.resnets:
            h = res(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class CogVideoXDecoder3D(nn.Module):
    """z [B, latent, T', h, w] -> pixels [B, 3, T, 8h, 8w]; every norm is
    conditioned on z."""

    def __init__(self, latent_channels: int = 16, out_channels: int = 3,
                 block_out_channels: Tuple[int, ...] = (128, 256, 256, 512),
                 layers_per_block: int = 3, norm_num_groups: int = 32,
                 temporal_compression_ratio: int = 4):
        super().__init__()
        rev = tuple(reversed(block_out_channels))
        tcl = _time_compress_levels(temporal_compression_ratio)
        g, zc = norm_num_groups, latent_channels
        self.conv_in = CausalConv3dCog(latent_channels, rev[0])
        self.mid_block = _MidBlock([
            ResnetBlock3DCog(rev[0], rev[0], g, zq_channels=zc)
            for _ in range(2)])
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, c in enumerate(rev):
            resnets = [ResnetBlock3DCog(prev if j == 0 else c, c, g,
                                        zq_channels=zc)
                       for j in range(layers_per_block + 1)]
            up = (Upsample3DCog(c, c, compress_time=i < tcl)
                  if i < len(rev) - 1 else None)
            self.up_blocks.append(_Block(resnets, "upsamplers", up))
            prev = c
        self.norm_out = SpatialNorm3D(prev, zc, g)
        self.conv_out = CausalConv3dCog(prev, out_channels)

    def forward(self, z, cache: Optional[StreamCache] = None):
        h = self.conv_in(z, cache)
        for res in self.mid_block.resnets:
            h = res(h, z, cache)
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h, z, cache)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        h = F.silu(self.norm_out(h, z, cache))
        return self.conv_out(h, cache)


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426
    # latent frames per streamed decode chunk (the first takes the rest)
    num_latent_frames_batch_size: int = 2
    # tiling: tile sizes in latent space and their overlaps
    tile_latent_min_height: int = 30
    tile_latent_min_width: int = 45
    tile_overlap_factor_height: float = 1 / 6
    tile_overlap_factor_width: float = 1 / 5


class AutoencoderKLCogVideoX(nn.Module):
    """`encode` pixels [B, 3, T, H, W] -> a latent sample
    [B, C_lat, T', H/8, W/8] and `decode` back (the reference's layouts);
    `moments` gives the posterior's mean and log-variance."""

    def __init__(self, config: CogVideoXVAEConfig = CogVideoXVAEConfig()):
        super().__init__()
        self.config = config
        kw = dict(latent_channels=config.latent_channels,
                  block_out_channels=config.block_out_channels,
                  layers_per_block=config.layers_per_block,
                  norm_num_groups=config.norm_num_groups,
                  temporal_compression_ratio=config.temporal_compression_ratio)
        self.encoder = CogVideoXEncoder3D(**kw)
        self.decoder = CogVideoXDecoder3D(out_channels=3, **kw)
        self.use_tiling = False
        self.spatial_factor = 2 ** (len(config.block_out_channels) - 1)

    def enable_tiling(self):
        self.use_tiling = True

    def moments(self, x):
        """x: [B, 3, T, H, W] -> (mean, logvar), each [B, C_lat, T', H/8,
        W/8], logvar clipped to [-30, 20]: the encoder over the whole clip
        in its parameters' dtype."""
        h = self.encoder(x.to(self.encoder.conv_out.conv.weight.dtype))
        mean, logvar = h.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """x: [B, 3, T, H, W] -> latent sample mean + std * noise
        [B, C_lat, T', H/8, W/8]. `noise`, of the mean's shape, is drawn
        from `generator` (on the mean's device) when not given; one of the
        two is needed."""
        mean, logvar = self.moments(x)
        if noise is None:
            if generator is None:
                raise ValueError("encode samples the posterior: pass noise "
                                 "or a generator")
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.device,
                                                         mean.dtype)

    def _decode_streamed(self, z):
        """Decode the latent frames `num_latent_frames_batch_size` at a time
        (the first chunk takes the remainder), the causal convs' caches
        threaded between chunks."""
        fbs = self.config.num_latent_frames_batch_size
        T = z.shape[2]
        if T <= fbs:
            return self.decoder(z)
        first = fbs + T % fbs
        bounds = [(0, first)] + [(s, s + fbs) for s in range(first, T, fbs)]
        cache: StreamCache = {}
        return torch.cat([self.decoder(z[:, :, s0:s1], cache)
                          for s0, s1 in bounds], dim=2)

    def decode(self, z):
        """z: [B, C_lat, T', h, w] -> [B, 3, T, H, W], streamed (tiled when
        tiling is on and z is larger than one tile)."""
        c = self.config
        z = z.to(self.decoder.conv_out.conv.weight.dtype)
        if self.use_tiling and (z.shape[3] > c.tile_latent_min_height
                                or z.shape[4] > c.tile_latent_min_width):
            return self._tiled_decode(z)
        return self._decode_streamed(z)

    def _tiled_decode(self, z):
        """Spatial tiles, each streamed, blended linearly where they
        overlap (the reference's step and blend arithmetic)."""
        c = self.config
        sf = self.spatial_factor
        th, tw = c.tile_latent_min_height, c.tile_latent_min_width
        step_h = int(th * (1 - c.tile_overlap_factor_height))
        step_w = int(tw * (1 - c.tile_overlap_factor_width))
        blend_h = int(th * sf * c.tile_overlap_factor_height)
        blend_w = int(tw * sf * c.tile_overlap_factor_width)
        limit_h, limit_w = th * sf - blend_h, tw * sf - blend_w

        H, W = z.shape[3], z.shape[4]

        def tile(i, j):
            with span(VAE_TILE):
                return self._decode_streamed(z[:, :, :, i:i + th, j:j + tw])

        rows = [[tile(i, j) for j in range(0, W, step_w)]
                for i in range(0, H, step_h)]

        def blend(a, b, extent, dim):
            n = min(a.shape[dim], extent)
            shape = [1] * a.ndim
            shape[dim] = n
            w = (torch.arange(n, device=a.device) / n).reshape(shape)
            mixed = a.narrow(dim, a.shape[dim] - n, n) * (1 - w) \
                + b.narrow(dim, 0, n) * w
            b = b.clone()
            b.narrow(dim, 0, n).copy_(mixed)
            return b

        out_rows = []
        for i, row in enumerate(rows):
            out_row = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = blend(rows[i - 1][j], tile, blend_h, 3)
                if j > 0:
                    tile = blend(row[j - 1], tile, blend_w, 4)
                out_row.append(tile[:, :, :, :limit_h, :limit_w])
            out_rows.append(torch.cat(out_row, dim=4))
        return torch.cat(out_rows, dim=3)

"""Causal temporal VAE (MAGVIT style), layout [B, C, T, H, W].

Port of `videosys_tpu/models/autoencoders/vae_temporal.py`. Module names
follow the reference VAE_Temporal state_dict (`res_blocks.j`,
`block_res_blocks.i.j`, `conv_blocks.i.conv`).

Under `parallel.use_rows` (the VAE split over ranks) each rank holds a
share of the rows h: a convolution with kernel 3 in h takes a one-row halo
from each neighbour in place of its zero pad (the line's first and last
ranks keep the zero pad) and the group norms sum their statistics over the
line. Strides and the depth-to-space upsample act on T only, so every rank's
rows stay the same rows through the whole stage.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.models.modules.normalization import GroupNorm


class CausalConv3d(nn.Module):
    """Conv3d with front-only temporal padding (kt - time_stride frames)
    and symmetric spatial padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 bias: bool = True, time_stride: int = 1):
        super().__init__()
        kt, kh, kw = kernel_size
        self.halo = kh // 2
        self.pad = (kw // 2, kw // 2, kh // 2, kh // 2, kt - time_stride, 0)
        stride = (time_stride, 1, 1)
        # a row split holds only where no conv strides over rows
        assert stride[1:] == (1, 1), stride
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                              stride=stride, bias=bias)

    def forward(self, x):
        rows = par.active_rows()
        if rows is None or not self.halo:
            return self.conv(F.pad(x, self.pad))
        # zero the pad rows (they stand for the conv's own zero pad), then
        # the neighbours' edge rows in place of the h pad
        x = par.halo_exchange(rows.mask(x), 3, self.halo, rows.axis)
        return self.conv(F.pad(x, self.pad[:2] + (0, 0) + self.pad[4:]))


class ResBlock3D(nn.Module):
    """GroupNorm-SiLU-CausalConv twice, plus a 1x1x1 shortcut."""

    def __init__(self, in_channels: int, filters: int, num_groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(num_groups, in_channels, eps=1e-5)
        self.conv1 = CausalConv3d(in_channels, filters, bias=False)
        self.norm2 = GroupNorm(num_groups, filters, eps=1e-5)
        self.conv2 = CausalConv3d(filters, filters, bias=False)
        self.conv3 = (CausalConv3d(in_channels, filters, (1, 1, 1), bias=False)
                      if in_channels != filters else None)

    def forward(self, x):
        rows = par.active_rows()
        h = self.conv1(F.silu(self.norm1(x, rows)))
        h = self.conv2(F.silu(self.norm2(h, rows)))
        if self.conv3 is not None:
            x = self.conv3(x)
        return x + h


class EncoderTemporal(nn.Module):
    """Encoder with stride-2 causal convolutions in time between the stages
    `temporal_downsample` marks: [B, C, T, H, W] -> [B, latent_embed_dim,
    T / 2^sum(temporal_downsample), H, W]."""

    def __init__(self, in_out_channels: int = 4, latent_embed_dim: int = 8,
                 filters: int = 128, num_res_blocks: int = 4,
                 channel_multipliers: Tuple[int, ...] = (1, 2, 2, 4),
                 temporal_downsample: Tuple[bool, ...] = (False, True, True),
                 num_groups: int = 32):
        super().__init__()
        mult = tuple(channel_multipliers)
        self.conv_in = CausalConv3d(in_out_channels, filters, bias=False)
        self.block_res_blocks = nn.ModuleList()
        self.conv_blocks = nn.ModuleDict()
        prev = filters
        for i, m in enumerate(mult):
            f = filters * m
            self.block_res_blocks.append(nn.ModuleList(
                ResBlock3D(prev if j == 0 else f, f, num_groups)
                for j in range(num_res_blocks)))
            prev = f
            if i < len(mult) - 1 and temporal_downsample[i]:
                self.conv_blocks[str(i)] = CausalConv3d(f, f, time_stride=2)
        self.res_blocks = nn.ModuleList(
            ResBlock3D(prev, prev, num_groups) for _ in range(num_res_blocks))
        self.norm1 = GroupNorm(num_groups, prev, eps=1e-5)
        self.conv2 = CausalConv3d(prev, latent_embed_dim, (1, 1, 1))

    def forward(self, x):
        h = self.conv_in(x)
        for i, blocks in enumerate(self.block_res_blocks):
            for res in blocks:
                h = res(h)
            if str(i) in self.conv_blocks:
                h = self.conv_blocks[str(i)](h)
        for res in self.res_blocks:
            h = res(h)
        return self.conv2(F.silu(self.norm1(h, par.active_rows())))


class DecoderTemporal(nn.Module):
    """Decoder with temporal depth-to-space upsampling."""

    def __init__(self, latent_channels: int = 4, out_channels: int = 4,
                 filters: int = 128, num_res_blocks: int = 4,
                 channel_multipliers: Tuple[int, ...] = (1, 2, 2, 4),
                 temporal_downsample: Tuple[bool, ...] = (False, True, True),
                 num_groups: int = 32):
        super().__init__()
        self.temporal_downsample = tuple(temporal_downsample)
        mult = tuple(channel_multipliers)
        top = filters * mult[-1]
        self.conv1 = CausalConv3d(latent_channels, top)
        self.res_blocks = nn.ModuleList(
            ResBlock3D(top, top, num_groups) for _ in range(num_res_blocks))
        self.block_res_blocks = nn.ModuleList()
        self.conv_blocks = nn.ModuleDict()
        prev = top
        for i in range(len(mult)):
            self.block_res_blocks.append(nn.ModuleList())
        for i in reversed(range(len(mult))):
            f = filters * mult[i]
            self.block_res_blocks[i].extend(
                ResBlock3D(prev if j == 0 else f, f, num_groups)
                for j in range(num_res_blocks))
            prev = f
            if i > 0 and self.temporal_downsample[i - 1]:
                self.conv_blocks[str(i - 1)] = CausalConv3d(f, f * 2)
        self.norm1 = GroupNorm(num_groups, prev, eps=1e-5)
        self.conv_out = CausalConv3d(prev, out_channels)

    def forward(self, z):
        h = self.conv1(z)
        for res in self.res_blocks:
            h = res(h)
        for i in reversed(range(len(self.block_res_blocks))):
            for res in self.block_res_blocks[i]:
                h = res(h)
            if str(i - 1) in self.conv_blocks:
                h = self.conv_blocks[str(i - 1)](h)
                # depth to space on time: channel c*2 + s -> frame t*2 + s
                B, C2, T, H, W = h.shape
                h = h.reshape(B, C2 // 2, 2, T, H, W).transpose(2, 3)
                h = h.reshape(B, C2 // 2, T * 2, H, W)
        return self.conv_out(F.silu(self.norm1(h, par.active_rows())))


class VAETemporal(nn.Module):
    """VAE_Temporal_SD: latent 4 channels, 4x time."""

    def __init__(self, in_out_channels: int = 4, latent_embed_dim: int = 4,
                 embed_dim: int = 4, filters: int = 128,
                 num_res_blocks: int = 4,
                 channel_multipliers: Tuple[int, ...] = (1, 2, 2, 4),
                 temporal_downsample: Tuple[bool, ...] = (False, True, True),
                 num_groups: int = 32):
        super().__init__()
        self.time_downsample_factor = 2 ** sum(temporal_downsample)
        self.encoder = EncoderTemporal(
            in_out_channels, latent_embed_dim * 2, filters, num_res_blocks,
            channel_multipliers, temporal_downsample, num_groups)
        self.quant_conv = CausalConv3d(latent_embed_dim * 2, 2 * embed_dim,
                                       (1, 1, 1))
        self.post_quant_conv = CausalConv3d(embed_dim, latent_embed_dim,
                                            (1, 1, 1))
        self.decoder = DecoderTemporal(
            latent_embed_dim, in_out_channels, filters, num_res_blocks,
            channel_multipliers, temporal_downsample, num_groups)

    def encode_moments(self, x):
        """x: [B, C, T, h, w], T front-padded with zeros to a multiple of
        the downsample factor -> (mean, logvar clipped to [-30, 20]), each
        [B, embed_dim, T_lat, h, w]."""
        time_padding = (-x.shape[2]) % self.time_downsample_factor
        if time_padding:
            x = F.pad(x, (0, 0, 0, 0, time_padding, 0))
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z, num_frames: int):
        """z: [B, C, T_lat, h, w] -> [B, C_out, num_frames, h, w]."""
        time_padding = (-num_frames) % self.time_downsample_factor
        x = self.decoder(self.post_quant_conv(z))
        return x[:, :, time_padding:time_padding + num_frames]

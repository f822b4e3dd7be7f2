"""2D image VAE (SD AutoencoderKL architecture), channel-first.

Port of `videosys_tpu/models/autoencoders/vae2d.py`. Module names follow
the diffusers AutoencoderKL state_dict (`mid_block.resnets.0`,
`mid_block.attentions.0.to_out.0`, `down_blocks.{i}.downsamplers.0.conv`,
`up_blocks.{i}.upsamplers.0.conv`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.models.modules.normalization import GroupNorm
from videosys_tpu_torch.ops.attention import scaled_dot_product_attention


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(num_groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(num_groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock2D(nn.Module):
    """Single-head self-attention over the spatial positions (VAE mid
    block); on a card it runs the flash kernel (D = C = 512)."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(num_groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = (f(h)[:, None] for f in (self.to_q, self.to_k, self.to_v))
        o = scaled_dot_product_attention(q, k, v, scale=C ** -0.5)[:, 0]
        o = self.to_out[0](o)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


class MidBlock2D(nn.Module):
    def __init__(self, channels: int, num_groups: int, add_attention: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(channels, channels, num_groups) for _ in range(2))
        self.attentions = nn.ModuleList(
            [AttnBlock2D(channels, num_groups)] if add_attention else [])

    def forward(self, h):
        h = self.resnets[0](h)
        for attn in self.attentions:
            h = attn(h)
        return self.resnets[1](h)


class Downsample2D(nn.Module):
    """diffusers Downsample2D: asymmetric pad (0, 1, 0, 1), then a stride-2
    3x3 convolution without padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, h):
        return self.conv(F.pad(h, (0, 1, 0, 1)))


class DownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 num_groups: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if j == 0 else out_channels,
                          out_channels, num_groups)
            for j in range(num_layers))
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels)] if downsample else [])

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        for down in self.downsamplers:
            h = down(h)
        return h


class Encoder2D(nn.Module):
    """Pixels [B, in_channels, H, W] -> moments [B, 2 * latent, H / f, W / f],
    f = 2^(len(block_out_channels) - 1)."""

    def __init__(self, block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 in_channels: int = 3, num_groups: int = 32,
                 mid_block_add_attention: bool = True):
        super().__init__()
        ch = tuple(block_out_channels)
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            DownBlock2D(ch[max(i - 1, 0)], c, layers_per_block, num_groups,
                        downsample=i < len(ch) - 1)
            for i, c in enumerate(ch))
        self.mid_block = MidBlock2D(ch[-1], num_groups, mid_block_add_attention)
        self.conv_norm_out = GroupNorm(num_groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for down in self.down_blocks:
            h = down(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, h):
        return self.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))


class UpBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 num_groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if j == 0 else out_channels,
                          out_channels, num_groups)
            for j in range(num_layers))
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels)] if upsample else [])

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        for up in self.upsamplers:
            h = up(h)
        return h


class Decoder2D(nn.Module):
    def __init__(self, block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 out_channels: int = 3, num_groups: int = 32,
                 mid_block_add_attention: bool = True):
        super().__init__()
        ch = tuple(block_out_channels)
        self.conv_in = nn.Conv2d(latent_channels, ch[-1], 3, padding=1)
        self.mid_block = MidBlock2D(ch[-1], num_groups, mid_block_add_attention)
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList(
            UpBlock2D(rev[max(i - 1, 0)], c, layers_per_block + 1, num_groups,
                      upsample=i < len(ch) - 1)
            for i, c in enumerate(rev))
        self.conv_norm_out = GroupNorm(num_groups, ch[0], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[0], out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for up in self.up_blocks:
            h = up(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL2D(nn.Module):
    """SD-style KL autoencoder: encode(x [B, 3, H, W]) -> moments
    [B, 2 * latent, H / f, W / f]; decode(z [B, latent, h, w]) ->
    [B, 3, h * f, w * f], f = 2^(len(blocks) - 1)."""

    def __init__(self, block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 out_channels: int = 3, num_groups: int = 32,
                 mid_block_add_attention: bool = True):
        super().__init__()
        self.block_out_channels = tuple(block_out_channels)
        self.encoder = Encoder2D(block_out_channels, layers_per_block,
                                 latent_channels, out_channels, num_groups,
                                 mid_block_add_attention)
        self.decoder = Decoder2D(block_out_channels, layers_per_block,
                                 latent_channels, out_channels, num_groups,
                                 mid_block_add_attention)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def encode(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

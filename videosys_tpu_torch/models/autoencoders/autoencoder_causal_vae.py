"""Open-Sora-Plan's causal video VAE (v1.1 and v1.2), channel-first, with
the tiled codec.

Port of `videosys_tpu/models/autoencoders/autoencoder_causal_vae.py`.
Both released checkpoints are instances of one op-registry architecture
(`VAE_OPS`), so either version's config maps directly. Activations are
[B, C, T, H, W]. Causal convolutions replicate the first frame (k_t - 1
times) in place of zero padding in time; per-frame 2D convolutions run as
3D ones with a kernel of 1 in time. Module names follow the reference
checkpoint (`encoder.down.{i}.block.{j}`, `encoder.mid.attn_1`,
`decoder.up.{i}.upsample`, `quant_conv.conv`, ...), so its state_dict loads
as it is.

The mid attention (`AttnBlock3DFix`, registry name "AttnBlock" too) is
single-head over each frame's positions at the channel width (512): on a
card the wide flash kernel. `AttnBlock3D` is v1.1's pre-fix block, whose
reshape scrambles channels and time into the attention rows; the v1.1
checkpoint was trained with it, so it is kept, and its attention runs
through the same entry point as [B·T, 1, HW, C] after the scramble.

`CausalVAE` adds the scaling, `encode` (its noise from `draw(name,
shape)`), `decode`, and the tiled codec: temporal chunks with a one-frame
overlap (`_t_chunks`), each cut into 2D tiles blended linearly
(`_tiled_2d`), with each version's tile sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.models.modules.normalization import GroupNorm
from videosys_tpu_torch.ops.attention import scaled_dot_product_attention

Draw = Callable[[str, Tuple[int, ...]], torch.Tensor]


def _triple(k) -> Tuple[int, int, int]:
    return tuple(k) if isinstance(k, (tuple, list)) else (k, k, k)


def _groups(c: int) -> int:
    """32 groups (the reference's Normalize), fewer for narrow test
    widths: the largest divisor of c up to 32."""
    g = min(32, c)
    while c % g:
        g -= 1
    return g


def _norm(c: int) -> GroupNorm:
    return GroupNorm(_groups(c), c, eps=1e-6)


def _first_frame_pad(x, n: int):
    """x [B, C, T, H, W] with `n` copies of frame 0 in front."""
    if n <= 0:
        return x
    return torch.cat([x[:, :, :1].expand(-1, -1, n, -1, -1), x], dim=2)


def _frame_conv(conv: nn.Conv2d, x, stride: int = 1, padding: int = 0):
    """A 2D convolution applied to every frame of x [B, C, T, H, W]."""
    return F.conv3d(x, conv.weight[:, :, None], conv.bias,
                    stride=(1, stride, stride), padding=(0, padding, padding))


class CausalConv3d(nn.Module):
    """Conv3d after (k_t - 1) copies of frame 0 in time; spatial padding
    k // 2 ("same") unless `spatial_padding` is given."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, spatial_padding: Optional[int] = None):
        super().__init__()
        k = _triple(kernel_size)
        self.time_pad = k[0] - 1
        ph = k[1] // 2 if spatial_padding is None else spatial_padding
        pw = k[2] // 2 if spatial_padding is None else spatial_padding
        self.conv = nn.Conv3d(in_channels, out_channels, k, stride=stride,
                              padding=(0, ph, pw))

    def forward(self, x):
        return self.conv(_first_frame_pad(x, self.time_pad))


class Conv2dOp(nn.Conv2d):
    """Per-frame Conv2d (the reference's video_to_image wrapper); its
    weights sit on the op itself."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=padding)

    def forward(self, x):
        return _frame_conv(self, x, padding=self.padding[0])


class ResnetBlock3D(nn.Module):
    """GroupNorm, swish, causal 3x3x3 conv, twice; a 1x1x1 causal
    `nin_shortcut` when the width changes."""

    conv_cls = CausalConv3d

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = self.conv_cls(in_channels, out_channels)
        self.norm2 = _norm(out_channels)
        self.conv2 = self.conv_cls(out_channels, out_channels)
        if in_channels != out_channels:
            self.nin_shortcut = self._shortcut(in_channels, out_channels)

    def _shortcut(self, cin: int, cout: int) -> nn.Module:
        return CausalConv3d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class ResnetBlock2D(ResnetBlock3D):
    """ResnetBlock3D with per-frame 2D convolutions."""

    conv_cls = Conv2dOp

    def _shortcut(self, cin: int, cout: int) -> nn.Module:
        return Conv2dOp(cin, cout, kernel_size=1, padding=0)


class _Attn(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 0):
        super().__init__()
        c = in_channels
        self.norm = _norm(c)
        self.q, self.k, self.v, self.proj_out = (CausalConv3d(c, c, 1)
                                                 for _ in range(4))

    def _qkv(self, x):
        h = self.norm(x)
        return self.q(h), self.k(h), self.v(h)


class AttnBlock3D(_Attn):
    """Single-head self-attention over each frame's H x W positions at the
    channel width, 1x1x1 causal projections (AttnBlock3DFix)."""

    def forward(self, x):
        B, C, T, H, W = x.shape
        q, k, v = (t.permute(0, 2, 3, 4, 1).reshape(B * T, 1, H * W, C)
                   for t in self._qkv(x))
        h = scaled_dot_product_attention(q, k, v, scale=C ** -0.5)
        h = h.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)
        return x + self.proj_out(h)


class AttnBlock3DLegacy(_Attn):
    """v1.1's pre-fix `AttnBlock3D`: [B, C, T, H, W] read as [B·T, C, H·W]
    without moving time in front of the channels, so each attention row
    mixes channels and frames; the attention itself is the same function
    as the fixed block's, over those rows."""

    def forward(self, x):
        B, C, T, H, W = x.shape
        q, k, v = (t.reshape(B * T, C, H * W).transpose(1, 2)[:, None]
                   for t in self._qkv(x))
        h = scaled_dot_product_attention(q, k, v, scale=C ** -0.5)
        h = h[:, 0].transpose(1, 2).reshape(B, C, T, H, W)
        return x + self.proj_out(h)


class SpatialDownsample2x(nn.Module):
    """(0, 1) zero pad in H and W, then a 1x3x3 stride-2 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = CausalConv3d(in_channels, out_channels, (1, 3, 3),
                                 stride=(1, 2, 2), spatial_padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Downsample(nn.Module):
    """v1.2's per-frame stride-2 3x3 conv after a (0, 1) pad."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=2)

    def forward(self, x):
        return _frame_conv(self.conv, F.pad(x, (0, 1, 0, 1)), stride=2)


class SpatialUpsample2x(nn.Module):
    """Nearest 2x in H and W, then a 1x3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = CausalConv3d(in_channels, out_channels, (1, 3, 3))

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=(1, 2, 2),
                                       mode="nearest"))


def _time_pool(x, k: int = 3):
    """(k - 1) copies of frame 0, then a stride-2 mean over k frames."""
    return F.avg_pool3d(_first_frame_pad(x, k - 1), (k, 1, 1),
                        stride=(2, 1, 1))


def _time_upsample(x):
    """Frame 0 kept, the rest doubled in time (linear, half-pixel)."""
    B, C, T, H, W = x.shape
    if T == 1:
        return x
    rest = F.interpolate(x[:, :, 1:], size=(2 * (T - 1), H, W),
                         mode="trilinear", align_corners=False)
    return torch.cat([x[:, :, :1], rest], dim=2)


class TimeDownsample2x(nn.Module):
    def __init__(self, in_channels: int = 0, out_channels: int = 0):
        super().__init__()

    def forward(self, x):
        return _time_pool(x)


class TimeUpsample2x(TimeDownsample2x):
    def forward(self, x):
        return _time_upsample(x)


class TimeDownsampleRes2x(nn.Module):
    """sigmoid(mix) x the time pool + (1 - sigmoid(mix)) x a (3, 3, 3)
    conv of stride 2 in time over the same padded frames."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.full((1,), 2.0))
        self.conv = nn.Conv3d(in_channels, out_channels, 3, stride=(2, 1, 1),
                              padding=(0, 1, 1))

    def forward(self, x):
        alpha = torch.sigmoid(self.mix_factor)
        return alpha * _time_pool(x) + (1 - alpha) * self.conv(
            _first_frame_pad(x, 2))


class TimeUpsampleRes2x(nn.Module):
    """sigmoid(mix) x the time upsample + (1 - sigmoid(mix)) x a causal
    conv of it."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.full((1,), 2.0))
        self.conv = CausalConv3d(in_channels, out_channels)

    def forward(self, x):
        alpha = torch.sigmoid(self.mix_factor)
        x = _time_upsample(x)
        return alpha * x + (1 - alpha) * self.conv(x)


class Spatial2xTime2x3DDownsample(nn.Module):
    """(0, 1) pad in H and W, then a causal 3x3x3 conv of stride 2."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = CausalConv3d(in_channels, out_channels, 3, stride=2,
                                 spatial_padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Spatial2xTime2x3DUpsample(nn.Module):
    """Trilinear 2x in T, H and W on frames 1.. (2x in H and W on frame 0),
    then a causal 3x3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = CausalConv3d(in_channels, out_channels)

    def forward(self, x):
        B, C, T, H, W = x.shape
        head = F.interpolate(x[:, :, :1], size=(1, 2 * H, 2 * W),
                             mode="trilinear", align_corners=False)
        if T > 1:
            rest = F.interpolate(x[:, :, 1:], size=(2 * (T - 1), 2 * H, 2 * W),
                                 mode="trilinear", align_corners=False)
            head = torch.cat([head, rest], dim=2)
        return self.conv(head)


VAE_OPS = {
    "CausalConv3d": CausalConv3d,
    "Conv2d": Conv2dOp,
    "ResnetBlock2D": ResnetBlock2D,
    "ResnetBlock3D": ResnetBlock3D,
    "AttnBlock": AttnBlock3D,
    # v1.1's "AttnBlock3D" is the pre-fix block its checkpoint was trained
    # with; "AttnBlock3DFix" is the corrected one
    "AttnBlock3D": AttnBlock3DLegacy,
    "AttnBlock3DFix": AttnBlock3D,
    "Downsample": Downsample,
    "SpatialDownsample2x": SpatialDownsample2x,
    "SpatialUpsample2x": SpatialUpsample2x,
    "TimeDownsample2x": TimeDownsample2x,
    "TimeUpsample2x": TimeUpsample2x,
    "TimeDownsampleRes2x": TimeDownsampleRes2x,
    "TimeUpsampleRes2x": TimeUpsampleRes2x,
    "Spatial2xTime2x3DDownsample": Spatial2xTime2x3DDownsample,
    "Spatial2xTime2x3DUpsample": Spatial2xTime2x3DUpsample,
}


@dataclasses.dataclass(frozen=True)
class CausalVAEConfig:
    """The registry config of CausalVAEModel; the defaults are the released
    v1.1 CausalVAEModel_4x8x8, `v120()` the v1.2 one."""

    hidden_size: int = 128
    z_channels: int = 4
    embed_dim: int = 4
    hidden_size_mult: Tuple[int, ...] = (1, 2, 4, 4)
    attn_resolutions: Tuple[int, ...] = ()
    resolution: int = 256
    num_res_blocks: int = 2
    double_z: bool = True
    use_quant_layer: bool = True
    encoder_conv_in: str = "CausalConv3d"
    encoder_conv_out: str = "CausalConv3d"
    encoder_attention: str = "AttnBlock3D"
    encoder_resnet_blocks: Tuple[str, ...] = ("ResnetBlock3D",) * 4
    encoder_spatial_downsample: Tuple[str, ...] = (
        "SpatialDownsample2x", "SpatialDownsample2x", "SpatialDownsample2x", "")
    encoder_temporal_downsample: Tuple[str, ...] = (
        "", "TimeDownsample2x", "TimeDownsample2x", "")
    encoder_mid_resnet: str = "ResnetBlock3D"
    decoder_conv_in: str = "CausalConv3d"
    decoder_conv_out: str = "CausalConv3d"
    decoder_attention: str = "AttnBlock3D"
    decoder_resnet_blocks: Tuple[str, ...] = ("ResnetBlock3D",) * 4
    decoder_spatial_upsample: Tuple[str, ...] = (
        "", "SpatialUpsample2x", "SpatialUpsample2x", "SpatialUpsample2x")
    decoder_temporal_upsample: Tuple[str, ...] = (
        "", "", "TimeUpsample2x", "TimeUpsample2x")
    decoder_mid_resnet: str = "ResnetBlock3D"
    scale_factor: float = 0.18215

    @staticmethod
    def v120(**overrides) -> "CausalVAEConfig":
        """The released v1.2 VAE: AttnBlock3DFix, Downsample and the
        Spatial2xTime2x3D ops for the same 4x8x8 stride."""
        base = dict(
            encoder_attention="AttnBlock3DFix",
            decoder_attention="AttnBlock3DFix",
            encoder_spatial_downsample=(
                "Downsample", "Spatial2xTime2x3DDownsample",
                "Spatial2xTime2x3DDownsample", ""),
            encoder_temporal_downsample=("", "", "", ""),
            decoder_spatial_upsample=(
                "", "Spatial2xTime2x3DUpsample", "Spatial2xTime2x3DUpsample",
                "SpatialUpsample2x"),
            decoder_temporal_upsample=("", "", "", ""),
        )
        base.update(overrides)
        return CausalVAEConfig(**base)


class _Level(nn.Module):
    """One resolution level: `block.{j}`, `attn.{j}`, and the optional
    (time) down- or upsample."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, resnet: str, attention: str, ch: int):
        super().__init__()
        self.block_1 = VAE_OPS[resnet](ch, ch)
        self.attn_1 = VAE_OPS[attention](ch, ch)
        self.block_2 = VAE_OPS[resnet](ch, ch)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


def _run_level(level: _Level, h):
    for j, block in enumerate(level.block):
        h = block(h)
        if len(level.attn):
            h = level.attn[j](h)
    for name in ("downsample", "time_downsample", "upsample", "time_upsample"):
        op = getattr(level, name, None)
        if op is not None:
            h = op(h)
    return h


class CausalVAEEncoder(nn.Module):
    """Pixels [B, 3, T, H, W] -> moments [B, 2 z, T', H / 8, W / 8]."""

    def __init__(self, cfg: CausalVAEConfig):
        super().__init__()
        ch = cfg.hidden_size
        self.conv_in = VAE_OPS[cfg.encoder_conv_in](3, ch)
        self.down = nn.ModuleList()
        res = cfg.resolution
        for i, m in enumerate(cfg.hidden_size_mult):
            level = _Level()
            for _ in range(cfg.num_res_blocks):
                level.block.append(
                    VAE_OPS[cfg.encoder_resnet_blocks[i]](ch, cfg.hidden_size * m))
                ch = cfg.hidden_size * m
                if res in cfg.attn_resolutions:
                    level.attn.append(VAE_OPS[cfg.encoder_attention](ch, ch))
            if cfg.encoder_spatial_downsample[i]:
                level.downsample = VAE_OPS[cfg.encoder_spatial_downsample[i]](ch, ch)
                res //= 2
            if cfg.encoder_temporal_downsample[i]:
                level.time_downsample = VAE_OPS[
                    cfg.encoder_temporal_downsample[i]](ch, ch)
            self.down.append(level)
        self.mid = _Mid(cfg.encoder_mid_resnet, cfg.encoder_attention, ch)
        self.norm_out = _norm(ch)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = VAE_OPS[cfg.encoder_conv_out](ch, out_ch)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = _run_level(level, h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class CausalVAEDecoder(nn.Module):
    """Latents [B, z, T', h, w] -> pixels [B, 3, T, 8 h, 8 w]."""

    def __init__(self, cfg: CausalVAEConfig):
        super().__init__()
        mult = cfg.hidden_size_mult
        n = len(mult)
        ch = cfg.hidden_size * mult[-1]
        res = cfg.resolution // 2 ** (n - 1)
        self.conv_in = VAE_OPS[cfg.decoder_conv_in](cfg.z_channels, ch)
        self.mid = _Mid(cfg.decoder_mid_resnet, cfg.decoder_attention, ch)
        levels = [None] * n
        for i in reversed(range(n)):
            level = _Level()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(
                    VAE_OPS[cfg.decoder_resnet_blocks[i]](ch, cfg.hidden_size * mult[i]))
                ch = cfg.hidden_size * mult[i]
                if res in cfg.attn_resolutions:
                    level.attn.append(VAE_OPS[cfg.decoder_attention](ch, ch))
            if cfg.decoder_spatial_upsample[i]:
                level.upsample = VAE_OPS[cfg.decoder_spatial_upsample[i]](ch, ch)
                res *= 2
            if cfg.decoder_temporal_upsample[i]:
                level.time_upsample = VAE_OPS[
                    cfg.decoder_temporal_upsample[i]](ch, ch)
            levels[i] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(ch)
        self.conv_out = VAE_OPS[cfg.decoder_conv_out](ch, 3)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = _run_level(level, h)
        return self.conv_out(F.silu(self.norm_out(h)))


class CausalVAE(nn.Module):
    """The codec with the latent scaling and the tiled path. x: pixels
    [B, 3, T, H, W] in [-1, 1]; latents [B, z, (T - 1) / 4 + 1, H / 8,
    W / 8], scaled by `scale_factor`. Tile sizes per `version` ("v110":
    256-pixel, 65-frame tiles, overlap 0.25; "v120": 33 frames, 0.125)."""

    def __init__(self, config: CausalVAEConfig = CausalVAEConfig(),
                 version: str = "v110"):
        super().__init__()
        if version not in ("v110", "v120"):
            raise ValueError(f"version {version!r} not in ('v110', 'v120')")
        cfg = config
        self.config = cfg
        self.encoder = CausalVAEEncoder(cfg)
        self.decoder = CausalVAEDecoder(cfg)
        if cfg.use_quant_layer:
            self.quant_conv = CausalConv3d(
                2 * cfg.z_channels if cfg.double_z else cfg.z_channels,
                2 * cfg.embed_dim, 1)
            self.post_quant_conv = CausalConv3d(cfg.embed_dim, cfg.z_channels, 1)
        self.use_tiling = False
        self.tile_sample_min_size = 256
        self.tile_sample_min_size_t = 65 if version == "v110" else 33
        self.tile_overlap_factor = 0.25 if version == "v110" else 0.125
        self.tile_latent_min_size = self.tile_sample_min_size // 2 ** (
            len(cfg.hidden_size_mult) - 1)
        self.time_down = 2 ** sum(
            1 for s in cfg.encoder_spatial_downsample
            + cfg.encoder_temporal_downsample if s and "Time" in s)
        self.tile_latent_min_size_t = (
            (self.tile_sample_min_size_t - 1) // self.time_down + 1)

    def enable_tiling(self, overlap_factor: Optional[float] = None):
        self.use_tiling = True
        if overlap_factor is not None:
            self.tile_overlap_factor = overlap_factor

    def get_latent_size(self, input_size: Sequence[int]) -> Tuple[int, int, int]:
        T, H, W = input_size
        return (T - 1) // self.time_down + 1, H // 8, W // 8

    def encode_moments(self, x):
        h = self.encoder(x)
        return self.quant_conv(h) if self.config.use_quant_layer else h

    def decode_latents(self, z):
        if self.config.use_quant_layer:
            z = self.post_quant_conv(z)
        return self.decoder(z)

    @property
    def _dtype(self) -> torch.dtype:
        return self.decoder.norm_out.weight.dtype

    def encode(self, x, draw: Optional[Draw] = None, sample: bool = True):
        """x [B, 3, T, H, W] -> latents x scale_factor; with `sample`, the
        posterior's noise is `draw("encode", shape of the mean)`."""
        x = x.to(self._dtype)
        _, _, T, H, W = x.shape
        if self.use_tiling and (H > self.tile_sample_min_size
                                or W > self.tile_sample_min_size
                                or T > self.tile_sample_min_size_t):
            moments = self._tiled_codec(x, encode=True)
        else:
            moments = self.encode_moments(x)
        mean, logvar = moments.chunk(2, dim=1)
        z = mean
        if sample:
            if draw is None:
                raise ValueError("sampling the posterior needs draw(name, "
                                 "shape)")
            noise = draw("encode", tuple(mean.shape)).to(mean.device, mean.dtype)
            z = mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise
        return z * self.config.scale_factor

    def decode(self, z):
        """Latents [B, z, T', h, w] -> pixels [B, 3, T, H, W] fp32."""
        z = z.to(self._dtype) / self.config.scale_factor
        _, _, T, H, W = z.shape
        if self.use_tiling and (H > self.tile_latent_min_size
                                or W > self.tile_latent_min_size
                                or T > self.tile_latent_min_size_t):
            return self._tiled_codec(z, encode=False)
        return self.decode_latents(z).float()

    @staticmethod
    def _t_chunks(t: int, size: int):
        """Temporal chunks of `size` frames overlapping by one; every chunk
        after the first drops its first output frame."""
        idx = list(range(0, t, size - 1))
        if len(idx) == 1 and idx[0] == 0:
            return [(0, t)]
        spans = [[idx[i], idx[i + 1] + 1] for i in range(len(idx) - 1)]
        if spans[-1][-1] > t:
            spans[-1][-1] = t
        elif spans[-1][-1] < t:
            spans.append([idx[-1], t])
        return [tuple(s) for s in spans]

    def _tiled_codec(self, x, encode: bool):
        t_size = (self.tile_sample_min_size_t if encode
                  else self.tile_latent_min_size_t)
        outs = []
        for k, (s, e) in enumerate(self._t_chunks(x.shape[2], t_size)):
            o = self._tiled_2d(x[:, :, s:e], encode)
            outs.append(o[:, :, 1:] if k else o)
        return torch.cat(outs, dim=2)

    def _tiled_2d(self, x, encode: bool):
        """Overlapping spatial tiles, each blended linearly into the tiles
        above and to its left (in fp32), then cropped."""
        if encode:
            in_size, out_size = self.tile_sample_min_size, self.tile_latent_min_size
            fn = self.encode_moments
        else:
            in_size, out_size = self.tile_latent_min_size, self.tile_sample_min_size
            fn = self.decode_latents
        overlap = int(in_size * (1 - self.tile_overlap_factor))
        blend = int(out_size * self.tile_overlap_factor)
        limit = out_size - blend
        H, W = x.shape[3], x.shape[4]
        if H <= in_size and W <= in_size:
            return fn(x).float()
        rows = [[fn(x[..., i:i + in_size, j:j + in_size]).float()
                 for j in range(0, W, overlap)] for i in range(0, H, overlap)]

        def blended(a, b, ext, dim):
            ext = min(a.shape[dim], b.shape[dim], ext)
            shape = [1] * 5
            shape[dim] = ext
            w = (torch.arange(ext, dtype=torch.float32, device=b.device)
                 / ext).reshape(shape)
            edge = (a.narrow(dim, a.shape[dim] - ext, ext) * (1 - w)
                    + b.narrow(dim, 0, ext) * w)
            return torch.cat([edge, b.narrow(dim, ext, b.shape[dim] - ext)],
                             dim=dim)

        out_rows = []
        for i, row in enumerate(rows):
            res = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = blended(rows[i - 1][j], tile, blend, 3)
                if j > 0:
                    tile = blended(row[j - 1], tile, blend, 4)
                res.append(tile[..., :limit, :limit])
            out_rows.append(torch.cat(res, dim=4))
        return torch.cat(out_rows, dim=3)

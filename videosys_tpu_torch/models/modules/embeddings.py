"""Embedders used by STDiT3, CogVideoX, Latte and Open-Sora-Plan:
timestep/size/caption/patch, PixArt's adaLN-single and caption projection,
the 1D and 2D sincos position tables and rotary embeddings (interleaved
pairs; rotate-half per axis).

Port of `videosys_tpu/models/modules/embeddings.py` (and of the adaLN-single
and the 1D table of the Latte and Open-Sora-Plan transformers).
Module attribute names follow the reference checkpoint's state_dict keys
(`mlp.0`/`mlp.2`, `y_proj.fc1`, `proj`; diffusers' `linear_1`/`linear_2`,
`emb.timestep_embedder`).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.models.modules.cast import Linear, compute_dtype_of


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, cos first. t: [N] -> [N, dim] fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _mlp_seq(in_features: int, hidden: int) -> nn.Sequential:
    return nn.Sequential(Linear(in_features, hidden), nn.SiLU(),
                         Linear(hidden, hidden))


class TimestepEmbedder(nn.Module):
    """Linear(256 -> C), SiLU, Linear(C -> C) over sinusoid(t)."""

    def __init__(self, hidden_size: int, freq_embed_size: int = 256):
        super().__init__()
        self.freq_embed_size = freq_embed_size
        self.mlp = _mlp_seq(freq_embed_size, hidden_size)

    def forward(self, t):
        x = timestep_embedding(t, self.freq_embed_size)
        return self.mlp(x.to(compute_dtype_of(self.mlp[0])))


class SizeEmbedder(TimestepEmbedder):
    """TimestepEmbedder over each scalar of s ([B] or [B, dims]), the dims
    flattened into the channel axis."""

    def forward(self, s, batch: int):
        if s.ndim == 1:
            s = s[:, None]
        if s.shape[0] != batch:
            s = s.repeat(batch // s.shape[0], 1)
        b, dims = s.shape
        x = super().forward(s.reshape(-1))
        return x.reshape(b, dims * x.shape[-1])


class Mlp(nn.Module):
    """fc1, tanh-approximated GELU, fc2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class CaptionEmbedder(nn.Module):
    """Projects text-encoder features to the model width; holds the learned
    null caption used for classifier-free guidance."""

    def __init__(self, in_channels: int, hidden_size: int,
                 token_num: int = 300):
        super().__init__()
        self.y_proj = Mlp(in_channels, hidden_size, hidden_size)
        self.y_embedding = nn.Parameter(
            torch.randn(token_num, in_channels) / in_channels ** 0.5)

    def forward(self, caption):
        return self.y_proj(caption)

    def null_embedding(self, batch: int):
        return self.y_embedding[None].expand(batch, *self.y_embedding.shape)


class PatchEmbed3D(nn.Module):
    """Strided Conv3d patchify: [B, C_in, T, H, W] -> [B, T', H', W', C]."""

    def __init__(self, patch_size: Tuple[int, int, int] = (1, 2, 2),
                 in_channels: int = 4, embed_dim: int = 1152):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(in_channels, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x):
        pt, ph, pw = self.patch_size
        _, _, T, H, W = x.shape
        pad = ((-W) % pw, (-H) % ph, (-T) % pt)
        if any(pad):
            x = F.pad(x, (0, pad[0], 0, pad[1], 0, pad[2]))
        # weights held in another dtype than x (fp32 master weights) are
        # cast at use, like the Linear layers
        out = F.conv3d(x, self.proj.weight.to(x.dtype),
                       self.proj.bias.to(x.dtype), stride=self.patch_size)
        return out.permute(0, 2, 3, 4, 1)


def pos_embed_2d(dim: int, h: int, w: int, scale: float = 1.0,
                 base_size: int | None = None) -> np.ndarray:
    """2D sincos position table [h*w, dim] (numpy fp32); token (i, j) gets
    [sincos(w_j), sincos(h_i)], the width embedding first."""
    assert dim % 4 == 0
    half = dim // 2
    inv_freq = 1.0 / (10000 ** (np.arange(0, half, 2, dtype=np.float32) / half))
    grid_h = np.arange(h, dtype=np.float32) / scale
    grid_w = np.arange(w, dtype=np.float32) / scale
    if base_size is not None:
        grid_h = grid_h * (base_size / h)
        grid_w = grid_w * (base_size / w)

    def sincos(coords):  # [n] -> [n, half]
        out = np.outer(coords, inv_freq)
        return np.concatenate([np.sin(out), np.cos(out)], axis=-1)

    emb_w = np.broadcast_to(sincos(grid_w)[None, :, :], (h, w, half))
    emb_h = np.broadcast_to(sincos(grid_h)[:, None, :], (h, w, half))
    return np.concatenate([emb_w, emb_h], axis=-1).reshape(h * w, dim)


def rope_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    """Rotary frequencies [dim/2] (rotary_embedding_torch defaults)."""
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim))


def rope_channel_tables(positions, freqs: np.ndarray,
                        num_heads: int) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved-pair RoPE (cos, sin) tables in the channel layout
    [N, C = num_heads * D], each frequency on its channel pair, the per-head
    table tiled across heads."""
    angles = np.asarray(positions, np.float32)[:, None] * np.asarray(freqs)[None]
    cos = np.repeat(np.cos(angles), 2, axis=-1)
    sin = np.repeat(np.sin(angles), 2, axis=-1)
    return np.tile(cos, (1, num_heads)), np.tile(sin, (1, num_heads))


def apply_rope_channel(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """Rotate adjacent channel pairs of x [B, N, C]:
    (x0, x1) -> (x0*cos - x1*sin, x1*cos + x0*sin). Computes in x's dtype
    for fp32 and bf16, else in fp32."""
    dt = x.dtype if x.dtype in (torch.float32, torch.bfloat16) else torch.float32
    cos = torch.as_tensor(cos, device=x.device).to(dt)
    sin = torch.as_tensor(sin, device=x.device).to(dt)
    xd = x.to(dt)
    pairs = xd.unflatten(-1, (-1, 2))
    swapped = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (xd * cos + swapped * sin).to(x.dtype)


def rotate_interleaved_pairs(x: torch.Tensor, cos: torch.Tensor,
                             sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent channel pairs of x [..., D] in fp32, then cast back
    to x's dtype: (x0, x1) -> (x0*cos - x1*sin, x1*cos + x0*sin). cos and
    sin: [..., D] fp32, each frequency on its channel pair."""
    xf = x.float()
    pairs = xf.unflatten(-1, (-1, 2))
    swapped = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (xf * cos + swapped * sin).to(x.dtype)


def rope_axis_tables(dim: int, length: int, scale: float = 1.0,
                     theta: float = 10000.0) -> tuple[np.ndarray, np.ndarray]:
    """1D rotate-half RoPE (cos, sin) tables [length, dim] with duplicated
    halves ([freqs, freqs]); positions divided by `scale`."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(length, dtype=np.float32) / scale
    freqs = np.outer(t, inv_freq)
    freqs = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(freqs), np.sin(freqs)


def apply_rope_multiaxis(x: torch.Tensor, cos, sin, n_axes: int) -> torch.Tensor:
    """Split the head dim of x [..., N, D] into `n_axes` equal chunks and
    rotate each (rotate-half) with its axis's columns of cos / sin
    ([N, D], the axes' tables side by side), in fp32; the result in x's
    dtype."""
    D = x.shape[-1] // n_axes
    cos = torch.as_tensor(cos, device=x.device).float()
    sin = torch.as_tensor(sin, device=x.device).float()
    xf = x.float()
    parts = []
    for i in range(n_axes):
        tok = xf[..., i * D:(i + 1) * D]
        x1, x2 = tok[..., : D // 2], tok[..., D // 2:]
        rot = torch.cat([-x2, x1], dim=-1)
        parts.append(tok * cos[..., i * D:(i + 1) * D]
                     + rot * sin[..., i * D:(i + 1) * D])
    return torch.cat(parts, dim=-1).to(x.dtype)


def pos_embed_1d(dim: int, length: int, scale: float = 1.0) -> np.ndarray:
    """1D sincos table [length, dim] (numpy fp32): [sin, cos] of
    position / scale over dim / 2 frequencies."""
    pos = np.arange(length, dtype=np.float32) / scale
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float32) / (dim / 2.0))
    ang = np.outer(pos, omega)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


class TimestepEmbedding(nn.Module):
    """diffusers' TimestepEmbedding over sinusoid(t) (cos first, 256
    channels): linear_1, SiLU, linear_2."""

    def __init__(self, hidden_size: int, freq_embed_size: int = 256):
        super().__init__()
        self.freq_embed_size = freq_embed_size
        self.linear_1 = Linear(freq_embed_size, hidden_size)
        self.linear_2 = Linear(hidden_size, hidden_size)

    def forward(self, t):
        x = timestep_embedding(t, self.freq_embed_size)
        x = x.to(compute_dtype_of(self.linear_1))
        return self.linear_2(F.silu(self.linear_1(x)))


class _Emb(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(hidden_size)


class AdaLayerNormSingle(nn.Module):
    """PixArt-Alpha's shared adaLN: forward(t [B]) -> (mods [B, 6 C], the
    embedded timestep [B, C]); mods = linear(silu(emb)). The caller rounds
    t to the dtype its model keys the sinusoid on."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.emb = _Emb(hidden_size)
        self.linear = Linear(hidden_size, 6 * hidden_size)

    def forward(self, t):
        emb = self.emb.timestep_embedder(t)
        return self.linear(F.silu(emb)), emb


class PixArtAlphaTextProjection(nn.Module):
    """Caption projection: linear_1, tanh-approximated GELU, linear_2."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.linear_1 = Linear(in_features, hidden_size)
        self.linear_2 = Linear(hidden_size, hidden_size)

    def forward(self, y):
        return self.linear_2(F.gelu(self.linear_1(y), approximate="tanh"))

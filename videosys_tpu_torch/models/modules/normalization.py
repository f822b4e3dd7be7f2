"""Normalization layers with fp32 statistics, and adaLN modulation.

Port of `videosys_tpu/models/modules/normalization.py` as plain math: the
per-head RMS statistics and the group norm are written directly, without
the TPU layout tricks of the JAX package. Numbers are the same.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from videosys_tpu_torch.core import parallel as par


class RMSNorm(nn.Module):
    """LlamaRMSNorm: x * rsqrt(mean(x^2) + eps) * weight, stats in fp32.
    With `num_heads` set, x is [B, N, C = num_heads * dim] and each head is
    normalized over its own `dim` channels."""

    def __init__(self, dim: int, eps: float = 1e-6, num_heads: int = 0):
        super().__init__()
        self.eps = eps
        self.num_heads = num_heads
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        if self.num_heads:
            return rms_norm_heads(x, self.weight, self.num_heads, self.eps)
        dtype = x.dtype
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        xf = xf * (var + self.eps) ** -0.5
        return (self.weight * xf.to(dtype)).to(dtype)


def rms_norm_heads(x, weight, num_heads: int, eps: float = 1e-6):
    """Per-head RMSNorm of a channel-layout [B, N, C] tensor; `weight` is
    the per-head_dim scale shared by all heads."""
    B, N, C = x.shape
    xf = x.float().reshape(B, N, num_heads, C // num_heads)
    var = (xf * xf).mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps) * weight.float()
    return xf.reshape(B, N, C).to(x.dtype)


def layer_norm(x, eps: float = 1e-6):
    """Affine-free LayerNorm with fp32 statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mean) * (var + eps) ** -0.5).to(x.dtype)


def t2i_modulate(x, shift, scale):
    """adaLN modulate: x * (1 + scale) + shift."""
    return x * (1 + scale) + shift


class GroupNorm(nn.Module):
    """GroupNorm over channel-first [B, C, ...] tensors with fp32 statistics
    (variance as E[x^2] - E[x]^2, as the JAX package's GroupNormMXU
    computes it); the output follows x's dtype. `weight`/`bias` are the JAX
    module's `scale`/`bias`.

    `rows`: dim 3 is this rank's share of a row-sharded axis (the Open-Sora
    temporal VAE under `parallel.shard_vae_rows`): the sum and the sum of
    squares are taken in fp32 over the real rows only, summed over the
    rows' line, and divided by the whole axis's count."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels ({num_channels}) must be divisible "
                             f"by num_groups ({num_groups})")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, rows: Optional[par.RowShard] = None):
        B, C = x.shape[:2]
        G = self.num_groups
        xf = x.float()
        if rows is None:
            xg = xf.reshape(B, G, -1)
            mean = xg.mean(-1)
            var = (xg * xg).mean(-1) - mean * mean
        else:
            xg = rows.mask(xf).reshape(B, G, -1)
            sums = par.all_reduce(
                torch.stack([xg.sum(-1), (xg * xg).sum(-1)], dim=-1),
                rows.axis)
            count = xg.shape[-1] // rows.local * rows.rows
            mean = sums[..., 0] / count
            var = sums[..., 1] / count - mean * mean
        rstd = torch.rsqrt(var + self.eps)  # [B, G]
        bshape = (B, C) + (1,) * (x.ndim - 2)
        r_c = rstd.repeat_interleave(C // G, dim=1)
        m_c = mean.repeat_interleave(C // G, dim=1)
        w = (r_c * self.weight.float()).reshape(bshape)
        b = (self.bias.float() - m_c * r_c * self.weight.float()).reshape(bshape)
        return (xf * w + b).to(x.dtype)

"""Self- and cross-attention blocks of the DiT families.

Port of `videosys_tpu/models/modules/blocks.py`; attention goes through
`ops.attention.scaled_dot_product_attention` (the CUDA kernel on a card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from videosys_tpu_torch.models.modules.cast import Linear
from videosys_tpu_torch.models.modules.embeddings import apply_rope_channel
from videosys_tpu_torch.models.modules.normalization import RMSNorm
from videosys_tpu_torch.ops.attention import scaled_dot_product_attention


class SelfAttention(nn.Module):
    """Multi-head self-attention on [B, N, C] with optional per-head RMS
    qk-norm and channel-layout interleaved RoPE (`rope_channel`: numpy
    (cos, sin) tables [N, C])."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_norm: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, num_heads=num_heads)
            self.k_norm = RMSNorm(head_dim, num_heads=num_heads)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x, kv_mask: Optional[torch.Tensor] = None,
                rope_channel=None):
        B, N, C = x.shape
        head_dim = self.dim // self.num_heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if N == 1:
            # single-token attention is the identity over v
            return self.proj(v)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if rope_channel is not None:
            cos, sin = rope_channel
            q = apply_rope_channel(q, cos, sin)
            k = apply_rope_channel(k, cos, sin)

        def heads(t):
            return t.reshape(B, N, self.num_heads, head_dim).transpose(1, 2)

        o = scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                         scale=head_dim ** -0.5,
                                         kv_mask=kv_mask)
        return self.proj(o.transpose(1, 2).reshape(B, N, C))


class MultiHeadCrossAttention(nn.Module):
    """Cross attention from image tokens x [B*frames, S, C] (batch-major,
    frame-minor rows) to text tokens cond [B, L, C], kv_mask [B, L] bool.
    k/v are projected once per batch element and repeated across frames."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.q_linear = Linear(dim, dim)
        self.kv_linear = Linear(dim, dim * 2)
        self.proj = Linear(dim, dim)

    def forward(self, x, cond, kv_mask: Optional[torch.Tensor] = None):
        Bf, N, C = x.shape
        Bc, L, _ = cond.shape
        frames = Bf // Bc
        head_dim = self.dim // self.num_heads
        q = self.q_linear(x).reshape(Bf, N, self.num_heads, head_dim).transpose(1, 2)
        k, v = self.kv_linear(cond).chunk(2, dim=-1)
        k = k.reshape(Bc, L, self.num_heads, head_dim).transpose(1, 2)
        v = v.reshape(Bc, L, self.num_heads, head_dim).transpose(1, 2)
        if frames > 1:
            k = k.repeat_interleave(frames, dim=0)
            v = v.repeat_interleave(frames, dim=0)
            if kv_mask is not None:
                kv_mask = kv_mask.repeat_interleave(frames, dim=0)
        o = scaled_dot_product_attention(q, k, v, scale=head_dim ** -0.5,
                                         kv_mask=kv_mask)
        return self.proj(o.transpose(1, 2).reshape(Bf, N, C))

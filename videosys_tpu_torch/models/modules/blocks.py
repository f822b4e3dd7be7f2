"""Self- and cross-attention blocks and the feed-forward of the DiT
families.

Port of `videosys_tpu/models/modules/blocks.py`, plus `Attention` and
`FeedForward` under diffusers' names (`to_q`, `to_k`, `to_v`, `to_out.0`;
`net.0.proj`, `net.2`) for Latte and Open-Sora-Plan. Attention goes through
`ops.attention.scaled_dot_product_attention` (the CUDA kernel on a card).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.core import parallel as par
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


class Attention(nn.Module):
    """Multi-head attention on x [B, N, C] with diffusers' projections:
    self-attention, with `rope` (a callable on the split q and k
    [B, H, N, D]), or cross-attention to `cond` [Bc, L, C] with `kv_mask`
    [Bc, L] (True = attend), where x's rows are batch-major, frame-minor
    (B = Bc x frames) and k, v are projected once per Bc row and repeated
    across the frames. `ulysses=True` (self-attention under active sp
    groups, `core/parallel.py`): x is this rank's sequence shard; q, k and
    v trade heads for the whole sequence in one all-to-all before `rope`
    and the attention (`kv_mask` [B, N * sp] then masks the pad tokens),
    and the output comes back by the inverse all-to-all."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = Linear(dim, dim)
        self.to_k = Linear(dim, dim)
        self.to_v = Linear(dim, dim)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, cond=None, kv_mask: Optional[torch.Tensor] = None,
                rope: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                ulysses: bool = False):
        B, N, C = x.shape
        H, D = self.num_heads, C // self.num_heads
        src = x if cond is None else cond
        Bc, L, _ = src.shape

        def heads(t, rows, n):
            return t.reshape(rows, n, H, D).transpose(1, 2)

        if ulysses and par.axis_size() > 1:
            qkv = torch.stack([t.reshape(B, N, H, D) for t in (
                self.to_q(x), self.to_k(x), self.to_v(x))], 2)
            q, k, v = (t.transpose(1, 2) for t in
                       par.ulysses_shard_heads(qkv).unbind(2))
            if rope is not None:
                q, k = rope(q), rope(k)
            o = scaled_dot_product_attention(q, k, v, scale=D ** -0.5,
                                             kv_mask=kv_mask)
            o = par.ulysses_shard_seq(o.transpose(1, 2), H)
            return self.to_out[0](o.reshape(B, N, C))

        v = heads(self.to_v(src), Bc, L)
        if cond is None and N == 1:
            # single-token attention is the identity over v
            return self.to_out[0](v.transpose(1, 2).reshape(B, N, C))
        q = heads(self.to_q(x), B, N)
        k = heads(self.to_k(src), Bc, L)
        if rope is not None:
            q, k = rope(q), rope(k)
        if B != Bc:
            frames = B // Bc
            k = k.repeat_interleave(frames, dim=0)
            v = v.repeat_interleave(frames, dim=0)
            if kv_mask is not None:
                kv_mask = kv_mask.repeat_interleave(frames, dim=0)
        o = scaled_dot_product_attention(q, k, v, scale=D ** -0.5,
                                         kv_mask=kv_mask)
        return self.to_out[0](o.transpose(1, 2).reshape(B, N, C))


class _Proj(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = Linear(dim, out)


class FeedForward(nn.Module):
    """diffusers' FeedForward, C -> 4C -> C: "gelu-approximate" (the tanh
    GELU) or "geglu" (net.0 projects to 2 x 4C: hidden * gelu(gate), the
    exact GELU)."""

    ACTIVATIONS = ("gelu-approximate", "geglu")

    def __init__(self, dim: int, activation: str = "gelu-approximate"):
        super().__init__()
        if activation not in self.ACTIVATIONS:
            raise ValueError(f"activation {activation!r} not in "
                             f"{self.ACTIVATIONS}")
        self.activation = activation
        inner = 4 * dim
        self.net = nn.ModuleList([
            _Proj(dim, 2 * inner if activation == "geglu" else inner),
            nn.Identity(), Linear(inner, dim)])

    def forward(self, x):
        h = self.net[0].proj(x)
        if self.activation == "geglu":
            hidden, gate = h.chunk(2, dim=-1)
            h = hidden * F.gelu(gate)
        else:
            h = F.gelu(h, approximate="tanh")
        return self.net[2](h)

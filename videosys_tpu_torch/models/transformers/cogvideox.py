"""CogVideoX transformer: joint [text; video] attention, 3D positions.

Port of `videosys_tpu/models/transformers/cogvideox.py`. Module names follow the reference checkpoint's state_dict (diffusers'
`CogVideoXTransformer3DModel`: `patch_embed.proj`, `time_embedding.linear_1`,
`transformer_blocks.{i}.attn1.to_out.0`, `ff.net.0.proj`, `norm_out.linear`,
...). The blocks are a Python loop. CogVideoX-2b adds a 3D sincos table to
the video tokens; CogVideoX-5b rotates the video tokens' q and k by 3D RoPE
(`use_rotary_positional_embeddings`). Both tables are numpy float32, made
once per latent shape and device and kept on the model.

PAB (`core/pab.py`): `forward(..., plan=, pab_cache=)` runs one sampling
step; a block whose attention the plan reads adds the cached output of the
joint attention (no norm, projection or attention for it), a block the plan
writes copies that output into `slot[depth]` in place.

Sequence parallelism (Ulysses, `core/parallel.py`): under groups installed
with `parallel.use_groups` and sp > 1, the video tokens are padded to a
multiple of sp and each rank holds its shard [B, N/sp, C]; the L text
tokens stay whole on every rank. The joint attention projects the rank's
rows, applies the qk norm and (5b) RoPE with the rank's rows of the table,
then trades its video rows' heads for the whole sequence (one all-to-all
of q, k and v, heads padded to a multiple of sp) and takes its own heads
of the text rows; the pad tokens are masked as keys. Its output goes back
by the inverse all-to-all (video) and a gather over heads (text), so that
`to_out` and the PAB slot see [text; local video] rows that equal world
1's. The video tokens are gathered before unpatchify. With no groups the
one-card loop runs unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.pab import (
    PABCache,
    PABConfig,
    PABStepPlan,
    cache_torch_dtype,
)
from videosys_tpu_torch.models.modules.cast import Linear
from videosys_tpu_torch.models.modules.embeddings import (
    pos_embed_2d,
    rotate_interleaved_pairs,
    timestep_embedding,
)
from videosys_tpu_torch.ops.attention import scaled_dot_product_attention
from videosys_tpu_torch.utils.timing import (
    ATTN,
    BLOCK,
    EMBED,
    FINAL,
    FORWARD,
    MLP,
    MODULATE,
    span,
)


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    """CogVideoX-2b by default; 5b: 42 layers, 48 heads, rotary
    positions. The model computes in its parameters' dtype."""

    num_layers: int = 30
    num_heads: int = 30
    head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    patch_size: int = 2
    max_text_seq_length: int = 226
    temporal_compression_ratio: int = 4
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = False  # False: 2b, True: 5b
    norm_eps: float = 1e-5

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def depth(self) -> int:
        return self.num_layers


def rope_3d(head_dim: int, t: int, h: int, w: int,
            theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """3D rotary (cos, sin) [t*h*w, head_dim], numpy float32: a quarter of
    the channels on frames, three eighths each on rows and columns, each
    frequency on its channel pair."""
    dim_t = head_dim // 4
    dim_h = head_dim // 8 * 3
    dim_w = head_dim // 8 * 3

    def axis_freqs(n, dim):
        freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
        ang = np.outer(np.arange(n, dtype=np.float32), freqs)
        return np.repeat(ang, 2, axis=-1)

    f_t = axis_freqs(t, dim_t)[:, None, None, :]
    f_h = axis_freqs(h, dim_h)[None, :, None, :]
    f_w = axis_freqs(w, dim_w)[None, None, :, :]
    freqs = np.concatenate([
        np.broadcast_to(f_t, (t, h, w, dim_t)),
        np.broadcast_to(f_h, (t, h, w, dim_h)),
        np.broadcast_to(f_w, (t, h, w, dim_w)),
    ], axis=-1).reshape(t * h * w, head_dim)
    return np.cos(freqs), np.sin(freqs)


def pos_embed_3d(embed_dim: int, t: int, h: int, w: int,
                 spatial_scale: float, temporal_scale: float) -> np.ndarray:
    """3D sincos table [t*h*w, D], numpy float32: the first quarter of the
    channels temporal, the rest the 2D spatial table."""
    d_s = embed_dim * 3 // 4
    d_t = embed_dim // 4
    spatial = pos_embed_2d(d_s, h, w, scale=spatial_scale, base_size=None)
    grid_t = np.arange(t, dtype=np.float32) / temporal_scale
    half = d_t // 2
    omega = 1.0 / 10000 ** (np.arange(half, dtype=np.float32) / half)
    ang = np.outer(grid_t, omega)
    temporal = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    out = np.concatenate([
        np.broadcast_to(temporal[:, None, :], (t, h * w, d_t)),
        np.broadcast_to(spatial[None], (t, h * w, d_s)),
    ], axis=-1)
    return out.reshape(t * h * w, embed_dim)


def layer_norm_fp32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """An affine LayerNorm computed in fp32 (weights included), the result
    in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class TimestepEmbedding(nn.Module):
    """linear_1, SiLU, linear_2 over the cos-first sinusoid of t."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.in_channels = in_channels
        self.linear_1 = Linear(in_channels, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, t):
        x = timestep_embedding(t, self.in_channels)
        x = self.linear_1(x.to(self.linear_1.weight.dtype))
        return self.linear_2(F.silu(x))


class CogVideoXPatchEmbed(nn.Module):
    """Patchify the latent frames (a strided Conv2d) and project the text."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 text_embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                              stride=patch_size)
        self.text_proj = Linear(text_embed_dim, embed_dim)


class CogVideoXLayerNormZero(nn.Module):
    """Affine LayerNorm of the video and text tokens, each modulated by its
    own (shift, scale) from temb; also gives their gates."""

    def __init__(self, time_embed_dim: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.linear = Linear(time_embed_dim, 6 * dim)
        self.norm = nn.LayerNorm(dim, eps=eps)

    def modulations(self, temb):
        """shift, scale, gate, e_shift, e_scale, e_gate, each [B, 1, C]."""
        return [m[:, None] for m in self.linear(F.silu(temb)).chunk(6, dim=-1)]

    def forward(self, x, enc, mods):
        shift, scale, _, e_shift, e_scale, _ = mods
        x = layer_norm_fp32(self.norm, x) * (1 + scale) + shift
        enc = layer_norm_fp32(self.norm, enc) * (1 + e_scale) + e_shift
        return x, enc


class CogVideoXJointAttention(nn.Module):
    """Self-attention over [text; video] with per-head qk LayerNorm (fp32,
    eps 1e-6, affine) and RoPE on the video tokens only. No key mask: the
    padded text tokens are attended, as in the reference."""

    def __init__(self, config: CogVideoXConfig):
        super().__init__()
        C, D = config.hidden_size, config.head_dim
        self.num_heads, self.head_dim = config.num_heads, D
        self.to_q = Linear(C, C)
        self.to_k = Linear(C, C)
        self.to_v = Linear(C, C)
        self.norm_q = nn.LayerNorm(D, eps=1e-6)
        self.norm_k = nn.LayerNorm(D, eps=1e-6)
        self.to_out = nn.ModuleList([Linear(C, C), nn.Dropout(0.0)])

    def forward(self, h, L: int, rope=None, key_mask=None):
        """h: [B, L + N, C], the text first -> the projected output, same
        shape. Under sp, N is this rank's video shard and `key_mask`
        [B, L + N * sp] marks the tokens that are not pad."""
        B, N, C = h.shape
        H, D = self.num_heads, self.head_dim
        q = layer_norm_fp32(self.norm_q, self.to_q(h).view(B, N, H, D))
        k = layer_norm_fp32(self.norm_k, self.to_k(h).view(B, N, H, D))
        v = self.to_v(h).view(B, N, H, D)
        if rope is not None:
            cos, sin = rope  # [N - L, 1, D] fp32
            q = torch.cat([q[:, :L], rotate_interleaved_pairs(q[:, L:], cos, sin)], 1)
            k = torch.cat([k[:, :L], rotate_interleaved_pairs(k[:, L:], cos, sin)], 1)
        if par.axis_size() > 1:  # Ulysses (JAX cogvideox.py:170-177)
            qkv = torch.stack([q, k, v], 2)  # [B, L + N, 3, H, D]
            q, k, v = torch.cat([par.split_heads(qkv[:, :L]),
                                 par.ulysses_shard_heads(qkv[:, L:])],
                                1).unbind(2)
        out = scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=D ** -0.5, kv_mask=key_mask).transpose(1, 2)
        if par.axis_size() > 1:
            out = torch.cat([par.gather_heads(out[:, :L], H),
                             par.ulysses_shard_seq(out[:, L:], H)], 1)
        return self.to_out[0](out.reshape(B, N, C))


class GELUProj(nn.Module):
    """Linear then tanh-approximated GELU (`ff.net.0`)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, inner), nn.Dropout(0.0),
                                  Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class CogVideoXBlock(nn.Module):
    def __init__(self, config: CogVideoXConfig):
        super().__init__()
        C = config.hidden_size
        self.norm1 = CogVideoXLayerNormZero(config.time_embed_dim, C,
                                            config.norm_eps)
        self.attn1 = CogVideoXJointAttention(config)
        self.norm2 = CogVideoXLayerNormZero(config.time_embed_dim, C,
                                            config.norm_eps)
        self.ff = FeedForward(C, 4 * C)

    def forward(self, x, enc, temb, rope=None, read=None, write=None,
                key_mask=None):
        """x: [B, N, C] video (this rank's shard under sp), enc: [B, L, C]
        text. `read` / `write`: the PAB cache view of this block's joint
        attention output [B, L + N, C] ("attn"): read replaces the
        attention, which is not computed; write receives a copy of it.
        `key_mask`: the joint attention's, under sp with padded tokens."""
        L = enc.shape[1]
        cached = bool(read) and "attn" in read
        with span(MODULATE):
            mods = self.norm1.modulations(temb)
            gate, e_gate = mods[2], mods[5]
            if not cached:
                nx, nenc = self.norm1(x, enc, mods)
        with span(ATTN):
            if cached:
                attn = read["attn"].to(x.dtype)
            else:
                attn = self.attn1(torch.cat([nenc, nx], 1), L, rope, key_mask)
                if write and "attn" in write:
                    write["attn"].copy_(attn)
        with span(MODULATE):
            x = x + gate * attn[:, L:]
            enc = enc + e_gate * attn[:, :L]
            mods = self.norm2.modulations(temb)
            nx, nenc = self.norm2(x, enc, mods)
        with span(MLP):
            ff = self.ff(torch.cat([nenc, nx], 1))
        with span(MODULATE):
            x = x + mods[2] * ff[:, L:]
            enc = enc + mods[5] * ff[:, :L]
        return x, enc


class AdaLayerNorm(nn.Module):
    """norm_out: LayerNorm modulated by (shift, scale) from temb."""

    def __init__(self, time_embed_dim: int, dim: int, eps: float):
        super().__init__()
        self.linear = Linear(time_embed_dim, 2 * dim)
        self.norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x, temb):
        shift, scale = self.linear(F.silu(temb)).chunk(2, dim=-1)
        return layer_norm_fp32(self.norm, x) * (1 + scale[:, None]) \
            + shift[:, None]


class CogVideoXTransformer3D(nn.Module):
    """forward(x [B, F, C_in, H, W] (frame-first), encoder_hidden_states
    [B, L, text_embed_dim], timestep [B]) -> [B, F, C_out, H, W] fp32."""

    def __init__(self, config: CogVideoXConfig = CogVideoXConfig()):
        super().__init__()
        cfg = config
        C = cfg.hidden_size
        self.config = cfg
        self.patch_embed = CogVideoXPatchEmbed(cfg.patch_size, cfg.in_channels,
                                               C, cfg.text_embed_dim)
        self.time_embedding = TimestepEmbedding(C, cfg.time_embed_dim)
        self.transformer_blocks = nn.ModuleList(
            CogVideoXBlock(cfg) for _ in range(cfg.num_layers))
        self.norm_final = nn.LayerNorm(C, eps=cfg.norm_eps)
        self.norm_out = AdaLayerNorm(cfg.time_embed_dim, C, cfg.norm_eps)
        self.proj_out = Linear(C, cfg.patch_size ** 2 * cfg.out_channels)
        self._tables: Dict[tuple, object] = {}

    def init_cache(self, pab: PABConfig, B: int, N_video: int,
                   L: int) -> Optional[PABCache]:
        """A zeroed PAB cache of the joint attention output for B rows of L
        text and N_video video tokens, on the model's device, in
        `pab.cache_dtype` (None: the model's dtype); None when `pab` does
        not broadcast the spatial (here: joint) attention. Under active sp
        groups the video rows are this rank's padded shard."""
        if pab is None or not pab.spatial_broadcast:
            return None
        cfg = self.config
        m = par.token_pad_multiple()
        N_video = -(-N_video // m)
        weight = self.proj_out.weight
        dtype = cache_torch_dtype(pab.cache_dtype) or weight.dtype
        return PABCache({"spatial": {"attn": torch.zeros(
            (cfg.num_layers, B, L + N_video, cfg.hidden_size), dtype=dtype,
            device=weight.device)}}, {})

    def _positions(self, F_: int, h: int, w: int, device, dtype):
        """The 5b rope (cos, sin) [N, 1, D] fp32 or the 2b sincos table
        [N, C] in the model dtype, made once per shape and device."""
        cfg = self.config
        key = (F_, h, w, str(device), dtype)
        if key not in self._tables:
            if cfg.use_rotary_positional_embeddings:
                self._tables[key] = tuple(
                    torch.from_numpy(a).to(device)[:, None]
                    for a in rope_3d(cfg.head_dim, F_, h, w))
            else:
                self._tables[key] = torch.from_numpy(pos_embed_3d(
                    cfg.hidden_size, F_, h, w, cfg.spatial_interpolation_scale,
                    cfg.temporal_interpolation_scale)).to(device, dtype)
        return self._tables[key]

    def forward(self, hidden_states, encoder_hidden_states, timestep,
                plan: Optional[PABStepPlan] = None,
                pab_cache: Optional[PABCache] = None):
        with span(FORWARD):
            return self._forward(hidden_states, encoder_hidden_states,
                                 timestep, plan, pab_cache)

    def _forward(self, hidden_states, encoder_hidden_states, timestep, plan,
                 pab_cache):
        cfg = self.config
        dtype = self.proj_out.weight.dtype
        B, F_, C_in, H, W = hidden_states.shape
        p = cfg.patch_size
        h_p, w_p = H // p, W // p
        N = F_ * h_p * w_p

        with span(EMBED):
            temb = self.time_embedding(timestep.float())
            imgs = hidden_states.to(dtype).reshape(B * F_, C_in, H, W)
            xe = self.patch_embed.proj(imgs)  # [B F, C, h, w]
            xe = xe.flatten(2).transpose(1, 2).reshape(B, N, cfg.hidden_size)
            enc = self.patch_embed.text_proj(encoder_hidden_states.to(dtype))
            L = enc.shape[1]

            rope = None
            table = self._positions(F_, h_p, w_p, xe.device, dtype)
            if cfg.use_rotary_positional_embeddings:
                rope = table
            else:
                xe = xe + table[None]

            # sp: the video tokens padded to the sp size, this rank's shard
            # resident, the pad masked as keys (JAX cogvideox.py:313)
            m = par.token_pad_multiple()
            key_mask = None
            if m > 1:
                xe = par.shard_tokens(xe)
                if rope is not None:
                    rope = tuple(par.shard_tokens(a, 0) for a in rope)
                if N % m:
                    key_mask = (torch.arange(L + N + -N % m, device=xe.device)
                                < L + N).expand(B, -1)

        plan = plan or PABStepPlan()
        for i, block in enumerate(self.transformer_blocks):
            views = (pab_cache.views(plan, "spatial", i) if pab_cache
                     is not None else ({}, {}))
            with span(BLOCK):
                xe, enc = block(xe, enc, temb, rope, *views,
                                key_mask=key_mask)

        with span(FINAL):
            if cfg.use_rotary_positional_embeddings:  # 5b: the joint tokens
                xe = layer_norm_fp32(self.norm_final,
                                     torch.cat([enc, xe], 1))[:, L:]
            else:
                xe = layer_norm_fp32(self.norm_final, xe)
            xe = self.proj_out(self.norm_out(xe, temb))
            if m > 1:  # gather the video tokens, drop the sp padding
                xe = par.gather(xe, 1)[:, :N]

            # unpatchify -> [B, F, C_out, H, W]
            out = xe.reshape(B, F_, h_p, w_p, cfg.out_channels, p, p)
            out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(
                B, F_, cfg.out_channels, h_p * p, w_p * p)
            return out.float()

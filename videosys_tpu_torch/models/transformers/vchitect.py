"""Vchitect-XL transformer: MMDiT (SD3-style) joint blocks with spatial,
temporal and cross attention.

Port of `videosys_tpu/models/transformers/vchitect.py` without sharding.
Activations are video tokens [B, F, S, C] and context tokens [B, F, L, C]
(the text replicated per frame). Per block: joint [video; context]
attention within each frame (spatial), attention across the F frames of
every joint token with RoPE on interleaved pairs (temporal), and attention
of every token to the frame-0 context (cross), combined as
`spatial * 1.1 + cross` and `+ temporal` after separate output projections;
with one frame the temporal term is zero. Every attention goes through
`ops.attention.scaled_dot_product_attention` (on the card the narrow
forward kernel). Module names follow the reference checkpoint
(`Vchitect/Vchitect-2.0-2B`): `pos_embed.proj`,
`time_text_embed.{timestep_embedder,text_embedder}.linear_{1,2}`,
`context_embedder`, `transformer_blocks.{i}` (`norm1`, `norm1_context`,
`attn`, `ff`, `ff_context`; the last block is `context_pre_only`),
`norm_out.linear`, `proj_out`.

PAB (`core/pab.py`): `forward(..., plan=, pab_cache=)` runs one sampling
step under its plan. Each block but the last caches its spatial and cross
attention outputs (branch "spatial", slots "attn" and "cross", [B, F, S + L,
C]) and its temporal outputs (branch "temporal", slot "attn": the projected
video rows, JAX's `temporal_x`, then the context rows before their
projection, JAX's `temporal_enc`). A slot the plan reads replaces its
branch, which is not computed; a slot it writes is filled in place. The
last block always runs dense.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.core.pab import (
    PABCache,
    PABConfig,
    PABStepPlan,
    cache_torch_dtype,
)
from videosys_tpu_torch.models.modules.blocks import FeedForward
from videosys_tpu_torch.models.modules.cast import Linear
from videosys_tpu_torch.models.modules.embeddings import (
    TimestepEmbedding,
    pos_embed_2d,
    rope_freqs,
    rotate_interleaved_pairs,
)
from videosys_tpu_torch.models.modules.normalization import layer_norm
from videosys_tpu_torch.ops.attention import scaled_dot_product_attention


@dataclasses.dataclass(frozen=True)
class VchitectModelConfig:
    """Vchitect-XL (VchitectXLTransformerModel's defaults): 18 joint blocks,
    18 heads x 64, patch 2, 16 latent channels, the SD3 text widths."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 18
    num_heads: int = 18
    head_dim: int = 64
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 96
    rope_theta: float = 1e6
    dtype: torch.dtype = torch.float32

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def depth(self) -> int:
        return self.num_layers


class AdaLayerNormZeroMods(nn.Module):
    """diffusers' AdaLayerNormZero: linear(silu(emb)) gives six [B, 1, 1, C]
    modulations; returns (norm(x) * (1 + scale) + shift, gate_msa,
    shift_mlp, scale_mlp, gate_mlp)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 6 * dim)

    def forward(self, x, emb):
        mods = self.linear(F.silu(emb))[:, None, None]
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = mods.chunk(6, dim=-1)
        return (layer_norm(x, 1e-6) * (1 + sc_msa) + sh_msa, g_msa, sh_mlp,
                sc_mlp, g_mlp)


class _AdaLayerNormContinuous(nn.Module):
    """diffusers' AdaLayerNormContinuous: linear(silu(emb)) -> (scale,
    shift); norm(x) * (1 + scale) + shift."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 2 * dim)

    def forward(self, x, emb):
        scale, shift = self.linear(F.silu(emb))[:, None, None].chunk(2, dim=-1)
        return layer_norm(x, 1e-6) * (1 + scale) + shift


class VchitectJointAttention(nn.Module):
    """VchitectAttention and its processor: the three attention paths on
    shared context projections."""

    def __init__(self, config: VchitectModelConfig,
                 context_pre_only: bool = False):
        super().__init__()
        C = config.hidden_size
        self.config = config
        self.context_pre_only = context_pre_only
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_q_temp", "to_k_temp", "to_v_temp",
                     "to_q_cross", "to_out_temporal", "to_out_context",
                     "to_add_out_temporal"):
            setattr(self, name, Linear(C, C))
        self.to_out = nn.ModuleList([Linear(C, C)])
        if not context_pre_only:
            self.to_add_out = Linear(C, C)

    def forward(self, x, enc, rope, read=None, write=None):
        """x [B, F, S, C], enc [B, F, L, C]; `rope`: (cos, sin) [F, D] fp32;
        `read` / `write`: PAB cache views by slot ("attn", "cross" of the
        spatial branch; "temporal" for the temporal slot), each
        [B, F, S + L, C]. Returns (video out [B, F, S, C], context out
        [B, F, L, C], None for a context_pre_only block)."""
        read = read or {}
        write = write or {}
        cfg = self.config
        B, Fr, S, C = x.shape
        L = enc.shape[2]
        N = S + L
        H, D = cfg.num_heads, cfg.head_dim
        scale = D ** -0.5
        enc_q = self.add_q_proj(enc)
        enc_k = self.add_k_proj(enc)
        enc_v = self.add_v_proj(enc)

        def joint(proj, ctx):
            return torch.cat([proj(x), ctx], dim=2)  # [B, F, N, C]

        # temporal: rows [B * N, H, F, D], RoPE over the frames
        temporal = None
        if Fr > 1:
            if "temporal" in read:
                temporal = read["temporal"].to(x.dtype)
            else:
                def frames(t):
                    return t.reshape(B, Fr, N, H, D).permute(0, 2, 3, 1, 4) \
                        .reshape(B * N, H, Fr, D)
                cos, sin = rope
                qt = rotate_interleaved_pairs(
                    frames(joint(self.to_q_temp, enc_q)), cos, sin)
                kt = rotate_interleaved_pairs(
                    frames(joint(self.to_k_temp, enc_k)), cos, sin)
                vt = frames(joint(self.to_v_temp, enc_v))
                of = scaled_dot_product_attention(qt, kt, vt, scale=scale)
                of = of.reshape(B, N, H, Fr, D).permute(0, 3, 1, 2, 4) \
                    .reshape(B, Fr, N, C)
                temporal = torch.cat([self.to_out_temporal(of[:, :, :S]),
                                      of[:, :, S:]], dim=2)
                if "temporal" in write:
                    write["temporal"].copy_(temporal)

        # cross: every token of every frame against the frame-0 context
        if "cross" in read:
            cross = read["cross"].to(x.dtype)
        else:
            qc = joint(self.to_q_cross, enc_q).reshape(B, Fr * N, H, D)
            kc = enc_k[:, 0].reshape(B, L, H, D)
            vc = enc_v[:, 0].reshape(B, L, H, D)
            oc = scaled_dot_product_attention(
                qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                scale=scale)
            cross = self.to_out_context(oc.transpose(1, 2).reshape(B, Fr, N, C))
            if "cross" in write:
                write["cross"].copy_(cross)

        # spatial: joint [video; context] attention within each frame
        if "attn" in read:
            spatial = read["attn"].to(x.dtype)
        else:
            def per_frame(t):
                return t.reshape(B * Fr, N, H, D).transpose(1, 2)
            os_ = scaled_dot_product_attention(
                per_frame(joint(self.to_q, enc_q)),
                per_frame(joint(self.to_k, enc_k)),
                per_frame(joint(self.to_v, enc_v)), scale=scale)
            spatial = os_.transpose(1, 2).reshape(B, Fr, N, C)
            if "attn" in write:
                write["attn"].copy_(spatial)

        mixed = spatial * 1.1 + cross
        out_x = self.to_out[0](mixed[:, :, :S])
        if temporal is not None:
            out_x = out_x + temporal[:, :, :S]
        if self.context_pre_only:  # the block drops its context output
            return out_x, None
        out_enc = self.to_add_out(mixed[:, :, S:])
        if temporal is not None:
            out_enc = out_enc + self.to_add_out_temporal(temporal[:, :, S:])
        return out_x, out_enc


class VchitectBlock(nn.Module):
    """JointTransformerBlock: adaLN-zero on both streams, the joint
    attention, then the feed-forwards; a `context_pre_only` block (the
    last) modulates the context with AdaLayerNormContinuous and returns it
    unchanged."""

    def __init__(self, config: VchitectModelConfig,
                 context_pre_only: bool = False):
        super().__init__()
        C = config.hidden_size
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZeroMods(C)
        self.norm1_context = (_AdaLayerNormContinuous(C) if context_pre_only
                              else AdaLayerNormZeroMods(C))
        self.attn = VchitectJointAttention(config, context_pre_only)
        self.ff = FeedForward(C)
        if not context_pre_only:
            self.ff_context = FeedForward(C)

    def forward(self, x, enc, temb, rope, read=None, write=None):
        nx, g_msa, sh_mlp, sc_mlp, g_mlp = self.norm1(x, temb)
        if self.context_pre_only:
            nenc = self.norm1_context(enc, temb)
        else:
            nenc, c_gmsa, c_shmlp, c_scmlp, c_gmlp = self.norm1_context(
                enc, temb)
        attn_x, attn_enc = self.attn(nx, nenc, rope, read, write)
        x = x + g_msa * attn_x
        x = x + g_mlp * self.ff(layer_norm(x, 1e-6) * (1 + sc_mlp) + sh_mlp)
        if self.context_pre_only:
            return x, enc
        enc = enc + c_gmsa * attn_enc
        enc = enc + c_gmlp * self.ff_context(
            layer_norm(enc, 1e-6) * (1 + c_scmlp) + c_shmlp)
        return x, enc


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, hidden_size: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, hidden_size, patch, stride=patch)


class _TextEmbedder(nn.Module):
    """The pooled-text projection: linear_1, SiLU, linear_2."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.linear_1 = Linear(in_features, hidden_size)
        self.linear_2 = Linear(hidden_size, hidden_size)

    def forward(self, y):
        return self.linear_2(F.silu(self.linear_1(y)))


class _TimeTextEmbed(nn.Module):
    def __init__(self, hidden_size: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(hidden_size)
        self.text_embedder = _TextEmbedder(pooled_dim, hidden_size)


class VchitectXLTransformer(nn.Module):
    """forward(hidden_states [B, F, C_in, H, W], encoder_hidden_states
    [B, L, joint_dim], pooled_projections [B, pooled_dim], timestep [B])
    -> [B, F, C_out, H, W] fp32, computed in the weights' dtype."""

    def __init__(self, config: VchitectModelConfig = VchitectModelConfig()):
        super().__init__()
        cfg = config
        C = cfg.hidden_size
        self.config = cfg
        self.pos_embed = _PatchEmbed(cfg.in_channels, C, cfg.patch_size)
        self.time_text_embed = _TimeTextEmbed(C, cfg.pooled_projection_dim)
        self.context_embedder = Linear(cfg.joint_attention_dim, C)
        self.transformer_blocks = nn.ModuleList(
            VchitectBlock(cfg, context_pre_only=i == cfg.num_layers - 1)
            for i in range(cfg.num_layers))
        self.norm_out = _AdaLayerNormContinuous(C)
        self.proj_out = Linear(C, cfg.patch_size ** 2 * cfg.out_channels)
        self._tables: Dict[tuple, tuple] = {}

    @staticmethod
    def cache_keys(pab: Optional[PABConfig]) -> Dict[str, Tuple[str, ...]]:
        """The slots each branch caches under `pab` (no MLP or pair
        broadcast: their plans leave the model dense, as in JAX)."""
        if pab is None or not pab.enabled or pab.pair_broadcast:
            return {}
        keys = {}
        spatial = (("attn",) if pab.spatial_broadcast else ()) + \
            (("cross",) if pab.cross_broadcast else ())
        if spatial:
            keys["spatial"] = spatial
        if pab.temporal_broadcast:
            keys["temporal"] = ("attn",)
        return keys

    def init_cache(self, pab: PABConfig, B: int, F: int, S: int,
                   L: int) -> PABCache:
        """A zeroed PAB cache, one row for each block but the last, on the
        model's device in `pab.cache_dtype` (None: the model's dtype)."""
        weight = self.proj_out.weight
        dtype = cache_torch_dtype(pab.cache_dtype) or weight.dtype
        shape = (self.config.depth - 1, B, F, S + L, self.config.hidden_size)
        slots = {branch: {k: torch.zeros(shape, dtype=dtype,
                                         device=weight.device) for k in keys}
                 for branch, keys in self.cache_keys(pab).items()}
        return PABCache(slots, {})

    @staticmethod
    def _views(cache: Optional[PABCache], plan: PABStepPlan, depth: int):
        """(read, write) views of one block by slot: "attn" and "cross" of
        the spatial branch, "temporal" for the temporal branch's slot."""
        if cache is None:
            return {}, {}
        read, write = cache.views(plan, "spatial", depth)
        for views, t_views in zip((read, write),
                                  cache.views(plan, "temporal", depth)):
            if "attn" in t_views:
                views["temporal"] = t_views["attn"]
        return read, write

    def _positions(self, F: int, h_p: int, w_p: int, device, dtype):
        """(the centre crop of the max-size 2D sincos table [S, C] in the
        model dtype; the temporal RoPE (cos, sin) [F, D] fp32), made once
        per shape and device."""
        key = (F, h_p, w_p, str(device), dtype)
        if key not in self._tables:
            cfg = self.config
            C, p, maxs = cfg.hidden_size, cfg.patch_size, cfg.pos_embed_max_size
            pos = pos_embed_2d(C, maxs, maxs, scale=1.0,
                               base_size=cfg.sample_size // p)
            top, left = (maxs - h_p) // 2, (maxs - w_p) // 2
            pos = pos.reshape(maxs, maxs, C)[top:top + h_p, left:left + w_p]
            angles = np.arange(F, dtype=np.float32)[:, None] * rope_freqs(
                cfg.head_dim, theta=cfg.rope_theta)[None]
            rope = tuple(torch.as_tensor(np.repeat(fn(angles), 2, axis=-1))
                         .to(device) for fn in (np.cos, np.sin))
            self._tables[key] = (
                torch.as_tensor(pos.reshape(h_p * w_p, C)).to(device, dtype),
                rope)
        return self._tables[key]

    def forward(self, hidden_states, encoder_hidden_states, pooled_projections,
                timestep, plan: Optional[PABStepPlan] = None,
                pab_cache: Optional[PABCache] = None):
        cfg = self.config
        dtype = self.proj_out.weight.dtype
        B, Fr, C_in, Hpx, Wpx = hidden_states.shape
        p = cfg.patch_size
        h_p, w_p = Hpx // p, Wpx // p
        S, C = h_p * w_p, cfg.hidden_size
        pos, rope = self._positions(Fr, h_p, w_p, hidden_states.device, dtype)

        # patch embed plus the centre-cropped SD3 position table
        xe = self.pos_embed.proj(
            hidden_states.reshape(B * Fr, C_in, Hpx, Wpx).to(dtype))
        xe = xe.flatten(2).transpose(1, 2).reshape(B, Fr, S, C) + pos

        # timestep plus pooled-text embedding
        emb = self.time_text_embed
        temb = emb.timestep_embedder(timestep.float()) + emb.text_embedder(
            pooled_projections.to(dtype))

        # the context, replicated per frame
        enc = self.context_embedder(encoder_hidden_states.to(dtype))
        enc = enc[:, None].expand(B, Fr, *enc.shape[1:])

        plan = plan or PABStepPlan()
        last = cfg.num_layers - 1
        for i, block in enumerate(self.transformer_blocks):
            read, write = self._views(pab_cache if i < last else None, plan, i)
            xe, enc = block(xe, enc, temb, rope, read, write)

        xo = self.proj_out(self.norm_out(xe, temb))
        # unpatchify: [B, F, (h w), (p q c)] -> [B, F, c, h p, w q]
        c = cfg.out_channels
        out = xo.reshape(B, Fr, h_p, w_p, p, p, c).permute(0, 1, 6, 2, 4, 3, 5)
        return out.reshape(B, Fr, c, h_p * p, w_p * p).float()

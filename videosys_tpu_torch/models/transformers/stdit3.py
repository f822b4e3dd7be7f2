"""STDiT3 (Open-Sora v1.2), the spatio-temporal DiT: dense path.

Port of `videosys_tpu/models/transformers/stdit3.py` without PAB caching,
rematerialization or sharding. Activations are [B, T, S, C]; the depth
pairs are a Python loop over `spatial_blocks` and `temporal_blocks`, named
as in the reference checkpoint's state_dict.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from videosys_tpu_torch.models.modules.blocks import (
    MultiHeadCrossAttention,
    SelfAttention,
)
from videosys_tpu_torch.models.modules.embeddings import (
    CaptionEmbedder,
    Mlp,
    PatchEmbed3D,
    SizeEmbedder,
    TimestepEmbedder,
    pos_embed_2d,
    rope_channel_tables,
    rope_freqs,
)
from videosys_tpu_torch.models.modules.normalization import layer_norm, t2i_modulate


@dataclasses.dataclass(frozen=True)
class STDiT3Config:
    """STDiT3-XL/2 by default: depth 28, hidden 1152, patch (1, 2, 2),
    16 heads. `dtype` is the one the pipeline holds the weights in; the
    model computes in its parameters' dtype."""

    input_sq_size: int = 512
    in_channels: int = 4
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    caption_channels: int = 4096
    model_max_length: int = 300
    qk_norm: bool = True
    pred_sigma: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.pred_sigma else self.in_channels


def t_mask_select(x_mask, x, masked_x):
    """Frame-conditioning select on [B, T, S, C]; x_mask [B, T], True =
    the normal-timestep branch."""
    return torch.where(x_mask[:, :, None, None], x, masked_x)


def _modulations(table, t_mlp, dtype):
    """(table + t_mlp) in fp32 -> six [B, 1, 1, C] tensors in `dtype`."""
    B = t_mlp.shape[0]
    mods = (table.float()[None] + t_mlp.reshape(B, 6, -1).float()).to(dtype)
    return [mods[:, i, None, None, :] for i in range(6)]


class STDiT3Block(nn.Module):
    """One DiT block on x [B, T, S, C]: spatial or temporal self-attention,
    cross-attention to the text, MLP, each with adaLN modulation."""

    def __init__(self, config: STDiT3Config, temporal: bool = False):
        super().__init__()
        C = config.hidden_size
        self.config = config
        self.temporal = temporal
        self.scale_shift_table = nn.Parameter(torch.randn(6, C) / C ** 0.5)
        self.attn = SelfAttention(C, config.num_heads, qk_norm=config.qk_norm)
        self.cross_attn = MultiHeadCrossAttention(C, config.num_heads)
        self.mlp = Mlp(C, int(C * config.mlp_ratio), C)

    def forward(self, x, y, t_mlp, t0_mlp=None, x_mask=None, kv_mask=None):
        cfg = self.config
        B, T, S, C = x.shape
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = _modulations(
            self.scale_shift_table, t_mlp, x.dtype)
        if x_mask is not None:
            (shift_msa0, scale_msa0, gate_msa0,
             shift_mlp0, scale_mlp0, gate_mlp0) = _modulations(
                self.scale_shift_table, t0_mlp, x.dtype)

        # attention (spatial or temporal)
        normed1 = layer_norm(x)
        x_m = t2i_modulate(normed1, shift_msa, scale_msa)
        if x_mask is not None:
            x_m = t_mask_select(x_mask, x_m,
                                t2i_modulate(normed1, shift_msa0, scale_msa0))
        if self.temporal:
            xa = x_m.permute(0, 2, 1, 3).reshape(B * S, T, C)
            rope = rope_channel_tables(np.arange(T, dtype=np.float32),
                                       rope_freqs(C // cfg.num_heads),
                                       cfg.num_heads)
            xa = self.attn(xa, rope_channel=rope)
            x_m = xa.reshape(B, S, T, C).permute(0, 2, 1, 3)
        else:
            x_m = self.attn(x_m.reshape(B * T, S, C)).reshape(B, T, S, C)
        x_m_s = gate_msa * x_m
        if x_mask is not None:
            x_m_s = t_mask_select(x_mask, x_m_s, gate_msa0 * x_m)
        x = x + x_m_s

        # cross attention, per frame
        x_cross = self.cross_attn(x.reshape(B * T, S, C), y, kv_mask)
        x = x + x_cross.reshape(B, T, S, C)

        # MLP
        normed2 = layer_norm(x)
        x_m = t2i_modulate(normed2, shift_mlp, scale_mlp)
        if x_mask is not None:
            x_m = t_mask_select(x_mask, x_m,
                                t2i_modulate(normed2, shift_mlp0, scale_mlp0))
        x_m = self.mlp(x_m)
        x_m_s = gate_mlp * x_m
        if x_mask is not None:
            x_m_s = t_mask_select(x_mask, x_m_s, gate_mlp0 * x_m)
        return x + x_m_s


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, out_features: int):
        super().__init__()
        self.scale_shift_table = nn.Parameter(
            torch.randn(2, hidden_size) / hidden_size ** 0.5)
        self.linear = nn.Linear(hidden_size, out_features)


class STDiT3(nn.Module):
    """Full STDiT3 transformer. forward(x [B, C_in, T, H, W], timestep [B],
    y [B, L, caption_channels]) -> [B, out_channels, T, H, W] fp32."""

    def __init__(self, config: STDiT3Config = STDiT3Config()):
        super().__init__()
        cfg = config
        C = cfg.hidden_size
        self.config = cfg
        self.x_embedder = PatchEmbed3D(cfg.patch_size, cfg.in_channels, C)
        self.t_embedder = TimestepEmbedder(C)
        self.fps_embedder = SizeEmbedder(C)
        self.t_block = nn.Sequential(nn.SiLU(), nn.Linear(C, 6 * C))
        self.y_embedder = CaptionEmbedder(cfg.caption_channels, C,
                                          cfg.model_max_length)
        self.spatial_blocks = nn.ModuleList(
            STDiT3Block(cfg, temporal=False) for _ in range(cfg.depth))
        self.temporal_blocks = nn.ModuleList(
            STDiT3Block(cfg, temporal=True) for _ in range(cfg.depth))
        pt, ph, pw = cfg.patch_size
        self.final_layer = FinalLayer(C, pt * ph * pw * cfg.out_channels)

    def forward(self, x, timestep, y, kv_mask: Optional[torch.Tensor] = None,
                x_mask: Optional[torch.Tensor] = None,
                fps: Optional[torch.Tensor] = None,
                height: float = 0.0, width: float = 0.0):
        cfg = self.config
        dtype = self.final_layer.linear.weight.dtype
        device = x.device
        B, _, Rt, Rh, Rw = x.shape
        pt, ph, pw = cfg.patch_size
        T, H, W = -(-Rt // pt), -(-Rh // ph), -(-Rw // pw)
        S = H * W

        base_size = round(S ** 0.5)
        resolution_sq = (float(height) * float(width)) ** 0.5
        scale = resolution_sq / cfg.input_sq_size if resolution_sq > 0 else 1.0
        pos = torch.as_tensor(
            pos_embed_2d(cfg.hidden_size, H, W, scale=scale,
                         base_size=base_size), device=device).to(dtype)

        # timesteps are rounded to the model dtype before the sinusoid
        timestep = timestep.to(dtype)
        if fps is None:
            fps = torch.full((B,), 24.0, device=device)
        fps_emb = self.fps_embedder(fps.to(dtype), B)
        t = self.t_embedder(timestep) + fps_emb
        t_mlp = self.t_block(t)
        t0 = t0_mlp = None
        if x_mask is not None:
            t0 = self.t_embedder(torch.zeros_like(timestep)) + fps_emb
            t0_mlp = self.t_block(t0)

        y = self.y_embedder(y.to(dtype))
        xe = self.x_embedder(x.to(dtype)).reshape(B, T, S, cfg.hidden_size)
        xe = xe + pos[None, None]

        for spatial, temporal in zip(self.spatial_blocks, self.temporal_blocks):
            xe = spatial(xe, y, t_mlp, t0_mlp, x_mask, kv_mask)
            xe = temporal(xe, y, t_mlp, t0_mlp, x_mask, kv_mask)

        table = self.final_layer.scale_shift_table.float()
        mods = (table[None] + t[:, None].float()).to(dtype)
        xo = t2i_modulate(layer_norm(xe), mods[:, 0, None, None, :],
                          mods[:, 1, None, None, :])
        if x_mask is not None:
            mods0 = (table[None] + t0[:, None].float()).to(dtype)
            # reference quirk kept for checkpoint parity: the t0 branch
            # normalizes the already modulated x
            xo0 = t2i_modulate(layer_norm(xo), mods0[:, 0, None, None, :],
                               mods0[:, 1, None, None, :])
            xo = t_mask_select(x_mask, xo, xo0)
        xo = self.final_layer.linear(xo)

        # unpatchify: [B, T, (H W), (pt ph pw c)] -> [B, c, T*pt, H*ph, W*pw]
        c = cfg.out_channels
        out = xo.reshape(B, T, H, W, pt, ph, pw, c)
        out = out.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(
            B, c, T * pt, H * ph, W * pw)
        return out[:, :, :Rt, :Rh, :Rw].float()


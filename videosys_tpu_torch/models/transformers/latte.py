"""LatteT2V (Latte-1; also Open-Sora-Plan v1.1), alternating spatial and
temporal DiT blocks under PixArt's adaLN-single.

Port of `videosys_tpu/models/transformers/latte.py`. Activations are [B, T, S, C]: spatial blocks attend over the S patches of
each frame (rows b·t), temporal blocks over the T frames of each patch (rows
b·s). Module names follow the reference checkpoint (`maxin-cn/Latte-1`,
`LanguageBind/Open-Sora-Plan-v1.1.0`): `pos_embed.proj`, `adaln_single`,
`caption_projection`, `transformer_blocks.{i}` (attn1, attn2, ff),
`temporal_transformer_blocks.{i}` (attn1, ff), `scale_shift_table`,
`proj_out`.

PAB (`core/pab.py`): `forward(..., plan=, pab_cache=)` runs one sampling
step under its plan. Spatial blocks cache their self-attention ("attn"),
cross-attention ("cross") and MLP ("mlp") outputs, temporal blocks their
self-attention and MLP; a slot the plan reads replaces its branch, which is
not computed (no norm, GEMM or attention), and a slot it writes is filled in
place. The MLP slots follow the per-depth rows of the reference's MLP
broadcast configs.

Sequence parallelism (DSP, `core/parallel.py`): under groups installed with
`parallel.use_groups` and sp > 1, T is padded to a multiple of sp after the
patch embed and each rank holds its frames [B, T/sp, S, C] (JAX :381); the
spatial and cross-attention and the MLP are local. A temporal block
switches its attention input to the token shard [B, T, S/sp, C] (S padded
to sp where it does not divide) and back (JAX :197-209); the pad frames are
masked as keys there and keep the positions after the real frames'. The
PAB slots hold the rank's frames. T is gathered before unpatchify.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.pab import (
    PABCache,
    PABConfig,
    PABStepPlan,
    cache_torch_dtype,
    mlp_config_blocks,
)
from videosys_tpu_torch.models.modules.blocks import Attention, FeedForward
from videosys_tpu_torch.models.modules.cast import Linear
from videosys_tpu_torch.models.modules.embeddings import (
    AdaLayerNormSingle,
    PixArtAlphaTextProjection,
    apply_rope_multiaxis,
    pos_embed_1d,
    pos_embed_2d,
    rope_axis_tables,
)
from videosys_tpu_torch.models.modules.normalization import layer_norm, t2i_modulate


@dataclasses.dataclass(frozen=True)
class LatteConfig:
    """Latte-1: 28 pairs, 16 heads x 72, patch 2, T5-XXL captions, 16
    frames at 512 x 512 (64 x 64 latents). `activation_fn` is the Latte-1
    checkpoint's "gelu-approximate" ("geglu" is the reference class's
    default); `use_rope` is Open-Sora-Plan v1.1's RoPE2D / RoPE1D."""

    num_layers: int = 28
    num_heads: int = 16
    head_dim: int = 72
    in_channels: int = 4
    patch_size: int = 2
    caption_channels: int = 4096
    video_length: int = 16
    sample_size: int = 64
    norm_eps: float = 1e-5
    learned_sigma: bool = True
    use_rope: bool = False
    activation_fn: str = "gelu-approximate"
    dtype: torch.dtype = torch.float32

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learned_sigma else self.in_channels

    @property
    def depth(self) -> int:
        return self.num_layers


def _mods6(table, t_6c, dtype):
    """(table + t_6c) in fp32 -> six [B, 1, 1, C] tensors in `dtype`."""
    B = t_6c.shape[0]
    mods = (table.float()[None] + t_6c.reshape(B, 6, -1).float()).to(dtype)
    return [mods[:, i, None, None, :] for i in range(6)]


class LatteBlock(nn.Module):
    """One block on x [B, T, S, C]: self-attention over the patches of a
    frame (spatial) or over the frames of a patch (temporal), then, in a
    spatial block, cross-attention to the text (no norm before it under
    adaLN-single), then the feed-forward."""

    def __init__(self, config: LatteConfig, temporal: bool):
        super().__init__()
        C = config.hidden_size
        self.config = config
        self.temporal = temporal
        self.scale_shift_table = nn.Parameter(torch.randn(6, C) / C ** 0.5)
        self.attn1 = Attention(C, config.num_heads)
        if not temporal:
            self.attn2 = Attention(C, config.num_heads)
        self.ff = FeedForward(C, config.activation_fn)

    def forward(self, x, t_6c, y=None, kv_mask=None, rope=None, read=None,
                write=None, t_pad=None):
        """`read` / `write`: PAB cache views of this block by slot ("attn",
        "cross", "mlp"), each [B, T, S, C] (outputs after their gates).
        `t_pad` [T * sp]: False at the frames that pad T to the sp size,
        masked as keys in a temporal block (x is this rank's frames)."""
        eps = self.config.norm_eps
        read = read or {}
        write = write or {}
        B, T, S, C = x.shape
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = _mods6(self.scale_shift_table,
                                                  t_6c, x.dtype)
        if "attn" in read:
            attn = read["attn"].to(x.dtype)
        else:
            h = t2i_modulate(layer_norm(x, eps), shift_msa, scale_msa)
            if self.temporal:
                # DSP switch: frame shard -> token shard and back
                h = par.shard_spatial(par.pad_to_multiple(
                    h, 2, par.axis_size()))
                Ba, Ta, Sa = h.shape[:3]
                t_kv = None if t_pad is None else t_pad.expand(Ba * Sa, Ta)
                h = self.attn1(h.transpose(1, 2).reshape(Ba * Sa, Ta, C),
                               kv_mask=t_kv, rope=rope)
                h = par.shard_temporal(h.reshape(Ba, Sa, Ta, C)
                                       .transpose(1, 2))[:, :, :S]
            else:
                h = self.attn1(h.reshape(B * T, S, C),
                               rope=rope).reshape(B, T, S, C)
            attn = gate_msa * h
            if "attn" in write:
                write["attn"].copy_(attn)
        x = x + attn

        if not self.temporal:
            if "cross" in read:
                cross = read["cross"].to(x.dtype)
            else:
                cross = self.attn2(x.reshape(B * T, S, C), y,
                                   kv_mask).reshape(B, T, S, C)
                if "cross" in write:
                    write["cross"].copy_(cross)
            x = x + cross

        if "mlp" in read:
            return x + read["mlp"].to(x.dtype)
        ff = gate_mlp * self.ff(t2i_modulate(layer_norm(x, eps), shift_mlp,
                                             scale_mlp))
        if "mlp" in write:
            write["mlp"].copy_(ff)
        return x + ff


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, hidden_size: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, hidden_size, patch, stride=patch)


class LatteT2V(nn.Module):
    """forward(x [B, C_in, T, H, W], timestep [B], y [B, L, caption],
    kv_mask [B, L]) -> [B, C_out, T, H, W] fp32, computed in the weights'
    dtype."""

    def __init__(self, config: LatteConfig = LatteConfig()):
        super().__init__()
        cfg = config
        C = cfg.hidden_size
        self.config = cfg
        self.pos_embed = _PatchEmbed(cfg.in_channels, C, cfg.patch_size)
        self.adaln_single = AdaLayerNormSingle(C)
        self.caption_projection = PixArtAlphaTextProjection(
            cfg.caption_channels, C)
        self.transformer_blocks = nn.ModuleList(
            LatteBlock(cfg, temporal=False) for _ in range(cfg.num_layers))
        self.temporal_transformer_blocks = nn.ModuleList(
            LatteBlock(cfg, temporal=True) for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(torch.randn(2, C) / C ** 0.5)
        self.proj_out = Linear(C, cfg.patch_size ** 2 * cfg.out_channels)
        self._tables: Dict[tuple, tuple] = {}

    @staticmethod
    def cache_keys(pab: Optional[PABConfig], temporal: bool) -> Tuple[str, ...]:
        """The slots a branch caches under `pab`. The MLP slot follows the
        per-depth configs only: Latte has no range-mode MLP or pair
        broadcast (their plans leave the model dense, as in JAX)."""
        if pab is None or not pab.enabled or pab.pair_broadcast:
            return ()
        keys = []
        if pab.temporal_broadcast if temporal else pab.spatial_broadcast:
            keys.append("attn")
        if not temporal and pab.cross_broadcast:
            keys.append("cross")
        if not pab.mlp_range_mode and mlp_config_blocks(pab):
            keys.append("mlp")
        return tuple(keys)

    def init_cache(self, pab: PABConfig, B: int, T: int, S: int) -> PABCache:
        """A zeroed PAB cache for B rows of T x S tokens on the model's
        device, in `pab.cache_dtype` (None: the model's dtype); an MLP slot
        holds one row per configured block. Under active sp groups the
        slots hold this rank's frames of the padded T."""
        weight = self.proj_out.weight
        T = -(-T // par.token_pad_multiple())
        dtype = cache_torch_dtype(pab.cache_dtype) or weight.dtype
        blocks = [b for b in mlp_config_blocks(pab) if b < self.config.depth]
        shape = (self.config.depth, B, T, S, self.config.hidden_size)
        slots = {}
        for branch, temporal in (("spatial", False), ("temporal", True)):
            keys = self.cache_keys(pab, temporal)
            if keys:
                slots[branch] = {
                    k: torch.zeros((len(blocks),) + shape[1:] if k == "mlp"
                                   else shape, dtype=dtype,
                                   device=weight.device) for k in keys}
        return PABCache(slots, {b: r for r, b in enumerate(blocks)})

    def _positions(self, T: int, h_p: int, w_p: int, device, dtype):
        """(2D sincos table [S, C] and temporal table [1, T, 1, C] or None,
        both in the model dtype; Open-Sora-Plan v1.1's RoPE2D (cos, sin)
        [S, D] and RoPE1D (cos, sin) [T, D] fp32 or None), made once per
        shape and device."""
        key = (T, h_p, w_p, str(device), dtype)
        if key not in self._tables:
            cfg = self.config
            C = cfg.hidden_size
            base = cfg.sample_size // cfg.patch_size if cfg.sample_size \
                else h_p
            pos = torch.as_tensor(pos_embed_2d(C, h_p, w_p, scale=1.0,
                                               base_size=base))
            temp = (torch.as_tensor(pos_embed_1d(C, T))[None, :, None]
                    .to(device, dtype) if T > 1 else None)
            ropes = self._ropes(T, h_p, w_p) if cfg.use_rope else None
            if ropes is not None:
                ropes = tuple(tuple(torch.as_tensor(a).to(device) for a in ab)
                              for ab in ropes)
            self._tables[key] = (pos.to(device, dtype), temp, ropes)
        return self._tables[key]

    def _ropes(self, T: int, h_p: int, w_p: int):
        """Open-Sora-Plan v1.1's RoPE2D over (y, x) on spatial attention and
        RoPE1D over frames on temporal attention, positions divided by the
        linear interpolation scale: ((cos, sin) [S, D], (cos, sin) [T, D])
        numpy fp32."""
        cfg = self.config
        D = cfg.head_dim
        scale_2d = max((cfg.sample_size // 64) if cfg.sample_size else 1, 1)
        vl = cfg.video_length
        scale_1d = max(((vl - 1) // 16) if vl % 2 == 1 else vl // 16, 1)
        cy, sy = rope_axis_tables(D // 2, h_p, float(scale_2d))
        cx, sx = rope_axis_tables(D // 2, w_p, float(scale_2d))

        def grid(ty, tx):
            return np.concatenate([
                np.broadcast_to(ty[:, None], (h_p, w_p, D // 2)),
                np.broadcast_to(tx[None, :], (h_p, w_p, D // 2))],
                axis=-1).reshape(h_p * w_p, D)

        return ((grid(cy, cx), grid(sy, sx)),
                rope_axis_tables(D, T, float(scale_1d)))

    def forward(self, x, timestep, y, kv_mask: Optional[torch.Tensor] = None,
                plan: Optional[PABStepPlan] = None,
                pab_cache: Optional[PABCache] = None):
        cfg = self.config
        dtype = self.proj_out.weight.dtype
        device = x.device
        B, C_in, T, H, W = x.shape
        p = cfg.patch_size
        h_p, w_p = H // p, W // p
        S, C = h_p * w_p, cfg.hidden_size

        # sp: T padded to the sp size, this rank's frames resident, the pad
        # frames masked as keys in the temporal rows (JAX latte.py:381)
        m = par.token_pad_multiple()
        Tp = -(-T // m) * m
        t_pad = (torch.arange(Tp, device=device) < T) if Tp != T else None

        # patch embed with the 2D sincos table at the checkpoint's base size
        pos, temp_pos, ropes = self._positions(Tp, h_p, w_p, device, dtype)
        if T == 1:
            temp_pos = None
        xe = x.transpose(1, 2).reshape(B * T, C_in, H, W).to(dtype)
        xe = self.pos_embed.proj(xe).flatten(2).transpose(1, 2)
        xe = xe.reshape(B, T, S, C) + pos
        if m > 1:
            xe = par.split(par.pad_to_multiple(xe, 1, m), 1)
            if temp_pos is not None:
                temp_pos = par.split(temp_pos, 1)

        # the sinusoid is keyed on the timestep rounded to the model dtype
        t_6c, t_emb = self.adaln_single(timestep.to(dtype))
        y = self.caption_projection(y.to(dtype))
        rope_s = rope_t = None
        if ropes is not None:
            (cs, ss), (ct, st) = ropes
            rope_s = partial(apply_rope_multiaxis, cos=cs, sin=ss, n_axes=2)
            rope_t = partial(apply_rope_multiaxis, cos=ct, sin=st, n_axes=1)

        plan = plan or PABStepPlan()
        for i, (spatial, temporal) in enumerate(zip(
                self.transformer_blocks, self.temporal_transformer_blocks)):
            views_s = views_t = ()
            if pab_cache is not None:
                views_s = pab_cache.views(plan, "spatial", i)
                views_t = pab_cache.views(plan, "temporal", i)
            xe = spatial(xe, t_6c, y, kv_mask, rope_s, *views_s)
            if i == 0 and temp_pos is not None:
                xe = xe + temp_pos
            xe = temporal(xe, t_6c, None, None, rope_t, *views_t,
                          t_pad=t_pad)

        mods = (self.scale_shift_table.float()[None]
                + t_emb[:, None].float()).to(dtype)
        xo = t2i_modulate(layer_norm(xe, 1e-6), mods[:, 0, None, None],
                          mods[:, 1, None, None])
        xo = self.proj_out(xo)
        if m > 1:  # gather T, drop the sp padding
            xo = par.gather(xo, 1)[:, :T]

        # unpatchify: [B, T, (h w), (p q c)] -> [B, c, T, h p, w q]
        c = cfg.out_channels
        out = xo.reshape(B, T, h_p, w_p, p, p, c).permute(0, 6, 1, 2, 4, 3, 5)
        return out.reshape(B, c, T, h_p * p, w_p * p).float()


"""Open-Sora-Plan v1.2 transformer (OpenSoraT2V): a PixArt-style DiT over
one stream of T x H x W tokens with 3D RoPE.

Port of `videosys_tpu/models/transformers/open_sora_plan_v120.py`: per-frame 2D conv patch embed, the shared adaLN-single, per block
self-attention with 3D RoPE (head_dim in thirds over t, h, w), cross-
attention to mT5 captions (no norm before it) and the feed-forward, each
modulated by the block's `scale_shift_table`. Module names follow the
reference checkpoint (`LanguageBind/Open-Sora-Plan-v1.2.0`):
`pos_embed.proj`, `adaln_single`, `caption_projection`,
`transformer_blocks.{i}` (attn1, attn2, ff), `scale_shift_table`,
`proj_out`.

PAB: `forward(..., plan=, pab_cache=)`; slots "attn" (self-attention,
before its gate) and "cross" of branch "spatial", [depth, B, N, C]. A slot
the plan reads replaces its branch, which is not computed; a slot it writes
is filled in place.

Sequence parallelism (Ulysses, `core/parallel.py`): under groups installed
with `parallel.use_groups` and sp > 1, the tokens are padded to a multiple
of sp and each rank holds its shard [B, N/sp, C]; self-attention trades
heads for the whole sequence (one all-to-all of q, k and v), applies the 3D
RoPE there with the whole table, masks the pad tokens as keys and comes
back by the inverse all-to-all (JAX :152-162). Cross-attention, the MLP
and the PAB slots are per rank. The tokens are gathered before unpatchify.
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
)
from videosys_tpu_torch.models.modules.blocks import Attention, FeedForward
from videosys_tpu_torch.models.modules.cast import Linear
from videosys_tpu_torch.models.modules.embeddings import (
    AdaLayerNormSingle,
    PixArtAlphaTextProjection,
    apply_rope_multiaxis,
    pos_embed_1d,
    rope_axis_tables,
)
from videosys_tpu_torch.models.modules.normalization import layer_norm, t2i_modulate


@dataclasses.dataclass(frozen=True)
class OpenSoraPlanV120Config:
    """The released 93-frame checkpoints' widths: 32 layers, 24 heads x 96,
    patch 2 (1 in time), mT5-XXL captions, 3D RoPE; `sample_size` is the
    latent (h, w) and `sample_size_t` the latent frames it was trained at,
    which set the RoPE interpolation scales."""

    num_layers: int = 32
    num_heads: int = 24
    head_dim: int = 96
    in_channels: int = 4
    out_channels: int = 4
    caption_channels: int = 4096
    patch_size: int = 2
    patch_size_t: int = 1
    sample_size: Tuple[int, int] = (60, 80)
    sample_size_t: int = 24
    use_rope: bool = True
    activation_fn: str = "gelu-approximate"
    norm_eps: float = 1e-6
    interpolation_scale_t: Optional[float] = None
    interpolation_scale_h: Optional[float] = None
    interpolation_scale_w: Optional[float] = None
    dtype: torch.dtype = torch.float32

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def depth(self) -> int:
        return self.num_layers

    def interpolation_thw(self) -> Tuple[float, float, float]:
        """t from sample_size_t / 16 ((t - 1) // 16 + 1 when odd), h and w
        from sample_size / 30 and / 40, unless set."""
        t = self.sample_size_t
        it = ((t - 1) // 16 + 1) if t % 2 == 1 else t / 16
        if self.interpolation_scale_t is not None:
            it = self.interpolation_scale_t
        ih = (self.interpolation_scale_h if self.interpolation_scale_h
              is not None else self.sample_size[0] / 30)
        iw = (self.interpolation_scale_w if self.interpolation_scale_w
              is not None else self.sample_size[1] / 40)
        return float(it), float(ih), float(iw)


def rope_3d_tables(head_dim: int, t: int, h: int, w: int,
                   scales: Tuple[float, float, float]):
    """Per-token (cos, sin), each [t*h*w, head_dim] (numpy fp32): the head
    dim in thirds over (t, y, x), each a rotate-half table."""
    if head_dim % 3:
        raise ValueError(f"3D RoPE needs head_dim divisible by 3, got "
                         f"{head_dim}")
    D = head_dim // 3
    tabs = [rope_axis_tables(D, n, s) for n, s in zip((t, h, w), scales)]

    def expand(i):
        a = np.broadcast_to(tabs[0][i][:, None, None], (t, h, w, D))
        b = np.broadcast_to(tabs[1][i][None, :, None], (t, h, w, D))
        c = np.broadcast_to(tabs[2][i][None, None, :], (t, h, w, D))
        return np.concatenate([a, b, c], axis=-1).reshape(t * h * w, head_dim)

    return expand(0), expand(1)


class V120Block(nn.Module):
    """BasicTransformerBlock on the ada_norm_single path, x [B, N, C]."""

    def __init__(self, config: OpenSoraPlanV120Config):
        super().__init__()
        C = config.hidden_size
        self.config = config
        self.scale_shift_table = nn.Parameter(torch.randn(6, C) / C ** 0.5)
        self.attn1 = Attention(C, config.num_heads)
        self.attn2 = Attention(C, config.num_heads)
        self.ff = FeedForward(C, config.activation_fn)

    def forward(self, x, enc, mods, kv_mask=None, rope=None, read=None,
                write=None, key_mask=None):
        """`read` / `write`: PAB cache views by slot ("attn", "cross"),
        each [B, N, C]. `key_mask` [B, N * sp]: self-attention's, under sp
        with padded tokens."""
        eps = self.config.norm_eps
        read = read or {}
        write = write or {}
        B, _, C = x.shape
        # the table is cast to the model dtype and added there
        m = self.scale_shift_table.to(x.dtype)[None] + mods.reshape(B, 6, C)
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = (m[:, i, None] for i in range(6))

        if "attn" in read:
            attn = read["attn"].to(x.dtype)
        else:
            attn = self.attn1(t2i_modulate(layer_norm(x, eps), shift_msa,
                                           scale_msa), kv_mask=key_mask,
                              rope=rope, ulysses=True)
            if "attn" in write:
                write["attn"].copy_(attn)
        x = x + gate_msa * attn

        if "cross" in read:
            attn = read["cross"].to(x.dtype)
        else:
            attn = self.attn2(x, enc, kv_mask)
            if "cross" in write:
                write["cross"].copy_(attn)
        x = x + attn

        ff = self.ff(t2i_modulate(layer_norm(x, eps), shift_mlp, scale_mlp))
        return x + gate_mlp * ff


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, hidden_size: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, hidden_size, patch, stride=patch)


class OpenSoraPlanV120Transformer(nn.Module):
    """forward(x [B, C_in, T, H, W], encoder_hidden_states [B, L, caption],
    timestep [B], kv_mask [B, L]) -> [B, C_out, T, H, W] fp32, computed in
    the weights' dtype (the timestep sinusoid in fp32)."""

    def __init__(self, config: OpenSoraPlanV120Config = OpenSoraPlanV120Config()):
        super().__init__()
        if config.patch_size_t != 1:
            raise ValueError("patch_size_t > 1 is not used by the released "
                             "v1.2 checkpoints")
        cfg = config
        C = cfg.hidden_size
        self.config = cfg
        self.pos_embed = _PatchEmbed(cfg.in_channels, C, cfg.patch_size)
        self.adaln_single = AdaLayerNormSingle(C)
        self.caption_projection = PixArtAlphaTextProjection(
            cfg.caption_channels, C)
        self.transformer_blocks = nn.ModuleList(
            V120Block(cfg) for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(torch.randn(2, C) / C ** 0.5)
        self.proj_out = Linear(C, cfg.patch_size ** 2 * cfg.out_channels)
        self._tables: Dict[tuple, tuple] = {}

    @staticmethod
    def cache_keys(pab: Optional[PABConfig]) -> Tuple[str, ...]:
        """The slots cached under `pab`: spatial and cross only."""
        if pab is None or not pab.enabled:
            return ()
        return tuple(k for k, on in (("attn", pab.spatial_broadcast),
                                     ("cross", pab.cross_broadcast)) if on)

    def init_cache(self, pab: PABConfig, B: int, N: int) -> PABCache:
        """A zeroed PAB cache for B rows of N tokens on the model's device,
        in `pab.cache_dtype` (None: the model's dtype). Under active sp
        groups the rows are this rank's padded shard."""
        weight = self.proj_out.weight
        N = -(-N // par.token_pad_multiple())
        dtype = cache_torch_dtype(pab.cache_dtype) or weight.dtype
        shape = (self.config.depth, B, N, self.config.hidden_size)
        keys = self.cache_keys(pab)
        slots = {"spatial": {k: torch.zeros(shape, dtype=dtype,
                                            device=weight.device)
                             for k in keys}} if keys else {}
        return PABCache(slots, {})

    def _positions(self, T: int, h_p: int, w_p: int, device, dtype):
        """The 3D RoPE (cos, sin) [T h w, D] fp32 when RoPE is on, else the
        sincos tables [h w, C] and [T, 1, C] in the model dtype, made once per shape
        and device."""
        key = (T, h_p, w_p, str(device), dtype)
        if key in self._tables:
            return self._tables[key]
        cfg = self.config
        C = cfg.hidden_size
        if cfg.use_rope:
            table = tuple(torch.as_tensor(a).to(device) for a in rope_3d_tables(
                cfg.head_dim, T, h_p, w_p, cfg.interpolation_thw()))
        else:
            it, ih, iw = cfg.interpolation_thw()
            # anisotropic 2D sincos: half the channels each for h and w
            bh, bw = cfg.sample_size[0] // cfg.patch_size, \
                cfg.sample_size[1] // cfg.patch_size
            emb_h = pos_embed_1d(C // 2, h_p, scale=(h_p / bh) * ih)
            emb_w = pos_embed_1d(C // 2, w_p, scale=(w_p / bw) * iw)
            pos = np.concatenate([
                np.broadcast_to(emb_h[:, None], (h_p, w_p, C // 2)),
                np.broadcast_to(emb_w[None, :], (h_p, w_p, C // 2))],
                axis=-1).reshape(h_p * w_p, C)
            tpos = pos_embed_1d(C, T, scale=it)
            table = (torch.as_tensor(pos).to(device, dtype),
                     torch.as_tensor(tpos).to(device, dtype)[:, None])
        self._tables[key] = table
        return table

    def forward(self, x, encoder_hidden_states, timestep,
                kv_mask: Optional[torch.Tensor] = None,
                plan: Optional[PABStepPlan] = None,
                pab_cache: Optional[PABCache] = None):
        cfg = self.config
        dtype = self.proj_out.weight.dtype
        B, C_in, T, H, W = x.shape
        p = cfg.patch_size
        h_p, w_p = H // p, W // p
        C = cfg.hidden_size

        xe = x.transpose(1, 2).reshape(B * T, C_in, H, W).to(dtype)
        xe = self.pos_embed.proj(xe).flatten(2).transpose(1, 2)
        xe = xe.reshape(B, T, h_p * w_p, C)
        table = self._positions(T, h_p, w_p, xe.device, dtype)
        N = T * h_p * w_p
        # sp: the tokens padded to the sp size, this rank's shard resident,
        # the pad masked as keys (JAX open_sora_plan_v120.py:348)
        sp = par.token_pad_multiple()
        key_mask = None
        if sp > 1 and N % sp:
            key_mask = (torch.arange(N + -N % sp, device=xe.device)
                        < N).expand(B, -1)
        rope = None
        if cfg.use_rope:
            cos, sin = (par.pad_to_multiple(a, 0, sp) for a in table)
            rope = partial(apply_rope_multiaxis, cos=cos, sin=sin, n_axes=3)
        else:
            xe = xe + table[0] + table[1]
        xe = par.shard_tokens(xe.reshape(B, N, C))

        mods, emb = self.adaln_single(timestep.float())
        enc = self.caption_projection(encoder_hidden_states.to(dtype))

        plan = plan or PABStepPlan()
        for i, block in enumerate(self.transformer_blocks):
            views = (pab_cache.views(plan, "spatial", i)
                     if pab_cache is not None else ())
            xe = block(xe, enc, mods, kv_mask, rope, *views,
                       key_mask=key_mask)

        m = self.scale_shift_table.to(dtype)[None] + emb[:, None]
        xe = t2i_modulate(layer_norm(xe, 1e-6), m[:, 0, None], m[:, 1, None])
        xo = self.proj_out(xe)
        if sp > 1:  # gather the tokens, drop the sp padding
            xo = par.gather(xo, 1)[:, :N]

        # unpatchify: [B, (T h w), (p q c)] -> [B, c, T, h p, w q]
        c = cfg.out_channels
        out = xo.reshape(B, T, h_p, w_p, p, p, c).permute(0, 6, 1, 2, 4, 3, 5)
        return out.reshape(B, c, T, h_p * p, w_p * p).float()

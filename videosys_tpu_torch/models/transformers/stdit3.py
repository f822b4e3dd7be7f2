"""STDiT3 (Open-Sora v1.2), the spatio-temporal DiT.

Port of `videosys_tpu/models/transformers/stdit3.py`. Activations are
[B, T, S, C]; the depth pairs are a Python loop over `spatial_blocks` and
`temporal_blocks`, named as in the reference checkpoint's state_dict.

Sequence parallelism (DSP, `core/parallel.py`): under groups installed with
`parallel.use_groups` and sp > 1, T and S are padded to the sp size after
patchify and each rank holds its S shard [B, T, S/sp, C]. A spatial block
switches only its attention input to T-sharded and back; temporal and
cross-attention and the MLP stay local; the padded tokens and frames are
masked as keys. S is gathered before unpatchify. With no groups the
one-card loop runs unchanged. For training, `remat` recomputes each
spatial+temporal pair in the backward pass, and `compute_dtype` computes in
another dtype than the parameters are held in (fp32 master weights, bf16
matmuls and attention). Under ZeRO-3 (`training/zero3.py`, which sets
`zero3`) each depth pair gathers its weights inside its recompute call and
the rest of the model for the whole forward (`unit_params`).

PAB (Pyramid Attention Broadcast, `core/pab.py`): `forward(..., plan=,
pab_cache=)` runs one sampling step under its `PABStepPlan`. A branch whose
slot the plan reads is not computed (no attention, GEMM or norm for it) and
its cached output is added instead; a branch whose slot the plan writes is
computed and copied into `slot[depth]` in place. Without a cache the dense
loop runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.pab import (
    PABCache,
    PABConfig,
    PABStepPlan,
    cache_torch_dtype,
    mlp_config_blocks,
)
from videosys_tpu_torch.models.modules.blocks import (
    MultiHeadCrossAttention,
    SelfAttention,
)
from videosys_tpu_torch.models.modules.cast import Linear, set_compute_dtype
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
from videosys_tpu_torch.utils.timing import (
    ATTN,
    BLOCK_SPATIAL,
    BLOCK_TEMPORAL,
    CROSS,
    EMBED,
    FINAL,
    FORWARD,
    MLP,
    MODULATE,
    span,
)


@dataclasses.dataclass(frozen=True)
class STDiT3Config:
    """STDiT3-XL/2 by default: depth 28, hidden 1152, patch (1, 2, 2),
    16 heads. `dtype` is the one the serving pipeline holds the weights in
    and the one training computes in (over fp32 parameters); a model built
    without `compute_dtype` computes in its parameters' dtype."""

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


_MATMUL_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of "dots": keep matmul outputs."""
    if op in _MATMUL_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


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

    def forward(self, x, y, t_mlp, t0_mlp=None, x_mask=None, kv_mask=None,
                read=None, write=None, s_pad=None, t_pad=None):
        """`read` / `write`: PAB cache views of this block by slot ("attn",
        "cross", "mlp"), each [B, T, S, C]. A slot in `read` replaces its
        branch, which is not computed, by the cached output; a branch whose
        slot is in `write` is computed and copied into it in place.
        `s_pad` [S] / `t_pad` [T]: False at the tokens / frames that pad
        to the sp size, masked as keys (x is this rank's S shard)."""
        cfg = self.config
        read = read or {}
        write = write or {}
        B, T, S, C = x.shape
        with span(MODULATE):
            (shift_msa, scale_msa, gate_msa,
             shift_mlp, scale_mlp, gate_mlp) = _modulations(
                self.scale_shift_table, t_mlp, x.dtype)
            if x_mask is not None:
                (shift_msa0, scale_msa0, gate_msa0,
                 shift_mlp0, scale_mlp0, gate_mlp0) = _modulations(
                    self.scale_shift_table, t0_mlp, x.dtype)
            if "attn" not in read:
                normed1 = layer_norm(x)
                x_m = t2i_modulate(normed1, shift_msa, scale_msa)
                if x_mask is not None:
                    x_m = t_mask_select(
                        x_mask, x_m,
                        t2i_modulate(normed1, shift_msa0, scale_msa0))

        # attention (spatial or temporal)
        with span(ATTN):
            if "attn" in read:
                x_m_s = read["attn"].to(x.dtype)
            elif self.temporal:
                # local under the resident S shard
                xa = x_m.permute(0, 2, 1, 3).reshape(B * S, T, C)
                rope = rope_channel_tables(np.arange(T, dtype=np.float32),
                                           rope_freqs(C // cfg.num_heads),
                                           cfg.num_heads)
                t_kv = None if t_pad is None else t_pad.expand(B * S, T)
                xa = self.attn(xa, kv_mask=t_kv, rope_channel=rope)
                x_m = xa.reshape(B, S, T, C).permute(0, 2, 1, 3)
            else:
                # DSP switch: S shard -> T shard (an image: batch shard)
                is_image = T == 1
                x_m = (par.shard_batch_over_all(x_m) if is_image
                       else par.shard_temporal(x_m))
                Ba, Ta, Sa = x_m.shape[:3]
                s_kv = None if s_pad is None else s_pad.expand(Ba * Ta, Sa)
                x_m = self.attn(x_m.reshape(Ba * Ta, Sa, C),
                                kv_mask=s_kv).reshape(Ba, Ta, Sa, C)
                x_m = (par.unshard_batch(x_m, B) if is_image
                       else par.shard_spatial(x_m))
        with span(MODULATE):
            if "attn" not in read:
                x_m_s = gate_msa * x_m
                if x_mask is not None:
                    x_m_s = t_mask_select(x_mask, x_m_s, gate_msa0 * x_m)
                if "attn" in write:
                    write["attn"].copy_(x_m_s)
            x = x + x_m_s

        # cross attention, per frame
        with span(CROSS):
            if "cross" in read:
                x_cross = read["cross"].to(x.dtype)
            else:
                x_cross = self.cross_attn(x.reshape(B * T, S, C), y,
                                          kv_mask).reshape(B, T, S, C)
                if "cross" in write:
                    write["cross"].copy_(x_cross)

        # MLP
        if "mlp" in read:
            with span(MLP):
                x_m_s = read["mlp"].to(x.dtype)
            with span(MODULATE):
                return x + x_cross + x_m_s
        with span(MODULATE):
            x = x + x_cross
            normed2 = layer_norm(x)
            x_m = t2i_modulate(normed2, shift_mlp, scale_mlp)
            if x_mask is not None:
                x_m = t_mask_select(
                    x_mask, x_m, t2i_modulate(normed2, shift_mlp0, scale_mlp0))
        with span(MLP):
            x_m = self.mlp(x_m)
        with span(MODULATE):
            x_m_s = gate_mlp * x_m
            if x_mask is not None:
                x_m_s = t_mask_select(x_mask, x_m_s, gate_mlp0 * x_m)
            if "mlp" in write:
                write["mlp"].copy_(x_m_s)
            return x + x_m_s


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, out_features: int):
        super().__init__()
        self.scale_shift_table = nn.Parameter(
            torch.randn(2, hidden_size) / hidden_size ** 0.5)
        self.linear = Linear(hidden_size, out_features)


class STDiT3(nn.Module):
    """Full STDiT3 transformer. forward(x [B, C_in, T, H, W], timestep [B],
    y [B, L, caption_channels]) -> [B, out_channels, T, H, W] fp32.

    `remat` recomputes each depth pair in the backward pass instead of
    keeping its activations (non-reentrant `torch.utils.checkpoint`):
    `remat_policy` "full" recomputes everything, "dots" keeps the outputs
    of the matrix products (the Linear layers) and recomputes the rest,
    attention included, "none" keeps every activation. Values never differ
    between the policies.

    `compute_dtype`: the dtype of matmuls, attention and activations when it
    differs from the parameters' (each Linear casts its weight, bias and
    input at use); None computes in the parameters' dtype."""

    REMAT_POLICIES = ("full", "dots", "none")

    def __init__(self, config: STDiT3Config = STDiT3Config(),
                 remat: bool = False, remat_policy: str = "full",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if remat_policy not in self.REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} not in "
                             f"{self.REMAT_POLICIES}")
        self.remat = remat
        self.remat_policy = remat_policy
        self.compute_dtype = compute_dtype
        cfg = config
        C = cfg.hidden_size
        self.config = cfg
        self.x_embedder = PatchEmbed3D(cfg.patch_size, cfg.in_channels, C)
        self.t_embedder = TimestepEmbedder(C)
        self.fps_embedder = SizeEmbedder(C)
        self.t_block = nn.Sequential(nn.SiLU(), Linear(C, 6 * C))
        self.y_embedder = CaptionEmbedder(cfg.caption_channels, C,
                                          cfg.model_max_length)
        self.spatial_blocks = nn.ModuleList(
            STDiT3Block(cfg, temporal=False) for _ in range(cfg.depth))
        self.temporal_blocks = nn.ModuleList(
            STDiT3Block(cfg, temporal=True) for _ in range(cfg.depth))
        pt, ph, pw = cfg.patch_size
        self.final_layer = FinalLayer(C, pt * ph * pw * cfg.out_channels)
        set_compute_dtype(self, compute_dtype)
        self.zero3 = None  # a training/zero3.py Zero3 when sharded

    def param_unit(self, name: str) -> int:
        """ZeRO-3's unit of parameter `name`: i for the blocks of depth pair
        i, `depth` for the rest of the model."""
        head, _, rest = name.partition(".")
        if head in ("spatial_blocks", "temporal_blocks"):
            return int(rest.partition(".")[0])
        return self.config.depth

    def unit_params(self, unit: int):
        """A context holding unit `unit`'s gathered weights under ZeRO-3
        (re-entrant); nothing otherwise."""
        if self.zero3 is None:
            return contextlib.nullcontext()
        return self.zero3.gathered(unit)

    @staticmethod
    def cache_keys(pab: Optional[PABConfig], temporal: bool) -> Tuple[str, ...]:
        """The component slots a branch caches under `pab`."""
        if pab is None or not pab.enabled or pab.pair_broadcast:
            return ()
        keys = []
        if pab.temporal_broadcast if temporal else pab.spatial_broadcast:
            keys.append("attn")
        if pab.cross_broadcast:
            keys.append("cross")
        if pab.mlp_broadcast and (pab.mlp_range_mode or mlp_config_blocks(pab)):
            keys.append("mlp")
        return tuple(keys)

    def init_cache(self, pab: PABConfig, B: int, T: int, S: int) -> PABCache:
        """A zeroed PAB cache for B rows of T x S tokens on the model's
        device, in `pab.cache_dtype` (None: the model's compute dtype).
        Under active sp groups its slots take this rank's padded shard,
        [B, T_pad, S_pad / sp, C], as the forward holds it."""
        cfg = self.config
        weight = self.final_layer.linear.weight
        dtype = (cache_torch_dtype(pab.cache_dtype) or self.compute_dtype
                 or weight.dtype)
        m = par.token_pad_multiple()
        if m > 1:
            T = T if T == 1 else -(-T // m) * m
            S = -(-S // m) * m // m
        shape = (cfg.depth, B, T, S, cfg.hidden_size)

        def zeros(shape):
            return torch.zeros(shape, dtype=dtype, device=weight.device)

        if pab.pair_broadcast:
            return PABCache({"pair": {"delta": zeros(shape)}}, {})
        blocks = mlp_config_blocks(pab)
        mlp_shape = shape if pab.mlp_range_mode else (len(blocks),) + shape[1:]
        slots = {}
        for branch, temporal in (("spatial", False), ("temporal", True)):
            keys = self.cache_keys(pab, temporal)
            if keys:
                slots[branch] = {k: zeros(mlp_shape if k == "mlp" else shape)
                                 for k in keys}
        return PABCache(slots, {b: r for r, b in enumerate(blocks)
                                if b < cfg.depth})

    def _pair(self, i, xe, y, t_mlp, t0_mlp, x_mask, kv_mask, s_pad=None,
              t_pad=None):
        with self.unit_params(i):
            with span(BLOCK_SPATIAL):
                xe = self.spatial_blocks[i](xe, y, t_mlp, t0_mlp, x_mask,
                                            kv_mask, s_pad=s_pad)
            with span(BLOCK_TEMPORAL):
                return self.temporal_blocks[i](xe, y, t_mlp, t0_mlp, x_mask,
                                               kv_mask, t_pad=t_pad)

    def _dense_pairs(self, xe, y, t_mlp, t0_mlp, x_mask, kv_mask,
                     s_pad=None, t_pad=None):
        recompute = (self.remat and self.remat_policy != "none"
                     and torch.is_grad_enabled())
        for i in range(self.config.depth):
            if recompute:
                # the replay in the backward pass runs the pair's DSP
                # collectives (and ZeRO-3's gather) again, in the forward's
                # order on every rank: the step's backward runs under the
                # same `use_groups`
                context = {} if self.remat_policy == "full" else {
                    "context_fn": functools.partial(
                        create_selective_checkpoint_contexts, _save_matmuls)}
                xe = checkpoint(self._pair, i, xe, y, t_mlp, t0_mlp, x_mask,
                                kv_mask, s_pad, t_pad, use_reentrant=False,
                                **context)
            else:
                xe = self._pair(i, xe, y, t_mlp, t0_mlp, x_mask, kv_mask,
                                s_pad, t_pad)
        return xe

    def _pab_pairs(self, xe, y, t_mlp, t0_mlp, x_mask, kv_mask,
                   plan: PABStepPlan, cache: PABCache, s_pad=None,
                   t_pad=None):
        """The depth pairs of one PAB step: a pair-read step adds each
        pair's cached residual and runs neither block."""
        delta = cache.slots.get("pair", {}).get("delta")
        for i, (spatial, temporal) in enumerate(
                zip(self.spatial_blocks, self.temporal_blocks)):
            if delta is not None and plan.pair:
                xe = xe + delta[i].to(xe.dtype)
                continue
            x_in = xe
            with span(BLOCK_SPATIAL):
                xe = spatial(xe, y, t_mlp, t0_mlp, x_mask, kv_mask,
                             *cache.views(plan, "spatial", i), s_pad=s_pad)
            with span(BLOCK_TEMPORAL):
                xe = temporal(xe, y, t_mlp, t0_mlp, x_mask, kv_mask,
                              *cache.views(plan, "temporal", i), t_pad=t_pad)
            if delta is not None and plan.save_pair:
                delta[i].copy_(xe - x_in)
        return xe

    def forward(self, x, timestep, y, kv_mask: Optional[torch.Tensor] = None,
                x_mask: Optional[torch.Tensor] = None,
                fps: Optional[torch.Tensor] = None,
                height: float = 0.0, width: float = 0.0,
                plan: Optional[PABStepPlan] = None,
                pab_cache: Optional[PABCache] = None):
        """`plan` and `pab_cache`: run one PAB sampling step (inference);
        without a cache the dense loop runs."""
        with span(FORWARD), self.unit_params(self.config.depth):
            return self._forward(x, timestep, y, kv_mask, x_mask, fps, height,
                                 width, plan, pab_cache)

    def _forward(self, x, timestep, y, kv_mask, x_mask, fps, height, width,
                 plan, pab_cache):
        cfg = self.config
        dtype = self.compute_dtype or self.final_layer.linear.weight.dtype
        device = x.device
        B, _, Rt, Rh, Rw = x.shape
        pt, ph, pw = cfg.patch_size
        T, H, W = -(-Rt // pt), -(-Rh // ph), -(-Rw // pw)
        S = H * W

        with span(EMBED):
            base_size = round(S ** 0.5)
            resolution_sq = (float(height) * float(width)) ** 0.5
            scale = (resolution_sq / cfg.input_sq_size if resolution_sq > 0
                     else 1.0)
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
            xe = self.x_embedder(x.to(dtype)).reshape(B, T, S,
                                                      cfg.hidden_size)
            xe = xe + pos[None, None]

            # sp: pad T and S to the sp size (an image never pads T), mask
            # the pad as keys, keep this rank's S shard (JAX
            # stdit3.py:515-537)
            T0, S0 = T, S
            s_pad = t_pad = None
            m = par.token_pad_multiple()
            if m > 1:
                Sp = -(-S // m) * m
                Tp = T if T == 1 else -(-T // m) * m
                if Sp != S:
                    s_pad = torch.arange(Sp, device=device) < S
                if Tp != T:
                    t_pad = torch.arange(Tp, device=device) < T
                    if x_mask is not None:
                        x_mask = torch.cat([x_mask, x_mask.new_ones(
                            (B, Tp - T))], dim=1)
                if (Tp, Sp) != (T, S):
                    xe = torch.nn.functional.pad(
                        xe, (0, 0, 0, Sp - S, 0, Tp - T))
                    T, S = Tp, Sp
                xe = par.split(xe, 2)

        if pab_cache is not None:
            xe = self._pab_pairs(xe, y, t_mlp, t0_mlp, x_mask, kv_mask,
                                 plan or PABStepPlan(), pab_cache, s_pad,
                                 t_pad)
        else:
            xe = self._dense_pairs(xe, y, t_mlp, t0_mlp, x_mask, kv_mask,
                                   s_pad, t_pad)

        with span(FINAL):
            table = self.final_layer.scale_shift_table.float()
            mods = (table[None] + t[:, None].float()).to(dtype)
            xo = t2i_modulate(layer_norm(xe), mods[:, 0, None, None, :],
                              mods[:, 1, None, None, :])
            if x_mask is not None:
                mods0 = (table[None] + t0[:, None].float()).to(dtype)
                # reference quirk kept for checkpoint parity: the t0 branch
                # normalizes the already modulated x
                xo0 = t2i_modulate(layer_norm(xo),
                                   mods0[:, 0, None, None, :],
                                   mods0[:, 1, None, None, :])
                xo = t_mask_select(x_mask, xo, xo0)
            xo = self.final_layer.linear(xo)
            if m > 1:  # gather S, drop the sp padding (JAX stdit3.py:625-626)
                xo = par.gather(xo, 2)[:, :T0, :S0]
                T, S = T0, S0

            # unpatchify: [B, T, (H W), (pt ph pw c)]
            # -> [B, c, T*pt, H*ph, W*pw]
            c = cfg.out_channels
            out = xo.reshape(B, T, H, W, pt, ph, pw, c)
            out = out.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(
                B, c, T * pt, H * ph, W * pw)
            return out[:, :, :Rt, :Rh, :Rw].float()


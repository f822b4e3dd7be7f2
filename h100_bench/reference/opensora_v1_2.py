"""Plain float32 reference of Open-Sora v1.2 serving: one CFG-doubled
STDiT3-XL/2 step with its rectified-flow update, and the video VAE's
decode to uint8 frames (its text encoder, T5, is `reference/t5.py`).

A frozen, independent copy of the model's equations (hpcai-tech Open-Sora
v1.2: STDiT3 blocks with adaLN-single modulation, per-head RMS qk-norm,
RoPE over frames, masked cross-attention to the caption; the VAE's
temporal decoder, 17-frame chunks, then the SD 2D decoder), written on
weights held by name (the program's state_dict names). Every product goes
through `common.Ops`, so the control is this code one precision down.
Imports torch and numpy only.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import Ops, group_norm, layer_norm, timestep_embedding

# ---- rectified flow --------------------------------------------------------


def rflow_ladder(steps: int, height: int, width: int, num_frames: int,
                 num_timesteps: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps, dts) of Open-Sora v1.2's sampler: uniform in (0, T],
    warped by resolution and duration, dt_i = (t_i - t_{i+1}) / T, the
    last to 0."""
    t = np.array([(1.0 - i / steps) * num_timesteps for i in range(steps)],
                 np.float64) / num_timesteps
    latent_frames = 1.0 if num_frames == 1 else float((num_frames // 17) * 5)
    ratio = math.sqrt(height * width / (512.0 * 512.0)) * math.sqrt(
        latent_frames)
    t = (ratio * t / (1 + (ratio - 1) * t) * num_timesteps).astype(np.float32)
    t64 = t.astype(np.float64)
    dts = np.empty_like(t64)
    dts[:-1] = t64[:-1] - t64[1:]
    dts[-1] = t64[-1]
    return t, (dts / num_timesteps).astype(np.float32)


# ---- STDiT3 ---------------------------------------------------------------


def pos_embed_2d(dim: int, h: int, w: int, scale: float,
                 base_size=None) -> np.ndarray:
    """2D sincos table [h*w, dim], the width's half first."""
    half = dim // 2
    inv = 1.0 / (10000 ** (np.arange(0, half, 2, dtype=np.float32) / half))
    gh = np.arange(h, dtype=np.float32) / scale
    gw = np.arange(w, dtype=np.float32) / scale
    if base_size is not None:
        gh = gh * (base_size / h)
        gw = gw * (base_size / w)

    def sincos(c):
        o = np.outer(c, inv)
        return np.concatenate([np.sin(o), np.cos(o)], axis=-1)

    ew = np.broadcast_to(sincos(gw)[None], (h, w, half))
    eh = np.broadcast_to(sincos(gh)[:, None], (h, w, half))
    return np.concatenate([ew, eh], axis=-1).reshape(h * w, dim)


def rope_tables(n: int, head_dim: int, heads: int, device):
    """Interleaved-pair rotary (cos, sin) over positions 0..n-1, each
    frequency on its channel pair, tiled over the heads: [n, heads*D]."""
    freqs = 1.0 / (10000.0 ** (np.arange(0, head_dim, 2, dtype=np.float32)
                               / head_dim))
    ang = np.arange(n, dtype=np.float32)[:, None] * freqs[None]
    cos = np.tile(np.repeat(np.cos(ang), 2, -1), (1, heads))
    sin = np.tile(np.repeat(np.sin(ang), 2, -1), (1, heads))
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def rotate(x, cos, sin):
    pairs = x.unflatten(-1, (-1, 2))
    swapped = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).flatten(-2)
    return x * cos + swapped * sin


def rms_heads(x, weight, heads: int, eps: float = 1e-6):
    B, N, C = x.shape
    xh = x.reshape(B, N, heads, C // heads)
    xh = xh * torch.rsqrt((xh * xh).mean(-1, keepdim=True) + eps) * weight
    return xh.reshape(B, N, C)


class STDiT3:
    """forward(x [B, 4, T, H, W], t [B], y [B, L, 4096], mask [B, L], fps,
    height, width) -> [B, 8, T, H, W]."""

    def __init__(self, ops: Ops, cfg: dict):
        self.o = ops
        self.depth = cfg["depth"]
        self.C = cfg["hidden_size"]
        self.heads = cfg["num_heads"]
        self.patch = tuple(cfg["patch_size"])
        self.out_channels = cfg["in_channels"] * (2 if cfg["pred_sigma"]
                                                  else 1)
        self.input_sq_size = cfg["input_sq_size"]
        self.t_dtype = {"bf16": torch.bfloat16, "fp16": torch.float16,
                        "fp32": torch.float32}[cfg["dtype"]]

    def mlp2(self, x, prefix, act):
        return self.o.linear(act(self.o.linear(x, prefix + ".0")), prefix + ".2")

    def embed_t(self, t, prefix):
        return self.mlp2(timestep_embedding(t, 256), prefix + ".mlp", F.silu)

    def self_attn(self, x, prefix, rope=None):
        o, H = self.o, self.heads
        B, N, C = x.shape
        D = C // H
        q, k, v = o.linear(x, prefix + ".qkv").chunk(3, dim=-1)
        q = rms_heads(q, o.p(prefix + ".q_norm.weight"), H)
        k = rms_heads(k, o.p(prefix + ".k_norm.weight"), H)
        if rope is not None:
            q, k = rotate(q, *rope), rotate(k, *rope)

        def heads(t):
            return t.reshape(B, N, H, D).transpose(1, 2)

        a = o.attention(heads(q), heads(k), heads(v), D ** -0.5)
        return o.linear(a.transpose(1, 2).reshape(B, N, C), prefix + ".proj")

    def cross_attn(self, x, y, mask, prefix):
        o, H = self.o, self.heads
        Bf, N, C = x.shape
        Bc, L, _ = y.shape
        D = C // H
        frames = Bf // Bc
        q = o.linear(x, prefix + ".q_linear").reshape(Bf, N, H, D).transpose(1, 2)
        k, v = o.linear(y, prefix + ".kv_linear").chunk(2, dim=-1)
        k = k.reshape(Bc, L, H, D).transpose(1, 2).repeat_interleave(frames, 0)
        v = v.reshape(Bc, L, H, D).transpose(1, 2).repeat_interleave(frames, 0)
        a = o.attention(q, k, v, D ** -0.5,
                        mask.repeat_interleave(frames, 0))
        return o.linear(a.transpose(1, 2).reshape(Bf, N, C), prefix + ".proj")

    def block(self, x, y, mask, t_mlp, branch: str, depth: int, plan=None,
              cache=None):
        """One block; under a PAB `plan` a slot it reads is taken from
        `cache` instead of computed, a slot it writes is stored there."""
        o = self.o
        prefix = f"{branch}_blocks.{depth}"
        read = plan.reads(branch, depth) if plan is not None else ()
        write = plan.writes(branch, depth) if plan is not None else ()
        B, T, S, C = x.shape
        mods = o.p(prefix + ".scale_shift_table")[None] + t_mlp.reshape(B, 6, C)
        sh1, sc1, g1, sh2, sc2, g2 = (mods[:, i, None, None] for i in range(6))
        if "attn" in read:
            xa = cache[(branch, depth, "attn")]
        else:
            xm = layer_norm(x, 1e-6) * (1 + sc1) + sh1
            if branch == "temporal":
                xt = xm.permute(0, 2, 1, 3).reshape(B * S, T, C)
                rope = rope_tables(T, C // self.heads, self.heads, x.device)
                xt = self.self_attn(xt, prefix + ".attn", rope)
                xm = xt.reshape(B, S, T, C).permute(0, 2, 1, 3)
            else:
                xm = self.self_attn(xm.reshape(B * T, S, C),
                                    prefix + ".attn").reshape(B, T, S, C)
            xa = g1 * xm
            if "attn" in write:
                cache[(branch, depth, "attn")] = xa
        x = o.add(x, xa)
        if "cross" in read:
            xc = cache[(branch, depth, "cross")]
        else:
            xc = self.cross_attn(x.reshape(B * T, S, C), y, mask,
                                 prefix + ".cross_attn").reshape(B, T, S, C)
            if "cross" in write:
                cache[(branch, depth, "cross")] = xc
        x = o.add(x, xc)
        if "mlp" in read:
            return o.add(x, cache[(branch, depth, "mlp")])
        xm = layer_norm(x, 1e-6) * (1 + sc2) + sh2
        xm = g2 * o.linear(F.gelu(o.linear(xm, prefix + ".mlp.fc1"),
                                  approximate="tanh"), prefix + ".mlp.fc2")
        if "mlp" in write:
            cache[(branch, depth, "mlp")] = xm
        return o.add(x, xm)

    @torch.no_grad()
    def forward(self, x, t, y, mask, fps, height: float, width: float,
                plan=None, cache=None):
        o, C = self.o, self.C
        B, _, Rt, Rh, Rw = x.shape
        pt, ph, pw = self.patch
        T, H, W = Rt // pt, Rh // ph, Rw // pw
        S = H * W
        scale = math.sqrt(height * width) / self.input_sq_size
        pos = torch.from_numpy(pos_embed_2d(C, H, W, scale, round(S ** 0.5))
                               ).to(x.device)
        # the model keys its sinusoid on t rounded to the dtype it is
        # served in
        t = t.to(self.t_dtype).float()
        temb = self.embed_t(t, "t_embedder") + self.embed_t(fps, "fps_embedder")
        t_mlp = o.linear(F.silu(temb), "t_block.1")
        y = o.linear(F.gelu(o.linear(y, "y_embedder.y_proj.fc1"),
                            approximate="tanh"), "y_embedder.y_proj.fc2")
        xe = o.conv(F.conv3d, x, "x_embedder.proj", stride=self.patch)
        xe = xe.permute(0, 2, 3, 4, 1).reshape(B, T, S, C) + pos
        for i in range(self.depth):
            for branch in ("spatial", "temporal"):
                xe = self.block(xe, y, mask, t_mlp, branch, i, plan, cache)
        mods = o.p("final_layer.scale_shift_table")[None] + temb[:, None]
        xo = layer_norm(xe, 1e-6) * (1 + mods[:, 1, None, None]) \
            + mods[:, 0, None, None]
        xo = o.linear(xo, "final_layer.linear")
        c = self.out_channels
        out = xo.reshape(B, T, H, W, pt, ph, pw, c)
        return out.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(
            B, c, T * pt, H * ph, W * pw)


def cfg_step(model: STDiT3, z, t: float, dt: float, y_all, mask_all,
             fps: float, height: float, width: float, guidance: float,
             in_channels: int, plan=None, cache=None):
    """One sampling step: the CFG-doubled model (conditional rows first),
    under a PAB plan and its cache if given, the guidance combine and the
    Euler update z + v dt."""
    B = z.shape[0]
    dev = z.device
    out = model.forward(torch.cat([z, z]), torch.full((2 * B,), t, device=dev),
                        y_all, mask_all, torch.full((2 * B,), fps, device=dev),
                        height, width, plan, cache)
    pred = out[:, :in_channels]
    v = pred[B:] + guidance * (pred[:B] - pred[B:])
    return z + v * torch.tensor(dt, dtype=torch.float32, device=dev)


# ---- the video VAE's decode -----------------------------------------------

SHIFT = (-0.10, 0.34, 0.27, 0.98)
SCALE = (3.85, 2.32, 2.33, 3.06)
SPATIAL_SCALING = 0.18215


class VAEDecoder:
    """decode_u8(z [B, 4, T_lat, h, w], num_frames) -> uint8 [B, F, H, W, 3].
    The temporal decoder runs on each chunk of `micro_z` latent frames
    (17 pixel frames), then the 2D decoder on every frame."""

    def __init__(self, ops: Ops, cfg: dict):
        self.o = ops
        self.vae = cfg
        self.frame_batch = 4

    # temporal stage (causal 3D convolutions, group norms eps 1e-5)
    def cconv(self, x, prefix, kernel=(3, 3, 3), bias=False, stride=1):
        kt, kh, kw = kernel
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - stride, 0))
        return self.o.conv(F.conv3d, x, prefix + ".conv", bias=bias,
                           stride=(stride, 1, 1))

    def gn(self, x, prefix, eps):
        return group_norm(x, 32, self.o.p(prefix + ".weight"),
                          self.o.p(prefix + ".bias"), eps)

    def res3d(self, x, prefix, cin, cout):
        h = self.cconv(F.silu(self.gn(x, prefix + ".norm1", 1e-5)),
                       prefix + ".conv1")
        h = self.cconv(F.silu(self.gn(h, prefix + ".norm2", 1e-5)),
                       prefix + ".conv2")
        if cin != cout:
            x = self.cconv(x, prefix + ".conv3", (1, 1, 1))
        return self.o.add(x, h)

    def temporal_decode(self, z, num_frames: int):
        t = self.vae["temporal"]
        filters, mult = t["filters"], t["channel_multipliers"]
        nres, down = t["num_res_blocks"], t["temporal_downsample"]
        p = "temporal_vae"
        h = self.cconv(z, p + ".post_quant_conv", (1, 1, 1), bias=True)
        top = filters * mult[-1]
        h = self.cconv(h, p + ".decoder.conv1", bias=True)
        for j in range(nres):
            h = self.res3d(h, f"{p}.decoder.res_blocks.{j}", top, top)
        prev = top
        for i in reversed(range(len(mult))):
            f = filters * mult[i]
            for j in range(nres):
                h = self.res3d(h, f"{p}.decoder.block_res_blocks.{i}.{j}",
                               prev if j == 0 else f, f)
            prev = f
            if i > 0 and down[i - 1]:
                h = self.cconv(h, f"{p}.decoder.conv_blocks.{i - 1}",
                               bias=True)
                B, C2, T, H, W = h.shape
                h = h.reshape(B, C2 // 2, 2, T, H, W).transpose(2, 3)
                h = h.reshape(B, C2 // 2, T * 2, H, W)
        h = self.cconv(F.silu(self.gn(h, p + ".decoder.norm1", 1e-5)),
                       p + ".decoder.conv_out", bias=True)
        factor = 2 ** sum(down)
        pad = (-num_frames) % factor
        return h[:, :, pad:pad + num_frames]

    # 2D stage (the SD decoder, group norms eps 1e-6)
    def conv2d(self, x, prefix, padding=1):
        return self.o.conv(F.conv2d, x, prefix, padding=padding)

    def res2d(self, x, prefix, cin, cout):
        h = self.conv2d(F.silu(self.gn(x, prefix + ".norm1", 1e-6)),
                        prefix + ".conv1")
        h = self.conv2d(F.silu(self.gn(h, prefix + ".norm2", 1e-6)),
                        prefix + ".conv2")
        if cin != cout:
            x = self.conv2d(x, prefix + ".conv_shortcut", padding=0)
        return self.o.add(x, h)

    def attn2d(self, x, prefix):
        o = self.o
        B, C, H, W = x.shape
        h = self.gn(x, prefix + ".group_norm", 1e-6).reshape(B, C, H * W)
        h = h.transpose(1, 2)
        q, k, v = (o.linear(h, f"{prefix}.{n}")[:, None]
                   for n in ("to_q", "to_k", "to_v"))
        a = o.attention(q, k, v, C ** -0.5)[:, 0]
        a = o.linear(a, prefix + ".to_out.0")
        return o.add(x, a.transpose(1, 2).reshape(B, C, H, W))

    def spatial_decode(self, z):
        s = self.vae["spatial"]
        ch, layers = s["block_out_channels"], s["layers_per_block"]
        p = "spatial_vae.module"
        h = self.conv2d(z, p + ".post_quant_conv", padding=0)
        h = self.conv2d(h, p + ".decoder.conv_in")
        m = p + ".decoder.mid_block"
        h = self.res2d(h, m + ".resnets.0", ch[-1], ch[-1])
        h = self.attn2d(h, m + ".attentions.0")
        h = self.res2d(h, m + ".resnets.1", ch[-1], ch[-1])
        rev = list(reversed(ch))
        for i, c in enumerate(rev):
            cin = rev[max(i - 1, 0)]
            for j in range(layers + 1):
                h = self.res2d(h, f"{p}.decoder.up_blocks.{i}.resnets.{j}",
                               cin if j == 0 else c, c)
            if i < len(ch) - 1:
                h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                h = self.conv2d(h, f"{p}.decoder.up_blocks.{i}.upsamplers.0.conv")
        h = F.silu(self.gn(h, p + ".decoder.conv_norm_out", 1e-6))
        return self.conv2d(h, p + ".decoder.conv_out")

    @torch.no_grad()
    def decode_u8(self, z, num_frames: int) -> torch.Tensor:
        dev = z.device
        shift = torch.tensor(SHIFT, device=dev)[:, None, None, None]
        scale = torch.tensor(SCALE, device=dev)[:, None, None, None]
        z = z.float() * scale + shift
        micro_z = -(-self.vae["micro_frame_size"] // 4)
        outs, remaining = [], num_frames
        for i in range(0, z.shape[2], micro_z):
            nf = min(self.vae["micro_frame_size"], remaining)
            remaining -= self.vae["micro_frame_size"]
            xz = self.temporal_decode(z[:, :, i:i + micro_z], nf)
            B, C, T, h, w = xz.shape
            frames = xz.transpose(1, 2).reshape(B * T, C, h, w)
            px = torch.cat([self.spatial_decode(frames[j:j + self.frame_batch]
                                                / SPATIAL_SCALING)
                            for j in range(0, B * T, self.frame_batch)])
            px = px.reshape(B, T, *px.shape[1:]).permute(0, 1, 3, 4, 2)
            u8 = torch.clamp((torch.clamp(px, -1, 1) + 1) / 2 * 255 + 0.5,
                             0, 255)
            outs.append(u8.to(torch.uint8))
        return torch.cat(outs, dim=1)


# ---- model FLOPs -----------------------------------------------------------


def step_flops(cfg: dict, batch: int, T: int, S: int, live_text: List[int],
               plan=None) -> float:
    """Model FLOPs of one CFG-doubled STDiT3 step over `batch` rows
    (2 per prompt) of T x S tokens; `live_text[b]`: row b's live caption
    tokens. A PAB plan (from `reference.pab`) drops the branches it reads
    from the cache. Products only, 2 flops a multiply-add; recompute is
    not counted."""
    C, depth = cfg["hidden_size"], cfg["depth"]
    M = batch * T * S
    L = sum(live_text)
    caption = 2.0 * L * (cfg["caption_channels"] * C + C * C)
    embed = 2.0 * M * C * cfg["in_channels"] * math.prod(cfg["patch_size"])
    final = 2.0 * M * C * cfg["in_channels"] * 2 * math.prod(cfg["patch_size"])
    t_mlp = 2.0 * batch * (2 * (256 * C + C * C) + 6 * C * C)
    attn = {"spatial": 6.0 * M * C * C + 2.0 * M * C * C
            + 4.0 * batch * T * S * S * C,
            "temporal": 6.0 * M * C * C + 2.0 * M * C * C
            + 4.0 * batch * S * T * T * C}
    cross = 2.0 * M * C * C * 2 + 2.0 * L * C * 2 * C + 4.0 * T * S * L * C
    mlp = 16.0 * M * C * C
    total = caption + embed + final + t_mlp
    for i in range(depth):
        for branch in ("spatial", "temporal"):
            read = plan.reads(branch, i) if plan is not None else ()
            total += 0.0 if "attn" in read else attn[branch]
            total += 0.0 if "cross" in read else cross
            total += 0.0 if "mlp" in read else mlp
    return total

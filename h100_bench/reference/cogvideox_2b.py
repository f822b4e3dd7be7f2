"""Plain float32 reference of CogVideoX-2b serving: one CFG-doubled step of
the joint-attention transformer with its DDIM (v-prediction) update, and
the causal 3D VAE's tiled, streamed decode.

A frozen, independent copy of the model's equations (THUDM CogVideoX-2b,
diffusers' `CogVideoXTransformer3DModel`, `CogVideoXDDIMScheduler` and
`AutoencoderKLCogVideoX`), on weights held by name (the program's
state_dict names). Every product goes through `common.Ops`. Imports torch
and numpy only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import Ops, group_norm, layer_norm, timestep_embedding
from reference.opensora_v1_2 import pos_embed_2d as _pos2d

# ---- DDIM, CogVideoX's settings --------------------------------------------


class DDIM:
    """v-prediction, scaled-linear betas 0.00085 .. 0.012, the SNR shift 3,
    zero terminal SNR, trailing spacing, final alpha 1."""

    def __init__(self, steps: int, T: int = 1000):
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, T,
                            dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        ac = ac / (3.0 + (1 - 3.0) * ac)
        s = np.sqrt(ac)
        s0, sT = s[0].copy(), s[-1].copy()
        s = (s - sT) * (s0 / (s0 - sT))
        self.ac = s ** 2
        self.T, self.steps = T, steps
        self.timesteps = (np.round(np.arange(T, 0, -T / steps)).astype(
            np.int64) - 1)

    def step(self, v, t: int, z):
        prev = t - self.T // self.steps
        a = float(self.ac[t])
        ap = float(self.ac[prev]) if prev >= 0 else 1.0
        x0 = a ** 0.5 * z - (1 - a) ** 0.5 * v
        eps = a ** 0.5 * v + (1 - a) ** 0.5 * z
        return ap ** 0.5 * x0 + (1 - ap) ** 0.5 * eps


# ---- the transformer ---------------------------------------------------------


def pos_embed_3d(C: int, t: int, h: int, w: int, s_scale: float,
                 t_scale: float) -> np.ndarray:
    d_s, d_t = C * 3 // 4, C // 4
    spatial = _pos2d(d_s, h, w, scale=s_scale, base_size=None)
    half = d_t // 2
    omega = 1.0 / 10000 ** (np.arange(half, dtype=np.float32) / half)
    ang = np.outer(np.arange(t, dtype=np.float32) / t_scale, omega)
    temporal = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return np.concatenate([
        np.broadcast_to(temporal[:, None], (t, h * w, d_t)),
        np.broadcast_to(spatial[None], (t, h * w, d_s))], -1).reshape(-1, C)


class Transformer:
    """forward(x [B, F, 16, H, W], enc [B, L, 4096], t [B]) ->
    [B, F, 16, H, W]."""

    def __init__(self, ops: Ops, cfg: dict):
        self.o = ops
        self.cfg = cfg
        self.H = cfg["num_attention_heads"]
        self.D = cfg["attention_head_dim"]
        self.C = self.H * self.D

    def ln(self, x, prefix, eps):
        return layer_norm(x, eps, self.o.p(prefix + ".weight"),
                          self.o.p(prefix + ".bias"))

    def block(self, x, enc, temb, i: int):
        o, H, D, C = self.o, self.H, self.D, self.C
        p = f"transformer_blocks.{i}"
        eps = self.cfg["norm_eps"]
        L = enc.shape[1]
        m = o.linear(F.silu(temb), p + ".norm1.linear").chunk(6, dim=-1)
        m = [t[:, None] for t in m]
        nx = self.ln(x, p + ".norm1.norm", eps) * (1 + m[1]) + m[0]
        ne = self.ln(enc, p + ".norm1.norm", eps) * (1 + m[4]) + m[3]
        h = torch.cat([ne, nx], 1)
        B, N, _ = h.shape
        q = self.ln(o.linear(h, p + ".attn1.to_q").view(B, N, H, D),
                    p + ".attn1.norm_q", 1e-6)
        k = self.ln(o.linear(h, p + ".attn1.to_k").view(B, N, H, D),
                    p + ".attn1.norm_k", 1e-6)
        v = o.linear(h, p + ".attn1.to_v").view(B, N, H, D)
        a = o.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), D ** -0.5).transpose(1, 2)
        a = o.linear(a.reshape(B, N, C), p + ".attn1.to_out.0")
        x = o.add(x, m[2] * a[:, L:])
        enc = o.add(enc, m[5] * a[:, :L])
        m = o.linear(F.silu(temb), p + ".norm2.linear").chunk(6, dim=-1)
        m = [t[:, None] for t in m]
        nx = self.ln(x, p + ".norm2.norm", eps) * (1 + m[1]) + m[0]
        ne = self.ln(enc, p + ".norm2.norm", eps) * (1 + m[4]) + m[3]
        f = o.linear(F.gelu(o.linear(torch.cat([ne, nx], 1),
                                     p + ".ff.net.0.proj"),
                            approximate="tanh"), p + ".ff.net.2")
        return o.add(x, m[2] * f[:, L:]), o.add(enc, m[5] * f[:, :L])

    @torch.no_grad()
    def forward(self, x, enc, t):
        o, cfg, C = self.o, self.cfg, self.C
        B, Fr, Cin, Hh, Ww = x.shape
        p = cfg["patch_size"]
        h, w = Hh // p, Ww // p
        temb = o.linear(F.silu(o.linear(timestep_embedding(t, C),
                                        "time_embedding.linear_1")),
                        "time_embedding.linear_2")
        xe = o.conv(F.conv2d, x.reshape(B * Fr, Cin, Hh, Ww),
                    "patch_embed.proj", stride=p)
        xe = xe.flatten(2).transpose(1, 2).reshape(B, Fr * h * w, C)
        xe = xe + torch.from_numpy(pos_embed_3d(
            C, Fr, h, w, cfg["spatial_interpolation_scale"],
            cfg["temporal_interpolation_scale"])).to(x.device)
        enc = o.linear(enc, "patch_embed.text_proj")
        for i in range(cfg["num_layers"]):
            xe, enc = self.block(xe, enc, temb, i)
        xe = self.ln(xe, "norm_final", cfg["norm_eps"])
        shift, scale = o.linear(F.silu(temb), "norm_out.linear").chunk(2, -1)
        xe = self.ln(xe, "norm_out.norm", cfg["norm_eps"]) * (
            1 + scale[:, None]) + shift[:, None]
        xe = o.linear(xe, "proj_out")
        co = cfg["out_channels"]
        out = xe.reshape(B, Fr, h, w, co, p, p)
        return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Fr, co, Hh, Ww)


def cfg_step(model: Transformer, sched: DDIM, z, t: int, enc_all,
             guidance: float):
    """The CFG-doubled model (unconditional rows first), the guidance
    combine and the DDIM update."""
    B = z.shape[0]
    pred = model.forward(torch.cat([z, z]), enc_all,
                         torch.full((2 * B,), float(t), device=z.device))
    v = pred[:B] + guidance * (pred[B:] - pred[:B])
    return sched.step(v, int(t), z)


# ---- the causal 3D VAE's decode -----------------------------------------------


class VAEDecoder:
    """decode_u8(latents [B, F, 16, h, w] as the pipeline holds them) ->
    uint8 [B, T, H, W, 3]: spatial tiles, each decoded two latent frames at
    a time (the first chunk takes the remainder) with the causal convs'
    last input frames carried between chunks, then blended linearly."""

    def __init__(self, ops: Ops, vae: dict):
        self.o = ops
        self.v = vae
        self.groups = vae["norm_num_groups"]

    def cconv(self, x, prefix, cache, k=3):
        if k > 1:
            prev = cache.get(prefix)
            front = prev if prev is not None and prev.shape[2] == k - 1 \
                else x[:, :, :1].expand(-1, -1, k - 1, -1, -1)
            cache[prefix] = x[:, :, -(k - 1):]
            x = torch.cat([front, x], 2)
        return self.o.conv(F.conv3d, x, prefix + ".conv",
                           padding=(0, k // 2, k // 2))

    def snorm(self, f, zq, prefix, cache):
        Tf, Hf, Wf = f.shape[2:]
        if Tf > 1 and Tf % 2 == 1:
            zq = torch.cat([
                F.interpolate(zq[:, :, :1], size=(1, Hf, Wf),
                              mode="nearest-exact"),
                F.interpolate(zq[:, :, 1:], size=(Tf - 1, Hf, Wf),
                              mode="nearest-exact")], 2)
        else:
            zq = F.interpolate(zq, size=(Tf, Hf, Wf), mode="nearest-exact")
        n = group_norm(f, self.groups, self.o.p(prefix + ".norm_layer.weight"),
                       self.o.p(prefix + ".norm_layer.bias"), 1e-6)
        return n * self.cconv(zq, prefix + ".conv_y", cache, 1) \
            + self.cconv(zq, prefix + ".conv_b", cache, 1)

    def res(self, x, zq, prefix, cache, cin, cout):
        h = self.cconv(F.silu(self.snorm(x, zq, prefix + ".norm1", cache)),
                       prefix + ".conv1", cache)
        h = self.cconv(F.silu(self.snorm(h, zq, prefix + ".norm2", cache)),
                       prefix + ".conv2", cache)
        if cin != cout:
            x = self.o.conv(F.conv3d, x, prefix + ".conv_shortcut")
        return self.o.add(x, h)

    def upsample(self, x, prefix, compress_time: bool):
        T, H, W = x.shape[2:]
        if compress_time and T > 1 and T % 2 == 1:
            x = torch.cat([
                F.interpolate(x[:, :, :1], size=(1, 2 * H, 2 * W),
                              mode="nearest-exact"),
                F.interpolate(x[:, :, 1:], size=(2 * (T - 1), 2 * H, 2 * W),
                              mode="nearest-exact")], 2)
        elif compress_time and T > 1:
            x = F.interpolate(x, size=(2 * T, 2 * H, 2 * W),
                              mode="nearest-exact")
        else:
            x = F.interpolate(x, size=(T, 2 * H, 2 * W), mode="nearest-exact")
        B, C, T2 = x.shape[:3]
        y = self.o.conv(F.conv2d, x.transpose(1, 2).reshape(B * T2, C, *x.shape[3:]),
                        prefix + ".conv", padding=1)
        return y.reshape(B, T2, *y.shape[1:]).transpose(1, 2)

    def decoder(self, z, cache):
        v = self.v
        rev = list(reversed(v["block_out_channels"]))
        tcl = {4: 2, 2: 1, 1: 0}[v["temporal_compression_ratio"]]
        h = self.cconv(z, "decoder.conv_in", cache)
        for j in range(2):
            h = self.res(h, z, f"decoder.mid_block.resnets.{j}", cache,
                         rev[0], rev[0])
        prev = rev[0]
        for i, c in enumerate(rev):
            for j in range(v["layers_per_block"] + 1):
                h = self.res(h, z, f"decoder.up_blocks.{i}.resnets.{j}",
                             cache, prev if j == 0 else c, c)
            prev = c
            if i < len(rev) - 1:
                h = self.upsample(h, f"decoder.up_blocks.{i}.upsamplers.0",
                                  i < tcl)
        h = F.silu(self.snorm(h, z, "decoder.norm_out", cache))
        return self.cconv(h, "decoder.conv_out", cache)

    def streamed(self, z):
        fbs = self.v["num_latent_frames_batch_size"]
        T = z.shape[2]
        if T <= fbs:
            return self.decoder(z, {})
        first = fbs + T % fbs
        bounds = [(0, first)] + [(s, s + fbs) for s in range(first, T, fbs)]
        cache: dict = {}
        return torch.cat([self.decoder(z[:, :, a:b], cache)
                          for a, b in bounds], 2)

    def tiled(self, z):
        v = self.v
        sf = 2 ** (len(v["block_out_channels"]) - 1)
        th, tw = v["tile_latent_min_height"], v["tile_latent_min_width"]
        step_h = int(th * (1 - v["tile_overlap_factor_height"]))
        step_w = int(tw * (1 - v["tile_overlap_factor_width"]))
        bh = int(th * sf * v["tile_overlap_factor_height"])
        bw = int(tw * sf * v["tile_overlap_factor_width"])
        lim_h, lim_w = th * sf - bh, tw * sf - bw
        H, W = z.shape[3], z.shape[4]
        rows = [[self.streamed(z[:, :, :, i:i + th, j:j + tw])
                 for j in range(0, W, step_w)] for i in range(0, H, step_h)]

        def blend(a, b, extent, dim):
            n = min(a.shape[dim], extent)
            shape = [1] * a.ndim
            shape[dim] = n
            wgt = (torch.arange(n, device=a.device) / n).reshape(shape)
            b = b.clone()
            b.narrow(dim, 0, n).copy_(a.narrow(dim, a.shape[dim] - n, n)
                                      * (1 - wgt) + b.narrow(dim, 0, n) * wgt)
            return b

        out = []
        for i, row in enumerate(rows):
            line = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = blend(rows[i - 1][j], tile, bh, 3)
                if j > 0:
                    tile = blend(row[j - 1], tile, bw, 4)
                line.append(tile[:, :, :, :lim_h, :lim_w])
            out.append(torch.cat(line, 4))
        return torch.cat(out, 3)

    def tiles(self, shape) -> List[Tuple[int, int, int, int, int, int]]:
        """The spatial tiles of latents of `shape` [B, C, F, h, w], each as
        (latent row, latent column, first output row, last, first output
        column, last): the output pixels that tile alone gives (the tiled
        decode blends a tile's first rows and columns with its neighbours'
        and crops its last)."""
        v = self.v
        H, W = shape[3], shape[4]
        th, tw = v["tile_latent_min_height"], v["tile_latent_min_width"]
        sf = 2 ** (len(v["block_out_channels"]) - 1)
        if H <= th and W <= tw:
            return [(0, 0, 0, H * sf, 0, W * sf)]
        step_h = int(th * (1 - v["tile_overlap_factor_height"]))
        step_w = int(tw * (1 - v["tile_overlap_factor_width"]))
        bh = int(th * sf * v["tile_overlap_factor_height"])
        bw = int(tw * sf * v["tile_overlap_factor_width"])
        lim_h, lim_w = th * sf - bh, tw * sf - bw
        out = []
        for ri, i in enumerate(range(0, H, step_h)):
            h = min(lim_h, (min(H, i + th) - i) * sf)
            for ci, j in enumerate(range(0, W, step_w)):
                w = min(lim_w, (min(W, j + tw) - j) * sf)
                r0, c0 = ri * lim_h, ci * lim_w
                out.append((i, j, r0 + (bh if ri else 0), r0 + h,
                            c0 + (bw if ci else 0), c0 + w))
        return out

    @torch.no_grad()
    def decode_tile_u8(self, latents, tile) -> torch.Tensor:
        """uint8 [B, T, rows, columns, 3] of the pixels `tile` alone gives,
        from latents [B, F, 16, h, w] as the pipeline holds them."""
        v = self.v
        z = latents.float().transpose(1, 2) / v["scaling_factor"]
        i, j, r0, r1, c0, c1 = tile
        th, tw = v["tile_latent_min_height"], v["tile_latent_min_width"]
        sf = 2 ** (len(v["block_out_channels"]) - 1)
        x = self.streamed(z[:, :, :, i:i + th, j:j + tw])
        rs, cs = r0 - self._origin(i, th, sf, "height"), \
            c0 - self._origin(j, tw, sf, "width")
        x = x[:, :, :, rs:rs + r1 - r0, cs:cs + c1 - c0]
        x = torch.round(torch.clamp(x / 2 + 0.5, 0, 1) * 255)
        return x.permute(0, 2, 3, 4, 1).to(torch.uint8)

    def _origin(self, start: int, size: int, sf: int, axis: str) -> int:
        """The output pixel where the tile starting at latent `start`
        begins: its index along the axis times the cropped tile size."""
        v = self.v
        over = v[f"tile_overlap_factor_{axis}"]
        step = int(size * (1 - over))
        lim = size * sf - int(size * sf * over)
        return (start // step) * lim


# ---- model FLOPs --------------------------------------------------------------


def step_flops(cfg: dict, batch: int, frames: int, h: int, w: int, L: int,
               reads: Optional[List[int]] = None) -> float:
    """Model FLOPs of one CFG-doubled step over `batch` rows of `frames`
    latent frames of h x w (patches of p x p) and L text tokens; `reads`:
    the blocks whose joint attention a PAB plan reads from the cache."""
    C = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    p = cfg["patch_size"]
    N = frames * (h // p) * (w // p)
    M = batch * (N + L)
    te = cfg["time_embed_dim"]
    embed = 2.0 * batch * N * cfg["in_channels"] * p * p * C \
        + 2.0 * batch * L * cfg["text_embed_dim"] * C
    temb = 2.0 * batch * (C * te + te * te + cfg["num_layers"] * 12 * te * C
                          + 2 * te * C)
    attn = 8.0 * M * C * C + 4.0 * batch * (N + L) ** 2 * C
    ff = 16.0 * M * C * C
    out = 2.0 * batch * N * C * p * p * cfg["out_channels"]
    skipped = len(reads or ())
    return embed + temb + out + cfg["num_layers"] * ff \
        + (cfg["num_layers"] - skipped) * attn


def latent_shape(cfg: dict, vae: dict, req: dict) -> Tuple[int, ...]:
    sf = 2 ** (len(vae["block_out_channels"]) - 1)
    F_lat = (req["num_frames"] - 1) // cfg["temporal_compression_ratio"] + 1
    return (1, F_lat, cfg["in_channels"], req["height"] // sf,
            req["width"] // sf)


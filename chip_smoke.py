#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`videosys_tpu_torch`) on one NVIDIA
card (an H100 is the target).

    python3 chip_smoke.py [--steps N]

Phases, each fatal on failure:
  1. build the flash-attention kernels from csrc/ (forward, fp32 backward,
     fused backward, dk/dv backward, dq backward: one nvcc each, started
     together) and print the card;
  2. hold the forward kernels against their plain PyTorch version at the main
     path's shapes (STDiT3 spatial and cross attention on the narrow wgmma
     kernel, temporal attention on the short-row kernel, the VAE mid
     attention on the wide wgmma kernel) in bf16 and fp32, and time them
     beside the plain version and torch's own scaled_dot_product_attention
     (a yardstick the port never calls); then the edges of the short-row and
     narrow kernels (rows and keys around 16, 64 and 128, head widths 32 to
     128, a fully masked row, the log-sum-exp output) and of the wide kernel
     (a key mask and the log-sum-exp output at D = 512 with 6360 q rows,
     D = 256, a head that is no multiple of 8);
  3. serve Open-Sora v1.2 text-to-video at full width (STDiT3-XL/2, depth
     28, hidden 1152; the full VAE) with random weights from a seed: one
     480p 9:16 2 s video and one 144p 1:1 image, checking that every
     attention call went through the kernel; then hold one full-width bf16
     STDiT3 forward at the 480p shapes against the same forward with the
     plain attention in place of the kernel;
  4. run a tiny configuration on the card and on the CPU (plain attention)
     with the same weights and noise, and compare the latents and video;
  5. hold the three backward kernels (flash_bwd_fused, flash_bwd_dq with
     the di = rowsum(dO * O) it writes, and flash_bwd_dkv fed that di) and
     the forward's log-sum-exp against their plain
     versions at the training path's shapes (spatial 144p x 51 frames batch
     4 and 240p x 51 frames batch 2, temporal, cross attention to 8 and to
     300 text tokens with a ragged mask, and the 8160-token row of a 1080p
     image), each on the backward `backward_variant` picks, in fp32 and
     bf16, and time them beside the plain version, the backward of torch's
     scaled_dot_product_attention and the route passed up ("bwd dispatch");
     then the fused backward's edges (1, 15,
     63, 64, 65 and 405 keys, four packed short rows with one fully masked,
     a full cluster of 512 keys), the dk/dv kernel's (key counts around
     its 128-key blocks, a fully masked row) and the dq kernel's (q rows
     around its 64- and 128-row blocks, a fully masked row), each giving
     bit-equal gradients twice;
  6. train Open-Sora v1.2 at full width and depth (`run_training`: bf16
     compute over fp32 parameters, recompute of every depth pair) for a few
     steps on the default buckets and one step on a 1080p image bucket,
     checking that losses and gradient norms are finite, that the step
     count and the EMA moved, and that every attention forward and
     backward went through the kernels, by launch counts predicted from
     the shapes;
  7. train a tiny configuration for 3 steps in fp32 on the card (kernels)
     and on the CPU (plain versions) from the same weights and draws, and
     compare the losses.

bf16 outputs are held by two relative measures, rel_l2 = |got - want|_2 /
|want|_2 and rel_max = max|got - want| / max|want|, at limits set per shape
from this script's readings of a correct kernel; beside each it prints the
same measures for a plain version that drops one key per row, the smallest
fault the limits must still catch. fp32 outputs are held at 2e-5 absolute,
fp32 gradients at 1e-4 absolute, di at 1e-5 relative to its largest entry.

The line before the last holds the kernel report as JSON, the one before it
the card's name and power limit; the last line is the JSON status.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 SIMT,
# HBM3 bandwidth
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
PHASES = ("kernel", "serve", "tiny", "bwd_kernel", "train", "tiny_train")
TRAIN_STEPS = 4  # on the default buckets: two video shapes and an image
F32_TOL = 2e-5
F32_GRAD_TOL = 1e-4
DI_TOL = 1e-5  # di against rowsum(dO * O), relative to its largest entry
# bf16 limits per shape (rel_l2, rel_max), set from this script's readings
# on an H100 (PERF.md): the kernel read at most half of each, and a plain
# version that drops one key per row read at least twice one of them
BF16_LIMITS = {"spatial": (8e-3, 2e-2), "cross": (1e-2, 2e-2),
               "temporal": (1e-2, 2e-2), "vae_mid": (6.5e-3, 1.5e-2),
               "stdit3_forward": (1.8e-2, 2.5e-2)}
# the same for the gradients of the backward kernels (the largest of dq, dk,
# dv): the kernels read at most a third of each limit (3.0e-4, 3.2e-3), the
# one-key fault at least 10x one of them (1.1e-2, 1.0e-1 at the long row)
BWD_BF16_LIMITS = {name: (1e-3, 1e-2) for name in (
    "spatial144", "spatial", "temporal", "cross8", "cross300", "long_row")}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rel_errors(got, want) -> tuple:
    """(rel_l2, rel_max) of `got` against `want`."""
    d = got.float() - want.float()
    want = want.float()
    return ((d.norm() / want.norm()).item(),
            (d.abs().max() / want.abs().max()).item())


def drop_last_key(mask, B: int, Nk: int, device):
    """The key mask with the last attended key of every row removed (rows
    left with none stay empty)."""
    import torch

    keep = torch.ones(B, Nk, dtype=torch.bool, device=device) \
        if mask is None else mask.clone()
    last = keep.cumsum(1).argmax(1)
    keep[torch.arange(B, device=device), last] = False
    return keep


def check_bf16(name: str, got, want, fault, limits=None) -> dict:
    """Hold a bf16 output (or a tuple of them: the worst counts) against
    its reference at `limits` (default BF16_LIMITS[name])."""
    import torch

    def worst(outs):
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        wants = want if isinstance(want, (tuple, list)) else (want,)
        errs = [rel_errors(o, w) for o, w in zip(outs, wants)]
        return max(e[0] for e in errs), max(e[1] for e in errs)

    l2, mx = worst(got)
    f_l2, f_mx = worst(fault)
    lim_l2, lim_mx = limits or BF16_LIMITS[name]
    finite = all(bool(torch.isfinite(o).all()) for o in
                 (got if isinstance(got, (tuple, list)) else (got,)))
    ok = l2 <= lim_l2 and mx <= lim_mx and finite
    log(f"check {name:14s} bf16 rel_l2={l2:.3e} (limit {lim_l2:.1e}, one key "
        f"dropped {f_l2:.3e}) rel_max={mx:.3e} (limit {lim_mx:.1e}, one key "
        f"dropped {f_mx:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain in bf16")
    if f_l2 <= lim_l2 and f_mx <= lim_mx:
        raise AssertionError(f"{name}: the bf16 limits let a one-key fault pass")
    return {"rel_l2": l2, "rel_max": mx, "fault_rel_l2": f_l2,
            "fault_rel_max": f_mx}


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(fa, text_len: int) -> dict:
    """Kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(0)
    # (name, B, H, Nq, Nk, D, masked); B*T = 30 (CFG x 15 latent frames),
    # B*S = 3180 temporal rows, 8 frames per VAE micro-batch
    shapes = [("spatial", 30, 16, 1590, 1590, 72, False),
              ("cross", 30, 16, 1590, text_len, 72, True),
              ("temporal", 3180, 16, 15, 15, 72, False),
              ("vae_mid", 8, 1, 6360, 6360, 512, False)]
    results = {}
    for name, B, H, Nq, Nk, D, masked in shapes:
        q = torch.randn(B, H, Nq, D, device="cuda", generator=gen)
        k = torch.randn(B, H, Nk, D, device="cuda", generator=gen)
        v = torch.randn(B, H, Nk, D, device="cuda", generator=gen)
        mask = None
        if masked:  # ragged real lengths, the longest filling the bucket
            lens = torch.randint(1, Nk + 1, (B,), device="cuda", generator=gen)
            lens[0] = Nk
            mask = torch.arange(Nk, device="cuda")[None] < lens[:, None]
        row = {"shape": [B, H, Nq, Nk, D], "masked": masked}
        for dt, tdt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            qt, kt, vt = q.to(tdt), k.to(tdt), v.to(tdt)
            got = fa.flash_attention(qt, kt, vt, kv_mask=mask)
            want = fa.flash_attention_plain(qt, kt, vt, kv_mask=mask)
            err = (got.float() - want.float()).abs().max().item()
            row[f"max_abs_err_{dt}"] = err
            log(f"kernel {name:8s} {dt} shape={row['shape']} masked={masked} "
                f"variant={fa.kernel_variant(tdt, Nq, Nk, D)} "
                f"max_abs_err={err:.3e}")
            if dt == "bf16":
                fault = fa.flash_attention_plain(
                    qt, kt, vt, kv_mask=drop_last_key(mask, B, Nk, "cuda"))
                row["bf16_check"] = check_bf16(name, got, want, fault)
                del fault
            elif not (err <= F32_TOL and bool(torch.isfinite(got).all())):
                raise AssertionError(f"kernel {name} fp32 disagrees with plain "
                                     f"({err:.3e} > {F32_TOL:.0e})")
            del got, want
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        iters = 3 if name == "vae_mid" else 10
        row["ms"] = time_ms(lambda: fa.flash_attention(qb, kb, vb, kv_mask=mask), iters)
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_plain(qb, kb, vb, kv_mask=mask), 3)
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        row["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                   attn_mask=sdpa_mask), iters)
        flops = 4.0 * B * H * Nq * Nk * D
        nbytes = 2.0 * B * H * (2 * Nq + 2 * Nk) * D + (B * Nk if masked else 0)
        t_ops, t_bytes = flops / PEAK_FLOPS["bf16"], nbytes / PEAK_BYTES
        row["bound_ms"] = max(t_ops, t_bytes) * 1e3
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row["tflops"] = flops / row["ms"] / 1e9
        log(f"kernel {name:8s} bf16 ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}) achieved={row['tflops']:.1f} TFLOP/s")
        results[name] = row
        del q, k, v, qb, kb, vb
        torch.cuda.empty_cache()
    results["narrow_edges"] = narrow_forward_edges(fa)
    results["wgmma_edges"] = wide_forward_edges(fa)
    return results


def narrow_forward_edges(fa) -> dict:
    """The short-row and narrow forwards at the edges their designs bring,
    bf16 against plain at the spatial limits: output and log-sum-exp, under a
    ragged key mask whose last batch row is fully masked."""
    import torch

    gen = torch.Generator("cuda").manual_seed(4)
    lim_l2, lim_mx = BF16_LIMITS["spatial"]
    out = {}
    # (B, H, Nq, Nk, D): short rows at 1, 15 and 16; 17 rows or keys; one
    # key; a last block of 54 rows (1590 = 12 * 128 + 54) and one whose
    # second warpgroup has no row (1590 keys, 63 rows); 64/65/127/128/129
    # keys and rows; the head widths the kernels pad to
    for B, H, Nq, Nk, D in ((3, 2, 1, 1, 72), (3, 2, 15, 15, 72),
                            (3, 2, 16, 16, 32), (3, 2, 17, 16, 72),
                            (3, 2, 16, 17, 128), (3, 2, 1590, 1, 72),
                            (3, 2, 1590, 300, 72), (3, 2, 63, 1590, 64),
                            (3, 2, 129, 65, 80), (3, 2, 128, 127, 72),
                            (3, 2, 127, 129, 128), (3, 2, 65, 64, 32)):
        q, k, v = (torch.randn(B, H, n, D, device="cuda", generator=gen)
                   .bfloat16() for n in (Nq, Nk, Nk))
        mask = ragged_mask(B, Nk, gen)
        mask[-1] = False
        variant = fa.kernel_variant(q.dtype, Nq, Nk, D)
        want_variant = "short" if Nq <= 16 and Nk <= 16 else "narrow"
        if variant != want_variant:
            raise AssertionError(f"{[Nq, Nk, D]}: expected the {want_variant} "
                                 f"forward, the dispatch says {variant}")
        got, lse = fa._launch(q, k, v, None, mask, save_lse=True)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_plain(q, k, v, None, mask,
                                                  return_lse=True)
        l2, mx = rel_errors(got, want)
        lse_err = (lse - want_lse).abs().max().item()
        ok = l2 <= lim_l2 and mx <= lim_mx and lse_err <= F32_GRAD_TOL \
            and bool(torch.isfinite(got).all())
        log(f"kernel edge {variant:6s} shape={[B, H, Nq, Nk, D]} masked, last "
            f"row dead rel_l2={l2:.3e} rel_max={mx:.3e} lse_err={lse_err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{variant} forward disagrees with plain at "
                                 f"{[B, H, Nq, Nk, D]}")
        out[f"{B}x{H}x{Nq}x{Nk}x{D}"] = {"variant": variant, "rel_l2": l2,
                                         "rel_max": mx, "lse_err": lse_err}
    return out


def wide_forward_edges(fa) -> dict:
    """The wgmma forward at the edges its design brings, bf16 against plain
    at the VAE mid limits: output and log-sum-exp."""
    import torch

    gen = torch.Generator("cuda").manual_seed(2)
    lim_l2, lim_mx = BF16_LIMITS["vae_mid"]
    out = {}
    # (B, H, Nq, Nk, D): 6360 q rows (not a multiple of 64) under a key mask;
    # the narrower instance; heads padded to 256 and 512; D % 8 != 0
    for B, H, Nq, Nk, D in ((2, 1, 6360, 300, 512), (2, 2, 130, 333, 256),
                            (1, 1, 50, 90, 200), (1, 1, 40, 70, 300),
                            (1, 1, 33, 65, 132)):
        q, k, v = (torch.randn(B, H, n, D, device="cuda", generator=gen)
                   .bfloat16() for n in (Nq, Nk, Nk))
        mask = ragged_mask(B, Nk, gen)
        if fa.kernel_variant(q.dtype, Nq, Nk, D) != "wgmma":
            raise AssertionError(f"D={D}: expected the wgmma forward")
        got, lse = fa._launch(q, k, v, None, mask, save_lse=True)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_plain(q, k, v, None, mask,
                                                  return_lse=True)
        l2, mx = rel_errors(got, want)
        lse_err = (lse - want_lse).abs().max().item()
        ok = l2 <= lim_l2 and mx <= lim_mx and lse_err <= F32_GRAD_TOL \
            and bool(torch.isfinite(got).all())
        log(f"kernel edge wgmma shape={[B, H, Nq, Nk, D]} masked rel_l2={l2:.3e} "
            f"rel_max={mx:.3e} lse_err={lse_err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"wgmma forward disagrees with plain at D={D}")
        out[f"{B}x{H}x{Nq}x{Nk}x{D}"] = {"rel_l2": l2, "rel_max": mx,
                                         "lse_err": lse_err}
    return out


def expected_launches(fa, pipe, num_frames: int, height: int, width: int,
                      steps: int, text_len: int) -> dict:
    """Kernel launches one request makes, by variant, from its shapes: per
    denoise step each depth runs spatial (S x S tokens), temporal (T x T,
    unless T = 1) and two cross attentions (S x the bucketed text length),
    each on the variant its shape takes; the VAE runs its mid attention once
    per frame micro-batch."""
    t_lat, h_lat, w_lat = pipe.vae.get_latent_size((num_frames, height, width))
    mc = pipe.model_config
    _, ph, pw = mc.patch_size
    S = -(-h_lat // ph) * -(-w_lat // pw)
    D = mc.hidden_size // mc.num_heads
    calls = [(S, S), (S, text_len), (S, text_len)]
    if t_lat > 1:
        calls.append((t_lat, t_lat))
    vae_cfg = pipe.vae.config
    n_vae, remaining = 0, num_frames
    for _ in range(0, t_lat, pipe.vae.micro_z_frame_size):
        nf = min(vae_cfg.micro_frame_size, remaining)
        n_vae += -(-nf // vae_cfg.micro_batch_size)
        remaining -= vae_cfg.micro_frame_size
    want = {key: 0 for key in fa.LAUNCHES}
    for Nq, Nk in calls:
        want[fa.kernel_variant(pipe.dtype, Nq, Nk, D)] += steps * mc.depth
    vae_mid_d = pipe.vae.spatial_vae.module.block_out_channels[-1]
    n_mid = h_lat * w_lat  # a frame's positions at the VAE's mid block
    want[fa.kernel_variant(pipe.dtype, n_mid, n_mid, vae_mid_d)] += n_vae
    return want


def serve_phase(fa, steps: int, seed: int, profile: bool = False) -> dict:
    import numpy as np
    import torch

    from videosys_tpu_torch import OpenSoraConfig, VideoSysEngine
    from videosys_tpu_torch.pipelines.open_sora.data_process import (
        get_image_size, get_num_frames)

    cfg = OpenSoraConfig(transformer=None, vae=None, text_encoder=None,
                         dtype="bf16", num_sampling_steps=steps)
    t0 = time.perf_counter()
    engine = VideoSysEngine(cfg, seed=seed)
    pipe = engine.pipeline
    pipe.keep_latents = True
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.transformer.parameters())
    log(f"serve: STDiT3 depth={pipe.model_config.depth} "
        f"hidden={pipe.model_config.hidden_size} heads={pipe.model_config.num_heads} "
        f"params={n_params / 1e9:.3f}B dtype=bf16 steps={steps} "
        f"init_s={time.perf_counter() - t0:.2f}")
    requests = [
        dict(prompt="a drone shot of waves breaking on a rocky coast at sunset",
             resolution="480p", aspect_ratio="9:16", num_frames="2s"),
        dict(prompt="a red fox sitting in fresh snow", resolution="144p",
             aspect_ratio="1:1", num_frames=1),
    ]
    out = {"requests": []}
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for i, req in enumerate(requests):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        video = engine.generate(seed=seed + i, **req).video
        wall = time.perf_counter() - t0
        launches = {k: fa.LAUNCHES[k] - before[k] for k in before}
        h, w = get_image_size(req["resolution"], req["aspect_ratio"])
        nf = get_num_frames(req["num_frames"])
        want = expected_launches(fa, pipe, nf, h, w, steps,
                                 pipe.last_text_kv_len)
        lat = pipe.last_latents
        rec = {"request": {k: req[k] for k in req if k != "prompt"},
               "video_shape": list(video.shape), "video_dtype": str(video.dtype),
               "latents_finite": bool(np.isfinite(lat).all()),
               "latent_std": float(lat.std()), "video_mean": float(video.mean()),
               "timings_s": pipe.last_timings, "wall_s": wall,
               "denoise_step_s": pipe.last_timings["denoise"] / steps,
               "text_kv_len": pipe.last_text_kv_len,
               "launches": launches, "expected_launches": want}
        log("serve:", json.dumps(rec))
        _, h_lat, w_lat = pipe.vae.get_latent_size((nf, h, w))
        sf = pipe.vae.patch_size[1]  # pixel sizes round down to the latent grid
        if video.shape != (1, nf, h_lat * sf, w_lat * sf, 3) \
                or video.dtype != np.uint8:
            raise AssertionError(f"bad video {video.shape} {video.dtype}")
        if not rec["latents_finite"]:
            raise AssertionError("non-finite latents")
        if launches != want:
            raise AssertionError(f"launches {launches} != expected {want}")
        out["requests"].append(rec)
    out["launches"] = dict(fa.LAUNCHES)
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve: launches={out['launches']} peak_mem_gib={out['peak_mem_gib']:.2f}")
    out["forward_check"] = forward_check(fa, pipe, requests[0], seed)
    if profile:
        out["profile"] = profile_step(pipe, requests[0])
    del engine, pipe
    torch.cuda.empty_cache()
    return out


def step_inputs(pipe, req, seed: int) -> dict:
    """The CFG-doubled inputs of one denoise step of `req`, text bucketed
    as `generate` buckets it, noise from `seed`."""
    import torch

    from videosys_tpu_torch.pipelines.common import bucket_text_kv
    from videosys_tpu_torch.pipelines.open_sora.data_process import (
        get_image_size, get_num_frames)

    h, w = get_image_size(req["resolution"], req["aspect_ratio"])
    nf = get_num_frames(req["num_frames"])
    t_lat, h_lat, w_lat = pipe.vae.get_latent_size((nf, h, w))
    y, m = pipe.text_encoder.encode([req["prompt"]])
    y_all = torch.cat([y.cuda(), pipe.null_embed(1).to(y.dtype)]).to(pipe.dtype)
    m_all = torch.cat([m, m]).cuda()
    y_all, m_all, _ = bucket_text_kv(y_all, m_all,
                                     pipe.model_config.model_max_length)
    z = torch.randn(1, pipe.vae.out_channels, t_lat, h_lat, w_lat,
                    device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    return {"z": z, "y_all": y_all, "m_all": m_all, "height": float(h),
            "width": float(w), "fps": torch.full((1,), 24.0, device="cuda")}


def forward_check(fa, pipe, req, seed: int) -> dict:
    """One full-width bf16 STDiT3 forward at the request's shapes with the
    kernel, against the same forward with `flash_attention_plain` in its
    place (and, as the fault to catch, with a plain version that drops one
    key per row). Launches made here come after the counts were read."""
    import torch

    import videosys_tpu_torch.ops.attention as attention

    a = step_inputs(pipe, req, seed)
    z_in = torch.cat([a["z"], a["z"]]).to(pipe.dtype)
    t_in = torch.full((2,), 700.0, device="cuda")

    def forward():
        with torch.no_grad():
            return pipe.transformer(z_in, t_in, a["y_all"], kv_mask=a["m_all"],
                                    fps=torch.cat([a["fps"], a["fps"]]),
                                    height=a["height"], width=a["width"])

    def dropping(q, k, v, scale=None, kv_mask=None):
        B, Nk = q.shape[0], k.shape[2]
        return fa.flash_attention_plain(
            q, k, v, scale=scale,
            kv_mask=drop_last_key(kv_mask, B, Nk, q.device))

    got = forward()
    try:
        attention.flash_attention = fa.flash_attention_plain
        want = forward()
        attention.flash_attention = dropping
        fault = forward()
    finally:
        attention.flash_attention = fa.flash_attention
    res = check_bf16("stdit3_forward", got, want, fault)
    res["shape"] = list(got.shape)
    return res


def profile_step(pipe, req) -> dict:
    """Device time of one 480p denoise step by kernel, from torch.profiler
    (launches made here add to the kernel's counts after they are read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = step_inputs(pipe, req, 0)

    def step():
        with torch.no_grad():
            pipe._step(a["z"], 500.0, 0.01, a["y_all"], a["m_all"], a["fps"],
                       a["height"], a["width"], 7.0)

    wall_ms = time_ms(step, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    top = [{"name": e.key[:90], "calls": e.count,
            "ms": e.self_device_time_total / 1e3,
            "share": e.self_device_time_total / max(total, 1)} for e in rows]
    attn = sum(e.self_device_time_total for e in events
               if "flash_fwd" in e.key)
    res = {"step_wall_ms": wall_ms, "device_busy_ms": total / 1e3,
           "idle_share": max(0.0, 1 - total / 1e3 / wall_ms),
           "attention_share": attn / max(total, 1), "top": top}
    log("profile (one 480p denoise step, CFG batch 2):", json.dumps(res))
    return res


def tiny_parity_phase(seed: int) -> dict:
    """The tiny configuration on the card (kernel) and on the CPU (plain
    attention), same weights and initial noise."""
    import numpy as np
    import torch

    from videosys_tpu_torch import OpenSoraConfig, VideoSysEngine
    from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as A
    from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
    from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config

    def engine(device, params=None):
        cfg = OpenSoraConfig(
            transformer=None, vae=None, text_encoder=None,
            num_sampling_steps=4, dtype="fp32",
            transformer_config=STDiT3Config(
                depth=2, hidden_size=32, num_heads=2, caption_channels=16,
                model_max_length=8))
        vae = A.OpenSoraVAE(
            A.OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
            spatial=AutoencoderKL2D(block_out_channels=(8, 16),
                                    layers_per_block=1, num_groups=4),
            temporal=VAETemporal(filters=8, num_res_blocks=1, num_groups=4))
        eng = VideoSysEngine(cfg, vae=vae, device=device, params=params,
                             seed=seed)
        eng.pipeline.keep_latents = True
        return eng

    card = engine("cuda")
    pipe = card.pipeline
    params = {name: {k: v.cpu().numpy() for k, v in m.state_dict().items()}
              for name, m in (("transformer", pipe.transformer),
                              ("vae", pipe.vae))}
    cpu = engine("cpu", params)
    kw = dict(resolution="144p", aspect_ratio="1:1", num_frames=18, seed=seed)
    t_lat, h, w = pipe.vae.get_latent_size((18, 192, 192))
    z = torch.randn(1, 4, t_lat, h, w,
                    generator=torch.Generator().manual_seed(seed))
    v_card = card.generate("waves at dusk", latents=z, **kw).video
    v_cpu = cpu.generate("waves at dusk", latents=z, **kw).video
    lat_err = float(np.abs(pipe.last_latents
                           - cpu.pipeline.last_latents).max())
    px_err = int(np.abs(v_card.astype(int) - v_cpu.astype(int)).max())
    log(f"tiny parity (card kernel vs CPU plain, fp32, 144p 18 frames, 4 steps): "
        f"latent max_abs_err={lat_err:.3e} (tol 2e-4) video max level "
        f"diff={px_err} (tol 1)")
    if not (lat_err <= 2e-4 and px_err <= 1):
        raise AssertionError("card and CPU paths disagree on the tiny config")
    return {"latent_max_abs_err": lat_err, "video_max_level_diff": px_err}


def ragged_mask(B: int, Nk: int, gen):
    """[B, Nk] key mask of ragged real lengths, the longest filling Nk."""
    import torch

    lens = torch.randint(1, Nk + 1, (B,), device="cuda", generator=gen)
    lens[0] = Nk
    return torch.arange(Nk, device="cuda")[None] < lens[:, None]


def fused_backward_edges(fa) -> dict:
    """`flash_bwd_fused` in bf16 at the edges its design brings, against
    plain at the backward limits, and twice for bit-equal gradients."""
    import torch

    gen = torch.Generator("cuda").manual_seed(3)
    lim_l2, lim_mx = BWD_BF16_LIMITS["spatial"]
    out = {}
    # (B, H, Nq, Nk, fully masked last row): key counts around the 16-key
    # groups and the 64-key blocks; seven blocks to a cluster; four short rows
    # packed into one block with one fully masked; a full cluster of eight
    for B, H, Nq, Nk, dead_row in (
            (2, 2, 100, 1, False), (2, 2, 100, 15, False),
            (2, 2, 100, 63, False), (2, 2, 100, 64, False),
            (2, 2, 100, 65, False), (2, 2, 100, 405, True),
            (4, 1, 15, 15, True), (2, 2, 70, 512, False)):
        q, k, v, do = (torch.randn(B, H, n, 72, device="cuda", generator=gen)
                       .bfloat16() for n in (Nq, Nk, Nk, Nq))
        mask = ragged_mask(B, Nk, gen)
        if dead_row:
            mask[-1] = False
        got = fa.flash_bwd_fused(q, k, v, mask, do)
        again = fa.flash_bwd_fused(q, k, v, mask, do)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, mask, do)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        l2 = mx = 0.0
        for g, w in zip(got, want):
            d = g.float() - w.float()
            # a gradient that is all zero (one key) is held absolutely
            l2 = max(l2, d.norm().item() / (w.float().norm().item() or 1.0))
            mx = max(mx, d.abs().max().item() / (w.float().abs().max().item() or 1.0))
        live = mask.any(1, keepdim=True)
        dead = ((~mask) & live)[:, None, :, None]
        zero = not bool(got[1].masked_select(dead).any()) \
            and not bool(got[2].masked_select(dead).any())
        ok = l2 <= lim_l2 and mx <= lim_mx and same and zero and all(
            bool(torch.isfinite(g).all()) for g in got)
        kind = fa.fused_kind(Nq, Nk, q.dtype)
        log(f"bwd edge {kind:7s} shape={[B, H, Nq, Nk, 72]} dead_row={dead_row} "
            f"rel_l2={l2:.3e} rel_max={mx:.3e} bit_equal={same} "
            f"masked_keys_zero={zero} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_bwd_fused fails at Nq={Nq}, Nk={Nk}")
        out[f"{B}x{H}x{Nq}x{Nk}"] = {"rel_l2": l2, "rel_max": mx, "kind": kind}
    return out


def dkv_edges(fa) -> dict:
    """`flash_bwd_dkv` in bf16 at the edges its design brings (key counts
    around its 128-key blocks, a warpgroup with no key, q rows past a 64-row
    tile, a fully masked row), against plain at the backward limits, and
    twice for bit-equal gradients. (With one key dk is rounding noise, dS =
    dP - di = 0 up to the order of two sums, so the fewest keys held here
    are two.)"""
    import torch

    gen = torch.Generator("cuda").manual_seed(5)
    lim_l2, lim_mx = BWD_BF16_LIMITS["long_row"]
    out = {}
    for B, H, Nq, Nk in ((2, 2, 100, 2), (2, 2, 100, 64), (2, 2, 100, 65),
                         (2, 2, 70, 127), (2, 2, 70, 128), (2, 2, 70, 129),
                         (2, 2, 200, 300), (1, 2, 1590, 405)):
        q, k, v, do = (torch.randn(B, H, n, 72, device="cuda", generator=gen)
                       .bfloat16() for n in (Nq, Nk, Nk, Nq))
        mask = ragged_mask(B, Nk, gen)
        if B > 1:
            mask[-1] = False
        o, lse = fa._launch(q, k, v, None, mask, save_lse=True)
        di = (do.float() * o.float()).sum(-1)
        got = fa.flash_bwd_dkv(q, k, v, mask, do, lse, di)
        again = fa.flash_bwd_dkv(q, k, v, mask, do, lse, di)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_lse_plain(q, k, v, mask, do, o, lse)[1:]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        l2 = mx = 0.0
        for g, w in zip(got, want):
            d = g.float() - w.float()
            l2 = max(l2, d.norm().item() / (w.float().norm().item() or 1.0))
            mx = max(mx, d.abs().max().item() / (w.float().abs().max().item() or 1.0))
        dead = ((~mask) & mask.any(1, keepdim=True))[:, None, :, None]
        zero = not any(bool(g.masked_select(dead).any()) for g in got)
        ok = l2 <= lim_l2 and mx <= lim_mx and same and zero and all(
            bool(torch.isfinite(g).all()) for g in got)
        log(f"bwd edge dkv     shape={[B, H, Nq, Nk, 72]} rel_l2={l2:.3e} "
            f"rel_max={mx:.3e} bit_equal={same} masked_keys_zero={zero} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_bwd_dkv fails at Nq={Nq}, Nk={Nk}")
        out[f"{B}x{H}x{Nq}x{Nk}"] = {"rel_l2": l2, "rel_max": mx}
    return out


def check_di(name: str, di, do, out) -> float:
    """Hold the di the dq kernel wrote against rowsum(dO * O) at DI_TOL,
    relative to its largest entry (fp32 sums taken in another order)."""
    want = (do.float() * out.float()).sum(-1)
    err = ((di - want).abs().max() / want.abs().max()).item()
    if not (err <= DI_TOL and di.shape == want.shape):
        raise AssertionError(f"{name}: di disagrees with rowsum(dO * O) "
                             f"({err:.3e} > {DI_TOL:.0e})")
    return err


def dq_edges(fa) -> dict:
    """`flash_bwd_dq` in bf16 at the edges its design brings (q rows around
    its 64-row warpgroups and 128-row blocks, a warpgroup with no row, a
    fully masked row), against plain at the backward limits, twice for
    bit-equal dq and di, and di against rowsum(dO * O). (With one key dq is
    rounding noise, dS = dP - di = 0 up to the order of two sums, so the
    fewest keys held here are two.)"""
    import torch

    gen = torch.Generator("cuda").manual_seed(7)
    lim_l2, lim_mx = BWD_BF16_LIMITS["long_row"]
    out = {}
    for Nq in (1, 63, 64, 65, 127, 128, 129, 405, 1590):
        for Nk in (2, 65, 300, 405):
            B, H = 2, 2
            q, do = (torch.randn(B, H, Nq, 72, device="cuda", generator=gen)
                     .bfloat16() for _ in range(2))
            k, v = (torch.randn(B, H, Nk, 72, device="cuda", generator=gen)
                    .bfloat16() for _ in range(2))
            mask = ragged_mask(B, Nk, gen)
            mask[-1] = False
            o, lse = fa._launch(q, k, v, None, mask, save_lse=True)
            got, di = fa.flash_bwd_dq(q, k, v, mask, do, lse, o)
            again, di2 = fa.flash_bwd_dq(q, k, v, mask, do, lse, o)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_lse_plain(q, k, v, mask, do, o, lse)[0]
            same = torch.equal(got, again) and torch.equal(di, di2)
            d = got.float() - want.float()
            l2 = d.norm().item() / (want.float().norm().item() or 1.0)
            mx = d.abs().max().item() / (want.float().abs().max().item() or 1.0)
            di_err = check_di(f"dq edge {Nq}x{Nk}", di, do, o)
            dead_zero = not bool(got[-1].any())
            ok = l2 <= lim_l2 and mx <= lim_mx and same and dead_zero and bool(
                torch.isfinite(got).all())
            log(f"bwd edge dq      shape={[B, H, Nq, Nk, 72]} rel_l2={l2:.3e} "
                f"rel_max={mx:.3e} di_rel={di_err:.3e} bit_equal={same} "
                f"dead_row_zero={dead_zero} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_bwd_dq fails at Nq={Nq}, Nk={Nk}")
            out[f"{B}x{H}x{Nq}x{Nk}"] = {"rel_l2": l2, "rel_max": mx,
                                         "di_rel": di_err}
    return out


def backward_kernel_phase(fa) -> dict:
    """The three backward kernels, and the forward's log-sum-exp, against
    their plain versions at the training path's shapes."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(1)
    # (name, B, H, Nq, Nk, D, masked, backward): 144p x 51 frames batch 4 is
    # B*T = 60 rows of S = 144 tokens; 240p x 51 frames batch 2 is B*T = 30
    # rows of S = 405 tokens and B*S = 810 rows of T = 15; the dummy text has
    # 8 tokens, real captions up to 300; a 1080p image is one row of 8160
    # tokens. Rows of more than 8 keys take the blocked pair.
    shapes = [("spatial144", 60, 16, 144, 144, 72, False, "blocked"),
              ("spatial", 30, 16, 405, 405, 72, False, "blocked"),
              ("temporal", 810, 16, 15, 15, 72, False, "fused"),
              ("cross8", 30, 16, 405, 8, 72, True, "fused"),
              ("cross300", 30, 16, 405, 300, 72, True, "blocked"),
              ("long_row", 1, 16, 8160, 8160, 72, False, "blocked")]
    products = {"fused": 5, "dkv": 4, "dq": 3}
    results = {}
    for name, B, H, Nq, Nk, D, masked, variant in shapes:
        if fa.backward_variant(B, H, Nq, Nk, D, torch.bfloat16) != variant:
            raise AssertionError(f"{name}: expected the {variant} backward")
        q, k, v, do = (torch.randn(B, H, n, D, device="cuda", generator=gen)
                       for n in (Nq, Nk, Nk, Nq))
        mask = ragged_mask(B, Nk, gen) if masked else None
        row = {"shape": [B, H, Nq, Nk, D], "masked": masked,
               "backward": variant}

        def kernels(qt, kt, vt, dot, out, lse):
            """{kernel: outputs} of the variant's kernels; the blocked
            pair as `FlashAttentionFunction` runs it: dq, which writes di
            (held here against rowsum(dO * O)), then dk, dv from that di."""
            if variant == "fused":
                return {"fused": fa.flash_bwd_fused(qt, kt, vt, mask, dot)}
            dq, di = fa.flash_bwd_dq(qt, kt, vt, mask, dot, lse, out)
            row[f"di_rel_{dt}"] = check_di(name, di, dot, out)
            return {"dq": (dq,),
                    "dkv": fa.flash_bwd_dkv(qt, kt, vt, mask, dot, lse, di)}

        def plain(qt, kt, vt, dot, out, lse, m):
            if variant == "fused":
                return {"fused": fa.flash_attention_bwd_plain(qt, kt, vt, m, dot)}
            dq, dk, dv = fa.flash_attention_bwd_lse_plain(qt, kt, vt, m, dot,
                                                          out, lse)
            return {"dkv": (dk, dv), "dq": (dq,)}

        for dt, tdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            qt, kt, vt, dot = (t.to(tdt) for t in (q, k, v, do))
            # the forward kernel's output and log-sum-exp feed both sides
            out, lse = fa._launch(qt, kt, vt, None, mask, save_lse=True)
            want_lse = fa.flash_attention_plain(qt, kt, vt, None, mask,
                                                return_lse=True)[1]
            lse_err = (lse - want_lse).abs().max().item()
            got = kernels(qt, kt, vt, dot, out, lse)
            want = plain(qt, kt, vt, dot, out, lse, mask)
            torch.cuda.synchronize()
            for kern in got:
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got[kern], want[kern]))
                row.setdefault(kern, {})[f"max_abs_err_{dt}"] = err
                log(f"bwd kernel {name:9s} {kern:5s} {dt} shape={row['shape']} "
                    f"masked={masked} max_abs_err={err:.3e} lse_err={lse_err:.3e}")
                if dt == "fp32" and not (
                        err <= F32_GRAD_TOL and lse_err <= F32_GRAD_TOL and all(
                            bool(torch.isfinite(g).all()) for g in got[kern])):
                    raise AssertionError(
                        f"bwd kernel {name} {kern} fp32 disagrees with plain "
                        f"({err:.3e}, lse {lse_err:.3e} > {F32_GRAD_TOL:.0e})")
            if mask is not None:
                # masked keys get exactly zero dk and dv
                dead = (~mask)[:, None, :, None]
                for kern, idx in (("fused", (1, 2)), ("dkv", (0, 1))):
                    for i in idx if kern in got else ():
                        if bool((got[kern][i].masked_select(dead) != 0).any()):
                            raise AssertionError(
                                f"{name} {kern}: a masked key got a gradient")
            if dt == "bf16":
                fault = plain(qt, kt, vt, dot, out, lse,
                              drop_last_key(mask, B, Nk, "cuda"))
                for kern in got:
                    row[kern]["bf16_check"] = check_bf16(
                        f"{name}/{kern}", got[kern], want[kern], fault[kern],
                        BWD_BF16_LIMITS[name])
                del fault
            del got, want, out, lse, want_lse
        qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
        out, lse = fa._launch(qb, kb, vb, None, mask, save_lse=True)
        di = fa.flash_bwd_dq(qb, kb, vb, mask, dob, lse, out)[1]
        iters = 3 if name == "long_row" else 10
        timed = {"fused": lambda: fa.flash_bwd_fused(qb, kb, vb, mask, dob)} \
            if variant == "fused" else {
            "dq": lambda: fa.flash_bwd_dq(qb, kb, vb, mask, dob, lse, out),
            "dkv": lambda: fa.flash_bwd_dkv(qb, kb, vb, mask, dob, lse, di)}
        plain_ms = time_ms(lambda: plain(qb, kb, vb, dob, out, lse, mask), 2)
        # yardstick: the backward of torch's own attention (never called by
        # the port), all of dq, dk, dv
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (qb, kb, vb))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=sdpa_mask)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dob, retain_graph=True), iters)
        el = 2.0  # bytes per bf16 element
        n_q, n_k = B * H * Nq * D, B * H * Nk * D
        stats = 2 * 4.0 * B * H * Nq  # lse and di, fp32
        # dq reads q, k, v, dO, O and lse and writes dq and di
        moved = {"fused": el * (2 * n_q + 2 * n_k) + el * (n_q + 2 * n_k),
                 "dkv": el * (2 * n_q + 2 * n_k) + stats + el * 2 * n_k,
                 "dq": el * (3 * n_q + 2 * n_k) + stats + el * n_q}
        # di = rowsum(dO * O) in the dq kernel: 2 fp32 operations an element
        simt_flops = {"dq": 2.0 * B * H * Nq * D}
        for kern, fn in timed.items():
            r = row[kern]
            r["ms"] = time_ms(fn, iters)
            r["plain_ms"], r["library_ms"] = plain_ms, library_ms
            flops = products[kern] * 2.0 * B * H * Nq * Nk * D
            nbytes = moved[kern] + (B * Nk if masked else 0)
            t_ops = flops / PEAK_FLOPS["bf16"] \
                + simt_flops.get(kern, 0.0) / PEAK_FLOPS["fp32"]
            t_bytes = nbytes / PEAK_BYTES
            r["bound_ms"] = max(t_ops, t_bytes) * 1e3
            r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            log(f"bwd kernel {name:9s} {kern:5s} bf16 ms={r['ms']:.4f} "
                f"plain_ms={plain_ms:.4f} (all of dq, dk, dv) "
                f"library_ms={library_ms:.4f} (all of dq, dk, dv) "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"achieved={flops / r['ms'] / 1e9:.1f} TFLOP/s")
        if variant == "fused":
            # the blocked pair, which `backward_variant` passes up here: dq
            # (which computes di) and dk/dv
            other = {"dq": lambda: fa.flash_bwd_dq(qb, kb, vb, mask, dob, lse, out),
                     "dkv": lambda: fa.flash_bwd_dkv(qb, kb, vb, mask, dob, lse, di)}
            row["other_variant_ms"] = {k: time_ms(fn, iters)
                                       for k, fn in other.items()}
            log(f"bwd dispatch {name:10s} chosen fused "
                f"({fa.fused_kind(Nq, Nk, qb.dtype)}): {row['fused']['ms']:.4f} ms; "
                f"passed up: {row['other_variant_ms']} ms, "
                f"{sum(row['other_variant_ms'].values()):.4f} in all")
        elif fa.fused_kind(Nq, Nk, qb.dtype) is not None:
            # the pair (dq computes di), against the fused backward passed up
            row["other_variant_ms"] = {"fused": time_ms(
                lambda: fa.flash_bwd_fused(qb, kb, vb, mask, dob), iters)}
            chosen = row["dq"]["ms"] + row["dkv"]["ms"]
            log(f"bwd dispatch {name:10s} chosen blocked: dq + dkv "
                f"{row['dq']['ms']:.4f} + {row['dkv']['ms']:.4f} = "
                f"{chosen:.4f} ms; passed up: fused "
                f"({fa.fused_kind(Nq, Nk, qb.dtype)}) "
                f"{row['other_variant_ms']['fused']:.4f} ms")
        else:
            log(f"bwd dispatch {name:10s} chosen blocked: dq + dkv "
                f"{row['dq']['ms'] + row['dkv']['ms']:.4f} ms; the fused "
                f"backward takes at most "
                f"{fa.FUSED_MAX_CLUSTER * fa.FUSED_KEYS_PER_BLOCK} keys")
        results[name] = row
        del q, k, v, do, qb, kb, vb, dob, out, lse, di, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    results["fused_edges"] = fused_backward_edges(fa)
    results["dkv_edges"] = dkv_edges(fa)
    results["dq_edges"] = dq_edges(fa)
    return results


def expected_train_launches(fa, cfg, history) -> dict:
    """Kernel launches of the logged training steps, by `LAUNCHES` key, from
    their shapes: per depth pair and micro-batch one spatial, one temporal
    (unless T = 1) and two cross attentions; under recompute every forward
    runs twice; every backward is `backward_variant`'s choice."""
    mc = cfg.model
    D = mc.hidden_size // mc.num_heads
    H = mc.num_heads
    _, ph, pw = mc.patch_size
    recompute = cfg.remat_policy != "none"
    want = {key: 0 for key in fa.LAUNCHES}
    for entry in history:
        T, Hpx, Wpx = entry["thw"]
        t_lat = max(1, T // 17 * 5) if T > 1 else 1
        S = -(-(Hpx // 8) // ph) * -(-(Wpx // 8) // pw)
        B = entry["batch"]
        text_len = 8  # run_training's synthetic captions
        calls = [(B * t_lat, S, S), (B * t_lat, S, text_len),
                 (B * t_lat, S, text_len)]
        if t_lat > 1:
            calls.append((B * S, t_lat, t_lat))
        for rows, Nq, Nk in calls:
            n = mc.depth * entry["gas"]
            want[fa.kernel_variant(mc.dtype, Nq, Nk, D)] += \
                n * (2 if recompute else 1)
            variant = fa.backward_variant(rows, H, Nq, Nk, D, mc.dtype)
            for key in fa.backward_launch_keys(variant, mc.dtype, Nq, Nk):
                want[key] += n
    return want


class no_fallback:
    """While training on the card, the plain attention versions and torch's
    own attention raise: nothing may take their route."""

    NAMES = ("flash_attention_plain", "flash_attention_bwd_plain",
             "flash_attention_bwd_lse_plain")

    def __init__(self, fa):
        self.fa = fa

    def __enter__(self):
        import torch.nn.functional as F

        def refuse(*a, **k):
            raise AssertionError("training on the card left the kernels' route")

        self.saved = {n: getattr(self.fa, n) for n in self.NAMES}
        self.sdpa = F.scaled_dot_product_attention
        for n in self.NAMES:
            setattr(self.fa, n, refuse)
        F.scaled_dot_product_attention = refuse

    def __exit__(self, *exc):
        import torch.nn.functional as F

        for n, f in self.saved.items():
            setattr(self.fa, n, f)
        F.scaled_dot_product_attention = self.sdpa
        return False


def train_phase(fa, steps: int, seed: int, profile: bool = False,
                remat_policy: str = "full") -> dict:
    """`run_training` at full width and depth on the default buckets, then
    one step on a 1080p image bucket (the 8160-token row that takes the
    blocked backward pair)."""
    import math

    import torch

    from videosys_tpu_torch import TrainConfig, run_training
    from videosys_tpu_torch.training.datasets import DummyVariableVideoTextDataset

    out = {"runs": []}
    runs = [
        ("default buckets", TrainConfig(
            max_steps=steps, log_every=1, warmup_steps=2, seed=seed,
            remat_policy=remat_policy), None),
        ("1080p image", TrainConfig(
            bucket_config={"1080p": {1: (1.0, 1)}}, max_steps=1, log_every=1,
            warmup_steps=2, seed=seed, remat_policy=remat_policy),
         DummyVariableVideoTextDataset(
             size=4, seed=seed, frames_choices=(1,),
             resolution_choices=((1080, 1920),))),
    ]
    fa.reset_launches()
    want = {key: 0 for key in fa.LAUNCHES}
    state = None
    for name, cfg, dataset in runs:
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with no_fallback(fa):
            state, ema, history = run_training(cfg, dataset=dataset)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mc = cfg.model
        n_params = sum(p.numel() for p in state.model.parameters())
        p_dtypes = sorted({str(p.dtype) for p in state.model.parameters()})
        ema_gap = max((ema[k] - p.detach().float()).abs().max().item()
                      for k, p in state.model.named_parameters())
        rec = {"run": name, "depth": mc.depth, "hidden": mc.hidden_size,
               "params_b": n_params / 1e9, "param_dtypes": p_dtypes,
               "compute_dtype": str(mc.dtype), "remat_policy": cfg.remat_policy,
               "steps": state.step, "optimizer_updates": state.tx.count,
               "history": history, "ema_gap": ema_gap, "wall_s": wall,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        log("train:", json.dumps(rec))
        if state.step != cfg.max_steps or len(history) != cfg.max_steps:
            raise AssertionError(f"{name}: {state.step} steps, wanted "
                                 f"{cfg.max_steps}")
        if p_dtypes != ["torch.float32"]:
            raise AssertionError(f"{name}: master weights are {p_dtypes}")
        for h in history:
            if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                    and h["grad_norm"] > 0):
                raise AssertionError(f"{name}: bad loss or grad norm in {h}")
        if cfg.max_steps > 1 and not ema_gap > 0:
            # the first update has lr 0; from the second on the parameters
            # move and the EMA trails them
            raise AssertionError(f"{name}: the EMA did not move")
        for key, n in expected_train_launches(fa, cfg, history).items():
            want[key] += n
        out["runs"].append(rec)
        del ema
    out["launches"] = dict(fa.LAUNCHES)
    out["expected_launches"] = want
    log(f"train: launches={out['launches']} expected={want}")
    if out["launches"] != want:
        raise AssertionError(f"train launches {out['launches']} != "
                             f"expected {want}")
    if profile:
        out["profile"] = profile_train_step(state, seed)
    del state
    torch.cuda.empty_cache()
    return out


def profile_train_step(state, seed: int) -> dict:
    """Device time of one full-width training step (240p, 51 frames, batch
    2, frame mask) by kernel, from torch.profiler (launches made here come
    after the counts were read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from videosys_tpu_torch.schedulers.rflow import RFlowConfig, RFlowScheduler
    from videosys_tpu_torch.training.train_step import make_train_step

    mc = state.model.config
    gen = torch.Generator().manual_seed(seed)
    batch = {"x": torch.randn(2, mc.in_channels, 15, 30, 53, generator=gen),
             "y": torch.randn(2, 8, mc.caption_channels, generator=gen),
             "kv_mask": torch.ones(2, 8, dtype=torch.bool),
             "fps": torch.full((2,), 24.0),
             "mask": torch.ones(2, 15, dtype=torch.bool)}
    batch["mask"][:, :3] = False
    batch = {k: v.cuda() for k, v in batch.items()}
    step = make_train_step(
        state.model, RFlowScheduler(RFlowConfig(sample_method="logit-normal")),
        state.tx, 240.0, 426.0, num_frames=51)

    def run():
        step(state, gen, batch)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)

    def share(match):
        return sum(e.self_device_time_total for e in events
                   if match(e.key)) / max(total, 1)

    gemm = ("gemm", "cutlass", "cublas", "xmma", "nvjet")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    res = {"shape": "240p x 51 frames, batch 2", "step_wall_ms": wall_ms,
           "device_busy_ms": total / 1e3,
           "idle_share": max(0.0, 1 - total / 1e3 / wall_ms),
           "flash_fwd_share": share(lambda k: "flash_fwd" in k),
           "flash_bwd_share": share(lambda k: "flash_bwd" in k),
           "gemm_share": share(lambda k: any(g in k.lower() for g in gemm)),
           "top": [{"name": e.key[:90], "calls": e.count,
                    "ms": e.self_device_time_total / 1e3,
                    "share": e.self_device_time_total / max(total, 1)}
                   for e in rows]}
    log("profile (one full-width training step):", json.dumps(res))
    return res


def tiny_train_parity_phase(fa, seed: int) -> dict:
    """A tiny configuration trained 3 steps in fp32 on the card (kernels)
    and on the CPU (plain versions): same weights, captions, dropout flags,
    timesteps, noise and masks."""
    import torch

    from videosys_tpu_torch import TrainConfig, run_training
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3, STDiT3Config

    mc = STDiT3Config(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
                      model_max_length=8, dtype=torch.float32)
    torch.manual_seed(seed)
    params = {k: v.clone() for k, v in STDiT3(mc).state_dict().items()}

    def run(device):
        cfg = TrainConfig(
            model=mc, bucket_config={"144p": {1: (1.0, 2), 51: (1.0, 2)}},
            mask_ratios={"identity": 0.5, "quarter_head": 0.25, "random": 0.25},
            max_steps=3, log_every=1, warmup_steps=2, lr=1e-3, seed=seed,
            dataset_size=16)
        return run_training(cfg, device=device, params=params)[2]

    fa.reset_launches()
    card = run("cuda")
    launches = dict(fa.LAUNCHES)
    cpu = run("cpu")
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(card, cpu))
    norm_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                   for a, b in zip(card, cpu))
    log(f"tiny train parity (card kernels vs CPU plain, fp32, 3 steps, buckets "
        f"{[h['bucket'] for h in card]}): losses card={[h['loss'] for h in card]} "
        f"cpu={[h['loss'] for h in cpu]} max_abs_diff={loss_err:.3e} (tol 1e-4) "
        f"grad_norm max_rel_diff={norm_err:.3e} (tol 1e-3) launches={launches}")
    if [h["bucket"] for h in card] != [h["bucket"] for h in cpu]:
        raise AssertionError("card and CPU runs took different buckets")
    if not (loss_err <= 1e-4 and norm_err <= 1e-3):
        raise AssertionError("card and CPU training disagree on the tiny config")
    if not (launches["f32"] > 0 and launches["bwd_fused_f32"] > 0):
        raise AssertionError("the tiny card run did not launch the kernels")
    return {"loss_max_abs_diff": loss_err, "grad_norm_max_rel_diff": norm_err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30,
                    help="rflow sampling steps of the full-width requests")
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "dots", "none"),
                    help="activation recompute of the training phase")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run "
                         f"({', '.join(PHASES)}); the kernel report and the "
                         "status line are printed only when all of them ran")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width denoise step and one "
                         "full-width training step")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "videosys_tpu_torch" / "csrc" / "flash_bwd.cu").exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
    from videosys_tpu_torch.ops import flash_attention as fa
    from videosys_tpu_torch.pipelines.common import bucket_text_kv

    # phase 1: build, card
    card = card_line()
    t0 = time.perf_counter()
    libs = fa.build()
    log(f"build: {[lib.name for lib in libs.values()]} in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(nvcc {fa.build_info.get('seconds', 0.0):.1f} s)")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device_count={torch.cuda.device_count()}")

    # the cross-attention key length the first request will use
    y, m = StubTextEncoder(16, 300, device="cpu").encode(
        ["a drone shot of waves breaking on a rocky coast at sunset "
         "aesthetic score: 6.5."])
    text_len = bucket_text_kv(y, m, 300)[2]

    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases takes a subset of {PHASES}")
    if "kernel" in phases:  # phase 2: forward kernel against plain
        shapes = kernel_phase(fa, text_len)
    if "serve" in phases:  # phase 3: the serving path
        served = serve_phase(fa, args.steps, args.seed, args.profile)
    if "tiny" in phases:  # phase 4: tiny configuration, card against CPU
        tiny_parity_phase(args.seed)
    if "bwd_kernel" in phases:  # phase 5: backward kernels against plain
        bwd_shapes = backward_kernel_phase(fa)
    if "train" in phases:  # phase 6: the training path
        trained = train_phase(fa, TRAIN_STEPS, args.seed, args.profile,
                              args.remat_policy)
    if "tiny_train" in phases:  # phase 7: tiny training, card against CPU
        tiny_train_parity_phase(fa, args.seed)
    if set(phases) != set(PHASES):
        log(f"partial run ({args.phases}) total_s="
            f"{time.perf_counter() - t_start:.1f}: no kernel report")
        return 0

    # the variants the main path launches (bf16), each with the TPU kernel
    # whose shapes it takes and the shape it is timed at
    kernels = []
    for key, shape, replaces in (
            ("short", "temporal", "videosys_tpu/ops/flash_attention.py:125"),
            ("narrow", "spatial", "videosys_tpu/ops/flash_attention.py:125"),
            ("wgmma", "vae_mid", "videosys_tpu/ops/flash_attention.py:49")):
        r = shapes[shape]
        if served["launches"][key] <= 0:
            raise AssertionError(f"serving never launched flash_fwd_{key}")
        kernels.append({
            "name": f"flash_fwd_{key}", "route": "cuda",
            "source": "videosys_tpu_torch/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": served["launches"][key],
            "max_abs_err": r["max_abs_err_bf16"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the backward kernels, launches from the training path (bf16)
    fused_src = "videosys_tpu_torch/csrc/flash_bwd_fused.cu"
    dkv_src = "videosys_tpu_torch/csrc/flash_bwd_dkv.cu"
    dq_src = "videosys_tpu_torch/csrc/flash_bwd_dq.cu"
    for key, shape, kern, source, replaces in (
            ("bwd_fused", "cross8", "fused", fused_src,
             "videosys_tpu/ops/flash_attention.py:326"),
            ("bwd_fused_short", "temporal", "fused", fused_src,
             "videosys_tpu/ops/flash_attention.py:326"),
            ("bwd_dkv", "long_row", "dkv", dkv_src,
             "videosys_tpu/ops/flash_attention.py:522"),
            ("bwd_dq", "long_row", "dq", dq_src,
             "videosys_tpu/ops/flash_attention.py:594")):
        r = bwd_shapes[shape][kern]
        if trained["launches"][key] <= 0:
            raise AssertionError(f"training never launched flash_{key}")
        kernels.append({
            "name": f"flash_{key}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": trained["launches"][key],
            "max_abs_err": r["max_abs_err_bf16"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"total_s={time.perf_counter() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

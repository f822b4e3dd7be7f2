#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`videosys_tpu_torch`) on one NVIDIA
card (an H100 is the target).

    python3 chip_smoke.py [--steps N] [--phases latte,open_sora_plan]

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
     480p 9:16 2 s video and one 144p 1:1 image; the 480p request again
     under the three PAB ladders of the JAX package's bench.py with an fp8
     cache (timers, peak memory, cache bytes, PSNR against the dense video),
     conditioned on a seeded pixel reference image (the VAE encoder), and
     with loop=2; each request's kernel launches, counted from 0, must equal
     the prediction from its shapes and PAB plans; compare the fp8 cast on
     the card with the CPU's; then hold one full-width bf16
     STDiT3 forward at the 480p shapes against the same forward with the
     plain attention in place of the kernel (`--profile`: one dense step
     and two PAB read steps by kernel);
  4. run a tiny configuration on the card and on the CPU (plain attention)
     with the same weights, noise and draws, and compare the latents and
     video: dense, with PAB on, and conditioned on a reference image; then
     a tiny CogVideoX (the 5b's RoPE) the same way in fp32 (DDIM dense, DPM
     with PAB) and in bf16 (DDIM, latents held at COG_TINY_BF16_LIMITS);
  5. the T5-v1.1-XXL text encoder at full width with random weights from a
     seed: bf16 against fp32 on the card over a batch of prompts (token ids
     from a word-hashing tokenizer defined here), the encode time of one
     300-token prompt against its bound, and a tiny T5 on the card against
     the CPU in fp32;
  6. the 480p 9:16 2 s request with the T5-XXL encoder served twice: every
     module resident, then with cpu_offload=True and the STDiT3 loaded
     from the first engine's weights written as a reference checkpoint
     (fp32, two safetensors shards and an index); the first denoise step
     and the video must agree, no module may be on the card outside its
     phase, and the peak memory must fall by at least the T5's weights
     (peaks per phase, fetch seconds and GiB, checkpoint write and load
     seconds printed);
  7. hold the three backward kernels (flash_bwd_fused, flash_bwd_dq with
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
  8. train Open-Sora v1.2 at full width and depth (`run_training`: bf16
     compute over fp32 parameters, recompute of every depth pair) for a few
     steps on the default buckets and one step on a 1080p image bucket,
     checking that losses and gradient norms are finite, that the step
     count and the EMA moved, and that every attention forward and
     backward went through the kernels, by launch counts predicted from
     the shapes;
  9. train a tiny configuration for 3 steps in fp32 on the card (kernels)
     and on the CPU (plain versions) from the same weights and draws, and
     compare the losses;
 10. serve CogVideoX text-to-video (49 x 480 x 720) at its published
     widths and full depth with random weights from a seed and the stub
     text encoder: the 2b (30 layers, 30 heads of 64, 3D sincos) over 50
     DDIM steps, dense and with PAB (timers, peak memory per phase, launches
     against the plans), the 5b (42 layers, 48 heads, 3D RoPE) with DPM and
     dynamic CFG over `--cog5b-steps`; then hold the narrow forward at both
     joint-attention shapes, [2, 30 | 48, 17776, 17776, 64] bf16, against
     its plain version computed in 1024-row chunks over sampled heads, and
     time it beside the chunked plain version and torch's SDPA
     (`--profile`: one 2b transformer step by kernel, attention's share).
 11. train Open-Sora at full width and depth with the DCP profile phase
     (`run_training(dynamic_profile=True, dynamic_recompute=True)` on the
     144p and 240p 51-frame buckets, 4 steps): print each profiled
     candidate (policy, batch, peak reserved memory against the budget,
     step seconds, FLOPs, fit, launches), the failures (only running out
     of memory is allowed, and recovered from), the planner's (bs, gas,
     policy) and the trained steps; check that the profile left the
     weights as a run without it starts from, that every fitting candidate
     and the trained steps stay within the budget, and that the launches
     of every candidate that ran and of the trained steps equal the
     prediction from their shapes; then hold the blocked backward pair
     against its plain version at the largest spatial shape trained;
 12. train from raw video: `flash_fwd_wide` at the VAE encoder's mid
     attention shapes ([4, 1, 576, 576, 512] at 144p, [4, 1, 1590, 1590,
     512] at 240p) against its plain version and timed; `run_training` with
     the full bf16 VAE on seeded 60-frame clips (180 x 320 and 270 x 480,
     resize-cropped to both buckets) for 4 steps, each step's launches
     equal to its train step's plus one wide launch per 4 frames encoded;
     then `preprocess` of the 144p clips (stub text encoder), the latents
     read back bit-equal by `PreprocessedLatentDataset`, and 2 steps from
     them.
 13. serve Latte-1 (28 pairs, 16 heads of 72, the SD VAE) at full width
     and depth with random weights from a seed and the stub text encoder:
     the default request (16 x 512 x 512, 50 DDIM steps, guidance 7.5)
     dense and under LattePABConfig() (spatial, temporal, cross and the
     MLP rows), timers, peaks per phase, launches against the plans, PAB's
     read steps and speed-up; the wide forward at the VAE's mid attention
     [16, 1, 4096, 4096, 512] against its plain version; a tiny Latte with
     PAB on the card against the CPU (fp32);
 14. serve Open-Sora-Plan the same way: v1.2 (32 layers, 24 heads of 96,
     3D RoPE, Euler-Ancestral over OSP_V120_STEPS) at 29 x 480p dense and
     under OpenSoraPlanV120PABConfig(), at 93 x 480p (28,800 tokens) for
     one step and its whole tiled decode of 93 frames, and v1.1 (28 pairs
     with RoPE, PNDM over OSP_V110_STEPS) at 65 x 512 x 512 with its pre-fix
     VAE attention, each tiled causal-VAE decode's launches counted tile by
     tile; then the narrow forward at head_dim 96 ([2, 24, 9600 | 28800,
     same, 96], in 1024-row chunks over sampled heads, and the
     cross-attention), at the 17-key temporal rows, and the wide forward
     at the causal VAE's tile rows, each against its plain version and
     timed beside torch's SDPA; tiny v1.1 and v1.2 pipelines on the card
     against the CPU (fp32).
 15. serve Vchitect-2.0 (18 joint blocks, 18 heads of 64, the 16-channel SD3
     VAE) at full width and depth with random weights from a seed and the
     word-hash stub encoder: the reference request (40 x 288 x 480,
     `--vchitect-steps` flow-match Euler steps, guidance 7.5 with the
     cosine-dynamic scale, uncond and cond forwards) dense and under
     VchitectPABConfig(), timers, peaks per phase, launches against the
     plans, read steps, cache bytes and speed-up, and the PAB video scored
     against the dense one by `eval.metrics.evaluate_pair` (PSNR, SSIM);
     then the narrow forward at the joint spatial rows [40, 18, 873, 873,
     64], the 34,920-query cross-attention and the 40-frame temporal rows,
     and the wide forward at the VAE's mid attention over 40 frames, each
     against its plain version and timed beside torch's SDPA; the CLIP-L +
     CLIP-bigG + T5-XXL trio at its published widths, bf16 against fp32,
     packed as SD3 packs it; tiny pipelines, dense and with PAB, on the
     card against the CPU (fp32).

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
PHASES = ("kernel", "serve", "tiny", "bwd_kernel", "train", "tiny_train", "t5",
          "offload", "cogvideox", "dcp", "raw_video", "latte", "open_sora_plan",
          "vchitect")
TRAIN_STEPS = 4  # on the default buckets: two video shapes and an image
F32_TOL = 2e-5
F32_GRAD_TOL = 1e-4
DI_TOL = 1e-5  # di against rowsum(dO * O), relative to its largest entry
# bf16 limits per shape (rel_l2, rel_max), set from this script's readings
# on an H100 (PERF.md): the kernel read at most half of each, and a plain
# version that drops one key per row read at least twice one of them
BF16_LIMITS = {"spatial": (8e-3, 2e-2), "cross": (1e-2, 2e-2),
               "temporal": (1e-2, 2e-2), "vae_mid": (6.5e-3, 1.5e-2),
               "stdit3_forward": (1.8e-2, 2.5e-2),
               # T5-v1.1-XXL bf16 against fp32 on the unmasked rows, read on
               # an H100: 2.15e-2, 2.50e-2; without the relative bias 0.73,
               # 0.84
               "t5_xxl": (4.5e-2, 5e-2),
               # CogVideoX's joint attention, 17,776 keys at D = 64, read
               # on an H100: kernel 3.11e-3, 5.88e-3 (2b) and 3.17e-3,
               # 6.21e-3 (5b); one key dropped 7.28e-3, 4.19e-2 and
               # 8.84e-3, 1.69e-1
               "cog2b": (6.5e-3, 1.5e-2), "cog5b": (6.5e-3, 1.5e-2),
               # the VAE encoder's mid attention at training buckets: the
               # wide kernel of "vae_mid", held at its limits
               "vae_enc144": (6.5e-3, 1.5e-2), "vae_enc240": (6.5e-3, 1.5e-2),
               # Latte and Open-Sora-Plan, read on an H100 (kernel; one key
               # dropped): narrow at head_dim 96, 9,600 keys 3.16e-3,
               # 5.41e-3 (1.09e-2, 0.100), 28,800 keys 3.66e-3, 4.27e-3
               # (6.55e-3, 0.136), the cross-attention 2.94e-3, 4.83e-3
               # (0.230, 0.873); the 17-key temporal rows 2.94e-3, 4.79e-3
               # (0.257, 0.891); the wide forward at the causal VAE's
               # tiles 3.05e-3, 4.10e-3 (3.14e-2, 0.139) and its v1.1 rows
               # 3.05e-3, 4.53e-3 (3.05e-2, 0.169), at Latte's VAE mid
               # 3.10e-3, 5.38e-3 (1.59e-2, 0.290)
               "osp480": (6.5e-3, 1.5e-2), "osp93": (7.5e-3, 1.5e-2),
               "osp_cross": (6.5e-3, 1.5e-2), "temporal17": (6.5e-3, 1.5e-2),
               "cvae_tile": (6.5e-3, 1.5e-2), "cvae_legacy": (6.5e-3, 1.5e-2),
               "latte_vae_mid": (6.5e-3, 1.5e-2),
               # LatteT2V's rows at head_dim 72 (Latte-1 and v1.1), read on
               # an H100 (kernel; one key dropped): spatial [32 | 34, 16,
               # 1024, 1024] 3.05e-3, 7.69e-3 (3.19e-2, 0.530) and 3.06e-3,
               # 3.97e-3 (3.19e-2, 0.180), cross 2.53e-3, 4.20e-3 (0.609,
               # 1.31) and 2.40e-3, 3.79e-3 (0.670, 1.10), the 16-frame
               # temporal rows on `short` 2.93e-3, 4.76e-3 (0.266, 0.889):
               # the limits of the Open-Sora rows of the same kind
               "latte_spatial": (8e-3, 2e-2), "latte_cross": (1e-2, 2e-2),
               "latte_temporal16": (1e-2, 2e-2),
               "osp110_spatial": (8e-3, 2e-2), "osp110_cross": (1e-2, 2e-2),
               # Vchitect-2.0's rows at head_dim 64 and its VAE's mid
               # attention over 40 frames: the limits of the Open-Sora rows
               # of the same kind; read on an H100 (kernel; one key
               # dropped): spatial [40, 18, 873, 873] 3.05e-3, 3.47e-3
               # (3.38e-2, 0.162), cross [1, 18, 34920, 333] 3.01e-3,
               # 3.91e-3 (5.91e-2, 0.366), the 40-frame rows 2.97e-3,
               # 5.88e-3 (0.163, 0.754), VAE mid 3.08e-3, 3.50e-3
               # (2.15e-2, 0.221)
               "vchitect_spatial": (8e-3, 2e-2), "vchitect_cross": (1e-2, 2e-2),
               "vchitect_temporal40": (1e-2, 2e-2),
               "vchitect_vae_mid": (6.5e-3, 1.5e-2),
               # the CLIP-L and CLIP-bigG text towers (hidden_states[-2] and
               # the projected pooled vector) bf16 against fp32, read on an
               # H100: 1.14e-2, 1.49e-2 and 1.51e-2, 2.33e-2; with the
               # causal mask dropped 1.08, 1.22 and 1.22, 1.14
               "clip_l": (4.5e-2, 5e-2), "clip_g": (4.5e-2, 5e-2)}
# the same for the gradients of the backward kernels (the largest of dq, dk,
# dv): the kernels read at most a third of each limit (3.0e-4, 3.2e-3), the
# one-key fault at least 10x one of them (1.1e-2, 1.0e-1 at the long row)
BWD_BF16_LIMITS = {name: (1e-3, 1e-2) for name in (
    "spatial144", "spatial", "temporal", "cross8", "cross300", "long_row",
    "dcp_spatial")}


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


def check_bf16(name: str, got, want, fault, limits=None,
               fault_name: str = "one key dropped") -> dict:
    """Hold a bf16 output (or a tuple of them: the worst counts) against
    its reference at `limits` (default BF16_LIMITS[name]); `fault`, the
    output of a version with `fault_name`, must break them."""
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
    log(f"check {name:14s} bf16 rel_l2={l2:.3e} (limit {lim_l2:.1e}, "
        f"{fault_name} {f_l2:.3e}) rel_max={mx:.3e} (limit {lim_mx:.1e}, "
        f"{fault_name} {f_mx:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: bf16 disagrees with its reference")
    if f_l2 <= lim_l2 and f_mx <= lim_mx:
        raise AssertionError(f"{name}: the bf16 limits let a fault "
                             f"({fault_name}) pass")
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
    # (name, B, H, Nq, Nk, D, masked); B*T = 30 (CFG x 15 latent frames),
    # B*S = 3180 temporal rows, 8 frames per VAE micro-batch
    results = forward_shapes(fa, [
        ("spatial", 30, 16, 1590, 1590, 72, False),
        ("cross", 30, 16, 1590, text_len, 72, True),
        ("temporal", 3180, 16, 15, 15, 72, False),
        ("vae_mid", 8, 1, 6360, 6360, 512, False)], seed=0)
    results["narrow_edges"] = narrow_forward_edges(fa)
    results["wgmma_edges"] = wide_forward_edges(fa)
    return results


def forward_shapes(fa, shapes, seed: int, dtypes=("bf16", "fp32")) -> dict:
    """Each forward shape (name, B, H, Nq, Nk, D, masked) in `dtypes` against
    the plain version (bf16 at BF16_LIMITS[name] with the one-key fault,
    fp32 at F32_TOL), then timed in bf16 beside the plain version and torch's
    SDPA, with its bound."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(seed)
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
            if dt not in dtypes:
                continue
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
                      steps: int, text_len: int, plans=None, loop: int = 1,
                      encoded=()) -> dict:
    """Kernel launches one request makes, by variant, from its shapes and
    PAB plans: per denoise step and loop each depth runs spatial (S x S
    tokens), temporal (T x T, unless T = 1) and two cross attentions (S x
    the bucketed text length), each on the variant its shape takes, less
    what the step's plan reads from the cache (spatial, temporal, both
    cross, or the whole pair); the VAE runs its mid attention once per frame
    micro-batch: per temporal chunk when one clip is streamed to uint8, over
    the whole clip per loop otherwise, and over each encoded clip of
    `encoded` frames (a reference, a loop's previous clip)."""
    t_lat, h_lat, w_lat = pipe.vae.get_latent_size((num_frames, height, width))
    mc = pipe.model_config
    _, ph, pw = mc.patch_size
    S = -(-h_lat // ph) * -(-w_lat // pw)
    D = mc.hidden_size // mc.num_heads
    want = {key: 0 for key in fa.LAUNCHES}
    for plan in plans or [None] * steps:
        calls = []
        if plan is None or not (plan.spatial or plan.pair):
            calls.append((S, S))
        if plan is None or not (plan.cross or plan.pair):
            calls += [(S, text_len)] * 2
        if t_lat > 1 and (plan is None or not (plan.temporal or plan.pair)):
            calls.append((t_lat, t_lat))
        for Nq, Nk in calls:
            want[fa.kernel_variant(pipe.dtype, Nq, Nk, D)] += mc.depth * loop
    vae_cfg = pipe.vae.config
    mbs = vae_cfg.micro_batch_size
    if loop == 1:
        n_vae, remaining = 0, num_frames
        for _ in range(0, t_lat, pipe.vae.micro_z_frame_size):
            nf = min(vae_cfg.micro_frame_size, remaining)
            n_vae += -(-nf // mbs)
            remaining -= vae_cfg.micro_frame_size
    else:
        n_vae = loop * -(-num_frames // mbs)
    n_vae += sum(-(-n // mbs) for n in encoded)
    vae_mid_d = pipe.vae.spatial_vae.module.block_out_channels[-1]
    n_mid = h_lat * w_lat  # a frame's positions at the VAE's mid blocks
    want[fa.kernel_variant(pipe.dtype, n_mid, n_mid, vae_mid_d)] += n_vae
    return want


# the PAB ladders of the JAX package's bench.py:158-201, each with an fp8
# cache: the reference's (spatial, temporal, cross and the MLP rows), the
# heavy one, and the pair-delta ladder
PAB_LEGS = {
    "pab": {},
    "pab_heavy": dict(spatial_range=3, temporal_range=6, cross_range=8),
    "pab_pair3_wide": dict(pair_broadcast=True, pair_range=3,
                           pair_threshold=(250, 950)),
}


def psnr_db(a, b) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-10))


def serve_request(fa, engine, req: dict, seed: int, steps: int,
                  plans=None, encoded=()) -> tuple:
    """One `generate` with the launch counts set to 0 just before it and
    read just after, held against the prediction; (record, video)."""
    import numpy as np
    import torch

    from videosys_tpu_torch.pipelines.open_sora.data_process import (
        get_image_size, get_num_frames)
    from videosys_tpu_torch.pipelines.open_sora.mask_strategy import (
        dframe_to_frame)

    pipe = engine.pipeline
    loop = req.get("loop", 1)
    # the peak before each decode is the denoise phase's (a PAB cache is
    # freed before the VAE runs, whose own peak is the request's)
    denoise_peaks = []

    def probed(name):
        decode = getattr(pipe.vae, name)

        def call(*args, **kwargs):
            denoise_peaks.append(torch.cuda.max_memory_allocated())
            return decode(*args, **kwargs)
        return call

    for name in ("decode", "decode_chunks_u8"):
        setattr(pipe.vae, name, probed(name))
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        video = engine.generate(seed=seed, **req).video
        wall = time.perf_counter() - t0
    finally:
        for name in ("decode", "decode_chunks_u8"):
            delattr(pipe.vae, name)
    launches = dict(fa.LAUNCHES)
    h, w = get_image_size(req["resolution"], req["aspect_ratio"])
    nf = get_num_frames(req["num_frames"])
    want = expected_launches(fa, pipe, nf, h, w, steps, pipe.last_text_kv_len,
                             plans, loop, encoded)
    lat = pipe.last_latents
    rec = {"request": {k: (list(v.shape) if k == "reference" else v)
                       for k, v in req.items() if k != "prompt"},
           "video_shape": list(video.shape), "video_dtype": str(video.dtype),
           "latents_finite": bool(np.isfinite(lat).all()),
           "latent_std": float(lat.std()), "video_mean": float(video.mean()),
           "timings_s": pipe.last_timings, "wall_s": wall,
           "denoise_step_s": pipe.last_timings["denoise"] / steps / loop,
           "text_kv_len": getattr(pipe, "last_text_kv_len", None),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "denoise_peak_mem_gib": max(denoise_peaks) / 2**30,
           "launches": launches, "expected_launches": want}
    _, h_lat, w_lat = pipe.vae.get_latent_size((nf, h, w))
    sf = pipe.vae.patch_size[1]  # pixel sizes round down to the latent grid
    frames = nf + (loop - 1) * (nf - dframe_to_frame(
        req.get("condition_frame_length", 5)))
    if video.shape != (1, frames, h_lat * sf, w_lat * sf, 3) \
            or video.dtype != np.uint8:
        raise AssertionError(f"bad video {video.shape} {video.dtype}")
    if not rec["latents_finite"]:
        raise AssertionError("non-finite latents")
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    return rec, video


def fp8_cast_check() -> dict:
    """float8_e4m3fn casts on the card against the CPU, from fp32 and bf16,
    over +-1e4 (the format's largest finite value is 448): whether the card
    saturates out of range, as the CPU does, or gives NaN."""
    import torch

    x = torch.cat([torch.linspace(-1e4, 1e4, 40001),
                   torch.tensor([448.0, 449.0, 460.0, 464.0, 500.0, 1e-3])])
    probe = torch.tensor([460.0, 464.0, 500.0, 1e4, -1e4])
    out = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        def cast(t, device):
            return t.to(dt).to(device).to(torch.float8_e4m3fn).float().cpu()
        cpu, cuda = cast(x, "cpu"), cast(x, "cuda")
        out[name] = {
            "cuda_equals_cpu": bool(torch.equal(cpu.nan_to_num(1e9),
                                                cuda.nan_to_num(1e9))),
            "nan_cpu": int(cpu.isnan().sum()),
            "nan_cuda": int(cuda.isnan().sum()),
            "probe": [float(v) for v in probe],
            "probe_cpu": [repr(float(v)) for v in cast(probe, "cpu")],
            "probe_cuda": [repr(float(v)) for v in cast(probe, "cuda")]}
    out["cuda_saturates"] = all(
        not out[n]["nan_cuda"] and out[n]["probe_cuda"][3] == "448.0"
        for n in ("fp32", "bf16"))
    log("fp8 cast (float8_e4m3fn, card vs CPU):", json.dumps(out))
    return out


def serve_phase(fa, steps: int, seed: int, profile: bool = False) -> dict:
    import numpy as np
    import torch

    from videosys_tpu_torch import (OpenSoraConfig, OpenSoraPABConfig,
                                    VideoSysEngine)
    from videosys_tpu_torch.core.pab import PABStepPlan, build_plans
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
    # the VAE's encoders (both stages' encoder and quant_conv) stay on the
    # card for every request, text-only ones included
    vae_sd = pipe.vae.state_dict()
    enc_bytes = sum(v.numel() * v.element_size() for k, v in vae_sd.items()
                    if ".encoder." in k or ".quant_conv." in k)
    log(f"serve: STDiT3 depth={pipe.model_config.depth} "
        f"hidden={pipe.model_config.hidden_size} heads={pipe.model_config.num_heads} "
        f"params={n_params / 1e9:.3f}B dtype=bf16 steps={steps} "
        f"init_s={time.perf_counter() - t0:.2f} "
        f"vae_bytes_gib={sum(v.numel() * v.element_size() for v in vae_sd.values()) / 2**30:.4f} "
        f"vae_encoder_bytes_gib={enc_bytes / 2**30:.4f}")
    video_req = dict(
        prompt="a drone shot of waves breaking on a rocky coast at sunset",
        resolution="480p", aspect_ratio="9:16", num_frames="2s")
    requests = [
        video_req,
        dict(prompt="a red fox sitting in fresh snow", resolution="144p",
             aspect_ratio="1:1", num_frames=1),
    ]
    out = {"requests": [], "launches": {k: 0 for k in fa.LAUNCHES}}

    def served(label, rec):
        log(f"serve {label}:", json.dumps(rec))
        for k, v in rec["launches"].items():
            out["launches"][k] += v

    videos = []
    for i, req in enumerate(requests):
        rec, video = serve_request(fa, engine, req, seed + i, steps)
        served("dense", rec)
        out["requests"].append(rec)
        videos.append(video)
    out["peak_mem_gib"] = max(r["peak_mem_gib"] for r in out["requests"])

    # PAB: the 480p request under each ladder, fp8 cache, the same weights
    out["fp8_cast"] = fp8_cast_check()
    h, w = get_image_size(video_req["resolution"], video_req["aspect_ratio"])
    nf = get_num_frames(video_req["num_frames"])
    ladder = pipe.scheduler.prepare_timesteps(h, w, nf)
    dense = out["requests"][0]
    out["pab"] = {}
    for name, over in PAB_LEGS.items():
        pab = OpenSoraPABConfig(cache_dtype="float8_e4m3fn", **over)
        engine.config.enable_pab, engine.config.pab_config = True, pab
        plans = build_plans(pab, ladder, pipe.model_config.depth, pipe.dtype)
        rec, video = serve_request(fa, engine, video_req, seed, steps, plans)
        rec.update(
            cache_bytes=pipe.last_pab_cache_bytes,
            cache_gib=pipe.last_pab_cache_bytes / 2**30,
            peak_over_dense_gib=rec["peak_mem_gib"] - dense["peak_mem_gib"],
            denoise_peak_over_dense_gib=rec["denoise_peak_mem_gib"]
            - dense["denoise_peak_mem_gib"],
            denoise_vs_dense=dense["timings_s"]["denoise"]
            / rec["timings_s"]["denoise"],
            psnr_vs_dense_db=psnr_db(video, videos[0]),
            read_steps={k: sum(getattr(p, k) for p in plans)
                        for k in ("spatial", "temporal", "cross", "pair")},
            mlp_row_reads=sum(sum(p.mlp_spatial_use) + sum(p.mlp_temporal_use)
                              for p in plans))
        served(name, rec)
        out["pab"][name] = rec
    engine.config.enable_pab = False

    # condition frames: a seeded pixel reference image (latent frame 0
    # frozen), then two loops, the second conditioned on the first's end
    ref = np.random.default_rng(seed).uniform(
        -1, 1, (3, 1, h, w)).astype(np.float32)
    rec, _ = serve_request(fa, engine, dict(video_req, reference=ref), seed,
                           steps, encoded=(1,))
    served("conditioned", rec)
    out["conditioned"] = rec
    rec, _ = serve_request(fa, engine, dict(video_req, loop=2), seed, steps,
                           encoded=(nf,))
    served("loop2", rec)
    out["loop2"] = rec
    log(f"serve: launches={out['launches']} peak_mem_gib={out['peak_mem_gib']:.2f}")
    out["forward_check"] = forward_check(fa, pipe, requests[0], seed)
    if profile:
        out["profile"] = profile_step(pipe, requests[0])
        # PAB read steps: spatial, temporal and cross from an fp8 cache;
        # the whole pair from its residual
        for label, plan, over in (
                ("pab stc-read", PABStepPlan(spatial=True, temporal=True,
                                             cross=True), {}),
                ("pab pair-read", PABStepPlan(pair=True),
                 PAB_LEGS["pab_pair3_wide"])):
            out[f"profile_{label}"] = profile_step(
                pipe, requests[0], label, plan,
                OpenSoraPABConfig(cache_dtype="float8_e4m3fn", **over))
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


def profile_step(pipe, req, label: str = "dense", plan=None, pab=None) -> dict:
    """Device time of one 480p denoise step by kernel, from torch.profiler
    (launches made here add to the kernel's counts after they are read);
    with `plan` a PAB step on a cache made for `pab`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = step_inputs(pipe, req, 0)
    cache = None
    if plan is not None:
        _, T, h, w = a["z"].shape[1:]
        mc = pipe.model_config
        cache = pipe.transformer.init_cache(
            pab, 2, T, (h // mc.patch_size[1]) * (w // mc.patch_size[2]))

    def step():
        with torch.no_grad():
            pipe._step(a["z"], 500.0, 0.01, a["y_all"], a["m_all"], a["fps"],
                       a["height"], a["width"], 7.0, plan=plan, cache=cache)

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
    log(f"profile {label} (one 480p denoise step, CFG batch 2):",
        json.dumps(res))
    return res


def tiny_parity_phase(seed: int) -> dict:
    """The tiny configuration on the card (kernel) and on the CPU (plain
    attention), same weights, initial noise and draws: dense, with PAB on
    (spatial, temporal and cross broadcast, the cache in fp32), and
    conditioned on a pixel reference image."""
    import numpy as np
    import torch

    from videosys_tpu_torch import OpenSoraConfig, OpenSoraPABConfig, VideoSysEngine
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
    reference = np.random.default_rng(seed).uniform(
        -1, 1, (3, 1, 192, 192)).astype(np.float32)
    pab = OpenSoraPABConfig(spatial_threshold=(100, 950),
                            temporal_threshold=(100, 950),
                            cross_threshold=(100, 950), mlp_broadcast=False)
    out = {}
    for label, extra in (("dense", {}), ("pab", {}),
                         ("conditioned", {"reference": reference})):
        for eng in (card, cpu):
            eng.config.enable_pab = label == "pab"
            eng.config.pab_config = pab
        videos = []
        for eng in (card, cpu):
            draws = torch.Generator().manual_seed(seed + 1)
            noise = lambda name, shape, g=draws: torch.randn(shape, generator=g)
            videos.append(eng.generate("waves at dusk", latents=z, noise=noise,
                                       **extra, **kw).video)
        lat_err = float(np.abs(pipe.last_latents
                               - cpu.pipeline.last_latents).max())
        px_err = int(np.abs(videos[0].astype(int) - videos[1].astype(int)).max())
        log(f"tiny parity {label} (card kernel vs CPU plain, fp32, 144p 18 "
            f"frames, 4 steps): latent max_abs_err={lat_err:.3e} (tol 2e-4) "
            f"video max level diff={px_err} (tol 1)")
        if not (lat_err <= 2e-4 and px_err <= 1):
            raise AssertionError(f"card and CPU paths disagree on the tiny "
                                 f"config ({label})")
        out[label] = {"latent_max_abs_err": lat_err,
                      "video_max_level_diff": px_err}
    out["cogvideox"] = tiny_cogvideox_parity(seed)
    return out


# T5-v1.1-XXL's published configuration (DeepFloyd/t5-v1_1-xxl config.json)
T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240,
              num_layers=24, num_heads=64, relative_attention_num_buckets=32,
              relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
              feed_forward_proj="gated-gelu")
PROMPTS = ["a drone shot of waves breaking on a rocky coast at sunset",
           "a red fox sitting in fresh snow, looking at the camera",
           "time-lapse of clouds over a mountain lake, golden hour",
           "a busy street market in the rain at night, neon signs"]


class WordTokenizer:
    """Stands in for T5's sentencepiece tokenizer, so that the script needs
    no `transformers`: words hash to ids 2..vocab-1, then eos (1) and
    padding (0), truncated to max_length; called as an HF tokenizer is."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length, padding, truncation,
                 return_attention_mask, add_special_tokens, return_tensors):
        import zlib

        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            toks = [2 + zlib.crc32(w.encode()) % (self.vocab_size - 2)
                    for w in text.split()[: max_length - 1]] + [1]
            ids[i, : len(toks)] = toks
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def t5_xxl(seed: int, dtype):
    """T5-v1.1-XXL's encoder on the card, weights drawn from `seed` as HF
    initializes them (in fp32, then cast to `dtype`), but the relative
    position bias at std 1 instead of d_model^-0.5, so that the positions
    weigh in the scores and dropping the bias is a fault a check can see."""
    import torch

    from videosys_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel

    torch.manual_seed(seed)
    with torch.device("cuda"):
        model = T5EncoderModel(T5Config(**T5_XXL))
        with torch.no_grad():
            model.encoder.block[0].layer[0].SelfAttention \
                .relative_attention_bias.weight.normal_(0.0, 1.0)
    return model.to(dtype).eval().requires_grad_(False)


def median_ms(fn, reps: int) -> float:
    """Median of `reps` single calls timed by CUDA events, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def device_busy(fn, wall_ms: float) -> dict:
    """The card's busy time in one call of `fn` (torch.profiler, the sum of
    the kernels' device time) and its idle share of `wall_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return {"encode_device_busy_ms": busy,
            "encode_idle_share": max(0.0, 1 - busy / wall_ms)}


def t5_bound_ms(cfg: dict, L: int, weight_bytes: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one encode of L tokens in
    bf16: the GEMMs and the two attention products over 989 TFLOP/s
    against reading every weight but the embedding table once over 3.35
    TB/s (the token ids, the L embedding rows and the output are
    negligible beside them)."""
    d, inner, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    gemm = 4 * d * inner + 3 * d * ff
    flops = cfg["num_layers"] * (2 * L * gemm + 4 * L * L * inner)
    ops_ms = flops / PEAK_FLOPS["bf16"] * 1e3
    bytes_ms = weight_bytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def t5_phase(seed: int) -> dict:
    """T5-v1.1-XXL at full width on the card: bf16 against fp32 on a batch
    of prompts (relative measures on the unmasked rows, limits checked to
    catch a dropped relative bias), the encode time of one 300-token prompt
    against its bound; then a tiny T5 on the card against the CPU in fp32."""
    import numpy as np
    import torch

    from videosys_tpu_torch.models.text_encoders.t5 import (
        T5Config, T5EncoderModel, T5TextEncoder, encoder_state_dict)

    t0 = time.perf_counter()
    m32 = t5_xxl(seed, torch.float32)
    with torch.device("meta"):
        m16 = T5EncoderModel(m32.config)
    m16.load_state_dict(encoder_state_dict(m32.state_dict(), torch.bfloat16),
                        assign=True)
    m16.eval()
    n_params = sum(p.numel() for p in m16.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in m16.parameters())
    tok = WordTokenizer(T5_XXL["vocab_size"])
    batch = tok(PROMPTS, 300, "max_length", True, True, True, "np")
    ids = torch.from_numpy(batch["input_ids"]).cuda()
    mask = torch.from_numpy(batch["attention_mask"]).cuda().bool()
    with torch.no_grad():
        want = m32(ids, mask)[mask]
        got = m16(ids, mask)[mask]
        rel_bias = m16.encoder.block[0].layer[0].SelfAttention \
            .relative_attention_bias.weight
        kept = rel_bias.data
        rel_bias.data = torch.zeros_like(kept)  # the fault: no position bias
        fault = m16(ids, mask)[mask]
        rel_bias.data = kept
    res = {"params": n_params, "weight_bytes": weight_bytes,
           "weight_gib": weight_bytes / 2**30,
           "init_s": time.perf_counter() - t0,
           "tokens": int(mask.sum()), "prompts": len(PROMPTS)}
    res.update(check_bf16("t5_xxl", got, want, fault,
                          fault_name="relative bias dropped"))
    del m32, want, got, fault
    torch.cuda.empty_cache()

    enc = T5TextEncoder(max_length=300, dtype=torch.bfloat16, tokenizer=tok,
                        model=m16)
    one = tok(PROMPTS[:1], 300, "max_length", True, True, True, "np")
    ids1 = torch.from_numpy(one["input_ids"]).cuda()
    mask1 = torch.from_numpy(one["attention_mask"]).cuda().bool()
    with torch.no_grad():
        res["encode_ms"] = median_ms(lambda: m16(ids1, mask1), 20)
        res["encode_batch4_ms"] = median_ms(lambda: m16(ids, mask), 10)
        res.update(device_busy(lambda: m16(ids1, mask1), res["encode_ms"]))
    res["bound_ms"], res["bound_by"] = t5_bound_ms(T5_XXL, 300, weight_bytes
                                                   - m16.shared.weight.numel()
                                                   * 2)
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        enc.encode(PROMPTS[:1])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    res["text_encoder_encode_wall_ms"] = sorted(walls)[2] * 1e3
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del enc, m16
    torch.cuda.empty_cache()

    # tiny T5, card against CPU, fp32
    tiny = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                    num_heads=4)
    torch.manual_seed(seed)
    cpu = T5EncoderModel(tiny).eval()
    card = T5EncoderModel(tiny).eval()
    card.load_state_dict(cpu.state_dict())
    card.cuda()
    rng = np.random.default_rng(seed)
    tids = torch.from_numpy(rng.integers(0, 64, (3, 40)))
    lens = torch.tensor([40, 17, 1])
    tmask = torch.arange(40)[None] < lens[:, None]
    with torch.no_grad():
        err = float((card(tids.cuda(), tmask.cuda()).cpu()
                     - cpu(tids, tmask)).abs().max())
    res["tiny_card_vs_cpu_max_abs_err"] = err
    log(f"t5: T5-v1.1-XXL params={n_params / 1e9:.3f}B weights="
        f"{res['weight_gib']:.3f} GiB bf16; encode of one 300-token prompt "
        f"{res['encode_ms']:.3f} ms (median, CUDA events; bound "
        f"{res['bound_ms']:.3f} ms by {res['bound_by']}; device busy "
        f"{res['encode_device_busy_ms']:.3f} ms); tiny card vs CPU "
        f"fp32 max_abs_err={err:.3e} (tol 2e-4)")
    log("t5:", json.dumps(res))
    if not err <= 2e-4:
        raise AssertionError("tiny T5: card and CPU disagree")
    return res


def offload_request(fa, engine, req: dict, seed: int, steps: int,
                    modules: dict) -> tuple:
    """One `generate` with the launch counts and the peak memory set to 0
    just before it; the peak read per phase (text, denoise, VAE) and for
    the request, the first denoise step's output kept. Under cpu_offload
    every fetch is logged and must find every other module on the host.
    (record, video, first step)."""
    import contextlib

    import torch

    from videosys_tpu_torch.core import pipeline as core_pipeline
    from videosys_tpu_torch.pipelines.open_sora.data_process import (
        get_image_size, get_num_frames)

    pipe = engine.pipeline
    peaks, first, fetches = {}, [], []
    phase, step = pipe._phase, pipe._step

    @contextlib.contextmanager
    def probed_phase(timer, module=None, name=""):
        torch.cuda.reset_peak_memory_stats()
        with phase(timer, module, name):
            yield
        peaks[timer] = max(peaks.get(timer, 0),
                           torch.cuda.max_memory_allocated())

    def probed_step(*args, **kwargs):
        z = step(*args, **kwargs)
        if not first:
            first.append(z.clone())
        return z

    def fetched(name, module, seconds, nbytes):
        mine = {id(p) for p in module.parameters()}
        stray = sorted({other for other, m in modules.items()
                        for p in m.parameters()
                        if id(p) not in mine and p.is_cuda})
        if stray:
            raise AssertionError(f"fetching {name}: {stray} still on the card")
        fetches.append({"module": name, "seconds": seconds,
                        "gib": nbytes / 2**30})

    pipe._phase, pipe._step = probed_phase, probed_step
    core_pipeline.FETCH_HOOKS.append(fetched)
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        video = engine.generate(seed=seed, **req).video
        wall = time.perf_counter() - t0
    finally:
        del pipe._phase, pipe._step
        core_pipeline.FETCH_HOOKS.remove(fetched)
    peaks["request"] = max(max(peaks.values()),
                           torch.cuda.max_memory_allocated())
    h, w = get_image_size(req["resolution"], req["aspect_ratio"])
    nf = get_num_frames(req["num_frames"])
    want = expected_launches(fa, pipe, nf, h, w, steps, pipe.last_text_kv_len)
    rec = {"wall_s": wall, "timings_s": pipe.last_timings,
           "peak_mem_gib": {k: v / 2**30 for k, v in peaks.items()},
           "fetches": fetches, "text_kv_len": pipe.last_text_kv_len,
           "launches": dict(fa.LAUNCHES), "expected_launches": want,
           "video_shape": list(video.shape)}
    if rec["launches"] != want:
        raise AssertionError(f"launches {rec['launches']} != expected {want}")
    return rec, video, first[0]


def offload_phase(fa, steps: int, seed: int) -> dict:
    """The 480p 9:16 2 s request at full width and depth with T5-v1.1-XXL,
    served twice with the same weights: (a) every module resident; (b)
    cpu_offload=True with the STDiT3 loaded through
    OpenSoraConfig(transformer=<dir>) from (a)'s weights written there in
    the reference layout (fp32, two safetensors shards and an index). The
    first denoise steps must be equal, the videos within one level, no
    module on the card outside its phase in (b), and (b)'s peak below (a)'s
    by at least the T5's weight bytes."""
    import tempfile

    import numpy as np
    import torch

    from videosys_tpu_torch import OpenSoraConfig, VideoSysEngine
    from videosys_tpu_torch.models.text_encoders.t5 import T5TextEncoder
    from videosys_tpu_torch.utils.safetensors_io import save_sharded

    req = dict(prompt=PROMPTS[0], resolution="480p", aspect_ratio="9:16",
               num_frames="2s")
    tok = WordTokenizer(T5_XXL["vocab_size"])
    model = t5_xxl(seed, torch.bfloat16)
    t5_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cfg = OpenSoraConfig(transformer=None, vae=None, text_encoder=None,
                         dtype="bf16", num_sampling_steps=steps)
    dense = VideoSysEngine(cfg, seed=seed, text_encoder=T5TextEncoder(
        max_length=300, dtype=torch.bfloat16, tokenizer=tok, model=model))
    pipe = dense.pipeline
    pipe.text_encoder.encode(PROMPTS[:1])  # warm-up: time (a) warm as (b)
    modules = {"text_encoder": model, "transformer": pipe.transformer,
               "vae": pipe.vae}
    rec_a, video_a, first_a = offload_request(fa, dense, req, seed, steps,
                                              modules)
    log("offload (a) dense, T5 resident:", json.dumps(rec_a))

    out = {"t5_weight_gib": t5_bytes / 2**30, "dense": rec_a}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        t0 = time.perf_counter()
        save_sharded({k: v.float() for k, v in
                      pipe.transformer.state_dict().items()}, ckpt, shards=2)
        out["checkpoint_write_s"] = time.perf_counter() - t0
        out["checkpoint_gib"] = sum(
            f.stat().st_size for f in Path(ckpt).iterdir()) / 2**30
        vae = pipe.vae
        del dense, pipe, modules
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        t5 = T5TextEncoder(max_length=300, dtype=torch.bfloat16, offload=True,
                           tokenizer=tok, model=model)
        out["t5_to_host_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        off = VideoSysEngine(
            OpenSoraConfig(transformer=ckpt, vae=None, text_encoder=None,
                           dtype="bf16", num_sampling_steps=steps,
                           cpu_offload=True),
            seed=seed, vae=vae, text_encoder=t5)
        out["checkpoint_load_s"] = time.perf_counter() - t0
    pipe = off.pipeline
    modules = {"text_encoder": model, "transformer": pipe.transformer,
               "vae": pipe.vae}
    resident = [(name, n) for name, m in modules.items()
                for n, p in m.named_parameters()
                if p.is_cuda or not p.is_pinned()]
    if resident:
        raise AssertionError(f"cpu_offload: not in pinned host memory: "
                             f"{resident[:3]}")
    rec_b, video_b, first_b = offload_request(fa, off, req, seed, steps,
                                              modules)
    log("offload (b) cpu_offload, checkpoint-loaded:", json.dumps(rec_b))
    on_card = [name for name, m in modules.items()
               if any(p.is_cuda for p in m.parameters())]
    level = int(np.abs(video_a.astype(int) - video_b.astype(int)).max())
    out.update(
        offload=rec_b, first_step_equal=bool(torch.equal(first_a, first_b)),
        first_step_max_abs_diff=float((first_a - first_b).abs().max()),
        video_max_level_diff=level,
        peak_saving_gib=rec_a["peak_mem_gib"]["request"]
        - rec_b["peak_mem_gib"]["request"])
    log(f"offload: write {out['checkpoint_write_s']:.2f} s "
        f"({out['checkpoint_gib']:.3f} GiB fp32, 2 shards), load "
        f"{out['checkpoint_load_s']:.2f} s, T5 to pinned host "
        f"{out['t5_to_host_s']:.2f} s; peak (a) "
        f"{rec_a['peak_mem_gib']['request']:.3f} GiB, (b) "
        f"{rec_b['peak_mem_gib']['request']:.3f} GiB (saving "
        f"{out['peak_saving_gib']:.3f}, T5 {out['t5_weight_gib']:.3f}); first "
        f"step equal={out['first_step_equal']}; video max level diff={level}")
    log("offload:", json.dumps({k: v for k, v in out.items()
                                if k not in ("dense", "offload")}))
    if on_card:
        raise AssertionError(f"cpu_offload: {on_card} left on the card")
    if not out["first_step_equal"]:
        raise AssertionError("cpu_offload: the first denoise step differs")
    if level > 1:
        raise AssertionError("cpu_offload: the video differs from dense")
    if out["peak_saving_gib"] < out["t5_weight_gib"]:
        raise AssertionError("cpu_offload: the peak fell by less than the "
                             "T5's weights")
    if rec_b["launches"] != rec_a["launches"]:
        raise AssertionError("cpu_offload changed the kernel launches")
    del off, pipe, modules, model, t5, vae
    torch.cuda.empty_cache()
    return out


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


# (name, B, H, Nq, Nk, D, masked, backward): 144p x 51 frames batch 4 is
# B*T = 60 rows of S = 144 tokens; 240p x 51 frames batch 2 is B*T = 30 rows
# of S = 405 tokens and B*S = 810 rows of T = 15; the dummy text has 8
# tokens, real captions up to 300; a 1080p image is one row of 8160 tokens.
# Rows of more than 8 keys take the blocked pair.
BWD_SHAPES = [("spatial144", 60, 16, 144, 144, 72, False, "blocked"),
              ("spatial", 30, 16, 405, 405, 72, False, "blocked"),
              ("temporal", 810, 16, 15, 15, 72, False, "fused"),
              ("cross8", 30, 16, 405, 8, 72, True, "fused"),
              ("cross300", 30, 16, 405, 300, 72, True, "blocked"),
              ("long_row", 1, 16, 8160, 8160, 72, False, "blocked")]


def backward_kernel_phase(fa, shapes=None) -> dict:
    """The three backward kernels, and the forward's log-sum-exp, against
    their plain versions at the training path's shapes (`BWD_SHAPES`, then
    each kernel's edges), or at `shapes` alone."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(1)
    edges = shapes is None
    shapes = BWD_SHAPES if shapes is None else shapes
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
    if edges:
        results["fused_edges"] = fused_backward_edges(fa)
        results["dkv_edges"] = dkv_edges(fa)
        results["dq_edges"] = dq_edges(fa)
    return results


def step_launches(fa, mc, thw, B: int, gas: int, policy: str,
                  text_len: int = 8) -> dict:
    """Kernel launches of one training step, by `LAUNCHES` key, from its
    shapes: per depth pair and micro-batch one spatial, one temporal
    (unless T = 1) and two cross attentions (to `text_len` keys: run_
    training's synthetic captions have 8); under recompute ("full" or
    "dots") every forward runs twice; every backward is
    `backward_variant`'s choice."""
    D = mc.hidden_size // mc.num_heads
    _, ph, pw = mc.patch_size
    T, Hpx, Wpx = thw
    t_lat = max(1, T // 17 * 5) if T > 1 else 1
    S = -(-(Hpx // 8) // ph) * -(-(Wpx // 8) // pw)
    calls = [(B * t_lat, S, S), (B * t_lat, S, text_len),
             (B * t_lat, S, text_len)]
    if t_lat > 1:
        calls.append((B * S, t_lat, t_lat))
    want = {key: 0 for key in fa.LAUNCHES}
    for rows, Nq, Nk in calls:
        n = mc.depth * gas
        want[fa.kernel_variant(mc.dtype, Nq, Nk, D)] += \
            n * (2 if policy != "none" else 1)
        variant = fa.backward_variant(rows, mc.num_heads, Nq, Nk, D, mc.dtype)
        for key in fa.backward_launch_keys(variant, mc.dtype, Nq, Nk):
            want[key] += n
    return want


def add_launches(total: dict, more: dict, times: int = 1) -> dict:
    for key, n in more.items():
        total[key] = total.get(key, 0) + n * times
    return total


def expected_train_launches(fa, cfg, history, text_len: int = 8) -> dict:
    """Kernel launches of the logged training steps, by `LAUNCHES` key, from
    their shapes and recompute policies (`step_launches`)."""
    want = {key: 0 for key in fa.LAUNCHES}
    for entry in history:
        add_launches(want, step_launches(
            fa, cfg.model, entry["thw"], entry["batch"], entry["gas"],
            entry.get("remat_policy", cfg.remat_policy), text_len))
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


# CogVideoX's published widths (the JAX package's pipeline_cogvideox.py
# :83-89): layers, heads of 64; the 2b serves with DDIM, the 5b with DPM
COG_WIDTHS = {"2b": (30, 30), "5b": (42, 48)}
COG_REQUEST = dict(prompt="a golden retriever running through a field of "
                   "sunflowers at sunset, cinematic", num_frames=49,
                   height=480, width=720)
COG_STEPS = 50  # the repo's default request (examples/inference/cogvideox)
# the 5b's DPM steps in a default run: 50 took 108.3 s of denoise on an
# H100 (2.17 s a step); 30 keep the whole script under 600 s
COG_5B_STEPS = 30
# query rows of one plain reference chunk at 17,776 keys (fp32 scores of
# one chunk: 73 MB a (batch, head) pair)
COG_CHUNK = 1024


def long_row(fa, name: str, B: int, H: int, N: int, D: int, gen) -> dict:
    """`flash_fwd_narrow` on one self-attention of N keys, [B, H, N, N, D]
    bf16: against the plain version in COG_CHUNK-row chunks over a sample
    of (batch, head) pairs that includes the last, held by check_bf16
    (BF16_LIMITS[name]) with a plain version that drops the last key as the
    fault; timed beside the chunked plain version over the whole shape and
    torch's scaled_dot_product_attention (a yardstick the port never
    calls)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (torch.randn(B, H, N, D, device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    variant = fa.kernel_variant(q.dtype, N, N, D)
    if variant != "narrow":
        raise AssertionError(f"{name}: dispatch says {variant}")
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    drop = drop_last_key(None, 1, N, "cuda")
    pairs = [(0, 0), (0, H // 2), (B - 1, H - 1)]
    outs, wants, faults = [], [], []
    for b, h in pairs:
        qs, ks, vs = (t[b:b + 1, h:h + 1] for t in (q, k, v))
        for r0 in range(0, N, COG_CHUNK):
            qc = qs[:, :, r0:r0 + COG_CHUNK]
            wants.append(fa.flash_attention_plain(qc, ks, vs))
            faults.append(fa.flash_attention_plain(qc, ks, vs, kv_mask=drop))
        outs.append(got[b:b + 1, h:h + 1])
    want = torch.cat(wants, dim=2).reshape(-1, D)
    fault = torch.cat(faults, dim=2).reshape(-1, D)
    sampled = torch.cat(outs, dim=2).reshape(-1, D)
    row = {"shape": [B, H, N, N, D], "variant": variant, "pairs": pairs,
           "max_abs_err": (sampled.float() - want.float()).abs().max().item()}
    row["bf16_check"] = check_bf16(name, sampled, want, fault)
    del wants, faults, want, fault, sampled, outs

    def plain_chunked():
        for r0 in range(0, N, COG_CHUNK):
            fa.flash_attention_plain(q[:, :, r0:r0 + COG_CHUNK], k, v)

    row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v), 5)
    row["plain_ms"] = time_ms(plain_chunked, 1)
    row["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v), 5)
    flops = 4.0 * B * H * N * N * D
    nbytes = 2.0 * B * H * 4 * N * D
    t_ops, t_bytes = flops / PEAK_FLOPS["bf16"], nbytes / PEAK_BYTES
    row["bound_ms"] = max(t_ops, t_bytes) * 1e3
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    row["tflops"] = flops / row["ms"] / 1e9
    log(f"kernel {name} bf16 shape={row['shape']} ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} (chunked) library_ms="
        f"{row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
        f"({row['bound_by']}) achieved={row['tflops']:.1f} TFLOP/s "
        f"max_abs_err={row['max_abs_err']:.3e}")
    del q, k, v, got
    torch.cuda.empty_cache()
    return row


def cog_kernel_phase(fa) -> dict:
    """`flash_fwd_narrow` at the joint attention of a 49 x 480 x 720
    request, [2, H, 17776, 17776, 64] bf16 (226 text + 13 * 30 * 45 video
    tokens, CFG batch 2), for the 2b (H = 30) and 5b (H = 48) widths
    (`long_row`)."""
    import torch

    gen = torch.Generator("cuda").manual_seed(8)
    return {name: long_row(fa, f"cog{name}", 2, H, 17776, 64, gen)
            for name, (_, H) in COG_WIDTHS.items()}


def phase_peaks(pipe) -> dict:
    """Record the peak card memory of each of the pipeline's phases (text,
    denoise, vae) into the returned dict: the peak is reset as a phase
    starts and read as it ends. `del pipe._phase` undoes it."""
    import contextlib

    import torch

    peaks = {}
    phase = pipe._phase

    @contextlib.contextmanager
    def probed(timer, module=None, name=""):
        torch.cuda.reset_peak_memory_stats()
        with phase(timer, module, name):
            yield
        peaks[timer] = max(peaks.get(timer, 0.0),
                           torch.cuda.max_memory_allocated() / 2**30)

    pipe._phase = probed
    return peaks


def cog_request(fa, engine, label: str, steps: int, seed: int, plans=None,
                **extra) -> dict:
    """One `generate` of the 49 x 480 x 720 request with the launch counts
    set to 0 just before it and read just after, held against the plans:
    one joint attention a layer and step, less the steps whose plan reads
    it from the PAB cache, all on `narrow`; the VAE has no attention."""
    import numpy as np
    import torch

    pipe = engine.pipeline
    mc = pipe.model_config
    peaks = phase_peaks(pipe)
    fa.reset_launches()
    try:
        t0 = time.perf_counter()
        video = engine.generate(seed=seed, num_inference_steps=steps,
                                **COG_REQUEST, **extra).video
        wall = time.perf_counter() - t0
    finally:
        del pipe._phase
    launches = dict(fa.LAUNCHES)
    want = {key: 0 for key in fa.LAUNCHES}
    _, F_lat, _, h, w = pipe.latent_shape(COG_REQUEST["num_frames"],
                                          COG_REQUEST["height"],
                                          COG_REQUEST["width"])
    p = mc.patch_size
    N = mc.max_text_seq_length + F_lat * (h // p) * (w // p)
    computed = sum(not plan.spatial for plan in plans) if plans else steps
    want[fa.kernel_variant(pipe.dtype, N, N, mc.head_dim)] = \
        mc.num_layers * computed
    lat = pipe.last_latents
    rec = {"label": label, "layers": mc.num_layers, "heads": mc.num_heads,
           "scheduler": engine.config.scheduler, "steps": steps,
           "video_shape": list(video.shape), "video_dtype": str(video.dtype),
           "latents_finite": bool(np.isfinite(lat).all()),
           "latent_std": float(lat.std()), "video_mean": float(video.mean()),
           "timings_s": pipe.last_timings, "wall_s": wall,
           "denoise_step_s": pipe.last_timings["denoise"] / steps,
           "peak_mem_gib_by_phase": peaks, "launches": launches,
           "expected_launches": want, **{k: v for k, v in extra.items()}}
    log(f"cogvideox {label}:", json.dumps(rec))
    frames, height, width = (COG_REQUEST[k] for k in ("num_frames", "height",
                                                      "width"))
    if video.shape != (1, frames, height, width, 3) or video.dtype != np.uint8:
        raise AssertionError(f"cogvideox {label}: bad video {video.shape} "
                             f"{video.dtype}")
    if not rec["latents_finite"]:
        raise AssertionError(f"cogvideox {label}: non-finite latents")
    if launches != want:
        raise AssertionError(f"cogvideox {label}: launches {launches} != "
                             f"expected {want}")
    torch.cuda.empty_cache()
    return rec


def profile_cog_step(pipe, seed: int) -> dict:
    """Device time of one CFG-doubled 2b transformer step at the request's
    shapes by kernel (`device_profile`)."""
    import torch

    shape = pipe.latent_shape(COG_REQUEST["num_frames"], COG_REQUEST["height"],
                              COG_REQUEST["width"], 2)
    g = torch.Generator("cuda").manual_seed(seed)
    z = torch.randn(shape, device="cuda", generator=g).to(pipe.dtype)
    enc = torch.randn(2, 226, pipe.model_config.text_embed_dim, device="cuda",
                      generator=g).to(pipe.dtype)
    t = torch.full((2,), 500.0, device="cuda")

    def step():
        with torch.no_grad():
            pipe.transformer(z, enc, t)

    return device_profile("cogvideox-2b (one 49 x 480 x 720 transformer step, "
                          "CFG batch 2)", step)


def device_profile(label: str, step) -> dict:
    """The wall time of `step` (CUDA events) and its device time by kernel
    (torch.profiler): busy time, idle share, attention's share, the top
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = time_ms(step, 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    attn = sum(e.self_device_time_total for e in events
               if "flash_fwd" in e.key)
    res = {"step_wall_ms": wall_ms, "device_busy_ms": total / 1e3,
           "idle_share": max(0.0, 1 - total / 1e3 / wall_ms),
           "attention_ms": attn / 1e3,
           "attention_share": attn / max(total, 1),
           "top": [{"name": e.key[:90], "calls": e.count,
                    "ms": e.self_device_time_total / 1e3,
                    "share": e.self_device_time_total / max(total, 1)}
                   for e in rows]}
    log(f"profile {label}:", json.dumps(res))
    return res


def t2v_step(pipe, seed: int, text_len: int):
    """One CFG-doubled transformer call of a Latte or Open-Sora-Plan
    pipeline at its request's latent shape (`latent_shape(2)` for
    Open-Sora-Plan, Latte's default request otherwise), on seeded inputs
    with `text_len` caption tokens."""
    import torch

    if hasattr(pipe, "version"):
        shape, v110 = pipe.latent_shape(2), pipe.version == "v110"
    else:
        shape, v110 = pipe.latent_shape(
            LATTE_REQUEST["video_length"], LATTE_REQUEST["height"],
            LATTE_REQUEST["width"], 2), True
    dev = pipe.device
    g = torch.Generator(dev).manual_seed(seed)
    z = torch.randn(shape, device=dev, generator=g).to(pipe.dtype)
    y = torch.randn(2, text_len, pipe.model_config.caption_channels,
                    device=dev, generator=g).to(pipe.dtype)
    t = torch.full((2,), 500.0, device=dev)

    def step():
        with torch.no_grad():
            if v110:  # LatteT2V: (x, t, y)
                pipe.transformer(z, t, y)
            else:
                pipe.transformer(z, y, t)
    return step


def host_tables_ab(label: str, pipe, step) -> dict:
    """`step` of Open-Sora-Plan v1.2 with its 3D RoPE tables held on the
    card against the same step with them on the host (copied to the card
    at every use, for q and k in every layer), timed A B B A in this
    process."""
    import numpy as np

    step()  # fills the table cache for the step's shape
    tables = pipe.transformer._tables
    device = dict(tables)
    host = {k: tuple(np.asarray(a.cpu()) for a in v) for k, v in device.items()}
    times = {"device": [], "host": []}
    for which in ("device", "host", "host", "device"):
        tables.clear()
        tables.update(device if which == "device" else host)
        times[which].append(time_ms(step, 3))
    tables.clear()
    tables.update(device)
    res = {k: sum(v) / len(v) for k, v in times.items()}
    res["host_over_device"] = res["host"] / res["device"]
    log(f"rope tables {label} (ms a step, A B B A):", json.dumps(res))
    return res


def cogvideox_phase(fa, seed: int, steps_5b: int,
                    profile: bool = False) -> dict:
    """CogVideoX text-to-video at its published widths and full depth,
    random weights from `seed`, the stub text encoder (226 tokens): the 2b
    over 50 DDIM steps, dense and with PAB; the 5b with DPM and dynamic CFG
    over `steps_5b` steps; then the narrow forward at both joint-attention
    shapes against its plain version (`cog_kernel_phase`)."""
    import numpy as np
    import torch

    from videosys_tpu_torch import (CogVideoXConfig, CogVideoXPABConfig,
                                    VideoSysEngine)
    from videosys_tpu_torch.core.pab import build_plans
    from videosys_tpu_torch.models.transformers.cogvideox import (
        CogVideoXConfig as ModelConfig)

    out = {}
    launches = {}
    for name, (layers, heads) in COG_WIDTHS.items():
        t0 = time.perf_counter()
        five = name == "5b"
        engine = VideoSysEngine(CogVideoXConfig(
            model_path=None, dtype="bf16", scheduler="dpm" if five else "ddim",
            transformer_config=ModelConfig(
                num_layers=layers, num_heads=heads,
                use_rotary_positional_embeddings=five)), seed=seed)
        pipe = engine.pipeline
        pipe.keep_latents = True
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in pipe.transformer.parameters())
        log(f"cogvideox-{name}: layers={layers} heads={heads} hidden="
            f"{pipe.model_config.hidden_size} params={n_params / 1e9:.3f}B "
            f"weights_gib={n_params * 2 / 2**30:.2f} dtype=bf16 "
            f"init_s={time.perf_counter() - t0:.2f}")
        if not five:
            dense = cog_request(fa, engine, "2b dense", COG_STEPS, seed)
            pab = CogVideoXPABConfig()
            engine.config.enable_pab, engine.config.pab_config = True, pab
            plans = build_plans(pab, pipe.scheduler.set_timesteps(
                COG_STEPS).astype(np.float32), layers)
            rec = cog_request(fa, engine, "2b pab", COG_STEPS, seed, plans)
            rec.update(cache_gib=pipe.last_pab_cache_bytes / 2**30,
                       read_steps=sum(p.spatial for p in plans),
                       denoise_vs_dense=dense["timings_s"]["denoise"]
                       / rec["timings_s"]["denoise"])
            log(f"cogvideox 2b pab: cache_gib={rec['cache_gib']:.3f} "
                f"read_steps={rec['read_steps']} denoise_vs_dense="
                f"{rec['denoise_vs_dense']:.3f}")
            engine.config.enable_pab = False
            out["2b"] = {"dense": dense, "pab": rec}
            launches["2b"] = dense["launches"]
            if profile:
                out["profile_2b"] = profile_cog_step(pipe, seed)
        else:
            log(f"cogvideox-5b: {steps_5b} of the request's {COG_STEPS} DPM "
                f"steps (cut to keep the script inside its time; width, "
                f"depth and shapes are the published ones)")
            out["5b"] = cog_request(fa, engine, "5b dpm", steps_5b, seed,
                                    use_dynamic_cfg=True)
            launches["5b"] = out["5b"]["launches"]
        del engine, pipe
        torch.cuda.empty_cache()
    out["kernel"] = cog_kernel_phase(fa)
    out["launches"] = launches
    return out


# bf16 tiny CogVideoX, card (narrow kernel) against the CPU (plain): the
# final latents' (rel_l2, rel_max) after 4 steps, read on an H100 at
# 2.17e-2, 1.92e-2 (bf16 rounding compounds over the steps)
COG_TINY_BF16_LIMITS = (5e-2, 5e-2)


def tiny_cogvideox_parity(seed: int) -> dict:
    """A tiny CogVideoX (two layers, the 5b's RoPE) on the card and on the
    CPU with the same weights, latents and draws: fp32 with DDIM dense and
    with DPM + PAB (latents 2e-4, video one level), and bf16 with DDIM
    (latents held at COG_TINY_BF16_LIMITS)."""
    import numpy as np
    import torch

    from videosys_tpu_torch import (CogVideoXConfig, CogVideoXPABConfig,
                                    VideoSysEngine)
    from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import (
        CogVideoXVAEConfig)
    from videosys_tpu_torch.models.transformers.cogvideox import (
        CogVideoXConfig as ModelConfig)

    def engine(device, dtype, scheduler, pab, params=None):
        cfg = CogVideoXConfig(
            model_path=None, dtype=dtype, scheduler=scheduler,
            enable_pab=pab, vae_tiling=False,
            pab_config=CogVideoXPABConfig(),
            transformer_config=ModelConfig(
                num_layers=2, num_heads=2, head_dim=16, in_channels=4,
                out_channels=4, time_embed_dim=16, text_embed_dim=16,
                max_text_seq_length=8, use_rotary_positional_embeddings=True),
            vae_config=CogVideoXVAEConfig(
                latent_channels=4, block_out_channels=(8, 8, 16, 16),
                layers_per_block=1, norm_num_groups=4))
        eng = VideoSysEngine(cfg, device=device, params=params, seed=seed)
        eng.pipeline.keep_latents = True
        return eng

    out = {}
    for label, dtype, scheduler, pab in (("fp32 ddim", "fp32", "ddim", False),
                                         ("fp32 dpm pab", "fp32", "dpm", True),
                                         ("bf16 ddim", "bf16", "ddim", False)):
        card = engine("cuda", dtype, scheduler, pab)
        params = {name: {k: v.float().cpu().numpy()
                         for k, v in m.state_dict().items()}
                  for name, m in (("transformer", card.pipeline.transformer),
                                  ("vae", card.pipeline.vae))}
        cpu = engine("cpu", dtype, scheduler, pab, params)
        shape = card.pipeline.latent_shape(9, 32, 32)
        z = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
        videos, lats = [], []
        for eng in (card, cpu):
            draws = torch.Generator().manual_seed(seed + 1)
            noise = lambda name, s, g=draws: torch.randn(s, generator=g)
            videos.append(eng.generate("waves at dusk", latents=z, noise=noise,
                                       num_inference_steps=4, num_frames=9,
                                       height=32, width=32, seed=seed).video)
            lats.append(torch.from_numpy(eng.pipeline.last_latents))
        px_err = int(np.abs(videos[0].astype(int)
                            - videos[1].astype(int)).max())
        if dtype == "fp32":
            lat_err = float((lats[0] - lats[1]).abs().max())
            ok = lat_err <= 2e-4 and px_err <= 1
            res = {"latent_max_abs_err": lat_err, "video_max_level_diff": px_err}
            msg = f"latent max_abs_err={lat_err:.3e} (tol 2e-4) video max " \
                  f"level diff={px_err} (tol 1)"
        else:
            l2, mx = rel_errors(lats[0], lats[1])
            ok = l2 <= COG_TINY_BF16_LIMITS[0] and mx <= COG_TINY_BF16_LIMITS[1]
            res = {"latent_rel_l2": l2, "latent_rel_max": mx,
                   "video_max_level_diff": px_err}
            msg = f"latent rel_l2={l2:.3e} rel_max={mx:.3e} (limits " \
                  f"{COG_TINY_BF16_LIMITS}) video max level diff={px_err}"
        log(f"tiny parity cogvideox {label} (card kernel vs CPU plain, 9 x 32 "
            f"x 32, 4 steps): {msg}")
        if not ok:
            raise AssertionError(f"card and CPU paths disagree on the tiny "
                                 f"CogVideoX ({label})")
        out[label] = res
    return out


# Latte-1's default request (examples/inference/latte): 16 x 512 x 512,
# 50 DDIM steps, guidance 7.5
LATTE_REQUEST = dict(prompt="a panda playing a guitar on a mossy rock in a "
                     "bamboo forest, cinematic", video_length=16, height=512,
                     width=512, guidance_scale=7.5, num_inference_steps=50)
OSP_PROMPT = "a red sports car driving along a coastal road at sunset"
# Euler-Ancestral steps of the v1.2 29 x 480p requests and PNDM steps of the
# v1.1 65 x 512 x 512 request (the pipeline's default is 100 for both: 100
# Euler calls of 0.535 s and 109 PNDM calls of 0.508 s on an H100); the
# 93 x 480p request runs one step and its whole tiled decode
OSP_V120_STEPS = 50
OSP_V120_93_STEPS = 1
OSP_V110_STEPS = 20


def latte_launches(fa, pipe, steps: int, T: int, S: int, text_len: int,
                   plans=None) -> dict:
    """Kernel launches of a LatteT2V denoise loop by variant: per step and
    depth a spatial (S x S), a cross (S x the bucketed text) and a temporal
    (T x T) attention, less what the step's plan reads from the PAB cache
    (MLP reads launch nothing either way)."""
    mc = pipe.model_config
    want = {key: 0 for key in fa.LAUNCHES}
    for plan in plans or [None] * steps:
        calls = []
        if plan is None or not plan.spatial:
            calls.append((S, S))
        if plan is None or not plan.cross:
            calls.append((S, text_len))
        if T > 1 and (plan is None or not plan.temporal):
            calls.append((T, T))
        for nq, nk in calls:
            want[fa.kernel_variant(pipe.dtype, nq, nk, mc.head_dim)] += mc.depth
    return want


def osp_v120_launches(fa, pipe, steps: int, N: int, text_len: int,
                      plans=None) -> dict:
    """The same for OpenSoraT2V: per step and layer a self-attention over N
    tokens and a cross-attention to the text, less the plan's reads."""
    mc = pipe.model_config
    want = {key: 0 for key in fa.LAUNCHES}
    for plan in plans or [None] * steps:
        calls = [] if plan is not None and plan.spatial else [(N, N)]
        if plan is None or not plan.cross:
            calls.append((N, text_len))
        for nq, nk in calls:
            want[fa.kernel_variant(pipe.dtype, nq, nk, mc.head_dim)] += mc.depth
    return want


def vae_width(pipe) -> int:
    """The causal VAE's mid width: its mid attention's head_dim."""
    cfg = pipe.vae.config
    return cfg.hidden_size * cfg.hidden_size_mult[-1]


def causal_vae_tiles(vae, T: int, H: int, W: int) -> list:
    """The latent blocks [t, h, w] the causal VAE's decode runs its decoder
    on, one mid attention each: the temporal chunks, each cut into the 2D
    tiles, or the whole latent when tiling is off or it fits one tile."""
    lat, lat_t = vae.tile_latent_min_size, vae.tile_latent_min_size_t
    if not vae.use_tiling or (H <= lat and W <= lat and T <= lat_t):
        return [(T, H, W)]
    step = int(lat * (1 - vae.tile_overlap_factor))
    tiles = []
    for s, e in vae._t_chunks(T, lat_t):
        if H <= lat and W <= lat:
            tiles.append((e - s, H, W))
            continue
        tiles += [(e - s, min(lat, H - i), min(lat, W - j))
                  for i in range(0, H, step) for j in range(0, W, step)]
    return tiles


def t2v_request(fa, engine, label: str, expected, n_frames: int, seed: int,
                videos=None, **gen) -> dict:
    """One `generate` with the launch counts set to 0 just before it and
    read just after, held against `expected(pipe)`; timers, the peak of
    each phase, the video's shape (`n_frames` x H x W) and finite latents.
    The video is appended to `videos` when given."""
    import numpy as np
    import torch

    pipe = engine.pipeline
    calls = len(pipe.scheduler.set_timesteps(gen["num_inference_steps"]))
    peaks = phase_peaks(pipe)
    fa.reset_launches()
    try:
        t0 = time.perf_counter()
        video = engine.generate(seed=seed, **gen).video
        wall = time.perf_counter() - t0
    finally:
        del pipe._phase
    launches = dict(fa.LAUNCHES)
    want = expected(pipe)
    if videos is not None:
        videos.append(video)
    lat = pipe.last_latents
    rec = {"label": label, "steps": gen["num_inference_steps"],
           "model_calls": calls, "video_shape": list(video.shape),
           "video_dtype": str(video.dtype),
           "latents_finite": bool(np.isfinite(lat).all()),
           "latent_std": float(lat.std()), "video_mean": float(video.mean()),
           "timings_s": pipe.last_timings, "wall_s": wall,
           "denoise_call_s": pipe.last_timings["denoise"] / calls,
           "text_kv_len": getattr(pipe, "last_text_kv_len", None),
           "peak_mem_gib_by_phase": peaks, "launches": launches,
           "expected_launches": want}
    log(f"{label}:", json.dumps(rec))
    if video.dtype != np.uint8 or video.shape[:2] != (1, n_frames) \
            or video.shape[-1] != 3:
        raise AssertionError(f"{label}: bad video {video.shape} {video.dtype}")
    if not rec["latents_finite"]:
        raise AssertionError(f"{label}: non-finite latents")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != expected {want}")
    torch.cuda.empty_cache()
    return rec


def pab_summary(label: str, plans, dense: dict, rec: dict, pipe) -> dict:
    """Read steps by branch (the MLP rows too) and the denoise speed-up of
    a PAB request against the dense one on the same weights."""
    mlp = sum(sum(p.mlp_spatial_use) + sum(p.mlp_temporal_use) for p in plans)
    out = {"read_steps": {b: sum(getattr(p, b) for p in plans)
                          for b in ("spatial", "temporal", "cross")},
           "mlp_row_reads": mlp,
           "mlp_read_steps": sum(any(p.mlp_spatial_use) or
                                 any(p.mlp_temporal_use) for p in plans),
           "cache_gib": pipe.last_pab_cache_bytes / 2**30,
           "denoise_vs_dense": dense["timings_s"]["denoise"]
           / rec["timings_s"]["denoise"]}
    log(f"{label}: {json.dumps(out)}")
    return out


def model_line(name: str, pipe, t0: float) -> None:
    import torch

    torch.cuda.synchronize()
    mc = pipe.model_config
    n = sum(p.numel() for p in pipe.transformer.parameters())
    log(f"{name}: layers={mc.num_layers} heads={mc.num_heads}x{mc.head_dim} "
        f"hidden={mc.hidden_size} params={n / 1e9:.3f}B weights_gib="
        f"{n * 2 / 2**30:.2f} dtype=bf16 init_s={time.perf_counter() - t0:.2f}")


def latte_phase(fa, seed: int, profile: bool = False) -> dict:
    """Latte-1 text-to-video at full width and depth (28 pairs, 16 heads x
    72, the SD VAE), random weights from `seed`, the stub text encoder (120
    tokens): the default request dense and under LattePABConfig(), then
    the kernels at the transformer's spatial, cross and temporal rows and
    at the VAE's mid attention against their plain versions, then a tiny
    Latte with PAB on the card against the CPU. `profile`: one
    transformer step by kernel."""
    import numpy as np
    import torch

    from videosys_tpu_torch import LatteConfig, LattePABConfig, VideoSysEngine
    from videosys_tpu_torch.core.pab import build_plans

    t0 = time.perf_counter()
    engine = VideoSysEngine(LatteConfig(model_path=None, dtype="bf16"),
                            seed=seed)
    pipe = engine.pipeline
    pipe.keep_latents = True
    model_line("latte-1", pipe, t0)
    req = dict(LATTE_REQUEST)
    T = req["video_length"]
    shape = pipe.latent_shape(T, req["height"], req["width"])
    p = pipe.model_config.patch_size
    S = (shape[3] // p) * (shape[4] // p)
    n_mid, d_mid = shape[3] * shape[4], pipe.vae.block_out_channels[-1]
    steps = req["num_inference_steps"]

    def expected(plans):
        def fn(pipe):
            want = latte_launches(fa, pipe, steps, T, S, pipe.last_text_kv_len,
                                  plans)
            # the VAE decodes the B x T frames in one call
            want[fa.kernel_variant(pipe.dtype, n_mid, n_mid, d_mid)] += 1
            return want
        return fn

    dense = t2v_request(fa, engine, "latte dense", expected(None), T, seed,
                        **req)
    pab = LattePABConfig()
    engine.config.enable_pab, engine.config.pab_config = True, pab
    plans = build_plans(pab, pipe.scheduler.set_timesteps(steps).astype(
        np.float32), pipe.model_config.depth)
    rec = t2v_request(fa, engine, "latte pab", expected(plans), T, seed, **req)
    rec.update(pab_summary("latte pab", plans, dense, rec, pipe))
    engine.config.enable_pab = False
    prof = None
    if profile:
        prof = device_profile("latte-1 (one 16 x 512 x 512 transformer step, "
                              "CFG batch 2)",
                              t2v_step(pipe, seed, dense["text_kv_len"]))
    pipe_heads = pipe.model_config.num_heads, pipe.model_config.head_dim
    del engine, pipe
    torch.cuda.empty_cache()
    # the transformer's rows (CFG batch 2): spatial over the S patches of
    # each frame, cross to the bucketed text, temporal over the T frames of
    # each patch; then the VAE's mid attention
    H, D = pipe_heads
    kernel = forward_shapes(fa, [
        ("latte_spatial", 2 * T, H, S, S, D, False),
        ("latte_cross", 2 * T, H, S, dense["text_kv_len"], D, True),
        ("latte_temporal16", 2 * S, H, T, T, D, False),
        ("latte_vae_mid", T, 1, n_mid, n_mid, d_mid, False)], seed=12,
        dtypes=("bf16",))
    return {"dense": dense, "pab": rec, "kernel": kernel, "profile": prof,
            "tiny": tiny_latte_parity(seed)}


def open_sora_plan_phase(fa, seed: int, profile: bool = False) -> dict:
    """Open-Sora-Plan text-to-video at full width and depth, random weights
    from `seed`, the stub text encoder: v1.2 (32 layers, 24 heads x 96, 3D
    RoPE, Euler-Ancestral) at 29 x 480p dense and under
    OpenSoraPlanV120PABConfig(), and at 93 x 480p (28,800 tokens) for
    OSP_V120_93_STEPS with the whole tiled decode of 93 frames; v1.1
    (28 pairs with RoPE, PNDM) at 65 x 512 x 512 with its pre-fix VAE
    attention, dense and under OpenSoraPlanV110PABConfig() (MLP rows
    read); then the kernels at the new shapes against their plain
    versions, and tiny v1.1 and v1.2 pipelines on the card against the
    CPU. `profile`: one 29 x 480p transformer step by kernel, and that step
    with the RoPE tables on the host against the card."""
    import numpy as np
    import torch

    from videosys_tpu_torch import (OpenSoraPlanConfig,
                                    OpenSoraPlanV110PABConfig,
                                    OpenSoraPlanV120PABConfig, VideoSysEngine)
    from videosys_tpu_torch.core.pab import build_plans
    from videosys_tpu_torch.models.transformers.open_sora_plan_v110 import (
        OpenSoraPlanV110Config)

    out = {}
    for ttype, steps in (("29x480p", OSP_V120_STEPS),
                         ("93x480p", OSP_V120_93_STEPS)):
        t0 = time.perf_counter()
        engine = VideoSysEngine(OpenSoraPlanConfig(
            version="v120", transformer_type=ttype, dtype="bf16"), seed=seed)
        pipe = engine.pipeline
        pipe.keep_latents = True
        model_line(f"open-sora-plan v1.2 {ttype}", pipe, t0)
        log(f"open-sora-plan v1.2 {ttype}: {steps} of the pipeline's 100 "
            f"Euler-Ancestral steps (cut to keep the script inside its time; "
            f"widths, depth and shapes are the published ones)")
        _, _, T, h, w = pipe.latent_shape()
        N = T * pipe._tokens(pipe.latent_shape())
        tiles = causal_vae_tiles(pipe.vae, T, h, w)

        def expected(plans, steps=steps, N=N, tiles=tiles):
            def fn(pipe):
                want = osp_v120_launches(fa, pipe, steps, N,
                                         pipe.last_text_kv_len, plans)
                for _, th, tw in tiles:
                    want[fa.kernel_variant(pipe.dtype, th * tw, th * tw,
                                           vae_width(pipe))] += 1
                return want
            return fn

        frames = engine.config.num_frames
        dense = t2v_request(fa, engine, f"osp v1.2 {ttype} dense",
                            expected(None), frames, seed, prompt=OSP_PROMPT,
                            num_inference_steps=steps)
        dense["tokens"], dense["vae_tiles"] = N, tiles
        out[ttype] = {"dense": dense}
        if ttype == "29x480p":
            pab = OpenSoraPlanV120PABConfig()
            engine.config.enable_pab, engine.config.pab_config = True, pab
            plans = build_plans(pab, np.asarray(pipe.scheduler.set_timesteps(
                steps), np.float32), pipe.model_config.depth)
            rec = t2v_request(fa, engine, f"osp v1.2 {ttype} pab",
                              expected(plans), frames, seed, prompt=OSP_PROMPT,
                              num_inference_steps=steps)
            rec.update(pab_summary(f"osp v1.2 {ttype} pab", plans, dense, rec,
                                   pipe))
            out[ttype]["pab"] = rec
            engine.config.enable_pab = False
            if profile:
                step = t2v_step(pipe, seed, dense["text_kv_len"])
                out[ttype]["profile"] = device_profile(
                    f"open-sora-plan v1.2 (one {ttype} transformer step, CFG "
                    f"batch 2)", step)
                out[ttype]["rope_tables"] = host_tables_ab(ttype, pipe, step)
                del step
        del engine, pipe
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = VideoSysEngine(OpenSoraPlanConfig(
        version="v110", transformer_type="65x512x512", dtype="bf16",
        transformer_config=OpenSoraPlanV110Config(
            "65x512x512", use_rope=True, dtype=torch.bfloat16)), seed=seed)
    pipe = engine.pipeline
    pipe.keep_latents = True
    model_line("open-sora-plan v1.1 65x512x512", pipe, t0)
    log(f"open-sora-plan v1.1 65x512x512: {OSP_V110_STEPS} of the pipeline's "
        f"100 PNDM steps (cut to keep the script inside its time; widths, "
        f"depth and shapes are the published ones)")
    _, _, T, h, w = pipe.latent_shape()
    S = pipe._tokens(pipe.latent_shape())
    tiles = causal_vae_tiles(pipe.vae, T, h, w)

    def expected110(plans):
        def fn(pipe):
            want = latte_launches(fa, pipe, len(pipe.scheduler.timesteps), T,
                                  S, pipe.last_text_kv_len, plans)
            for _, th, tw in tiles:
                want[fa.kernel_variant(pipe.dtype, th * tw, th * tw,
                                       vae_width(pipe))] += 1
            return want
        return fn

    frames = engine.config.num_frames
    dense = t2v_request(fa, engine, "osp v1.1 65x512x512 dense",
                        expected110(None), frames, seed, prompt=OSP_PROMPT,
                        num_inference_steps=OSP_V110_STEPS)
    dense["vae_tiles"] = tiles
    pab = OpenSoraPlanV110PABConfig()
    engine.config.enable_pab, engine.config.pab_config = True, pab
    plans = build_plans(pab, np.asarray(pipe.scheduler.set_timesteps(
        OSP_V110_STEPS), np.float32), pipe.model_config.depth)
    rec = t2v_request(fa, engine, "osp v1.1 65x512x512 pab", expected110(plans),
                      frames, seed, prompt=OSP_PROMPT,
                      num_inference_steps=OSP_V110_STEPS)
    rec.update(pab_summary("osp v1.1 65x512x512 pab", plans, dense, rec, pipe))
    engine.config.enable_pab = False
    out["65x512x512"] = {"dense": dense, "pab": rec}
    text_len110 = pipe.last_text_kv_len
    H110, D110 = pipe.model_config.num_heads, pipe.model_config.head_dim
    del engine, pipe
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(13)
    out["kernel"] = {"osp480": long_row(fa, "osp480", 2, 24, 9600, 96, gen),
                     "osp93": long_row(fa, "osp93", 2, 24, 28800, 96, gen)}
    out["kernel"].update(forward_shapes(fa, [
        ("osp_cross", 2, 24, 9600, out["29x480p"]["dense"]["text_kv_len"],
         96, True),
        ("temporal17", 2 * S, H110, T, T, D110, False),
        ("osp110_spatial", 2 * T, H110, S, S, D110, False),
        ("osp110_cross", 2 * T, H110, S, text_len110, D110, True),
        ("cvae_tile", 9, 1, 1024, 1024, 512, False),
        ("cvae_legacy", 17, 1, 1024, 1024, 512, False)], seed=14,
        dtypes=("bf16",)))
    out["tiny"] = tiny_osp_parity(seed)
    return out


def one_key_dropped(module=None):
    """A context in which every attention of the transformer blocks (those
    that call `module.scaled_dot_product_attention`; default
    `models.modules.blocks`) drops the last attended key of each row (a
    planted fault; on the card it still runs the kernel)."""
    import contextlib

    if module is None:
        from videosys_tpu_torch.models.modules import blocks as module

    sdpa = module.scaled_dot_product_attention

    def faulty(q, k, v, scale=None, kv_mask=None, force_flash=None):
        B, Nk = q.shape[0], k.shape[2]
        return sdpa(q, k, v, scale=scale, force_flash=force_flash,
                    kv_mask=drop_last_key(kv_mask, B, Nk, q.device))

    @contextlib.contextmanager
    def ctx():
        module.scaled_dot_product_attention = faulty
        try:
            yield
        finally:
            module.scaled_dot_product_attention = sdpa
    return ctx()


def tiny_parity(label: str, make, generate, seed: int,
                fault_module=None) -> dict:
    """A tiny fp32 pipeline on the card (kernels) and on the CPU (plain
    attention) with the same weights, latents and draws: the first model
    output within 2e-4, the final latents within 2e-4 of their largest
    magnitude (random weights drive them to 80-800, so an absolute 2e-4
    would hold fp32 rounding grown by the sampler), the video within one
    uint8 level. A card run whose attentions drop one key per row
    (`one_key_dropped(fault_module)`) must break both numeric limits."""
    import contextlib

    import numpy as np
    import torch

    card = make("cuda", None)
    params = {name: {k: v.cpu().numpy() for k, v in
                     getattr(card.pipeline, name).state_dict().items()}
              for name in ("transformer", "vae")}
    cpu = make("cpu", params)
    runs = []
    for eng, fault in ((card, False), (cpu, False), (card, True)):
        eng.pipeline.keep_latents = True
        outs = []
        hook = eng.pipeline.transformer.register_forward_hook(
            lambda m, a, o, outs=outs: outs.append(o.detach().float().cpu()))
        try:
            with (one_key_dropped(fault_module) if fault
                  else contextlib.nullcontext()):
                video = generate(eng)
        finally:
            hook.remove()
        runs.append((video, eng.pipeline.last_latents, outs[0].numpy()))

    def errors(got, want):
        return (float(np.abs(got[2] - want[2]).max()),
                float(np.abs(got[1] - want[1]).max()),
                int(np.abs(got[0].astype(int) - want[0].astype(int)).max()))

    out_err, lat_err, px_err = errors(runs[0], runs[1])
    f_out, f_lat, f_px = errors(runs[2], runs[1])
    scale = float(np.abs(runs[1][1]).max())
    log(f"tiny parity {label} (card kernel vs CPU plain, fp32): first model "
        f"output max_abs_err={out_err:.3e} (tol 2e-4, one key dropped "
        f"{f_out:.3e}) latent max_abs_err={lat_err:.3e} of max |latent| "
        f"{scale:.1f} (tol 2e-4 x {scale:.1f}, one key dropped {f_lat:.3e}) "
        f"video max level diff={px_err} (tol 1, one key dropped {f_px})")
    if not (out_err <= 2e-4 and lat_err <= 2e-4 * scale and px_err <= 1
            and runs[0][0].shape == runs[1][0].shape):
        raise AssertionError(f"card and CPU paths disagree on the tiny "
                             f"{label}")
    if f_out <= 2e-4 or f_lat <= 2e-4 * scale:
        raise AssertionError(f"tiny {label}: a limit lets a card run that "
                             f"drops one key pass")
    torch.cuda.empty_cache()
    return {"first_output_max_abs_err": out_err, "latent_max_abs_err": lat_err,
            "latent_max_abs": scale, "video_max_level_diff": px_err,
            "fault_first_output_max_abs_err": f_out,
            "fault_latent_max_abs_err": f_lat, "fault_video_max_level_diff":
            f_px}


def tiny_latte_parity(seed: int) -> dict:
    """Tiny Latte (two pairs, the SD VAE at two levels) under a PAB ladder
    that reads every slot kind, 5 DDIM steps."""
    import torch

    from videosys_tpu_torch import LatteConfig, LattePABConfig, VideoSysEngine
    from videosys_tpu_torch.models.transformers.latte import LatteConfig as MC

    pab = LattePABConfig(
        mlp_spatial_broadcast_config={800: {"block": [0, 1], "skip_count": 2}},
        mlp_temporal_broadcast_config={800: {"block": [1], "skip_count": 1}})

    def make(device, params):
        return VideoSysEngine(LatteConfig(
            model_path=None, dtype="fp32", enable_pab=True, pab_config=pab,
            transformer_config=MC(num_layers=2, num_heads=2, head_dim=16,
                                  caption_channels=16, video_length=4,
                                  sample_size=8),
            vae_config=dict(block_out_channels=(8, 16), layers_per_block=1,
                            num_groups=4)),
            device=device, params=params, seed=seed)

    z = torch.randn(1, 4, 4, 8, 8, generator=torch.Generator().manual_seed(seed))
    return tiny_parity("latte pab", make, lambda eng: eng.generate(
        "a cat playing piano", num_inference_steps=5, video_length=4,
        height=16, width=16, seed=seed, latents=z).video, seed)


def tiny_osp_parity(seed: int) -> dict:
    """Tiny Open-Sora-Plan pipelines (two layers, a two-level causal VAE):
    v1.1 with RoPE and PNDM over 4 steps, its pre-fix VAE attention; v1.2
    with Euler-Ancestral and PAB over 6 steps, the draws from one seeded
    CPU generator for both devices."""
    import torch

    from videosys_tpu_torch import (OpenSoraPlanConfig,
                                    OpenSoraPlanV120PABConfig, VideoSysEngine)
    from videosys_tpu_torch.models.autoencoders.autoencoder_causal_vae import (
        CausalVAEConfig)
    from videosys_tpu_torch.models.transformers.open_sora_plan_v110 import (
        OpenSoraPlanV110Config)
    from videosys_tpu_torch.models.transformers.open_sora_plan_v120 import (
        OpenSoraPlanV120Config)

    vae = dict(hidden_size=8, hidden_size_mult=(1, 2), num_res_blocks=1,
               encoder_resnet_blocks=("ResnetBlock3D",) * 2,
               decoder_resnet_blocks=("ResnetBlock3D",) * 2,
               encoder_spatial_downsample=("SpatialDownsample2x", ""),
               encoder_temporal_downsample=("TimeDownsample2x", ""),
               decoder_spatial_upsample=("", "SpatialUpsample2x"),
               decoder_temporal_upsample=("", "TimeUpsample2x"))
    out = {}
    for version, ttype, tcfg, vcfg, steps in (
            ("v110", "65x512x512", OpenSoraPlanV110Config(
                num_layers=2, num_heads=2, head_dim=24, caption_channels=32,
                sample_size=16, video_length=3, use_rope=True),
             CausalVAEConfig(**vae), 4),
            ("v120", "29x480p", OpenSoraPlanV120Config(
                num_layers=2, num_heads=2, head_dim=24, caption_channels=32,
                sample_size=(8, 8), sample_size_t=3),
             CausalVAEConfig(**dict(vae, encoder_attention="AttnBlock3DFix",
                                    decoder_attention="AttnBlock3DFix")), 6)):
        def make(device, params, version=version, ttype=ttype, tcfg=tcfg,
                 vcfg=vcfg):
            return VideoSysEngine(OpenSoraPlanConfig(
                version=version, transformer_type=ttype, dtype="fp32",
                enable_tiling=False, enable_pab=version == "v120",
                pab_config=(OpenSoraPlanV120PABConfig() if version == "v120"
                            else None),
                transformer_config=tcfg, vae_config=vcfg),
                device=device, params=params, seed=seed)

        shape = make("cpu", None).pipeline.latent_shape()
        z = torch.randn(shape, generator=torch.Generator().manual_seed(seed))

        def generate(eng, steps=steps, z=z):
            draws = torch.Generator().manual_seed(seed + 1)
            return eng.generate(
                "waves at dusk", num_inference_steps=steps, seed=seed,
                latents=z, draw=lambda name, s, g=draws: torch.randn(
                    s, generator=g)).video

        out[version] = tiny_parity(f"open-sora-plan {version}", make, generate,
                                   seed)
    return out


VCHITECT_REQUEST = dict(prompt="Sunset over the sea.", frames=40, height=288,
                        width=480, guidance_scale=7.5)
# the reference request's flow-match Euler steps
# (examples/inference/vchitect/sample.py)
VCHITECT_STEPS = 100
# the text towers of Vchitect-2.0's trio at their published widths (SD3's
# text_encoder and text_encoder_2 config.json); CLIP's vocabulary and 77
# positions are the CLIPTextConfig defaults
CLIP_L = dict(hidden_size=768, intermediate_size=3072, projection_dim=768,
              num_hidden_layers=12, num_attention_heads=12,
              hidden_act="quick_gelu")
CLIP_G = dict(hidden_size=1280, intermediate_size=5120, projection_dim=1280,
              num_hidden_layers=32, num_attention_heads=20, hidden_act="gelu")


def vchitect_launches(fa, pipe, steps: int, F: int, S: int, L: int,
                      plans=None) -> dict:
    """Kernel launches of a Vchitect denoise loop by variant: per step two
    forwards (uncond, cond), per block a spatial (S + L tokens of each
    frame), a cross (the F (S + L) tokens against the L context tokens of
    frame 0) and, with more than one frame, a temporal (the F frames of
    each token) attention, less what the step's plan reads from the PAB
    cache in every block but the last, which runs dense."""
    mc = pipe.model_config
    N = S + L
    want = {key: 0 for key in fa.LAUNCHES}
    for plan in plans or [None] * steps:
        for cached, blocks in ((True, mc.depth - 1), (False, 1)):
            def reads(branch):
                return cached and plan is not None and getattr(plan, branch)
            calls = [] if reads("spatial") else [(N, N)]
            if not reads("cross"):
                calls.append((F * N, L))
            if F > 1 and not reads("temporal"):
                calls.append((F, F))
            for nq, nk in calls:
                want[fa.kernel_variant(pipe.dtype, nq, nk, mc.head_dim)] += \
                    2 * blocks
    return want


class ClipWordTokenizer:
    """Stands in for CLIP's BPE tokenizer, so that the script needs no
    `transformers`: bos (vocab - 2), the words hashed to 1..vocab - 3, eos
    (vocab - 1), then `pad_id` (CLIP-L pads with its eos, CLIP-bigG with
    0), truncated to max_length with the eos kept; called as an HF
    tokenizer is."""

    def __init__(self, vocab_size: int, pad_id: int):
        self.vocab_size, self.pad_id = vocab_size, pad_id

    def __call__(self, texts, padding, max_length, truncation,
                 return_tensors):
        import zlib

        import numpy as np

        V = self.vocab_size
        ids = np.full((len(texts), max_length), self.pad_id, np.int64)
        for i, text in enumerate(texts):
            toks = [V - 2] + [1 + zlib.crc32(w.encode()) % (V - 3) for w in
                              text.split()[: max_length - 2]] + [V - 1]
            ids[i, : len(toks)] = toks
        return {"input_ids": ids}


def clip_text(seed: int, widths: dict):
    """A CLIP text tower on the card in fp32, weights drawn from `seed` as
    HF initializes them."""
    import torch

    from videosys_tpu_torch.models.text_encoders.clip import (
        CLIPTextConfig, CLIPTextModelWithProjection)

    torch.manual_seed(seed)
    with torch.device("cuda"):
        model = CLIPTextModelWithProjection(CLIPTextConfig(**widths))
    return model.eval().requires_grad_(False)


def cast_copy(model, make, dtype):
    """A copy of `model` in `dtype` (built on the meta device by `make`,
    its tensors cast one at a time)."""
    import torch

    with torch.device("meta"):
        copy = make(model.config)
    copy.load_state_dict({k: v.to(dtype) for k, v in model.state_dict().items()},
                         assign=True)
    return copy.eval()


def no_causal_mask():
    """A context in which CLIP's attention sees every token (its causal
    mask dropped: the fault the CLIP limits must catch)."""
    import contextlib

    import torch

    from videosys_tpu_torch.models.text_encoders import clip

    forward = clip.CLIPAttention.forward

    def unmasked(self, x):
        B, L, C = x.shape
        H = self.num_heads

        def heads(t):
            return t.reshape(B, L, H, C // H).transpose(1, 2)

        q = heads(self.q_proj(x) * (C // H) ** -0.5)
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(),
                          dim=-1).to(x.dtype)
        return self.out_proj(torch.matmul(p, v).transpose(1, 2).reshape(
            B, L, C))

    @contextlib.contextmanager
    def ctx():
        clip.CLIPAttention.forward = unmasked
        try:
            yield
        finally:
            clip.CLIPAttention.forward = forward
    return ctx()


def vchitect_text_phase(seed: int) -> dict:
    """Vchitect-2.0's CLIP-L + CLIP-bigG + T5-v1.1-XXL trio at its published
    widths, random weights from `seed`: the packed embeddings of a batch of
    prompts in bf16 against fp32 on the card (the CLIP rows with their
    pooled vectors, held at BF16_LIMITS["clip_l"] / ["clip_g"] with the
    causal mask dropped as the fault; the T5 rows of real tokens at
    ["t5_xxl"] with the relative bias dropped), the packed shapes, and the
    encode time of one prompt."""
    import torch

    from videosys_tpu_torch.models.text_encoders.clip import (
        CLIPTextModelWithProjection, ClipTextEncoder, VchitectTripleTextEncoder)
    from videosys_tpu_torch.models.text_encoders.t5 import (
        T5EncoderModel, T5TextEncoder)

    t0 = time.perf_counter()
    fp32 = {"clip_l": clip_text(seed, CLIP_L), "clip_g": clip_text(seed + 1, CLIP_G),
            "t5": t5_xxl(seed + 2, torch.float32)}
    bf16 = {k: cast_copy(m, T5EncoderModel if k == "t5" else
                         CLIPTextModelWithProjection, torch.bfloat16)
            for k, m in fp32.items()}
    V = fp32["clip_l"].config.vocab_size
    t5_tok = WordTokenizer(T5_XXL["vocab_size"])

    def trio(models, dtype):
        return VchitectTripleTextEncoder(
            clip_l=ClipTextEncoder(tokenizer=ClipWordTokenizer(V, V - 1),
                                   model=models["clip_l"], dtype=dtype),
            clip_g=ClipTextEncoder(tokenizer=ClipWordTokenizer(V, 0),
                                   model=models["clip_g"], dtype=dtype),
            t5=T5TextEncoder(max_length=256, dtype=dtype, tokenizer=t5_tok,
                             model=models["t5"]))

    enc32, enc16 = trio(fp32, torch.float32), trio(bf16, torch.bfloat16)
    init_s = time.perf_counter() - t0
    mask = torch.from_numpy(t5_tok(PROMPTS, 256, "max_length", True, True,
                                   True, "np")["attention_mask"]).cuda().bool()
    dl = CLIP_L["hidden_size"]
    dg = dl + CLIP_G["hidden_size"]

    def parts(out):
        emb, pooled = out
        return {"clip_l": (emb[:, :77, :dl], pooled[:, :CLIP_L["projection_dim"]]),
                "clip_g": (emb[:, :77, dl:dg], pooled[:, CLIP_L["projection_dim"]:]),
                "t5": emb[:, 77:][mask]}

    want, got = enc32.encode_dual(PROMPTS), enc16.encode_dual(PROMPTS)
    shapes = [list(t.shape) for t in got]
    if shapes != [[len(PROMPTS), 77 + 256, T5_XXL["d_model"]],
                  [len(PROMPTS), CLIP_L["projection_dim"]
                   + CLIP_G["projection_dim"]]]:
        raise AssertionError(f"vchitect text: packed shapes {shapes}")
    if got[0][:, :77, dg:].any():
        raise AssertionError("vchitect text: the CLIP rows are not zero-padded")
    with no_causal_mask():
        fault_clip = parts(enc16.encode_dual(PROMPTS))
    rel_bias = bf16["t5"].encoder.block[0].layer[0].SelfAttention \
        .relative_attention_bias.weight
    kept = rel_bias.data
    rel_bias.data = torch.zeros_like(kept)
    fault_t5 = parts(enc16.encode_dual(PROMPTS))
    rel_bias.data = kept
    want, got = parts(want), parts(got)
    res = {"init_s": init_s, "packed_shapes": shapes,
           "params": {k: sum(p.numel() for p in m.parameters())
                      for k, m in bf16.items()}}
    for name in ("clip_l", "clip_g"):
        res[name] = check_bf16(name, got[name], want[name], fault_clip[name],
                               fault_name="causal mask dropped")
    res["t5"] = check_bf16("t5_xxl", got["t5"], want["t5"], fault_t5["t5"],
                           fault_name="relative bias dropped")
    del enc32, fp32, want, fault_clip, fault_t5
    torch.cuda.empty_cache()
    res["encode_one_prompt_ms"] = median_ms(
        lambda: enc16.encode_dual([VCHITECT_REQUEST["prompt"]]), 5)
    log("vchitect text:", json.dumps(res))
    del enc16, bf16
    torch.cuda.empty_cache()
    return res


def vchitect_step(pipe, seed: int, F: int, h: int, w: int, L: int):
    """One transformer forward of the Vchitect request (batch 1: the
    pipeline runs uncond and cond apart) on seeded inputs."""
    import torch

    mc = pipe.model_config
    dev = pipe.device
    g = torch.Generator(dev).manual_seed(seed)
    z = torch.randn(1, F, mc.in_channels, h, w, device=dev,
                    generator=g).to(pipe.dtype)
    y = torch.randn(1, L, mc.joint_attention_dim, device=dev,
                    generator=g).to(pipe.dtype)
    pooled = torch.randn(1, mc.pooled_projection_dim, device=dev, generator=g)
    t = torch.full((1,), 500.0, device=dev)

    def step():
        with torch.no_grad():
            pipe.transformer(z, y, pooled, t)
    return step


def vchitect_phase(fa, seed: int, steps: int, profile: bool = False) -> dict:
    """Vchitect-2.0 text-to-video at full width and depth (18 joint blocks,
    18 heads x 64, the 16-channel SD3 VAE), random weights from `seed`, the
    stub encoder (77 + 256 tokens): the reference request dense and under
    VchitectPABConfig(), the PAB video scored against the dense one; then
    the kernels at the transformer's spatial, cross and temporal rows and
    at the VAE's mid attention against their plain versions, the text
    trio at its published widths, and tiny pipelines on the card against
    the CPU. `profile`: one transformer forward by kernel."""
    import numpy as np
    import torch

    from videosys_tpu_torch import VchitectConfig, VchitectPABConfig, VideoSysEngine
    from videosys_tpu_torch.core.pab import build_plans
    from videosys_tpu_torch.eval.metrics import evaluate_pair
    from videosys_tpu_torch.models.transformers.vchitect import VchitectModelConfig

    t0 = time.perf_counter()
    engine = VideoSysEngine(VchitectConfig(
        model_path=None, dtype="bf16",
        transformer_config=VchitectModelConfig(dtype=torch.bfloat16)),
        seed=seed)
    pipe = engine.pipeline
    pipe.keep_latents = True
    model_line("vchitect-2.0", pipe, t0)
    if steps != VCHITECT_STEPS:
        log(f"vchitect-2.0: {steps} of the request's {VCHITECT_STEPS} "
            f"flow-match Euler steps (cut to keep the script inside its "
            f"time; widths, depth and shapes are the published ones)")
    mc = pipe.model_config
    req = dict(VCHITECT_REQUEST, num_inference_steps=steps)
    F = req["frames"]
    _, _, _, h, w = pipe.latent_shape(F, req["height"], req["width"])
    S = (h // mc.patch_size) * (w // mc.patch_size)
    L = pipe.text_encoder.clip_len + pipe.text_encoder.t5_len
    d_mid = pipe.vae.block_out_channels[-1]

    def expected(plans):
        def fn(pipe):
            want = vchitect_launches(fa, pipe, steps, F, S, L, plans)
            # the VAE decodes the F frames in one call
            want[fa.kernel_variant(pipe.dtype, h * w, h * w, d_mid)] += 1
            return want
        return fn

    videos = []
    dense = t2v_request(fa, engine, "vchitect dense", expected(None), F, seed,
                        videos, **req)
    pab = VchitectPABConfig()
    engine.config.enable_pab, engine.config.pab_config = True, pab
    plans = build_plans(pab, np.asarray(pipe.scheduler.set_timesteps(steps),
                                        np.float32), mc.depth)
    rec = t2v_request(fa, engine, "vchitect pab", expected(plans), F, seed,
                      videos, **req)
    rec.update(pab_summary("vchitect pab", plans, dense, rec, pipe))
    engine.config.enable_pab = False
    t1 = time.perf_counter()
    quality = evaluate_pair(videos[1], videos[0])
    rec["quality"] = {"psnr_db": quality["psnr"]["value"],
                      "ssim": quality["ssim"]["value"],
                      "score_s": time.perf_counter() - t1}
    log("vchitect pab against dense (eval.metrics.evaluate_pair, random "
        "weights):", json.dumps(rec["quality"]))
    if not np.isfinite([rec["quality"]["psnr_db"], rec["quality"]["ssim"]]).all():
        raise AssertionError("vchitect: PAB quality is not finite")
    prof = None
    if profile:
        prof = device_profile(
            f"vchitect-2.0 (one {F} x {req['height']} x {req['width']} "
            f"transformer forward, batch 1)", vchitect_step(pipe, seed, F, h,
                                                            w, L))
    H, D = mc.num_heads, mc.head_dim
    del engine, pipe, videos
    torch.cuda.empty_cache()
    N = S + L
    kernel = forward_shapes(fa, [
        ("vchitect_spatial", F, H, N, N, D, False),
        ("vchitect_cross", 1, H, F * N, L, D, False),
        ("vchitect_temporal40", N, H, F, F, D, False),
        ("vchitect_vae_mid", F, 1, h * w, h * w, d_mid, False)], seed=15,
        dtypes=("bf16",))
    return {"dense": dense, "pab": rec, "kernel": kernel, "profile": prof,
            "text": vchitect_text_phase(seed), "tiny": tiny_vchitect_parity(seed)}


def tiny_vchitect_parity(seed: int) -> dict:
    """Tiny Vchitect pipelines (three blocks, the 2D VAE at two levels),
    8 flow-match steps on four frames, dense and under VchitectPABConfig()
    (every branch read on some step)."""
    import torch

    from videosys_tpu_torch import VchitectConfig, VideoSysEngine
    from videosys_tpu_torch.models.transformers import vchitect
    from videosys_tpu_torch.models.transformers.vchitect import VchitectModelConfig

    z = torch.randn(1, 4, 16, 16, 16,
                    generator=torch.Generator().manual_seed(seed))
    out = {}
    for label, pab in (("dense", False), ("pab", True)):
        def make(device, params, pab=pab):
            return VideoSysEngine(VchitectConfig(
                model_path=None, dtype="fp32", enable_pab=pab,
                transformer_config=VchitectModelConfig(
                    num_layers=3, num_heads=2, head_dim=16,
                    joint_attention_dim=32, pooled_projection_dim=24,
                    sample_size=8, pos_embed_max_size=12),
                vae_config=dict(block_out_channels=(8, 16), layers_per_block=1,
                                num_groups=4)),
                device=device, params=params, seed=seed)

        out[label] = tiny_parity(f"vchitect {label}", make, lambda eng: eng.generate(
            "a ship sailing at dawn", num_inference_steps=8, width=32,
            height=32, frames=4, seed=seed, latents=z).video, seed,
            fault_module=vchitect)
    return out


# the buckets of the DCP and raw-video phases: the default configuration's
# two 51-frame video shapes with its batch sizes
DCP_BUCKETS = {"144p": {51: (1.0, 4)}, "240p": {51: (1.0, 2)}}
DCP_STEPS = 4
DEVICE = "cuda"  # of the training phases (a rehearsal on the CPU sets "cpu")


def seeded_build(seed: int):
    """Context: modules made inside are made on DEVICE with weights drawn
    from `seed`; the global generators are left as they were."""
    import contextlib

    import torch

    stack = contextlib.ExitStack()
    stack.enter_context(torch.random.fork_rng(
        devices=[DEVICE] if DEVICE != "cpu" else []))
    stack.enter_context(torch.device(DEVICE))
    torch.manual_seed(seed)
    return stack


def weights_checksum(model) -> int:
    """Sum of the fp32 parameters' bit patterns read as int32 (exact)."""
    import torch

    return sum(int(p.detach().view(torch.int32).sum(dtype=torch.int64))
               for p in model.parameters())


class profiled:
    """While open, `run_training`'s `Profiler` is a subclass that keeps
    itself in `self.made`, reads the model's weights checksum when it is
    made (before any candidate) and when its planner is asked for (after
    the weights were copied back), counts the kernel launches of each
    candidate it runs, and resets the card's peak memory when the profile
    is over, so that the peak read after `run_training` is the trained
    steps'."""

    def __init__(self, fa):
        self.fa = fa
        self.made = []

    def __enter__(self):
        import inspect

        import torch

        from videosys_tpu_torch.core.dcp import Profiler
        from videosys_tpu_torch.training import train as train_mod

        fa, made = self.fa, self.made

        class Recording(Profiler):
            def __init__(self, bucket, step_builder, **kw):
                super().__init__(bucket, step_builder, **kw)
                self.model = inspect.getclosurevars(
                    step_builder).nonlocals["model"]
                self.checksum_before = weights_checksum(self.model)
                self.launches = []
                made.append(self)

            def _run(self, fn, args, thw, bs, sp, policy):
                before = dict(fa.LAUNCHES)
                try:
                    return super()._run(fn, args, thw, bs, sp, policy)
                finally:
                    self.launches.append({k: fa.LAUNCHES[k] - before[k]
                                          for k in before})

            def make_planner(self):
                self.checksum_after = weights_checksum(self.model)
                self.model = None
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                self.planner = super().make_planner()
                return self.planner

        self.module, self.saved = train_mod, train_mod.Profiler
        train_mod.Profiler = Recording
        return self

    def __exit__(self, *exc):
        self.module.Profiler = self.saved
        return False


def dcp_phase(fa, seed: int) -> dict:
    """`run_training` at full width and depth with the DCP profile phase
    (each bucket's recompute policy and batch ladder, gas from the step
    times), then the blocked backward pair against its plain version at
    the largest spatial shape a trained step ran."""
    import math

    import torch

    from videosys_tpu_torch import TrainConfig, run_training
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3
    from videosys_tpu_torch.training.datasets import DummyVariableVideoTextDataset

    t0 = time.perf_counter()
    log(f"dcp: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held by "
        f"earlier phases")
    cfg = TrainConfig(bucket_config=DCP_BUCKETS, dynamic_profile=True,
                      dynamic_recompute=True, max_steps=DCP_STEPS, log_every=1,
                      warmup_steps=2, seed=seed)
    # rows enough for a plan of each bucket at any batch the ladder picks
    dataset = DummyVariableVideoTextDataset(
        size=1024, seed=seed, distribution="uniform", frames_choices=(51,),
        resolution_choices=((144, 256), (240, 426)))
    # the weights a run without the profile starts from
    with seeded_build(cfg.seed):
        fresh = STDiT3(cfg.model)
    fresh_sum = weights_checksum(fresh.float())
    del fresh
    torch.cuda.empty_cache()
    fa.reset_launches()
    with profiled(fa) as rec, no_fallback(fa):
        state, ema, history = run_training(cfg, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (prof,) = rec.made
    launches = dict(fa.LAUNCHES)
    trained_peak = torch.cuda.max_memory_allocated()
    trained_reserved = torch.cuda.max_memory_reserved()
    budget = prof.memory_budget
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    mc = cfg.model
    log(f"dcp: budget {budget / 2**30:.2f} GiB (0.92 of {card_bytes / 2**30:.2f}); "
        f"profile and {len(history)} trained steps in {wall:.1f} s")
    log("dcp profile: bucket | policy | bs | peak reserved GiB (budget) | "
        "step s | fits | launches")
    profiled_launches = {key: 0 for key in fa.LAUNCHES}
    trials = []
    for t, got in zip(prof.trials, prof.launches):
        add_launches(profiled_launches, got)
        one = step_launches(fa, mc, prof.bucket.get_thw(t.bucket_id), t.bs, 1,
                            t.remat_policy)
        if math.isfinite(t.time):  # ran: a warm and a timed step
            if got != add_launches({}, one, 2):
                raise AssertionError(f"profile {t.bucket_id} bs {t.bs} "
                                     f"{t.remat_policy}: launches {got}, "
                                     f"predicted twice {one}")
        elif any(got[k] > 2 * one[k] for k in got):
            raise AssertionError(f"a failed profile run launched {got}, more "
                                 f"than two steps' {one}")
        if t.fits and t.memory_bytes > budget:
            raise AssertionError(f"a fitting rung read {t.memory_bytes} B, "
                                 f"over the budget {budget}")
        row = {"bucket": f"{t.bucket_id[0]}x{t.bucket_id[1]}",
               "thw": list(prof.bucket.get_thw(t.bucket_id)),
               "policy": t.remat_policy, "bs": t.bs,
               "peak_reserved_gib": t.memory_bytes / 2**30, "step_s": t.time,
               "fits": t.fits,
               "launches": {k: v for k, v in got.items() if v}}
        trials.append(row)
        log(f"  {row['bucket']} | {t.remat_policy:4s} | {t.bs:3d} | "
            f"{row['peak_reserved_gib']:.2f} ({budget / 2**30:.2f}) | "
            f"{t.time:.3f} | {t.fits} | {row['launches']}")
    for f in prof.failures:
        log(f"  failure: {dict(f, error=f['error'][:160])}")
        if f.get("phase") != "execute" or "OutOfMemoryError" not in f["error"]:
            raise AssertionError(f"a profile candidate failed other than by "
                                 f"running out of memory: {f}")
    if not all(p.fits for p in prof.results.values()):
        raise AssertionError("a bucket found no candidate that fits the card")
    planned = {}
    for bid in prof.results:
        sp, gas = prof.planner.plan(bid)
        planned[f"{bid[0]}x{bid[1]}"] = {
            "bs": prof.planner.bs(bid), "gas": gas, "sp": sp,
            "policy": prof.planner.remat_policy(bid)}
    log(f"dcp planner (target {prof.planner.target_time:.3f} s): {planned}")
    log(f"dcp weights checksum: fresh model {fresh_sum}, before the profile "
        f"{prof.checksum_before}, after it {prof.checksum_after}; optimizer "
        f"updates {state.tx.count} of {len(history)} steps")
    if not fresh_sum == prof.checksum_before == prof.checksum_after:
        raise AssertionError("the profile changed the weights")
    if state.tx.count != DCP_STEPS or state.step != DCP_STEPS:
        raise AssertionError(f"{state.tx.count} updates, {state.step} steps")
    for h in history:
        log("dcp train:", json.dumps(h))
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"bad loss or grad norm in {h}")
    log(f"dcp trained steps: peak allocated {trained_peak / 2**30:.2f} GiB, "
        f"reserved {trained_reserved / 2**30:.2f} GiB (budget "
        f"{budget / 2**30:.2f})")
    if trained_peak > budget:
        raise AssertionError("the trained steps went over the budget")
    trained_got = {k: launches[k] - profiled_launches[k] for k in launches}
    trained_want = expected_train_launches(fa, cfg, history)
    log(f"dcp launches: profile {profiled_launches}; trained {trained_got}, "
        f"predicted {trained_want}")
    if trained_got != trained_want:
        raise AssertionError("the trained steps' launches differ from the "
                             "prediction")
    del state, ema
    torch.cuda.empty_cache()
    # the largest spatial attention a trained step ran, on the blocked pair
    D = mc.hidden_size // mc.num_heads

    def spatial(h):
        T, H, W = h["thw"]
        t_lat = max(1, T // 17 * 5)
        S = -(-(H // 8) // 2) * -(-(W // 8) // 2)
        return h["batch"] * t_lat, S

    rows, S = max((spatial(h) for h in history), key=lambda r: r[0] * r[1] ** 2)
    variant = fa.backward_variant(rows, mc.num_heads, S, S, D, torch.bfloat16)
    bwd = backward_kernel_phase(fa, [("dcp_spatial", rows, mc.num_heads, S, S,
                                      D, False, variant)])["dcp_spatial"]
    return {"trials": trials, "failures": prof.failures, "planner": planned,
            "history": history, "launches": launches,
            "trained_peak_gib": trained_peak / 2**30,
            "trained_reserved_gib": trained_reserved / 2**30,
            "budget_gib": budget / 2**30, "wall_s": wall, "bwd": bwd}


def seeded_clips(path: Path, sizes, frames: int, seed: int):
    """A `VariableVideoTextDataset` over a CSV of `sizes` whose decode
    (`read_frames`, its only override) reads seeded uint8 clips of `frames`
    frames from memory; `host_seconds` sums the time its `load_video`
    (temporal crop, resize-crop, normalize) took on the host."""
    import csv

    import numpy as np

    from videosys_tpu_torch.training.datasets import VariableVideoTextDataset

    class SeededClips(VariableVideoTextDataset):
        def __init__(self, csv_path, clips):
            super().__init__(csv_path)
            self.clips = clips

        def read_frames(self, i, keep):
            return self.clips[i][keep]

    rng = np.random.default_rng(seed)
    clips = [rng.integers(0, 256, (frames, h, w, 3), dtype=np.uint8)
             for h, w in sizes]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["path", "text", "num_frames", "height", "width"])
        for i, (h, w) in enumerate(sizes):
            writer.writerow([f"clip{i}", f"seeded clip number {i}", frames, h, w])
    ds = SeededClips(str(path), clips)
    ds.host_seconds = 0.0
    load = ds.load_video

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        try:
            return load(*a, **kw)
        finally:
            ds.host_seconds += time.perf_counter() - t0

    ds.load_video = timed_load
    return ds


def raw_video_phase(fa, seed: int) -> dict:
    """Open-Sora training from raw clips through the full VAE encoder (bf16,
    random weights): `flash_fwd_wide` at the encoder's mid-attention shapes
    against its plain version, `run_training` on both 51-frame buckets from
    seeded 60-frame clips (launches per step from the shapes: the train
    step's and one wide launch per 4 frames of the micro-batch), then
    `preprocess` of the 144p clips and 2 steps from the latents it wrote."""
    import math
    import tempfile

    import numpy as np
    import torch

    from videosys_tpu_torch import (
        PreprocessedLatentDataset,
        TrainConfig,
        preprocess,
        run_training,
    )
    from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
        OpenSoraVAE,
    )
    from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder

    out = {}
    # the encoder's mid attention: micro-batches of 4 frames, one head of
    # 512 over an h x w latent (18 x 32 at 144p, 30 x 53 at 240p)
    if fa.kernel_variant(torch.bfloat16, 576, 576, 512) != "wgmma":
        raise AssertionError("the encoder's mid attention is not on the wide kernel")
    out["kernel"] = forward_shapes(fa, [
        ("vae_enc144", 4, 1, 576, 576, 512, False),
        ("vae_enc240", 4, 1, 1590, 1590, 512, False)], seed=5, dtypes=("bf16",))
    with seeded_build(seed + 7):
        vae = OpenSoraVAE().to(torch.bfloat16).eval()
    mbs = vae.config.micro_batch_size
    with tempfile.TemporaryDirectory() as tmp:
        # 8 clips of 180 x 320 (the 144p bucket) and 4 of 270 x 480 (240p):
        # two plans of each at the buckets' batch sizes
        sizes = [(180, 320)] * 8 + [(270, 480)] * 4
        ds = seeded_clips(Path(tmp) / "clips.csv", sizes, 60, seed)
        after_step = []
        cfg = TrainConfig(bucket_config=DCP_BUCKETS, max_steps=4, log_every=1,
                          warmup_steps=2, seed=seed,
                          tracker=lambda rec: after_step.append(dict(fa.LAUNCHES)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        with no_fallback(fa):
            state, ema, history = run_training(cfg, dataset=ds, vae=vae,
                                               device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        prev = {k: 0 for k in fa.LAUNCHES}
        wide = {}
        for h, snap in zip(history, after_step):
            got = {k: snap[k] - prev[k] for k in snap}
            prev = snap
            T, B = h["thw"][0], h["batch"]
            want = add_launches(
                {"wgmma": h["gas"] * -(-B * T // mbs)},
                step_launches(fa, cfg.model, h["thw"], B, h["gas"],
                              h["remat_policy"]))
            want = {k: want.get(k, 0) for k in got}
            log(f"raw video step {h['step']} {h['bucket']} batch {B}: loss "
                f"{h['loss']:.4f} step {h['seconds']:.3f} s, reads + encode "
                f"{h['data_seconds']:.3f} s; launches "
                f"{ {k: v for k, v in got.items() if v} }")
            if got != want:
                raise AssertionError(f"raw-video step launches {got} != {want}")
            if not math.isfinite(h["loss"]):
                raise AssertionError(f"bad loss in {h}")
            wide[h["bucket"]] = wide.get(h["bucket"], 0) + got["wgmma"]
        buckets = {h["bucket"] for h in history}
        if len(buckets) != 2 or state.step != 4:
            raise AssertionError(f"raw-video run: {state.step} steps over "
                                 f"{buckets}")
        log(f"raw video: {len(history)} steps in {wall:.1f} s, peak "
            f"{peak:.2f} GiB; host load_video {ds.host_seconds:.2f} s, reads "
            f"+ encodes {sum(h['data_seconds'] for h in history):.2f} s, "
            f"steps {sum(h['seconds'] for h in history):.2f} s; wide launches "
            f"by bucket {wide}")
        out.update(history=history, wall_s=wall, peak_gib=peak,
                   host_load_s=ds.host_seconds, wide_launches=wide)
        del state, ema
        torch.cuda.empty_cache()

        # preprocess the 144p clips, then train 2 steps from their latents
        small = seeded_clips(Path(tmp) / "small.csv", sizes[:8], 60, seed)
        written = []
        encode = vae.encode
        vae.encode = lambda x, noise: written.append(encode(x, noise)) or written[-1]
        fa.reset_launches()
        t0 = time.perf_counter()
        try:
            out_csv = preprocess(small, vae, StubTextEncoder(device=DEVICE),
                                 (51, 144, 256), str(Path(tmp) / "latents"),
                                 seed=seed, device=DEVICE)
        finally:
            del vae.encode
        pre_s = time.perf_counter() - t0
        pre_launches = dict(fa.LAUNCHES)
        if pre_launches["wgmma"] != len(sizes[:8]) * -(-51 // mbs):
            raise AssertionError(f"preprocess launched {pre_launches}")
        lat = PreprocessedLatentDataset(out_csv)
        for i, z in enumerate(written):
            want = z[0].float().cpu().numpy().astype(np.float16).astype(np.float32)
            if not np.array_equal(lat.load_latents([i], want.shape[1:])[0], want):
                raise AssertionError(f"latent {i} read back differs")
        prefetched = []
        prefetch = lat.prefetch
        lat.prefetch = lambda idx: prefetched.append(list(idx)) or prefetch(idx)
        cfg2 = TrainConfig(bucket_config={"144p": {51: (1.0, 4)}}, max_steps=2,
                           log_every=1, warmup_steps=2, seed=seed)
        fa.reset_launches()
        with no_fallback(fa):
            state, ema, hist2 = run_training(cfg2, dataset=lat, vae=vae,
                                             text_embed_fn=lat.text_embeds,
                                             device=DEVICE)
        lat.close()
        got = dict(fa.LAUNCHES)
        want = expected_train_launches(fa, cfg2, hist2, text_len=300)
        log(f"preprocess: 8 clips in {pre_s:.2f} s, launches "
            f"{ {k: v for k, v in pre_launches.items() if v} }; latents read "
            f"back bit-equal; 2 steps from them (prefetched "
            f"{[len(p) for p in prefetched]} rows), losses "
            f"{[round(h['loss'], 4) for h in hist2]}, launches "
            f"{ {k: v for k, v in got.items() if v} }")
        if state.step != 2 or got != want or not prefetched:
            raise AssertionError(f"training from preprocessed latents: "
                                 f"{state.step} steps, launches {got} != {want}")
        out.update(preprocess_s=pre_s, latent_history=hist2)
        del state, ema, vae
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30,
                    help="rflow sampling steps of the full-width requests "
                         "(serve and offload)")
    ap.add_argument("--cog5b-steps", type=int, default=COG_5B_STEPS,
                    help="DPM steps of the CogVideoX-5b request (the 2b "
                         f"runs the request's {COG_STEPS})")
    ap.add_argument("--vchitect-steps", type=int, default=VCHITECT_STEPS,
                    help="flow-match Euler steps of the Vchitect-2.0 "
                         f"requests (the reference request's {VCHITECT_STEPS})")
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "dots", "none"),
                    help="activation recompute of the training phase")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run "
                         f"({', '.join(PHASES)}); the kernel report and the "
                         "status line are printed only when all of them ran")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width denoise step (dense "
                         "and two PAB read steps), one full-width "
                         "training step, and one transformer step of "
                         "CogVideoX-2b, Latte-1, Open-Sora-Plan v1.2 (also "
                         "with its RoPE tables on the host) and Vchitect-2.0")
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
    if "t5" in phases:  # phase 5: the T5-XXL text encoder
        t5_phase(args.seed)
    if "offload" in phases:  # phase 6: T5, checkpoint loading, cpu_offload
        offload_phase(fa, args.steps, args.seed)
    if "bwd_kernel" in phases:  # phase 7: backward kernels against plain
        bwd_shapes = backward_kernel_phase(fa)
    if "train" in phases:  # phase 8: the training path
        trained = train_phase(fa, TRAIN_STEPS, args.seed, args.profile,
                              args.remat_policy)
    if "tiny_train" in phases:  # phase 9: tiny training, card against CPU
        tiny_train_parity_phase(fa, args.seed)
    if "cogvideox" in phases:  # phase 10: CogVideoX serving, its kernel shapes
        cog = cogvideox_phase(fa, args.seed, args.cog5b_steps, args.profile)
    if "dcp" in phases:  # phase 11: training with the DCP profile phase
        t0 = time.perf_counter()
        dcp = dcp_phase(fa, args.seed)
        log(f"dcp phase: {time.perf_counter() - t0:.1f} s")
    if "raw_video" in phases:  # phase 12: raw video, preprocess, latents
        t0 = time.perf_counter()
        raw = raw_video_phase(fa, args.seed)
        log(f"raw_video phase: {time.perf_counter() - t0:.1f} s")
    if "latte" in phases:  # phase 13: Latte-1 serving, its kernel shapes
        t0 = time.perf_counter()
        latte = latte_phase(fa, args.seed, args.profile)
        log(f"latte phase: {time.perf_counter() - t0:.1f} s")
    if "open_sora_plan" in phases:  # phase 14: Open-Sora-Plan v1.1 and v1.2
        t0 = time.perf_counter()
        osp = open_sora_plan_phase(fa, args.seed, args.profile)
        log(f"open_sora_plan phase: {time.perf_counter() - t0:.1f} s")
    if "vchitect" in phases:  # phase 15: Vchitect-2.0 serving, its shapes
        t0 = time.perf_counter()
        vch = vchitect_phase(fa, args.seed, args.vchitect_steps, args.profile)
        log(f"vchitect phase: {time.perf_counter() - t0:.1f} s")
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
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    # the narrow forward at CogVideoX's joint attention (the TPU takes it
    # to the blocked kernel: more than 4096 keys), launches from each
    # width's request
    for name in COG_WIDTHS:
        r = cog["kernel"][name]
        n = cog["launches"][name]["narrow"]
        if n <= 0:
            raise AssertionError(f"CogVideoX-{name} never launched "
                                 f"flash_fwd_narrow")
        kernels.append({
            "name": "flash_fwd_narrow", "route": "cuda",
            "source": "videosys_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "videosys_tpu/ops/flash_attention.py:49",
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
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
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": bwd_shapes[shape]["shape"]})
    # the blocked backward pair at the largest spatial shape the DCP run
    # trained, launches from that run (profile steps included)
    r = dcp["bwd"]
    for key, kern, source, replaces in (
            ("bwd_dkv", "dkv", dkv_src, "videosys_tpu/ops/flash_attention.py:522"),
            ("bwd_dq", "dq", dq_src, "videosys_tpu/ops/flash_attention.py:594")):
        if dcp["launches"][key] <= 0:
            raise AssertionError(f"the DCP run never launched flash_{key}")
        kernels.append({
            "name": f"flash_{key}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": dcp["launches"][key],
            "max_abs_err": r[kern]["max_abs_err_bf16"], "ms": r[kern]["ms"],
            "plain_ms": r[kern]["plain_ms"], "bound_ms": r[kern]["bound_ms"],
            "bound_by": r[kern]["bound_by"], "library_ms": r[kern]["library_ms"],
            "shape": r["shape"]})
    # the wide forward at the VAE encoder's shapes, launches from the
    # raw-video run's steps of each bucket
    for shape, res in (("vae_enc144", "144p"), ("vae_enc240", "240p")):
        r = raw["kernel"][shape]
        n = sum(v for b, v in raw["wide_launches"].items() if res in b)
        if n <= 0:
            raise AssertionError(f"raw-video training never launched "
                                 f"flash_fwd_wide at {res}")
        kernels.append({
            "name": "flash_fwd_wide", "route": "cuda",
            "source": "videosys_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "videosys_tpu/ops/flash_attention.py:49",
            "launches": n, "max_abs_err": r["max_abs_err_bf16"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    # the new shapes of Latte and Open-Sora-Plan, launches from the request
    # that runs them: the narrow forward at head_dim 96 (more than 4096 keys
    # go to the blocked kernel on the TPU), at the 17-key temporal rows and
    # the cross-attention, and at the LatteT2V rows of Latte-1 and v1.1; the
    # short forward at Latte's 16-frame temporal rows; the wide forward at
    # the VAEs' mid attention
    for r, request, key, replaces in (
            (latte["kernel"]["latte_vae_mid"], latte["dense"], "wgmma", 49),
            (osp["kernel"]["osp480"], osp["29x480p"]["dense"], "narrow", 49),
            (osp["kernel"]["osp93"], osp["93x480p"]["dense"], "narrow", 49),
            (osp["kernel"]["osp_cross"], osp["29x480p"]["dense"], "narrow", 125),
            (osp["kernel"]["temporal17"], osp["65x512x512"]["dense"], "narrow",
             125),
            (latte["kernel"]["latte_spatial"], latte["dense"], "narrow", 125),
            (latte["kernel"]["latte_cross"], latte["dense"], "narrow", 125),
            (latte["kernel"]["latte_temporal16"], latte["dense"], "short", 125),
            (osp["kernel"]["osp110_spatial"], osp["65x512x512"]["dense"],
             "narrow", 125),
            (osp["kernel"]["osp110_cross"], osp["65x512x512"]["dense"],
             "narrow", 125),
            (osp["kernel"]["cvae_tile"], osp["93x480p"]["dense"], "wgmma", 49),
            (osp["kernel"]["cvae_legacy"], osp["65x512x512"]["dense"], "wgmma",
             49),
            # Vchitect-2.0: the narrow forward at D = 64 on the joint rows,
            # the cross-attention and the 40-frame temporal rows; the wide
            # forward at the SD3 VAE's mid attention over 40 frames
            (vch["kernel"]["vchitect_spatial"], vch["dense"], "narrow", 125),
            (vch["kernel"]["vchitect_cross"], vch["dense"], "narrow", 125),
            (vch["kernel"]["vchitect_temporal40"], vch["dense"], "narrow", 125),
            (vch["kernel"]["vchitect_vae_mid"], vch["dense"], "wgmma", 49)):
        n = request["launches"][key]
        if n <= 0:
            raise AssertionError(f"{request['label']} never launched "
                                 f"flash_fwd_{key}")
        kernels.append({
            "name": {"wgmma": "flash_fwd_wide", "narrow": "flash_fwd_narrow",
                     "short": "flash_fwd_short"}[key],
            "route": "cuda", "source": "videosys_tpu_torch/csrc/flash_fwd.cu",
            "replaces": f"videosys_tpu/ops/flash_attention.py:{replaces}",
            "launches": n, "max_abs_err": r.get("max_abs_err",
                                                r.get("max_abs_err_bf16")),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    log(f"total_s={time.perf_counter() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`videosys_tpu_torch`) on one NVIDIA
card (an H100 is the target).

    python3 chip_smoke.py [--steps N] [--phases latte,open_sora_plan]

Phases, each fatal on failure:
  1. build the flash-attention kernels from csrc/ (forward, long-row
     forward, fp32 backward, fused backward, dk/dv backward, dq backward:
     one nvcc each, started together) and print the card;
  2. hold the forward kernels against their plain PyTorch version at the main
     path's shapes (STDiT3 spatial and cross attention on the narrow wgmma
     kernel, temporal attention on the short-row kernel, the VAE mid
     attention on the wide wgmma kernel) in bf16 and fp32, and time them
     beside the plain version and torch's own scaled_dot_product_attention
     (a yardstick the port never calls); then the edges of the short-row and
     narrow kernels (rows and keys around 16, 64 and 128, head widths 32 to
     128, a fully masked row, the log-sum-exp output) and of the wide kernel
     (a key mask and the log-sum-exp output at D = 512 with 6360 q rows,
     D = 256, a head that is no multiple of 8); then `flash_fwd_long` (rows
     of more than 4096 keys at heads up to 128) against its plain version
     at short rows with ragged q and key tails (4097 keys and more), a
     ragged key mask with a fully masked row, the log-sum-exp, bf16 and
     fp16, D = 64, 72, 96 and 128 and the partly filled widths 40, 88, 120;
  3. serve Open-Sora v1.2 text-to-video at full width (STDiT3-XL/2, depth
     28, hidden 1152; the full VAE) with random weights from a seed: one
     480p 9:16 2 s video and one 144p 1:1 image; the 480p request again
     under the three PAB ladders of the JAX package's bench.py with an fp8
     cache (timers, peak memory, cache bytes, PSNR against the dense video),
     conditioned on a seeded pixel reference image (the VAE encoder), and
     with loop=2 (those two at COND_STEPS); each request's kernel
     launches, counted from 0, must equal
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
     image, whose forward and log-sum-exp come from `flash_fwd_long`, also
     held and timed as a forward), each on the backward `backward_variant`
     picks, in fp32 and
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
     dynamic CFG over `--cog5b-steps`; the 2b's VAE (published widths,
     bf16) encodes one seeded 49 x 480 x 720 clip to [1, 16, 13, 60, 90]
     (seconds, peak memory, every value finite); then hold the long
     forward at both joint-attention shapes, [2, 30 | 48, 17776, 17776,
     64] bf16, against its plain version computed in 1024-row chunks over
     sampled heads, and time it beside the chunked plain version and
     torch's SDPA (`--profile`: one 2b transformer step by kernel,
     attention's share); a tiny CogVideoX VAE's moments and encode in fp32
     with TF32 off (2e-4 relative L2) and the DDIM, PNDM and
     Euler-Ancestral `add_noise` (1e-6 relative) on the card against the
     CPU.
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
     tile; then the long forward at head_dim 96 ([2, 24, 9600 | 28800,
     same, 96], in 1024-row chunks over sampled heads), the narrow forward
     at the cross-attention and the 17-key temporal rows, and the wide forward
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
 16. serve Open-Sora v1.2 in parallel (`core/parallel.py`) through
     `VideoSysEngine(OpenSoraConfig(num_gpus=N, enable_cp=...))`, the ranks
     sharing this one card: first whether NCCL takes two ranks on one
     device (its message is printed; when it refuses, the shared-card
     worlds pass backend="gloo" explicitly, which stages every exchange
     through the host); world 1 through `initialize` on the default
     backend (NCCL) with the groups installed, the 480p request at
     PARALLEL_SHORT_STEPS; then that request at full width on sp=2, cp=2
     and cp=2 x sp=2, each held against world 1 (PARALLEL_LIMITS), with
     each rank's peak memory, denoise seconds, launches against the
     prediction from its per-rank shapes, attention shapes and the
     exchange's share of the denoise (the request runs untimed; each
     collective it made is then replayed alone with a sync on each side,
     and its median times its count is the exchange's seconds); sp=2 over
     NCCL on two cards where there are two, else a line that says it did
     not run. Then every other family the same way at its published widths
     and depth (FAMILY_WORLDS, sp=2 on the shared card, Latte also cp=2):
     CogVideoX-2b 49 x 480 x 720 and Open-Sora-Plan v1.2 29 x 480p under
     Ulysses, Latte-1 16 x 512 x 512, Open-Sora-Plan v1.1 65 x 512 x 512 and
     Vchitect-2.0 40 x 288 x 480 under DSP, FAMILY_STEPS denoise steps and
     one decode each, against world 1 (the driver's own pipeline with its
     groups taken away), the per-rank attention shapes held to the
     prediction. A tiny fp32 configuration on sp=2 and sp=4 (T and S both
     padded, an image, a reference frame) against world 1 at 2e-4, and on
     the same ranks every family's tiny parallel forward (every pad taken)
     against the CPU; a worker that raises must fail the driver's call;
     the forward kernels at one rank's shapes of every world against their
     plain versions. The Open-Sora VAE runs split over the ranks (latent
     rows with halos, then frames): every rank decodes its share at once,
     and each rank's VAE seconds and VAE peak are printed beside world
     1's working set over the world size (the prediction).
 17. train STDiT3-XL/2 at its published width over ranks sharing the card
     (gloo): dp=2, sp=2 and dp=2 x sp=2 (PTRAIN_WORLDS, at 8 pairs), ZeRO-1
     and DSP under recompute "full", the 240p 51-frame bucket, PTRAIN_STEPS
     steps each, against world 1 on the same global batch and draws
     (PTRAIN_LIMITS): the per-step loss and grad norm, each rank's peak,
     ZeRO-1 moment bytes (1/N of world 1's), the seconds in collectives
     (each wrapped with a sync on both sides) against the steps', and its
     launches against the per-rank prediction; then zero3_dynsp: four
     ranks under ZeRO-3 and dynamic sp at full depth (28 pairs), a given
     planner putting a 144p image bucket at sp 1 (dp 4), 144p 51 frames at
     sp 2 and 240p 51 frames at sp 4, one step each, against world 1 on
     the same plans (PTRAIN_LIMITS), each rank's peak, parameter,
     gradient, EMA and moment bytes against 1/4 of the sharded leaves
     plus the whole small ones, seconds in collectives, launches against
     each step's layout and its forward shapes by layout; tiny fp32
     configurations at dp=2, sp=2, dp=2 x sp=2, under ZeRO-3 and with
     dynamic sp on the card's kernels against the CPU's world 1 (losses
     1e-4); the kernels at one rank's new training rows (forward and
     backward: the sp=2 world's and the sp=4 and dp=4 layouts') and at one
     rank's share of the split decode against their plain versions.
 18. the port's entry points at their tiny sizes on the card: every
     `examples/inference/*/sample.py` function but `run_multi_device`
     (which the CPU tests run), the PAB experiments' `pab_quality` and the
     CogVideoX demo's `generate_pair` on `build_engines(tiny=True)`; each
     video read back (uint8 frames) and each run's kernel launches.

Opt-in (named in --phases only): `parallel_fp32` runs the DSP and cp
worlds of phase 16 (Open-Sora sp=2 and cp=2, Latte-1 sp=2 and cp=2, OSP
v1.1 sp=2, Vchitect-2.0 sp=2) in fp32 with TF32 off for 2 steps (v1.1 4)
against world 1 in fp32 and prints each world's latent relative L2.

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
from typing import Optional

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 SIMT,
# HBM3 bandwidth
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
PHASES = ("kernel", "serve", "tiny", "bwd_kernel", "train", "tiny_train", "t5",
          "offload", "cogvideox", "dcp", "raw_video", "latte", "open_sora_plan",
          "vchitect", "parallel", "parallel_train", "entry_points")
OPT_IN_PHASES = ("parallel_fp32",)  # run only when named in --phases
TRAIN_STEPS = 4  # on the default buckets: two video shapes and an image
# rflow steps of the serve phase's conditioned and loop=2 requests (the
# depth of those repeats of the 480p request; their width is the request's)
COND_STEPS = 5  # cut from 10 to keep the script inside its time
# the main path's request: 480p 9:16 2 s (51 frames)
REQUEST_480P = dict(
    prompt="a drone shot of waves breaking on a rocky coast at sunset",
    resolution="480p", aspect_ratio="9:16", num_frames="2s")
F32_TOL = 2e-5
F32_GRAD_TOL = 1e-4
DI_TOL = 1e-5  # di against rowsum(dO * O), relative to its largest entry
# bf16 limits per shape (rel_l2, rel_max), set from this script's readings
# on an H100 (PERF.md): the kernel read at most half of each, and a plain
# version that drops one key per row read at least twice one of them
BF16_KIND = {"spatial": (8e-3, 2e-2), "cross": (1e-2, 2e-2),
             "temporal": (1e-2, 2e-2)}
BF16_LIMITS = {**BF16_KIND, "vae_mid": (6.5e-3, 1.5e-2),
               "stdit3_forward": (1.8e-2, 2.5e-2),
               # T5-v1.1-XXL bf16 against fp32 on the unmasked rows, read on
               # an H100: 2.15e-2, 2.50e-2; without the relative bias 0.73,
               # 0.84
               "t5_xxl": (4.5e-2, 5e-2),
               # CogVideoX's joint attention, 17,776 keys at D = 64, read
               # on an H100: kernel 3.11e-3, 5.88e-3 (2b) and 3.17e-3,
               # 6.21e-3 (5b); one key dropped 7.28e-3, 4.19e-2 and
               # 8.84e-3, 1.69e-1. The long kernel against its own plain
               # version (128-key tiles): 3.68e-4, 2.94e-3 and 3.74e-4,
               # 3.09e-3
               "cog2b": (6.5e-3, 1.5e-2), "cog5b": (6.5e-3, 1.5e-2),
               # the VAE encoder's mid attention at training buckets: the
               # wide kernel of "vae_mid", held at its limits
               "vae_enc144": (6.5e-3, 1.5e-2), "vae_enc240": (6.5e-3, 1.5e-2),
               # Latte and Open-Sora-Plan, read on an H100 (kernel; one key
               # dropped): narrow at head_dim 96, 9,600 keys 3.16e-3,
               # 5.41e-3 (1.09e-2, 0.100), 28,800 keys 3.66e-3, 4.27e-3
               # (6.55e-3, 0.136); the long kernel against its own plain
               # version 3.23e-4, 5.41e-3 and 4.59e-4, 4.27e-3 (7.14e-3,
               # 0.136); the cross-attention 2.94e-3, 4.83e-3
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
               "clip_l": (4.5e-2, 5e-2), "clip_g": (4.5e-2, 5e-2),
               # one rank's rows under sp / cp (parallel phase): the limits
               # of the Open-Sora rows of the same kind
               **{f"{w}_{k}": BF16_KIND[k] for w in ("sp2", "cp2", "cp2sp2",
                                                     "sp4")
                  for k in ("spatial", "temporal", "cross")},
               # one rank's rows in the other families' worlds: the limits
               # of the family's own rows of the same kind
               "sp2_cog2b": (6.5e-3, 1.5e-2), "sp2_osp120": (6.5e-3, 1.5e-2),
               # the 1080p training row's forward (the long kernel at D =
               # 72): the limits of the long rows of the same kind
               "train1080": (6.5e-3, 1.5e-2),
               "sp2_osp120_cross": (6.5e-3, 1.5e-2),
               **{f"sp2_{f}_{k}": BF16_KIND[k]
                  for f in ("latte", "osp110", "vchitect")
                  for k in ("spatial", "temporal", "cross")},
               # one rank's training rows under sp=2 (parallel_train) and
               # its share of the split 480p decode: the limits of the
               # rows of the same kind
               **{f"ptrain_{k}": BF16_KIND[k]
                  for k in ("spatial", "temporal", "cross")},
               "vae_mid_rank": (6.5e-3, 1.5e-2),
               # one rank's training rows of the sp=4 and dp=4 layouts of
               # the zero3_dynsp world: the limits of the rows of the same
               # kind
               **{f"zds_{w}_{k}": BF16_KIND[k]
                  for w, k in (("sp4", "spatial"), ("sp4", "cross"),
                               ("sp4", "temporal"), ("dp4", "spatial"),
                               ("dp4", "cross"))}}
# the same for the gradients of the backward kernels (the largest of dq, dk,
# dv): the kernels read at most a third of each limit (3.0e-4, 3.2e-3), the
# one-key fault at least 10x one of them (1.1e-2, 1.0e-1 at the long row)
BWD_BF16_LIMITS = {name: (1e-3, 1e-2) for name in (
    "spatial144", "spatial", "temporal", "cross8", "cross300", "long_row",
    "dcp_spatial", "ptrain_spatial", "ptrain_cross", "ptrain_temporal",
    "zds_sp4_spatial", "zds_sp4_cross", "zds_sp4_temporal", "zds_dp4_spatial",
    "zds_dp4_cross")}


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
    results["long_edges"] = long_forward_edges(fa)
    return results


def forward_shapes(fa, shapes, seed: int, dtypes=("bf16", "fp32")) -> dict:
    """Each forward shape (name, B, H, Nq, Nk, D, masked) in `dtypes` against
    the plain version (bf16 at BF16_LIMITS[name] with the one-key fault,
    fp32 at F32_TOL), then timed in bf16 beside the plain version and torch's
    SDPA, with its bound. `masked`: False, True (ragged real lengths) or the
    number of real keys of every row (the rest pad to the sp size)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(seed)
    results = {}
    for name, B, H, Nq, Nk, D, masked in shapes:
        q = torch.randn(B, H, Nq, D, device="cuda", generator=gen)
        k = torch.randn(B, H, Nk, D, device="cuda", generator=gen)
        v = torch.randn(B, H, Nk, D, device="cuda", generator=gen)
        mask = None
        if masked is True:  # ragged real lengths, the longest filling the bucket
            lens = torch.randint(1, Nk + 1, (B,), device="cuda", generator=gen)
            lens[0] = Nk
            mask = torch.arange(Nk, device="cuda")[None] < lens[:, None]
        elif masked:  # the same real keys in every row, then the pad
            mask = (torch.arange(Nk, device="cuda") < masked).expand(
                B, Nk).contiguous()
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


# the source of each forward variant the kernel report names
FWD_SOURCES = {key: "videosys_tpu_torch/csrc/flash_fwd.cu"
               for key in ("short", "narrow", "wgmma", "f32")}
FWD_SOURCES["long"] = "videosys_tpu_torch/csrc/flash_fwd_long.cu"
# fp16 outputs of the long forward (rel_l2, rel_max): the fp16 limits of
# tests/test_torch_port_kernel.py (HALF_LIMITS), set from H100 readings
FP16_LIMITS = (1e-3, 2e-3)


def long_forward_edges(fa) -> dict:
    """`flash_fwd_long` at the edges its design brings, against its plain
    version (`flash_attention_long_plain`): q rows and keys that are no
    multiple of its 128-row tiles, the first row it takes (4097 keys), each
    padded width (D = 64, 72, 96, 128) and heads that fill their padded
    width's copies only in part (D = 40 of 64, 88 of 96, 120 of 128), a
    ragged key mask whose last batch row is fully masked, the log-sum-exp,
    bf16 (the spatial limits) and fp16 (FP16_LIMITS)."""
    import torch

    gen = torch.Generator("cuda").manual_seed(18)
    out = {}
    for B, H, Nq, Nk, D, dtype in (
            (2, 2, 200, 4097, 64, torch.bfloat16),
            (2, 2, 130, 4200, 72, torch.float16),
            (3, 1, 129, 4500, 96, torch.bfloat16),
            (2, 1, 64, 5000, 128, torch.float16),
            (2, 2, 300, 4352, 96, torch.float16),
            (2, 1, 1, 4097, 72, torch.bfloat16),
            (2, 2, 200, 4300, 40, torch.bfloat16),
            (2, 1, 130, 4400, 88, torch.float16),
            (2, 2, 129, 4240, 120, torch.bfloat16)):
        q, k, v = (torch.randn(B, H, n, D, device="cuda", generator=gen)
                   .to(dtype) for n in (Nq, Nk, Nk))
        mask = ragged_mask(B, Nk, gen)
        mask[-1] = False
        variant = fa.kernel_variant(dtype, Nq, Nk, D)
        if variant != "long":
            raise AssertionError(f"{[Nq, Nk, D]}: expected the long forward, "
                                 f"the dispatch says {variant}")
        want, want_lse = fa.flash_attention_long_plain(q, k, v, None, mask,
                                                       return_lse=True)
        lim_l2, lim_mx = BF16_LIMITS["spatial"] if dtype == torch.bfloat16 \
            else FP16_LIMITS
        got, lse = fa.flash_fwd_long(q, k, v, None, mask, save_lse=True)
        torch.cuda.synchronize()
        l2, mx = rel_errors(got, want)
        lse_err = (lse - want_lse).abs().max().item()
        ok = l2 <= lim_l2 and mx <= lim_mx and lse_err <= F32_GRAD_TOL \
            and bool(torch.isfinite(got).all())
        log(f"kernel edge long   {str(dtype)[6:]:8s} shape="
            f"{[B, H, Nq, Nk, D]} masked, last row dead rel_l2={l2:.3e} "
            f"rel_max={mx:.3e} lse_err={lse_err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the long forward disagrees with its plain "
                                 f"version at {[B, H, Nq, Nk, D]}")
        out[f"{B}x{H}x{Nq}x{Nk}x{D}_{str(dtype)[6:]}"] = {
            "rel_l2": l2, "rel_max": mx, "lse_err": lse_err}
    return out


def expected_launches(fa, pipe, num_frames: int, height: int, width: int,
                      steps: int, text_len: int, plans=None, loop: int = 1,
                      encoded=(), sp: int = 1, vae_ranks: int = 1) -> dict:
    """Kernel launches one request makes, by variant, from its shapes and
    PAB plans: per denoise step and loop each depth runs spatial (S x S
    tokens), temporal (T x T, unless T = 1) and two cross attentions (S x
    the bucketed text length), each on the variant its shape takes (on
    one of `sp` sequence-parallel ranks: T and S padded to a multiple of
    sp, a cross-attention row of S / sp queries), less
    what the step's plan reads from the cache (spatial, temporal, both
    cross, or the whole pair); the VAE runs its mid attention once per frame
    micro-batch: per temporal chunk when one clip is streamed to uint8, over
    the whole clip per loop otherwise, and over each encoded clip of
    `encoded` frames (a reference, a loop's previous clip); split over
    `vae_ranks` ranks, each decodes its block of those frames (padded to a
    multiple of the ranks) in micro-batches."""
    t_lat, h_lat, w_lat = pipe.vae.get_latent_size((num_frames, height, width))
    mc = pipe.model_config
    _, ph, pw = mc.patch_size
    S = -(-(-(-h_lat // ph) * -(-w_lat // pw)) // sp) * sp
    T = t_lat if t_lat == 1 else -(-t_lat // sp) * sp
    D = mc.hidden_size // mc.num_heads
    want = {key: 0 for key in fa.LAUNCHES}
    for plan in plans or [None] * steps:
        calls = []
        if plan is None or not (plan.spatial or plan.pair):
            calls.append((S, S))
        if plan is None or not (plan.cross or plan.pair):
            calls += [(S // sp, text_len)] * 2
        if T > 1 and (plan is None or not (plan.temporal or plan.pair)):
            calls.append((T, T))
        for Nq, Nk in calls:
            want[fa.kernel_variant(pipe.dtype, Nq, Nk, D)] += mc.depth * loop
    vae_cfg = pipe.vae.config
    mbs = vae_cfg.micro_batch_size

    def micro_batches(n_frames: int) -> int:  # a rank's, of n frames
        return -(-(-(-n_frames // vae_ranks)) // mbs)

    if loop == 1:
        n_vae, remaining = 0, num_frames
        for _ in range(0, t_lat, pipe.vae.micro_z_frame_size):
            nf = min(vae_cfg.micro_frame_size, remaining)
            n_vae += micro_batches(nf)
            remaining -= vae_cfg.micro_frame_size
    else:
        n_vae = loop * micro_batches(num_frames)
    n_vae += sum(micro_batches(n) for n in encoded)
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
    video_req = dict(REQUEST_480P)
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
    set_steps(pipe, COND_STEPS)
    rec, _ = serve_request(fa, engine, dict(video_req, reference=ref), seed,
                           COND_STEPS, encoded=(1,))
    served("conditioned", rec)
    out["conditioned"] = rec
    rec, _ = serve_request(fa, engine, dict(video_req, loop=2), seed,
                           COND_STEPS, encoded=(nf,))
    served("loop2", rec)
    out["loop2"] = rec
    set_steps(pipe, steps)
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
        if masked is True:
            mask = ragged_mask(B, Nk, gen)
        elif masked:  # the same real keys in every row, then the sp pad
            mask = (torch.arange(Nk, device="cuda") < masked).expand(
                B, Nk).contiguous()
        else:
            mask = None
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
        # the forward of the 1080p row, whose log-sum-exp the pair reads:
        # the long kernel
        results["train1080"] = long_row(fa, "train1080", 1, 16, 8160, 72, gen)
    return results


def step_launches(fa, mc, thw, B: int, gas: int, policy: str,
                  text_len: int = 8, sp: int = 1) -> dict:
    """Kernel launches of one training step, by `LAUNCHES` key, from its
    shapes: per depth pair and micro-batch one spatial, one temporal
    (unless T = 1) and two cross attentions (to `text_len` keys: run_
    training's synthetic captions have 8); under recompute ("full" or
    "dots") every forward runs twice; every backward is
    `backward_variant`'s choice. On one of `sp` ranks (DSP; B its batch),
    T and S are padded to a multiple of sp: spatial attention over its
    T / sp frames of the whole S, temporal over its S / sp rows, the cross
    over its S / sp queries."""
    D = mc.hidden_size // mc.num_heads
    _, ph, pw = mc.patch_size
    T, Hpx, Wpx = thw
    t_lat = max(1, T // 17 * 5) if T > 1 else 1
    S = -(-(Hpx // 8) // ph) * -(-(Wpx // 8) // pw)
    S = -(-S // sp) * sp
    Tp = t_lat if t_lat == 1 else -(-t_lat // sp) * sp
    calls = [(B * Tp // sp, S, S), (B * Tp, S // sp, text_len),
             (B * Tp, S // sp, text_len)]
    if t_lat > 1:
        calls.append((B * S // sp, Tp, Tp))
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
             "flash_attention_bwd_lse_plain", "flash_attention_long_plain",
             "flash_attention_by_key_tiles_plain")

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
# the repo's default request (examples/inference/cogvideox) runs 50 steps;
# the 2b runs 10 of them, to keep the script inside its time
COG_REQUEST_STEPS = 50
COG_STEPS = 10
# the 5b's DPM steps in a default run: 50 took 108.3 s of denoise on an
# H100 (2.17 s a step); 5 keep the script inside its time
COG_5B_STEPS = 5
# query rows of one plain reference chunk at 17,776 keys (fp32 scores of
# one chunk: 73 MB a (batch, head) pair)
COG_CHUNK = 1024


def long_row(fa, name: str, B: int, H: int, N: int, D: int, gen) -> dict:
    """`flash_fwd_long` on one self-attention of N keys (more than 4096),
    [B, H, N, N, D] bf16: against its plain version (the online softmax over
    128-key tiles) in COG_CHUNK-row chunks over a sample of (batch, head)
    pairs that includes the last, held by check_bf16 (BF16_LIMITS[name])
    with a plain version that drops the last key as the fault; timed beside
    the chunked plain version over the whole shape and torch's
    scaled_dot_product_attention (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (torch.randn(B, H, N, D, device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    variant = fa.kernel_variant(q.dtype, N, N, D)
    if variant != "long":
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
            wants.append(fa.flash_attention_long_plain(qc, ks, vs))
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
            fa.flash_attention_long_plain(q[:, :, r0:r0 + COG_CHUNK], k, v)

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
    """`flash_fwd_long` at the joint attention of a 49 x 480 x 720
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
    it from the PAB cache, all on `long`; the VAE has no attention."""
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


# one clip of the request's size through the CogVideoX-2b VAE's encoder at
# its published widths, bf16: 49 frames encode to 13 latent frames
COG_ENCODE_SHAPE = (1, 3, 49, 480, 720)
COG_LATENT_SHAPE = [1, 16, 13, 60, 90]
# fp32 card against CPU, TF32 off: the whole-model tolerance (relative L2)
COG_ENCODE_TOL = 2e-4
# add_noise card against CPU (fp32, the same formula): relative max error
ADD_NOISE_TOL = 1e-6


def cog_encode(vae, seed: int) -> dict:
    """`AutoencoderKLCogVideoX.encode` of one seeded clip of
    COG_ENCODE_SHAPE in bf16 on the card, twice (the first call takes
    cuDNN's choices): seconds, the peak memory over the resident weights,
    the latent's shape and that every value is finite."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.rand(COG_ENCODE_SHAPE, device="cuda", generator=gen,
                   dtype=torch.bfloat16) * 2 - 1
    rec = {"shape_in": list(COG_ENCODE_SHAPE), "dtype": "bf16",
           "resident_gib": torch.cuda.memory_allocated() / 2**30}
    for run in ("first", "second"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            z = vae.encode(x, generator=gen)
        torch.cuda.synchronize()
        rec[f"{run}_s"] = time.perf_counter() - t0
        rec[f"{run}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec.update(latent_shape=list(z.shape), finite=bool(torch.isfinite(z).all()),
               latent_std=float(z.float().std()))
    log("cogvideox 2b encode:", json.dumps(rec))
    if rec["latent_shape"] != COG_LATENT_SHAPE or not rec["finite"] \
            or not rec["latent_std"] > 0:
        raise AssertionError(f"cogvideox encode: latent {rec['latent_shape']}"
                             f" (want {COG_LATENT_SHAPE}), finite="
                             f"{rec['finite']}, std={rec['latent_std']}")
    del x, z
    torch.cuda.empty_cache()
    return rec


def api_gaps_parity(seed: int) -> dict:
    """A tiny CogVideoX VAE's `moments` and `encode` (13 frames, a given
    noise) in fp32 on the card against the CPU with TF32 off
    (COG_ENCODE_TOL, relative L2), and each diffusers scheduler's
    `add_noise` on the card against the CPU at a batch of timesteps that
    holds the first and the last (ADD_NOISE_TOL, relative max)."""
    import copy

    import torch

    from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import (
        AutoencoderKLCogVideoX, CogVideoXVAEConfig)
    from videosys_tpu_torch.schedulers.ddim import DDIMScheduler
    from videosys_tpu_torch.schedulers.euler_ancestral import (
        EulerAncestralScheduler)
    from videosys_tpu_torch.schedulers.pndm import PNDMScheduler

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(seed)
        cpu = AutoencoderKLCogVideoX(CogVideoXVAEConfig(
            latent_channels=4, block_out_channels=(8, 8, 16, 16),
            layers_per_block=1, norm_num_groups=4)).eval()
        card = copy.deepcopy(cpu).cuda()
        gen = torch.Generator().manual_seed(seed)
        x = torch.rand(1, 3, 13, 32, 32, generator=gen) * 2 - 1
        with torch.no_grad():
            want = cpu.moments(x)
            noise = torch.randn(want[0].shape, generator=gen)
            want = want + (cpu.encode(x, noise),)
            got = card.moments(x.cuda()) + (card.encode(x.cuda(),
                                                        noise.cuda()),)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    rec = {name: rel_errors(g.cpu(), w)[0]
           for name, g, w in zip(("mean", "logvar", "sample"), got, want)}
    x0 = torch.randn(2, 16, 13, 60, 90, generator=gen)
    eps = torch.randn(x0.shape, generator=gen)
    euler = EulerAncestralScheduler()
    euler.set_timesteps(50)
    for name, sched, t in (("ddim", DDIMScheduler(), [0, 999]),
                           ("pndm", PNDMScheduler(), [0, 999]),
                           ("euler_ancestral", euler, [0, 50])):
        want = sched.add_noise(x0, eps, torch.tensor(t))
        got = sched.add_noise(x0.cuda(), eps.cuda(), torch.tensor(t).cuda())
        if got.device.type != "cuda":
            raise AssertionError(f"add_noise {name} left the card")
        rec[f"add_noise_{name}"] = rel_errors(got.cpu(), want)[1]
    log("api gaps, card against CPU:", json.dumps(rec))
    bad = {k: v for k, v in rec.items()
           if v > (ADD_NOISE_TOL if k.startswith("add_noise") else
                   COG_ENCODE_TOL)}
    if bad:
        raise AssertionError(f"card against CPU over tolerance: {bad}")
    return rec


def cogvideox_phase(fa, seed: int, steps_5b: int,
                    profile: bool = False) -> dict:
    """CogVideoX text-to-video at its published widths and full depth,
    random weights from `seed`, the stub text encoder (226 tokens): the 2b
    over 50 DDIM steps, dense and with PAB; the 5b with DPM and dynamic CFG
    over `steps_5b` steps; the 2b's VAE encodes one clip of the request's
    size (`cog_encode`); then the long forward at both joint-attention
    shapes against its plain version (`cog_kernel_phase`), and a tiny
    encode and the schedulers' `add_noise` on the card against the CPU
    (`api_gaps_parity`)."""
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
            out["2b"] = {"dense": dense, "pab": rec,
                         "encode": cog_encode(pipe.vae, seed)}
            launches["2b"] = dense["launches"]
            if profile:
                out["profile_2b"] = profile_cog_step(pipe, seed)
        else:
            log(f"cogvideox-5b: {steps_5b} of the request's "
                f"{COG_REQUEST_STEPS} DPM "
                f"steps (cut to keep the script inside its time; width, "
                f"depth and shapes are the published ones)")
            out["5b"] = cog_request(fa, engine, "5b dpm", steps_5b, seed,
                                    use_dynamic_cfg=True)
            launches["5b"] = out["5b"]["launches"]
        del engine, pipe
        torch.cuda.empty_cache()
    out["kernel"] = cog_kernel_phase(fa)
    out["launches"] = launches
    out["api_gaps"] = api_gaps_parity(seed)
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
# 50 DDIM steps, guidance 7.5; 10 of the steps run, to keep the script
# inside its time
LATTE_REQUEST = dict(prompt="a panda playing a guitar on a mossy rock in a "
                     "bamboo forest, cinematic", video_length=16, height=512,
                     width=512, guidance_scale=7.5, num_inference_steps=10)
OSP_PROMPT = "a red sports car driving along a coastal road at sunset"
# Euler-Ancestral steps of the v1.2 29 x 480p requests and PNDM steps of the
# v1.1 65 x 512 x 512 request (the pipeline's default is 100 for both: 100
# Euler calls of 0.535 s and 109 PNDM calls of 0.508 s on an H100); the
# 93 x 480p request runs one step and its whole tiled decode
OSP_V120_STEPS = 10  # cut from 50 to keep the script inside its time
OSP_V120_93_STEPS = 1
OSP_V110_STEPS = 5  # cut from 20 to keep the script inside its time


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
                      plans=None, sp: int = 1) -> dict:
    """The same for OpenSoraT2V: per step and layer a self-attention over N
    tokens and a cross-attention to the text, less the plan's reads (on one
    of `sp` Ulysses ranks: N padded to a multiple of sp, N / sp queries in
    the cross-attention)."""
    mc = pipe.model_config
    N = -(-N // sp) * sp
    want = {key: 0 for key in fa.LAUNCHES}
    for plan in plans or [None] * steps:
        calls = [] if plan is not None and plan.spatial else [(N, N)]
        if plan is None or not plan.cross:
            calls.append((N // sp, text_len))
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
# (examples/inference/vchitect/sample.py): 47.6 s dense and 35.2 s under
# PAB on an H100; a default run takes VCHITECT_RUN_STEPS of them to keep the
# whole script inside its time (`--vchitect-steps 100` runs the reference's)
VCHITECT_STEPS = 100
VCHITECT_RUN_STEPS = 10  # cut from 50 to keep the script inside its time
# the text towers of Vchitect-2.0's trio at their published widths (SD3's
# text_encoder and text_encoder_2 config.json); CLIP's vocabulary and 77
# positions are the CLIPTextConfig defaults
CLIP_L = dict(hidden_size=768, intermediate_size=3072, projection_dim=768,
              num_hidden_layers=12, num_attention_heads=12,
              hidden_act="quick_gelu")
CLIP_G = dict(hidden_size=1280, intermediate_size=5120, projection_dim=1280,
              num_hidden_layers=32, num_attention_heads=20, hidden_act="gelu")


def vchitect_launches(fa, pipe, steps: int, F: int, S: int, L: int,
                      plans=None, sp: int = 1) -> dict:
    """Kernel launches of a Vchitect denoise loop by variant: per step two
    forwards (uncond, cond), per block a spatial (S + L tokens of each
    frame), a cross (the F (S + L) tokens against the L context tokens of
    frame 0) and, with more than one frame, a temporal (the F frames of
    each token) attention, less what the step's plan reads from the PAB
    cache in every block but the last, which runs dense. On one of `sp`
    DSP ranks F is padded to a multiple of sp: the cross rows hold the
    rank's F / sp frames, the temporal rows all of them."""
    mc = pipe.model_config
    N = S + L
    Fp = -(-F // sp) * sp
    want = {key: 0 for key in fa.LAUNCHES}
    for plan in plans or [None] * steps:
        for cached, blocks in ((True, mc.depth - 1), (False, 1)):
            def reads(branch):
                return cached and plan is not None and getattr(plan, branch)
            calls = [] if reads("spatial") else [(N, N)]
            if not reads("cross"):
                calls.append((Fp // sp * N, L))
            if F > 1 and not reads("temporal"):
                calls.append((Fp, Fp))
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


# --------------------------------------------------------------------------- #
# phase 16: parallel serving, DSP and CFG parallelism (core/parallel.py)

PARALLEL_REQUEST = REQUEST_480P
PARALLEL_SHORT_STEPS = 2  # the Open-Sora worlds
PARALLEL_WORLDS = (("sp2", 2, False), ("cp2", 2, True), ("cp2sp2", 4, True))
PARALLEL_TIMEOUT_S = 300.0
SHARED = "ranks share one card"
# a full-width world against world 1, bf16, same seed and steps: the final
# latents' relative L2 and the video's largest difference in uint8 levels.
# Not bit-equal: a rank's bf16 GEMMs run over fewer rows and may take other
# cuBLAS kernels, whose rounding differs, and the steps carry it on. Read on
# an H100 (rel_l2, levels, PSNR): sp=2 at 30 steps 8.6e-3, 42, 39.9 dB; cp=2
# and cp=2 x sp=2 at 4 steps 2.5e-2, 61 and 76, 37.0 dB. The latents' limit
# is twice the largest of those readings and the video's a third above it;
# a wrong layout or a lost pad mask moves the latents by their own size
# (rel_l2 ~1). The other families' worlds (2 steps; v1.1 4) read up to
# 3.2e-2 (Latte cp=2) and 25 levels; CogVideoX-2b and v1.2 under Ulysses
# equal world 1 bit for bit
PARALLEL_LIMITS = {"latent_rel_l2": 5e-2, "video_levels": 100}
# world 1's latents decoded split over a world's ranks against the same
# latents decoded whole on world 1, both in fp32 with TF32 off: the first
# temporal chunk (5 latent frames, 17 pixel frames) at the request's rows
# (so each rank's rows, halos and seam are the request's) and half its
# columns (half the memory and time). The split changes only the order of
# the group norms' sums, the convolutions' shapes and the frames a
# micro-batch holds; a wrong halo, pad mask or seam moves whole rows. In
# bf16 the same decode read 41 levels (mean 1.50, 41.11 dB; sp=2, H100):
# rounding that the random weights amplify, which would hide such a fault
SPLIT_VAE_LEVELS = 1
SPLIT_VAE_CHUNK = (5, 17)  # latent frames, pixel frames
# the tiny fp32 worlds against world 1 on the card (latents, absolute)
PARALLEL_TINY_TOL = 2e-4
PARALLEL_LOG: dict = {}  # attention launches by (variant, shape, masked)
# collectives by (op, shape, dtype, scatter dim, gather dim, axis)
EXCHANGE_LOG: dict = {}
EXCHANGE_AXES: dict = {}  # a logged line's name -> its Axis
EXCHANGE_REPS = 3  # timed calls of each logged collective in the replay
PARALLEL_DEVICE = "cuda:0"  # the card the ranks share (a CPU rehearsal: "cpu")


def _nccl_probe_rank(rank: int, address: str, q) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://{address}",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        q.put((rank, "ok", float(x)))
        dist.destroy_process_group()
    except Exception as e:  # the message is the finding
        q.put((rank, "error", f"{type(e).__name__}: {e}"))


def nccl_probe() -> dict:
    """Two NCCL ranks on cuda:0 and one all-reduce: does NCCL take two
    ranks on one device? Each rank's outcome, verbatim."""
    import queue

    import torch

    from videosys_tpu_torch.core import parallel as par

    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    address = f"localhost:{par.free_port()}"
    procs = [ctx.Process(target=_nccl_probe_rank, args=(r, address, q))
             for r in range(2)]
    for p in procs:
        p.start()
    outcomes = {}
    deadline = time.monotonic() + 120
    while len(outcomes) < 2 and time.monotonic() < deadline:
        try:
            rank, status, detail = q.get(timeout=5)
            outcomes[rank] = {"status": status, "detail": detail}
        except queue.Empty:
            if not any(p.is_alive() for p in procs):
                break
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    accepted = len(outcomes) == 2 and all(
        o["status"] == "ok" for o in outcomes.values())
    out = {"accepted": accepted, "ranks": outcomes,
           "exitcodes": [p.exitcode for p in procs]}
    log("parallel: NCCL, two ranks on cuda:0:", json.dumps(out))
    return out


# run on every rank of an engine through VideoSysEngine._run_workers


def _log_collectives(par) -> None:
    """Wrap `par.all_to_all` and `par.gather` (the model and the pipeline
    call them through the module) to count each collective by its
    arguments in EXCHANGE_LOG; no sync, no clock: the request runs as
    served. The wrappers keep the plain function as `inner`."""
    if hasattr(par.all_to_all, "inner"):
        return

    def label(group):
        """An axis name, or for a line given as an Axis (the VAE's) its
        ranks (a key must sort and pickle); EXCHANGE_AXES maps it back."""
        if isinstance(group, str):
            return group
        name = "ranks " + ",".join(map(str, group.ranks))
        EXCHANGE_AXES[name] = group
        return name

    def note(key, group):
        if par.axis_size(group) > 1:
            EXCHANGE_LOG[key] = EXCHANGE_LOG.get(key, 0) + 1

    a2a, gather = par.all_to_all, par.gather

    def logged_a2a(x, scatter_dim, gather_dim, group=par.SP_AXIS):
        note(("all_to_all", tuple(x.shape), str(x.dtype), scatter_dim,
              gather_dim, label(group)), group)
        return a2a(x, scatter_dim, gather_dim, group)

    def logged_gather(x, dim, group=par.SP_AXIS):
        note(("gather", tuple(x.shape), str(x.dtype), dim, -1, label(group)),
             group)
        return gather(x, dim, group)

    logged_a2a.inner, logged_gather.inner = a2a, gather
    par.all_to_all, par.gather = logged_a2a, logged_gather


VAE_PEAK: dict = {}  # this rank's card memory over its last VAE decode


def _probe_vae(pipeline) -> None:
    """Wrap the pipeline's VAE decodes (once) to read the card's memory
    over each: VAE_PEAK holds the largest peak of a decode, the bytes held
    when it began and the request's peak before it. The decodes run
    together on every rank (the split VAE is collective)."""
    import torch

    vae = getattr(pipeline, "vae", None)
    if vae is None or getattr(vae, "_probed", False) \
            or pipeline.device.type != "cuda":
        return
    for name in ("decode", "decode_chunks_u8"):
        plain = getattr(vae, name, None)
        if plain is None:
            continue

        def probed(*args, _plain=plain, **kwargs):
            torch.cuda.synchronize()
            VAE_PEAK["before"] = max(VAE_PEAK.get("before", 0),
                                     torch.cuda.max_memory_allocated())
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                return _plain(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                if peak > VAE_PEAK.get("peak", -1):
                    VAE_PEAK.update(peak=peak, base=base)

        setattr(vae, name, probed)
    vae._probed = True


def rank_reset(pipeline) -> None:
    """Zero this rank's launch counts, shape log, exchange counters and
    log, peak memory and VAE probe; log each attention launch's variant
    and shape and each collective's arguments."""
    import torch

    from videosys_tpu_torch.core import parallel as par
    from videosys_tpu_torch.ops import flash_attention as fa

    if not hasattr(fa._launch, "logged"):
        launch = fa._launch

        def logged(q, k, v, scale, kv_mask, save_lse=False):
            B, H, Nq, D = q.shape
            key = (fa.kernel_variant(q.dtype, Nq, k.shape[2], D),
                   (B, H, Nq, k.shape[2], D), kv_mask is not None)
            PARALLEL_LOG[key] = PARALLEL_LOG.get(key, 0) + 1
            return launch(q, k, v, scale, kv_mask, save_lse)

        logged.logged = True
        fa._launch = logged
    _log_collectives(par)
    _probe_vae(pipeline)
    VAE_PEAK.clear()
    PARALLEL_LOG.clear()
    EXCHANGE_LOG.clear()
    fa.reset_launches()
    par.reset_exchange()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def rank_read(pipeline) -> dict:
    """This rank's counts since `rank_reset`, its latents and timers."""
    import torch

    from videosys_tpu_torch.core import parallel as par
    from videosys_tpu_torch.ops import flash_attention as fa

    cuda = torch.cuda.is_available()
    peak = max(VAE_PEAK.get("before", 0),
               torch.cuda.max_memory_allocated() if cuda else 0)
    vae_peak = VAE_PEAK.get("peak", 0)
    return {"launches": dict(fa.LAUNCHES),
            "shapes": [[v, list(s), m, n]
                       for (v, s, m), n in sorted(PARALLEL_LOG.items())],
            "peak_gib": peak / 2**30,
            # the decode's peak, and its working set (the peak less what
            # the rank held when the decode began: weights, caches)
            "vae_peak_gib": vae_peak / 2**30,
            "vae_working_gib": (vae_peak - VAE_PEAK.get("base", 0)) / 2**30,
            "exchange": dict(par.EXCHANGE),
            "timings_s": dict(pipeline.last_timings),
            "text_kv_len": getattr(pipeline, "last_text_kv_len", None),
            "latents": pipeline.last_latents}


def rank_exchange_replay(pipeline) -> dict:
    """Each collective of this rank's last request (EXCHANGE_LOG), replayed
    alone on a tensor of its shape: the median of EXCHANGE_REPS calls, each
    with a device sync before and after, times the request's count of it.
    Every rank replays the same keys in the same order, so the calls
    meet."""
    import statistics

    import torch

    from videosys_tpu_torch.core import parallel as par

    def sync():
        if pipeline.device.type == "cuda":
            torch.cuda.synchronize(pipeline.device)

    calls, total = [], 0.0
    with par.use_groups(pipeline.groups):
        for key in sorted(EXCHANGE_LOG):
            op, shape, dtype, a, b, name = key
            group = EXCHANGE_AXES.get(name, name)
            x = torch.randn(shape, device=pipeline.device).to(
                getattr(torch, dtype.removeprefix("torch.")))
            times = []
            for _ in range(EXCHANGE_REPS + 1):  # the first warms up
                sync()
                t0 = time.perf_counter()
                if op == "all_to_all":
                    par.all_to_all.inner(x, a, b, group)
                else:
                    par.gather.inner(x, a, group)
                sync()
                times.append(time.perf_counter() - t0)
            ms = 1e3 * statistics.median(times[1:])
            total += EXCHANGE_LOG[key] * ms / 1e3
            calls.append([op, list(shape), dtype, name, EXCHANGE_LOG[key],
                          ms])
    return {"seconds": total, "calls": calls}


def raise_on_workers(pipeline, *args, **kwargs):
    """Rank 0 generates and blocks in its first all-to-all; every other
    rank raises before it gets there."""
    if pipeline.groups.rank != 0:
        raise ValueError("fault injected on a worker by chip_smoke")
    return pipeline.generate(*args, **kwargs)


def set_steps(pipeline, steps: int) -> None:
    """The smoke's own switch of a built pipeline's rflow step count."""
    import dataclasses

    from videosys_tpu_torch.schedulers.rflow import RFlowScheduler

    pipeline.scheduler = RFlowScheduler(dataclasses.replace(
        pipeline.scheduler.config, num_sampling_steps=steps))


def rank_split_decode(pipeline, z, num_frames: int):
    """World 1's latents `z` through this rank's share of the split decode
    (the request's own VAE call, under the rank's groups), the VAE cast to
    fp32 for it: the uint8 video on rank 0, None on the others."""
    import torch

    from videosys_tpu_torch.core import parallel as par

    pipeline.vae.float()
    with par.use_groups(pipeline.groups):
        chunks = pipeline.vae.decode_chunks_u8(
            torch.from_numpy(z).to(pipeline.device), num_frames)
    return torch.cat(chunks, dim=1).cpu().numpy() if chunks else None


def world_record(label: str, backend: str, where: str, ranks: list,
                 video, ref: dict, expected: dict, steps: int,
                 split_video=None) -> dict:
    """Hold one world's ranks against the prediction and world 1; log it.
    `split_video`: a chunk of world 1's latents decoded split over the
    world's ranks in fp32, held against the same chunk decoded whole on
    world 1 at SPLIT_VAE_LEVELS."""
    import numpy as np

    lats = [r.pop("latents") for r in ranks]
    ranks_equal = all(np.array_equal(lat, lats[0]) for lat in lats)
    d = lats[0].astype(np.float64) - ref["latents"]
    rel_l2 = float(np.linalg.norm(d) / np.linalg.norm(ref["latents"]))
    levels = int(np.abs(video.astype(int) - ref["video"].astype(int)).max())
    denoise = ranks[0]["timings_s"]["denoise"]
    rec = {"world": label, "backend": backend, "where": where,
           "steps": steps, "video_shape": list(video.shape),
           "latents_finite": bool(np.isfinite(lats[0]).all()),
           "ranks_equal": ranks_equal, "latent_rel_l2": rel_l2,
           "video_max_levels": levels,
           "video_mean_levels": float(np.abs(
               video.astype(float) - ref["video"].astype(float)).mean()),
           "psnr_vs_world1_db": psnr_db(video, ref["video"]),
           "denoise_s": denoise, "denoise_step_s": denoise / steps,
           "expected_launches": expected, "ranks": ranks}
    vae_split = split_video is not None
    if vae_split:
        diff = np.abs(split_video.astype(int)
                      - ref["split_video"].astype(int))
        rec.update(split_vae_max_levels=int(diff.max()),
                   split_vae_mean_levels=float(diff.mean()),
                   split_vae_psnr_db=psnr_db(split_video,
                                             ref["split_video"]))
        log(f"parallel world {label}: world 1's latents (first chunk "
            f"{list(split_video.shape)}, fp32, TF32 off) decoded split over "
            f"{len(ranks)} ranks vs whole on world 1: max "
            f"{rec['split_vae_max_levels']} levels (limit {SPLIT_VAE_LEVELS})"
            f", mean {rec['split_vae_mean_levels']:.4f}, psnr "
            f"{rec['split_vae_psnr_db']:.2f} dB")
    for r in ranks:
        r["exchange_share"] = r["exchange"]["replayed"]["seconds"] / max(
            r["timings_s"]["denoise"], 1e-9)
    staged = ("host-staged (gloo copies each CUDA buffer through the host)"
              if backend == "gloo" else "over NCCL")
    log(f"parallel world {label}: backend {backend}, {where}; steps={steps} "
        f"denoise_s={denoise:.3f} ({denoise / steps:.4f} a step) "
        f"latent_rel_l2={rel_l2:.3e} video_max_levels={levels} "
        f"psnr={rec['psnr_vs_world1_db']:.2f} dB ranks_equal={ranks_equal}")
    w1_vae = ref.get("record", {}).get("vae_working_gib")
    for i, r in enumerate(ranks):
        if r["vae_peak_gib"] and w1_vae:
            # the prediction: a rank holds what it held before the decode
            # plus 1/world of world 1's VAE working set
            r["vae_predicted_gib"] = (r["vae_peak_gib"] - r["vae_working_gib"]
                                      + w1_vae / len(ranks))
        log(f"parallel world {label} rank {i}: backend {backend}, {where}; "
            f"vae_s={r['timings_s'].get('vae', 0.0):.3f} ("
            f"{f'split over {len(ranks)} ranks, all at once' if vae_split else 'whole on every rank'}"
            f") vae_peak_gib="
            f"{r['vae_peak_gib']:.3f} vae_working_gib="
            f"{r['vae_working_gib']:.3f} (predicted peak "
            f"{r.get('vae_predicted_gib', float('nan')):.3f}: held + world 1's "
            f"working set {w1_vae or float('nan'):.3f} / {len(ranks)})")
        log(f"parallel world {label} rank {i}: backend {backend}, {where}; "
            f"peak_gib={r['peak_gib']:.2f} denoise_s="
            f"{r['timings_s']['denoise']:.3f} launches={r['launches']} "
            f"(predicted {expected}) exchange: {r['exchange']['calls']} "
            f"calls, {r['exchange']['bytes'] / 2**30:.3f} GiB, replayed "
            f"alone {r['exchange']['replayed']['seconds']:.3f} s = "
            f"{100 * r['exchange_share']:.1f}% of the (untimed) denoise, "
            f"{staged}; replayed calls [op, shape, dtype, axis, count, ms] "
            f"{r['exchange']['replayed']['calls']}; "
            f"attention shapes {r['shapes']}")
    bad = [i for i, r in enumerate(ranks) if r["launches"] != expected]
    if bad:
        raise AssertionError(f"world {label}: ranks {bad} launched other "
                             f"than predicted {expected}")
    if not (ranks_equal and rec["latents_finite"]):
        raise AssertionError(f"world {label}: ranks disagree or non-finite")
    if rel_l2 > PARALLEL_LIMITS["latent_rel_l2"] \
            or levels > PARALLEL_LIMITS["video_levels"]:
        raise AssertionError(f"world {label} disagrees with world 1: "
                             f"{rel_l2:.3e}, {levels} levels")
    if vae_split and rec["split_vae_max_levels"] > SPLIT_VAE_LEVELS:
        raise AssertionError(f"world {label}: the split decode disagrees "
                             f"with the whole one")
    return rec


def free_card() -> float:
    """Drop this process's unreferenced tensors and cached blocks, so that
    ranks sharing the card find its memory; the GiB still reserved."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def full_width_world(fa, label: str, n: int, cp: bool, steps: int,
                     seed: int, backend: str, devices: list, where: str,
                     ref: dict) -> dict:
    """STDiT3-XL/2 and its VAE at 480p 9:16 2 s, bf16, on `n` ranks."""
    from videosys_tpu_torch import OpenSoraConfig, VideoSysEngine
    from videosys_tpu_torch.pipelines.open_sora.data_process import (
        get_image_size, get_num_frames)

    cfg = OpenSoraConfig(transformer=None, vae=None, text_encoder=None,
                         dtype="bf16", num_sampling_steps=steps, num_gpus=n,
                         enable_cp=cp)
    log(f"parallel world {label}: backend {backend}, {where}; the driver "
        f"holds {free_card():.2f} GiB before the ranks start")
    t0 = time.perf_counter()
    engine = VideoSysEngine(cfg, devices=devices, backend=backend,
                            timeout=PARALLEL_TIMEOUT_S, seed=seed)
    setup_s = time.perf_counter() - t0
    try:
        engine._run_workers(setattr, "keep_latents", True)
        engine._run_workers(rank_reset)
        t0 = time.perf_counter()
        video = engine.generate(seed=seed, **PARALLEL_REQUEST).video
        wall = time.perf_counter() - t0
        ranks = engine._run_workers(rank_read)
        for r, replay in zip(ranks, engine._run_workers(rank_exchange_replay)):
            r["exchange"]["replayed"] = replay
        h, w = get_image_size(PARALLEL_REQUEST["resolution"],
                              PARALLEL_REQUEST["aspect_ratio"])
        nf = get_num_frames(PARALLEL_REQUEST["num_frames"])
        split = engine._run_workers(rank_split_decode, ref["split_z"],
                                    SPLIT_VAE_CHUNK[1])[0]
        expected = expected_launches(
            fa, engine.pipeline, nf, h, w, steps,
            engine.pipeline.last_text_kv_len, sp=n // 2 if cp else n,
            vae_ranks=n)
    finally:
        engine.shutdown()
        del engine  # the driver's pipeline, freed before the next world
    rec = world_record(label, backend, where, ranks, video, ref, expected,
                       steps, split_video=split)
    rec.update(setup_s=setup_s, wall_s=wall)
    log(f"parallel world {label}: backend {backend}, {where}; setup_s="
        f"{setup_s:.1f} generate_s={wall:.3f}")
    return rec


def world1_leg(fa, seed: int, step_counts) -> dict:
    """World 1 through `initialize` with the groups installed, on the
    default backend (NCCL for a CUDA device), one NCCL all-reduce, then
    the 480p request at each step count: the references of the worlds."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from videosys_tpu_torch import OpenSoraConfig, OpenSoraPipeline
    from videosys_tpu_torch.core import parallel as par
    from videosys_tpu_torch.pipelines.open_sora.data_process import (
        get_image_size, get_num_frames)

    par.initialize(0, 1, f"localhost:{par.free_port()}",
                   device=PARALLEL_DEVICE)
    backend = dist.get_backend()
    try:
        groups = par.build_groups(par.ParallelConfig(), PARALLEL_DEVICE)
        x = torch.ones(1, device=PARALLEL_DEVICE)
        dist.all_reduce(x)
        if float(x) != 1.0:
            raise AssertionError("world-1 all-reduce changed its input")
        cfg = OpenSoraConfig(transformer=None, vae=None, text_encoder=None,
                             dtype="bf16", num_sampling_steps=max(step_counts))
        pipe = OpenSoraPipeline(cfg, seed=seed, groups=groups,
                                device=PARALLEL_DEVICE)
        pipe.keep_latents = True
        h, w = get_image_size(PARALLEL_REQUEST["resolution"],
                              PARALLEL_REQUEST["aspect_ratio"])
        nf = get_num_frames(PARALLEL_REQUEST["num_frames"])
        refs = {}
        for steps in step_counts:
            set_steps(pipe, steps)
            rank_reset(pipe)
            t0 = time.perf_counter()
            video = pipe.generate(seed=seed, **PARALLEL_REQUEST).video
            wall = time.perf_counter() - t0
            r = rank_read(pipe)
            want = expected_launches(fa, pipe, nf, h, w, steps,
                                     pipe.last_text_kv_len)
            z = r.pop("latents")
            zc = np.ascontiguousarray(
                z[:, :, :SPLIT_VAE_CHUNK[0], :, :z.shape[4] // 2])
            pipe.vae.float()  # the split decode's reference, in fp32
            split_ref = torch.cat(pipe.vae.decode_chunks_u8(
                torch.from_numpy(zc).to(PARALLEL_DEVICE),
                SPLIT_VAE_CHUNK[1]), dim=1).cpu().numpy()
            pipe.vae.to(pipe.dtype)
            refs[steps] = {"video": video, "split_z": zc,
                           "split_video": split_ref,
                           "latents": z.astype(np.float64), "record": dict(
                               r, steps=steps, wall_s=wall,
                               expected_launches=want)}
            log(f"parallel world 1: backend {backend} (the default for "
                f"{PARALLEL_DEVICE}), 1 rank on 1 card, groups installed; "
                f"steps={steps} "
                f"generate_s={wall:.3f} denoise_s="
                f"{r['timings_s']['denoise']:.3f} vae_s="
                f"{r['timings_s']['vae']:.3f} vae_peak_gib="
                f"{r['vae_peak_gib']:.3f} vae_working_gib="
                f"{r['vae_working_gib']:.3f} peak_gib={r['peak_gib']:.2f}"
                f" launches={r['launches']} (predicted {want}) exchange "
                f"calls={r['exchange']['calls']}")
            if r["launches"] != want or r["exchange"]["calls"]:
                raise AssertionError("world 1 launched other than predicted "
                                     "or exchanged")
        del pipe
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "refs": refs}


def tiny_parallel(seed: int, backend: str) -> dict:
    """A tiny fp32 Open-Sora on sp=2 and sp=4 ranks on cuda:0 against world
    1 on the card: 17 frames (T = 5 latent frames) at 144p 5:8 (a 9 x 15
    token grid), both padded under sp=2 and sp=4, an image (the batch
    switch) and a reference frame (x_mask); on the same ranks every other
    family's tiny parallel forward against the CPU (`rank_tiny_families`);
    then the engine's failure path."""
    import numpy as np
    import torch

    from videosys_tpu_torch import OpenSoraConfig, OpenSoraPipeline, VideoSysEngine
    from videosys_tpu_torch.core.engine import WorkerError
    from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as A
    from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
    from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config

    def config(**kw):
        return OpenSoraConfig(
            transformer=None, vae=None, text_encoder=None,
            num_sampling_steps=4, dtype="fp32", transformer_config=STDiT3Config(
                depth=2, hidden_size=32, num_heads=2, caption_channels=16,
                model_max_length=8), **kw)

    def vae():
        return A.OpenSoraVAE(
            A.OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
            spatial=AutoencoderKL2D(block_out_channels=(8, 8, 8, 16),
                                    layers_per_block=1, num_groups=4,
                                    mid_block_add_attention=False),
            temporal=VAETemporal(filters=8, num_res_blocks=1, num_groups=4))

    torch.manual_seed(seed)
    one = OpenSoraPipeline(config(), vae=vae(), seed=seed,
                           device=PARALLEL_DEVICE)
    one.keep_latents = True
    params = {name: {k: v.cpu().numpy() for k, v in m.state_dict().items()}
              for name, m in (("transformer", one.transformer),
                              ("vae", one.vae))}
    kw = dict(prompt="waves at dusk", resolution="144p", aspect_ratio="5:8",
              seed=seed)
    cases = {"video": dict(num_frames=17), "image": dict(num_frames=1),
             "reference": dict(num_frames=17, mask_strategy="0",
                               reference=np.random.default_rng(seed).uniform(
                                   -1, 1, (3, 1, 151, 241)).astype(np.float32))}
    refs = {}
    for case, extra in cases.items():
        one.generate(**kw, **extra)
        refs[case] = one.last_latents
    out = {}
    for label, n in (("sp2", 2), ("sp4", 4)):
        engine = VideoSysEngine(config(num_gpus=n), vae=vae(), params=params,
                                devices=[PARALLEL_DEVICE] * n,
                                backend=backend,
                                timeout=PARALLEL_TIMEOUT_S)
        try:
            engine._run_workers(setattr, "keep_latents", True)
            for case, extra in cases.items():
                engine.generate(**kw, **extra)
                lats = engine._run_workers(getattr, "last_latents")
                err = float(np.abs(lats[0] - refs[case]).max())
                equal = all(np.array_equal(x, lats[0]) for x in lats) \
                    and bool(np.isfinite(lats[0]).all())
                log(f"parallel tiny {label} {case}: backend {backend}, "
                    f"{SHARED}; fp32 latents max_abs_err vs world 1="
                    f"{err:.3e} (tol {PARALLEL_TINY_TOL:.0e}) "
                    f"ranks_equal={equal}")
                if not (err <= PARALLEL_TINY_TOL and equal):
                    raise AssertionError(f"tiny {label} {case} disagrees")
                out[f"{label}_{case}"] = {"max_abs_err": err,
                                          "ranks_equal": equal}
            # every family's parallel forward, card against the CPU
            fams = engine._run_workers(rank_tiny_families, seed)
            worst = {k: max(r[k] for r in fams) for k in fams[0]}
            log(f"parallel tiny {label} families: backend {backend}, "
                f"{SHARED}; fp32 forward max_abs_err, card (groups) vs CPU "
                f"(none), worst rank: {json.dumps(worst)} (tol "
                f"{PARALLEL_TINY_TOL:.0e})")
            if not all(e <= PARALLEL_TINY_TOL for e in worst.values()):
                raise AssertionError(f"tiny {label}: a family's parallel "
                                     f"forward disagrees")
            out[f"{label}_families"] = worst
            if label == "sp2":  # the failure path
                t0 = time.perf_counter()
                try:
                    engine._run_workers(raise_on_workers, **kw,
                                        **cases["image"])
                except WorkerError as e:
                    took = time.perf_counter() - t0
                    first = str(e).splitlines()[0]
                    log(f"parallel failure path: backend {backend}, "
                        f"{SHARED}; a raising worker failed the "
                        f"driver's call in {took:.2f} s (timeout "
                        f"{PARALLEL_TIMEOUT_S:.0f} s): {first} / "
                        f"{str(e).strip().splitlines()[-1]}")
                    if "fault injected" not in str(e):
                        raise AssertionError("the call failed with another "
                                             "error than the worker's")
                    out["failure"] = {"seconds": took, "error": first}
                else:
                    raise AssertionError("a raising worker's call returned")
        finally:
            engine.shutdown()
    return out


def parallel_kernel_shapes(fa, text_len: int) -> dict:
    """The forward kernels at one rank's attention shapes of the parallel
    worlds (480p 2 s, CFG batch 2, T 15 padded to 16 under sp=2, S 1590
    padded to 1592 under sp=4), against their plain versions."""
    return forward_shapes(fa, [
        ("sp2_spatial", 16, 16, 1590, 1590, 72, False),
        ("sp2_temporal", 1590, 16, 16, 16, 72, 15),
        ("sp2_cross", 32, 16, 795, text_len, 72, True),
        ("cp2_spatial", 15, 16, 1590, 1590, 72, False),
        ("cp2_temporal", 1590, 16, 15, 15, 72, False),
        ("cp2_cross", 15, 16, 1590, text_len, 72, True),
        ("cp2sp2_spatial", 8, 16, 1590, 1590, 72, False),
        ("cp2sp2_temporal", 795, 16, 16, 16, 72, 15),
        ("cp2sp2_cross", 16, 16, 795, text_len, 72, True),
        ("sp4_spatial", 8, 16, 1592, 1592, 72, 1590)], seed=5)


# the other families' worlds, ranks sharing the card: (label, family,
# num_gpus, enable_cp). Each serves its family's request at full width,
# FAMILY_STEPS denoise steps (v1.1's PNDM takes 4 at least) and one
# decode, against world 1 (the driver's own pipeline, its groups taken
# away for one request, on the same seed)
FAMILY_WORLDS = (("cog2b_sp2", "cog2b", 2, False),
                 ("osp120_sp2", "osp120", 2, False),
                 ("latte_sp2", "latte", 2, False),
                 ("latte_cp2", "latte", 2, True),
                 ("osp110_sp2", "osp110", 2, False),
                 ("vchitect_sp2", "vchitect", 2, False))
FAMILY_STEPS = 1
# transformer blocks of each family world (published depths 18-32), cut to
# keep the script inside its time: the worlds test layouts, pads, shapes
# and launches, which the depth does not change (PERF.md §4)
FAMILY_LAYERS = 8


def family_config(family: str, dtype: str = "bf16",
                  layers: Optional[int] = None, **kw):
    """The family's serving config at its published widths and depth,
    random weights, the stub encoders, in `dtype` ("bf16" or "fp32");
    `layers` cuts the transformer to that many blocks (its published
    model config with `num_layers` replaced), for other families than
    Open-Sora."""
    import dataclasses

    import torch

    from videosys_tpu_torch import (CogVideoXConfig, LatteConfig,
                                    OpenSoraConfig, OpenSoraPlanConfig,
                                    VchitectConfig)
    from videosys_tpu_torch.models.transformers.cogvideox import (
        CogVideoXConfig as CogModelConfig)
    from videosys_tpu_torch.models.transformers.latte import (
        LatteConfig as LatteModelConfig)
    from videosys_tpu_torch.models.transformers.open_sora_plan_v110 import (
        OpenSoraPlanV110Config)
    from videosys_tpu_torch.models.transformers.open_sora_plan_v120 import (
        OpenSoraPlanV120Config)
    from videosys_tpu_torch.models.transformers.vchitect import VchitectModelConfig

    def cut(mc):  # None keeps the pipeline's own published config
        if layers is None:
            return None
        return dataclasses.replace(mc, num_layers=layers)

    tdtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    if family == "open_sora":
        return OpenSoraConfig(transformer=None, vae=None, text_encoder=None,
                              dtype=dtype, **kw)
    if family == "cog2b":  # the pipeline's 2b model config
        return CogVideoXConfig(model_path=None, dtype=dtype,
                               transformer_config=cut(CogModelConfig(
                                   use_rotary_positional_embeddings=False,
                                   num_layers=30, num_heads=30)), **kw)
    if family == "osp120":  # the pipeline's 29 x 480p model config
        return OpenSoraPlanConfig(
            version="v120", transformer_type="29x480p", dtype=dtype,
            transformer_config=cut(OpenSoraPlanV120Config(
                sample_size=(60, 80), sample_size_t=(29 - 1) // 4 + 1,
                dtype=tdtype)), **kw)
    if family == "osp110":
        mc = OpenSoraPlanV110Config("65x512x512", use_rope=True, dtype=tdtype)
        return OpenSoraPlanConfig(
            version="v110", transformer_type="65x512x512", dtype=dtype,
            transformer_config=cut(mc) or mc, **kw)
    if family == "latte":
        return LatteConfig(model_path=None, dtype=dtype,
                           transformer_config=cut(LatteModelConfig(
                               dtype=tdtype)), **kw)
    mc = VchitectModelConfig(dtype=tdtype)
    return VchitectConfig(model_path=None, dtype=dtype,
                          transformer_config=cut(mc) or mc, **kw)


def family_request(family: str) -> dict:
    steps = dict(num_inference_steps=4 if family == "osp110"
                 else FAMILY_STEPS)
    if family == "cog2b":
        return dict(COG_REQUEST, **steps)
    if family in ("osp120", "osp110"):
        return dict(prompt=OSP_PROMPT, **steps)
    if family == "latte":
        return dict(LATTE_REQUEST, **steps)
    return dict(VCHITECT_REQUEST, **steps)


def family_launches(fa, family: str, pipe, sp: int = 1) -> dict:
    """One rank's launches of the family's request (dense) on
    `sp` sequence-parallel ranks: the transformer's rows at the rank's
    shapes (`latte_launches`, `osp_v120_launches`, `vchitect_launches`;
    CogVideoX one joint attention a layer over L + N padded to sp) and the
    VAE's whole decode, which every rank runs."""
    mc = pipe.model_config
    req = family_request(family)
    steps = req["num_inference_steps"]
    text_len = getattr(pipe, "last_text_kv_len", None)
    if family == "cog2b":
        _, F, _, h, w = pipe.latent_shape(req["num_frames"], req["height"],
                                          req["width"])
        N = F * (h // mc.patch_size) * (w // mc.patch_size)
        n = mc.max_text_seq_length + -(-N // sp) * sp
        want = {key: 0 for key in fa.LAUNCHES}
        want[fa.kernel_variant(pipe.dtype, n, n, mc.head_dim)] = \
            mc.num_layers * steps
        return want
    if family in ("osp120", "osp110"):
        _, _, T, h, w = pipe.latent_shape()
        S = pipe._tokens(pipe.latent_shape())
        if family == "osp120":
            want = osp_v120_launches(fa, pipe, steps, T * S, text_len, sp=sp)
        else:
            want = latte_launches(fa, pipe, len(pipe.scheduler.set_timesteps(
                steps)), -(-T // sp) * sp, S, text_len)
        for _, th, tw in causal_vae_tiles(pipe.vae, T, h, w):
            want[fa.kernel_variant(pipe.dtype, th * tw, th * tw,
                                   vae_width(pipe))] += 1
        return want
    if family == "latte":
        T = req["video_length"]
        shape = pipe.latent_shape(T, req["height"], req["width"])
        S = (shape[3] // mc.patch_size) * (shape[4] // mc.patch_size)
        want = latte_launches(fa, pipe, steps, -(-T // sp) * sp, S, text_len)
    else:
        F = req["frames"]
        shape = pipe.latent_shape(F, req["height"], req["width"])
        S = (shape[3] // mc.patch_size) * (shape[4] // mc.patch_size)
        L = pipe.text_encoder.clip_len + pipe.text_encoder.t5_len
        want = vchitect_launches(fa, pipe, steps, F, S, L, sp=sp)
    n_mid = shape[3] * shape[4]  # one decode of every frame
    d_mid = pipe.vae.block_out_channels[-1]
    want[fa.kernel_variant(pipe.dtype, n_mid, n_mid, d_mid)] += 1
    return want


def family_rank_shapes(family: str, text_len) -> list:
    """One rank's attention rows at sp=2 (or cp=2: Latte's halves of the
    CFG batch give the same rows), predicted before any run: (name, B, H,
    Nq, Nk, D, masked) as `forward_shapes` takes them; `masked` an int is
    the real keys of every row."""
    if family == "cog2b":  # 226 text + 13 x 30 x 45 video tokens, 30 heads
        return [("sp2_cog2b", 2, 15, 17776, 17776, 64, False)]
    if family == "osp120":  # 8 x 30 x 40 tokens, 24 heads
        return [("sp2_osp120", 2, 12, 9600, 9600, 96, False),
                ("sp2_osp120_cross", 2, 24, 4800, text_len, 96, True)]
    if family == "latte":  # 16 frames of 32 x 32 patches, CFG batch 2
        return [("sp2_latte_spatial", 16, 16, 1024, 1024, 72, False),
                ("sp2_latte_cross", 16, 16, 1024, text_len, 72, True),
                ("sp2_latte_temporal", 1024, 16, 16, 16, 72, False)]
    if family == "osp110":  # 17 frames padded to 18, 32 x 32 patches
        return [("sp2_osp110_spatial", 18, 16, 1024, 1024, 72, False),
                ("sp2_osp110_cross", 18, 16, 1024, text_len, 72, True),
                ("sp2_osp110_temporal", 1024, 16, 18, 18, 72, 17)]
    # Vchitect: 40 frames of 18 x 30 patches and 333 context tokens
    return [("sp2_vchitect_spatial", 20, 18, 873, 873, 64, False),
            ("sp2_vchitect_cross", 1, 18, 17460, 333, 64, False),
            ("sp2_vchitect_temporal", 437, 18, 40, 40, 64, False)]


def world1_on_driver(fa, engine, family: str, seed: int) -> dict:
    """World 1 of a family world: the driver's pipeline (rank 0 of the
    engine, the same seeded weights) serves the request alone, its groups
    taken away; launches counted from 0 and held against the family's
    world-1 prediction."""
    import numpy as np
    import torch

    pipe = engine.pipeline
    groups, pipe.groups = pipe.groups, None
    try:
        fa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = pipe.generate(seed=seed, **family_request(family)).video
        wall = time.perf_counter() - t0
    finally:
        pipe.groups = groups
    launches = dict(fa.LAUNCHES)
    want = family_launches(fa, family, pipe)
    rec = {"launches": launches, "expected_launches": want, "wall_s": wall,
           "timings_s": dict(pipe.last_timings),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"parallel world 1 of {family}: the driver's pipeline alone, groups "
        f"taken away; steps={family_request(family)['num_inference_steps']} "
        f"generate_s={wall:.3f} denoise_s="
        f"{rec['timings_s']['denoise']:.3f} peak_gib={rec['peak_gib']:.2f} "
        f"launches={launches} (predicted {want})")
    if launches != want:
        raise AssertionError(f"world 1 of {family} launched other than "
                             f"predicted")
    return {"video": video, "latents": pipe.last_latents.astype(np.float64),
            "record": rec}


def family_world(fa, label: str, family: str, n: int, cp: bool, seed: int,
                 backend: str, refs: dict) -> dict:
    """One family world on `n` ranks sharing the card: the request once
    (untimed, launches and attention shapes logged per rank), the exchange
    replayed, then world 1 on the driver's pipeline (kept in `refs` by
    family for the next world of that family); held by `world_record`.
    The logged per-rank shapes must be the predicted ones."""
    from videosys_tpu_torch import VideoSysEngine

    log(f"parallel world {label}: backend {backend}, {SHARED}; the driver "
        f"holds {free_card():.2f} GiB before the ranks start")
    t0 = time.perf_counter()
    cp_kw = {"enable_cp": True} if cp else {}  # CogVideoX has no cp
    engine = VideoSysEngine(family_config(family, layers=FAMILY_LAYERS,
                                          num_gpus=n, **cp_kw),
                            devices=[PARALLEL_DEVICE] * n, backend=backend,
                            timeout=PARALLEL_TIMEOUT_S, seed=seed)
    setup_s = time.perf_counter() - t0
    try:
        engine._run_workers(setattr, "keep_latents", True)
        engine._run_workers(rank_reset)
        t0 = time.perf_counter()
        video = engine.generate(seed=seed, **family_request(family)).video
        wall = time.perf_counter() - t0
        ranks = engine._run_workers(rank_read)
        for r, replay in zip(ranks, engine._run_workers(rank_exchange_replay)):
            r["exchange"]["replayed"] = replay
        sp = n // 2 if cp else n
        expected = family_launches(fa, family, engine.pipeline, sp=sp)
        if family not in refs:
            refs[family] = world1_on_driver(fa, engine, family, seed)
    finally:
        engine.shutdown()
        del engine
    rec = world_record(label, backend, SHARED, ranks, video, refs[family],
                       expected, family_request(family)["num_inference_steps"])
    rec.update(setup_s=setup_s, wall_s=wall, family=family,
               world1=refs[family]["record"])
    text_len = ranks[0]["text_kv_len"]
    want = {(tuple(s[1:6]), bool(s[6])) for s in
            family_rank_shapes(family, text_len)}
    for i, r in enumerate(ranks):
        got = {(tuple(shape), masked) for variant, shape, masked, _ in
               r["shapes"] if variant != "wgmma"}
        if got != want:
            raise AssertionError(f"world {label} rank {i}: attention shapes "
                                 f"{sorted(got)} != predicted {sorted(want)}")
    log(f"parallel world {label}: backend {backend}, {SHARED}; setup_s="
        f"{setup_s:.1f} generate_s={wall:.3f}; per-rank attention shapes as "
        f"predicted")
    return rec


def family_kernel_shapes(fa, worlds: dict) -> dict:
    """The forward kernels at each new per-rank shape of the family worlds
    against their plain versions at the limits of their kind (bf16), timed
    beside the plain version and SDPA: the rows over more than 4096 keys by
    `long_row` (chunked plain version, sampled heads), the rest by
    `forward_shapes`; each row's launches a request from rank 0's log."""
    import torch

    rows, seen = [], set()
    for rec in worlds.values():
        for row in family_rank_shapes(rec["family"],
                                      rec["ranks"][0]["text_kv_len"]):
            if row[1:] not in seen:
                seen.add(row[1:])
                rows.append((row, rec))
    gen = torch.Generator("cuda").manual_seed(16)
    out = {}
    for (name, B, H, Nq, Nk, D, masked), rec in rows:
        if Nq > 4096 and Nq == Nk and not masked:
            out[name] = long_row(fa, name, B, H, Nq, D, gen)
        else:
            out.update(forward_shapes(fa, [(name, B, H, Nq, Nk, D, masked)],
                                      seed=16, dtypes=("bf16",)))
        out[name]["world"] = rec["world"]
        out[name]["variant"] = fa.kernel_variant(torch.bfloat16, Nq, Nk, D)
        out[name]["launches"] = sum(
            c for _, shape, m, c in rec["ranks"][0]["shapes"]
            if shape == [B, H, Nq, Nk, D] and m == bool(masked))
    return out


def rank_tiny_families(pipeline, seed: int) -> dict:
    """On every rank of a tiny world: a tiny fp32 transformer of each
    family, sized so that every pad is taken (3 heads; 45 video tokens;
    5 and 3 frames; 15 and 25 patches; Vchitect's S + L = 14 + 333), on
    this rank's device under its groups, against the same forward with no
    groups on the CPU: the largest absolute difference by family."""
    import numpy as np
    import torch

    from videosys_tpu_torch.core import parallel as par
    from videosys_tpu_torch.models.transformers import cogvideox as C
    from videosys_tpu_torch.models.transformers import latte as La
    from videosys_tpu_torch.models.transformers import open_sora_plan_v120 as O
    from videosys_tpu_torch.models.transformers import vchitect as V

    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    steps2 = torch.tensor([500.0, 720.0])
    cog = dict(num_layers=2, num_heads=3, head_dim=16, in_channels=4,
               out_channels=4, time_embed_dim=16, text_embed_dim=16,
               max_text_seq_length=8)
    ragged = torch.arange(8)[None] < torch.tensor([[8], [5]])
    cases = {
        "cog2b": (lambda: C.CogVideoXTransformer3D(C.CogVideoXConfig(**cog)),
                  (t(2, 3, 4, 6, 10), t(2, 8, 16), steps2)),
        "cog5b": (lambda: C.CogVideoXTransformer3D(C.CogVideoXConfig(
            **cog, use_rotary_positional_embeddings=True)),
            (t(2, 3, 4, 6, 10), t(2, 8, 16), steps2)),
        "osp120": (lambda: O.OpenSoraPlanV120Transformer(
            O.OpenSoraPlanV120Config(num_layers=2, num_heads=3, head_dim=24,
                                     caption_channels=32, sample_size=(6, 10),
                                     sample_size_t=3)),
            (t(2, 4, 3, 12, 20), t(2, 8, 32), steps2, ragged)),
        "latte": (lambda: La.LatteT2V(La.LatteConfig(
            num_layers=2, num_heads=2, head_dim=16, caption_channels=16,
            video_length=5, sample_size=8)),
            (t(2, 4, 5, 6, 10), steps2, t(2, 8, 16), ragged)),
        "osp110": (lambda: La.LatteT2V(La.LatteConfig(
            num_layers=2, num_heads=2, head_dim=24, caption_channels=32,
            video_length=3, sample_size=10, use_rope=True)),
            (t(2, 4, 3, 10, 10), steps2, t(2, 8, 32), ragged)),
        "vchitect": (lambda: V.VchitectXLTransformer(V.VchitectModelConfig(
            num_layers=3, num_heads=2, head_dim=16, in_channels=4,
            out_channels=4, joint_attention_dim=32, pooled_projection_dim=24,
            sample_size=8, pos_embed_max_size=12)),
            (t(1, 5, 4, 4, 14), t(1, 333, 32), t(1, 24),
             torch.tensor([500.0]))),
    }
    errs = {}
    for name, (make, inputs) in cases.items():
        torch.manual_seed(seed)
        model = make().float().eval()
        with torch.no_grad():
            want = model(*inputs)
            model.to(pipeline.device)
            with par.use_groups(pipeline.groups):
                got = model(*(a.to(pipeline.device) for a in inputs))
        errs[name] = float((got.cpu() - want).abs().max())
    return errs


def parallel_phase(fa, steps: int, seed: int) -> dict:
    """Open-Sora v1.2 served through `VideoSysEngine(num_gpus=N)` with the
    ranks sharing one card (see the module docstring, phase 16), each
    world at PARALLEL_SHORT_STEPS against world 1 (NCCL, `initialize`);
    then every other family's worlds (FAMILY_WORLDS), their per-rank
    kernel rows, and the tiny worlds."""
    import torch

    t_start = time.perf_counter()
    out = {"nccl_probe": nccl_probe()}
    backend = "nccl" if out["nccl_probe"]["accepted"] else "gloo"
    how = ("NCCL took two ranks on one device" if backend == "nccl"
           else "NCCL refused two ranks on one device")
    log(f"parallel: ranks that share one card run backend {backend}, passed "
        f"explicitly ({how})")
    if steps != PARALLEL_SHORT_STEPS:
        log(f"parallel: the Open-Sora worlds run {PARALLEL_SHORT_STEPS} rflow "
            f"steps (the serve phase's request runs {steps}; cut to keep the "
            f"script inside its time)")
    w1 = world1_leg(fa, seed, [PARALLEL_SHORT_STEPS])
    out["world1"] = {s: r["record"] for s, r in w1["refs"].items()}
    out["worlds"] = {}
    for label, n, cp in PARALLEL_WORLDS:
        out["worlds"][label] = full_width_world(
            fa, label, n, cp, PARALLEL_SHORT_STEPS, seed, backend,
            [PARALLEL_DEVICE] * n, SHARED, w1["refs"][PARALLEL_SHORT_STEPS])
    if torch.cuda.device_count() >= 2:
        out["worlds"]["sp2_nccl"] = full_width_world(
            fa, "sp2_nccl", 2, False, PARALLEL_SHORT_STEPS, seed, "nccl",
            ["cuda:0", "cuda:1"], "two cards",
            w1["refs"][PARALLEL_SHORT_STEPS])
    else:
        log(f"parallel: sp=2 over NCCL on two cards did not run: "
            f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    refs = {}
    out["family_worlds"] = {}
    for label, family, n, cp in FAMILY_WORLDS:
        out["family_worlds"][label] = family_world(fa, label, family, n, cp,
                                                   seed, backend, refs)
    del refs
    free_card()
    out["tiny"] = tiny_parallel(seed, backend)
    out["kernel"] = parallel_kernel_shapes(
        fa, out["worlds"]["sp2"]["ranks"][0]["text_kv_len"])
    out["family_kernel"] = family_kernel_shapes(fa, out["family_worlds"])
    out["seconds"] = time.perf_counter() - t_start
    log(f"parallel phase: {out['seconds']:.1f} s")
    return out


# opt-in phase parallel_fp32: the drift of the DSP and cp worlds against
# world 1, in fp32 with TF32 off (in bf16 they read 1.7e-2 to 3.2e-2
# relative L2 after 2 steps)
DRIFT_WORLDS = (("open_sora_sp2", "open_sora", 2, False),
                ("open_sora_cp2", "open_sora", 2, True),
                ("latte_sp2", "latte", 2, False),
                ("latte_cp2", "latte", 2, True),
                ("osp110_sp2", "osp110", 2, False),
                ("vchitect_sp2", "vchitect", 2, False))
DRIFT_STEPS = 2  # Open-Sora-Plan v1.1's PNDM takes 4 at least


def drift_world(label: str, family: str, n: int, cp: bool, seed: int,
                backend: str) -> dict:
    """One world in fp32 against world 1 (the driver's pipeline with its
    groups taken away): the final latents' relative L2."""
    import numpy as np

    from videosys_tpu_torch import VideoSysEngine

    steps = 4 if family == "osp110" else DRIFT_STEPS
    if family == "open_sora":
        cfg_kw, request = dict(num_sampling_steps=steps), dict(PARALLEL_REQUEST)
    else:
        cfg_kw = {}
        request = dict(family_request(family), num_inference_steps=steps)
        if family == "vchitect":  # two fp32 decodes of 40 frames at once
            request["frames"] = 16  # would outgrow the card

    if cp:
        cfg_kw["enable_cp"] = True
    free_card()
    engine = VideoSysEngine(family_config(family, "fp32", num_gpus=n,
                                          **cfg_kw),
                            devices=[PARALLEL_DEVICE] * n, backend=backend,
                            timeout=PARALLEL_TIMEOUT_S, seed=seed)
    try:
        engine._run_workers(setattr, "keep_latents", True)
        engine.generate(seed=seed, **request)
        lats = engine._run_workers(getattr, "last_latents")
        pipe = engine.pipeline
        groups, pipe.groups = pipe.groups, None
        try:
            pipe.generate(seed=seed, **request)
        finally:
            pipe.groups = groups
        ref = pipe.last_latents.astype(np.float64)
    finally:
        engine.shutdown()
        del engine
    rel = float(np.linalg.norm(lats[0] - ref) / np.linalg.norm(ref))
    equal = all(np.array_equal(x, lats[0]) for x in lats)
    log(f"parallel_fp32 world {label}: backend {backend}, {SHARED}; fp32, "
        f"TF32 off, {steps} steps; latents rel_l2 vs world 1 = {rel:.3e} "
        f"ranks_equal={equal}")
    if not (equal and np.isfinite(rel)):
        raise AssertionError(f"parallel_fp32 {label}: ranks disagree")
    return {"latent_rel_l2": rel, "steps": steps}


def parallel_fp32_phase(seed: int) -> dict:
    """The DSP and cp worlds of phase 16 in fp32 with TF32 off, 2 steps,
    against world 1 in fp32: near 1e-5 the bf16 drift is rounding, at 1e-3
    or more a layout fault."""
    import torch

    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("parallel_fp32 needs TF32 off")
    out = {label: drift_world(label, family, n, cp, seed, "gloo")
           for label, family, n, cp in DRIFT_WORLDS}
    out["seconds"] = time.perf_counter() - t0
    log(f"parallel_fp32 phase: {out['seconds']:.1f} s")
    return out


# phase 17: training over ranks, dp and sp with ZeRO-1 (training/train_step.py)
PTRAIN_STEPS = 3
PTRAIN_BATCH = 2  # the global batch of the 240p 51-frame bucket
# (label, dp, sp, depth): the ZeRO-1 worlds, an earlier path, at 8 pairs
# (with their own world 1 at that depth) to pay for the zero3_dynsp world's
# 28 (PERF.md §4); at 28 pairs ZeRO-1 could not hold dp=2 x sp=2 (4 x (14 B
# x 1.209e9 params + ~2 GiB) = 71 GiB of the card)
PTRAIN_WORLDS = (("dp2", 2, 1, 8), ("sp2", 1, 2, 8), ("dp2sp2", 2, 2, 8))
# zero3_dynsp: four ranks, ZeRO-3 and dynamic sp at full depth; a given
# planner puts each bucket on its own layout (sp of the pool: dp = 4 / sp)
# and the bucket batches (x dp_size 2) make the global batches 4, 4 and 2;
# one epoch of the dataset `zds_dataset` is one plan of each bucket
ZDS_DEPTH = 28
ZDS_BUCKETS = {"144p": {1: (1.0, 2), 51: (1.0, 2)}, "240p": {51: (1.0, 1)}}
ZDS_SP = {("144p", 1): 1, ("144p", 51): 2, ("240p", 51): 4}
# full width, bf16, 3 steps against world 1 on the same global batch and
# draws: the largest relative difference of a step's loss and grad norm.
# Read on an H100 (dp=2, sp=2, dp=2 x sp=2; PERF.md): at most 4.0e-4 and
# 7.8e-4; the limits are about four times those
PTRAIN_LIMITS = {"loss_rel": 2e-3, "grad_norm_rel": 3e-3}
PTRAIN_TIMEOUT_S = 900.0
EXCHANGE_TIME: dict = {}  # seconds in each torch.distributed collective


def ptrain_config(dp: int, sp: int, depth: int, seed: int, **kw):
    """STDiT3-XL/2 at its published width, `depth` pairs, bf16 compute,
    the 240p 51-frame bucket at a global batch of PTRAIN_BATCH, recompute
    "full", PTRAIN_STEPS steps."""
    import torch

    from videosys_tpu_torch import TrainConfig
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config

    kw.setdefault("model", STDiT3Config(depth=depth, dtype=torch.bfloat16))
    return TrainConfig(
        bucket_config={"240p": {51: (1.0, PTRAIN_BATCH // dp)}},
        remat_policy="full", max_steps=PTRAIN_STEPS, log_every=1,
        warmup_steps=2, seed=seed, dataset_size=64, dp_size=dp, sp_size=sp,
        **kw)


def ptrain_dataset(seed: int):
    from videosys_tpu_torch.training.datasets import DummyVariableVideoTextDataset

    return DummyVariableVideoTextDataset(
        size=64, seed=seed, distribution="uniform", frames_choices=(51,),
        resolution_choices=((240, 426),))


def _time_collectives() -> None:
    """Wrap torch.distributed's collectives (once) to add each call's
    seconds to EXCHANGE_TIME, with the card synchronized before (the
    queued compute is not the exchange's) and after."""
    import torch
    import torch.distributed as dist

    if getattr(dist.all_reduce, "timed", False):
        return
    for name in ("all_to_all_single", "all_gather", "reduce_scatter",
                 "all_reduce", "broadcast", "gather", "reduce"):
        plain = getattr(dist, name)

        def timed(*args, _plain=plain, _name=name, **kwargs):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _plain(*args, **kwargs)
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                EXCHANGE_TIME[_name] = EXCHANGE_TIME.get(_name, 0.0) \
                    + time.perf_counter() - t0

        timed.timed = True
        setattr(dist, name, timed)


# bytes a training rank holds, their largest over the steps, and the card's
# peak over the steps (run_training's end, which makes a ZeRO-3 model and
# EMA whole on every rank, not counted)
HELD: dict = {}
LAYOUT_LOG: dict = {}  # (layout, variant, shape, masked) -> forward launches


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _probe_training() -> None:
    """Wrap (once) the optimizer's update, the EMA update and the forward
    kernels' launch: HELD records the gradient bytes an update finds and the
    parameter and EMA bytes after it, LAYOUT_LOG each forward launch's
    shape under the layout in force. Counts only; nothing is timed."""
    from videosys_tpu_torch.core import parallel as par
    from videosys_tpu_torch.ops import flash_attention as fa
    from videosys_tpu_torch.training import train as tr
    from videosys_tpu_torch.training import train_step as ts

    if getattr(tr.update_ema, "probed", False):
        return
    update, ema_update, launch = ts.ClippedAdamW.update, tr.update_ema, \
        fa._launch

    def held(key, n):
        HELD[key] = max(HELD.get(key, 0), n)

    def probed_update(tx, dp=None):
        held("grads", _nbytes(p.grad for p in tx.params if p.grad is not None))
        return update(tx, dp)

    def probed_ema(ema, model, decay):
        import torch

        out = ema_update(ema, model, decay)
        held("params", _nbytes(model.parameters()))
        held("ema", _nbytes(ema.values()))
        if torch.cuda.is_available():
            held("steps_peak", torch.cuda.max_memory_allocated())
        return out

    def logged(q, k, v, scale, kv_mask, save_lse=False):
        groups = par.active_groups()
        c = groups.config if groups is not None else None
        layout = (c.dp_size, c.cp_size, c.sp_size) if c else None
        B, H, Nq, D = q.shape
        key = (layout, fa.kernel_variant(q.dtype, Nq, k.shape[2], D),
               (B, H, Nq, k.shape[2], D), kv_mask is not None)
        LAYOUT_LOG[key] = LAYOUT_LOG.get(key, 0) + 1
        return launch(q, k, v, scale, kv_mask, save_lse)

    probed_ema.probed = True
    ts.ClippedAdamW.update, tr.update_ema, fa._launch = \
        probed_update, probed_ema, logged


def rank_parallel_train(target, dataset, params=None, planner=None,
                        cfg=None) -> dict:
    """`run_training` of `cfg` (default the rank's own; its dp x sp must be
    the rank's groups') on this training rank (`core/worker.py`'s
    TrainRank): its launches, forward shapes by layout, peak, the bytes
    it held (ZeRO moments, and the largest parameter, gradient and EMA
    bytes of a step), exchange calls, bytes and seconds, and the metrics
    history."""
    import torch

    from videosys_tpu_torch.core import parallel as par
    from videosys_tpu_torch.ops import flash_attention as fa
    from videosys_tpu_torch.training.train import run_training

    _time_collectives()
    _probe_training()
    fa.reset_launches()
    par.reset_exchange()
    EXCHANGE_TIME.clear()
    HELD.clear()
    LAYOUT_LOG.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with no_fallback(fa):
        state, ema, history = run_training(
            cfg or target.cfg, dataset=dataset, device=target.device,
            groups=target.groups, params=params, planner=planner)
    torch.cuda.synchronize()
    out = {"history": history, "launches": dict(fa.LAUNCHES),
           "shapes": [[list(k[0]) if k[0] else None, k[1], list(k[2]), k[3],
                       n] for k, n in sorted(LAYOUT_LOG.items(), key=str)],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "moment_bytes": state.tx.moment_bytes, "held": dict(HELD),
           "param_count": sum(p.numel() for p in state.model.parameters()),
           "exchange": dict(par.EXCHANGE),
           "exchange_s": dict(EXCHANGE_TIME), "wall_s":
           time.perf_counter() - t0}
    del state, ema
    free_card()
    return out


def world_runs(cfg, backend: str, four, *args) -> tuple:
    """Every rank's `rank_parallel_train(*args)` for `cfg`: on `four` (the
    phase's running dp=2 x sp=2 ranks) where cfg is dp_size 2 x sp_size 2,
    else on dp x sp ranks spawned for it on the shared card and stopped
    after (a spawn costs ~10 s); (results, the spawn's seconds)."""
    from videosys_tpu_torch.core.engine import Ranks
    from videosys_tpu_torch.core.worker import setup_train_rank

    if four is not None and (cfg.dp_size, cfg.sp_size) == (2, 2):
        return four._run_workers(rank_parallel_train, *args, cfg=cfg), 0.0
    n = cfg.dp_size * cfg.sp_size
    t0 = time.perf_counter()
    ranks = Ranks()
    ranks._spawn(n, setup_train_rank, (cfg,), [PARALLEL_DEVICE] * n, backend,
                 PTRAIN_TIMEOUT_S)
    setup_s = time.perf_counter() - t0
    try:
        return ranks._run_workers(rank_parallel_train, *args), setup_s
    finally:
        ranks.shutdown()


def ptrain_world(fa, label: str, dp: int, sp: int, depth: int, seed: int,
                 backend: str, ref: list, four=None) -> dict:
    """One training world on dp x sp ranks: every rank's run, held against
    world 1's history `ref` and the launch prediction."""
    n = dp * sp
    cfg = ptrain_config(dp, sp, depth, seed)
    where = SHARED
    log(f"parallel_train world {label}: backend {backend}, {where}; the "
        f"driver holds {free_card():.2f} GiB before the ranks start")
    got, setup_s = world_runs(cfg, backend, four, ptrain_dataset(seed))
    hist = got[0]["history"]
    if any(r["history"] != hist for r in got[1:]):
        raise AssertionError(f"parallel_train {label}: ranks' histories "
                             f"disagree")
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(hist, ref))
    norm_rel = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                   for a, b in zip(hist, ref))
    steps_s = sum(h["seconds"] for h in hist)
    P = got[0]["param_count"]
    predicted_moments = 2 * 4 * -(-P // n)
    rec = {"world": label, "dp": dp, "sp": sp, "depth": depth,
           "backend": backend, "where": where, "setup_s": setup_s,
           "loss": [h["loss"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "world1_loss": [h["loss"] for h in ref],
           "world1_grad_norm": [h["grad_norm"] for h in ref],
           "loss_max_rel": loss_rel, "grad_norm_max_rel": norm_rel,
           "step_s": [h["seconds"] for h in hist], "ranks": []}
    log(f"parallel_train world {label}: backend {backend}, {where}; "
        f"dp={dp} sp={sp} depth={depth} steps={len(hist)} setup_s="
        f"{setup_s:.1f} step_s={[round(h['seconds'], 3) for h in hist]} "
        f"loss={rec['loss']} (world 1 {rec['world1_loss']}) grad_norm="
        f"{rec['grad_norm']} (world 1 {rec['world1_grad_norm']}) max rel "
        f"diff loss {loss_rel:.3e} grad_norm {norm_rel:.3e} (limits "
        f"{PTRAIN_LIMITS})")
    for i, r in enumerate(got):
        want = {key: 0 for key in fa.LAUNCHES}
        for h in r["history"]:
            add_launches(want, step_launches(
                fa, cfg.model, h["thw"], h["batch"] // dp, h["gas"],
                h["remat_policy"], sp=sp))
        ex_s = sum(r["exchange_s"].values())
        bwd = {k: v for k, v in r["launches"].items() if k.startswith("bwd")}
        log(f"parallel_train world {label} rank {i}: backend {backend}, "
            f"{where}; peak_gib={r['peak_gib']:.2f} zero1_moment_bytes="
            f"{r['moment_bytes']} (predicted 2 x 4 x ceil({P} / {n}) = "
            f"{predicted_moments}; world 1 {8 * P}) exchange: "
            f"{r['exchange']} ({ex_s:.3f} s in collectives = "
            f"{100 * ex_s / max(steps_s, 1e-9):.1f}% of the steps' "
            f"{steps_s:.3f} s; by op {r['exchange_s']}) launches={r['launches']}"
            f" (predicted {want}); backward launches {bwd}")
        rec["ranks"].append({"peak_gib": r["peak_gib"],
                             "moment_bytes": r["moment_bytes"],
                             "exchange": r["exchange"], "exchange_s": ex_s,
                             "exchange_share": ex_s / max(steps_s, 1e-9),
                             "launches": r["launches"],
                             "expected_launches": want})
        if r["launches"] != want:
            raise AssertionError(f"parallel_train {label} rank {i} launched "
                                 f"other than predicted")
        if r["moment_bytes"] != predicted_moments:
            raise AssertionError(f"parallel_train {label} rank {i}: moments "
                                 f"are not 1/{n} of the whole")
    if not (loss_rel <= PTRAIN_LIMITS["loss_rel"]
            and norm_rel <= PTRAIN_LIMITS["grad_norm_rel"]):
        raise AssertionError(f"parallel_train {label} disagrees with world 1")
    return rec


def ptrain_world1(fa, depth: int, seed: int) -> list:
    """World 1 on the driver: the global batch on one rank."""
    import torch

    from videosys_tpu_torch import run_training

    cfg = ptrain_config(1, 1, depth, seed)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with no_fallback(fa):
        state, ema, history = run_training(cfg, dataset=ptrain_dataset(seed),
                                           device="cuda:0")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"parallel_train world 1 (depth {depth}): 1 rank, the global batch "
        f"{PTRAIN_BATCH}; step_s={[round(h['seconds'], 3) for h in history]} "
        f"loss={[h['loss'] for h in history]} grad_norm="
        f"{[h['grad_norm'] for h in history]} peak_gib={peak:.2f} "
        f"launches={dict(fa.LAUNCHES)}")
    del state, ema
    free_card()
    return history


def zds_config(seed: int, world1: bool = False):
    """The zero3_dynsp world's TrainConfig: STDiT3-XL/2 at its published
    width, bf16 compute, "full" recompute, PTRAIN_STEPS steps;
    dp_size=2 x sp_size=2 with dynamic_sp and zero3, or (`world1`) the same
    global batches on one rank."""
    import torch

    from videosys_tpu_torch import TrainConfig
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config

    buckets = {res: {t: (p, bs * (2 if world1 else 1))
                     for t, (p, bs) in frames.items()}
               for res, frames in ZDS_BUCKETS.items()}
    return TrainConfig(
        model=STDiT3Config(depth=ZDS_DEPTH, dtype=torch.bfloat16),
        bucket_config=buckets, remat_policy="full", max_steps=PTRAIN_STEPS,
        log_every=1, warmup_steps=2, seed=seed, dataset_size=10,
        dp_size=1 if world1 else 2, sp_size=1 if world1 else 2,
        dynamic_sp=not world1, zero3=not world1)


def zds_dataset(seed: int):
    """Exactly one global batch of each ZDS bucket: 4 images at 144p, 4
    clips of 51 frames at 144p, 2 at 240p."""
    from videosys_tpu_torch.training.datasets import DummyVariableVideoTextDataset

    ds = DummyVariableVideoTextDataset(size=10, seed=seed)
    ds._shapes = ([(1, 144, 256)] * 4 + [(51, 144, 256)] * 4
                  + [(51, 240, 426)] * 2)
    return ds


def zds_planner():
    """The given planner: each bucket at its ZDS_SP (matched by resolution
    and frames), gas 1."""
    from videosys_tpu_torch.training.sampler import DCPPlanner

    return DCPPlanner(profile={(res, t, "0.56"): {"time": 1.0, "sp": sp}
                               for (res, t), sp in ZDS_SP.items()})


def zds_expected(fa, mc, history) -> dict:
    """One rank's launches over the history, each step on its layout
    (its "mesh": a rank's batch is the global over the layout's dp)."""
    want = {key: 0 for key in fa.LAUNCHES}
    for h in history:
        dp, _, sp = h["mesh"]
        add_launches(want, step_launches(fa, mc, h["thw"], h["batch"] // dp,
                                         h["gas"], h["remat_policy"], sp=sp))
    return want


def zds_held_prediction(depth: int, n: int) -> dict:
    """Bytes a rank should hold under ZeRO-3 on n ranks, from the model's
    leaves (built on the meta device): each unit's sharded leaves padded to
    a multiple of n over n, plus the whole small leaves; the same of
    gradients and EMA, twice of moments; the whole model's for scale."""
    import torch

    from videosys_tpu_torch.models.transformers.stdit3 import (
        STDiT3,
        STDiT3Config,
    )
    from videosys_tpu_torch.training.zero3 import ZERO3_MIN_SHARD_BYTES

    with torch.device("meta"):
        model = STDiT3(STDiT3Config(depth=depth))
    units, small, whole = {}, 0, 0
    for name, p in model.named_parameters():
        whole += 4 * p.numel()
        if 4 * p.numel() < ZERO3_MIN_SHARD_BYTES:
            small += 4 * p.numel()
        else:
            u = model.param_unit(name)
            units[u] = units.get(u, 0) + p.numel()
    held = sum(4 * -(-k // n) for k in units.values()) + small
    return {"params": held, "grads": held, "ema": held, "moments": 2 * held,
            "small": small, "whole": whole,
            "largest_unit": 4 * max(units.values())}


def zds_world(fa, seed: int, backend: str, four=None) -> dict:
    """zero3_dynsp: four ranks sharing the card, ZeRO-3 and dynamic sp at
    28 pairs, the three buckets on three layouts (ZDS_SP), held against
    world 1 on the same global batches and plans at PTRAIN_LIMITS; each
    rank's launches against its layouts' shapes, its bytes against the
    1/4 prediction, its peak and its seconds in collectives."""
    import torch

    from videosys_tpu_torch import run_training

    cfg = zds_config(seed)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with no_fallback(fa):
        state, ema, ref = run_training(zds_config(seed, world1=True),
                                       dataset=zds_dataset(seed),
                                       device="cuda:0", planner=zds_planner())
    w1_peak = torch.cuda.max_memory_allocated() / 2**30
    del state, ema
    log(f"parallel_train zero3_dynsp world 1 (depth {ZDS_DEPTH}): buckets "
        f"{[h['bucket'] for h in ref]} step_s="
        f"{[round(h['seconds'], 3) for h in ref]} loss="
        f"{[h['loss'] for h in ref]} grad_norm="
        f"{[h['grad_norm'] for h in ref]} peak_gib={w1_peak:.2f}")
    log(f"parallel_train world zero3_dynsp: backend {backend}, {SHARED}; the "
        f"driver holds {free_card():.2f} GiB before the ranks start")
    got, setup_s = world_runs(cfg, backend, four, zds_dataset(seed), None,
                              zds_planner())
    hist = got[0]["history"]
    if any(r["history"] != hist for r in got[1:]):
        raise AssertionError("zero3_dynsp: ranks' histories disagree")
    if [h["bucket"] for h in hist] != [h["bucket"] for h in ref]:
        raise AssertionError("zero3_dynsp ran other plans than world 1")
    layouts = {h["mesh"] for h in hist}
    want_layouts = {(4 // sp, 1, sp) for sp in ZDS_SP.values()}
    if layouts != want_layouts:
        raise AssertionError(f"zero3_dynsp ran on {layouts}, not "
                             f"{want_layouts}")
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(hist, ref))
    norm_rel = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                   for a, b in zip(hist, ref))
    steps_s = sum(h["seconds"] for h in hist)
    pred = zds_held_prediction(ZDS_DEPTH, 4)
    rec = {"world": "zero3_dynsp", "depth": ZDS_DEPTH, "backend": backend,
           "setup_s": setup_s, "layouts": [h["mesh"] for h in hist],
           "buckets": [h["bucket"] for h in hist],
           "loss": [h["loss"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "world1_loss": [h["loss"] for h in ref],
           "world1_grad_norm": [h["grad_norm"] for h in ref],
           "world1_peak_gib": w1_peak, "loss_max_rel": loss_rel,
           "grad_norm_max_rel": norm_rel,
           "step_s": [h["seconds"] for h in hist], "held_predicted": pred,
           "ranks": []}
    log(f"parallel_train world zero3_dynsp: backend {backend}, {SHARED}; "
        f"dp_size=2 sp_size=2 dynamic_sp zero3 depth={ZDS_DEPTH} layouts="
        f"{rec['layouts']} buckets={rec['buckets']} setup_s={setup_s:.1f} "
        f"step_s={[round(x, 3) for x in rec['step_s']]} loss={rec['loss']} "
        f"(world 1 {rec['world1_loss']}) grad_norm={rec['grad_norm']} (world "
        f"1 {rec['world1_grad_norm']}) max rel diff loss {loss_rel:.3e} "
        f"grad_norm {norm_rel:.3e} (limits {PTRAIN_LIMITS}); predicted "
        f"bytes a rank {pred}")
    for i, r in enumerate(got):
        want = zds_expected(fa, cfg.model, r["history"])
        ex_s = sum(r["exchange_s"].values())
        held = dict(r["held"], moments=r["moment_bytes"])
        steps_peak = held.pop("steps_peak", 0) / 2**30
        log(f"parallel_train world zero3_dynsp rank {i}: backend {backend}, "
            f"{SHARED}; peak_gib={r['peak_gib']:.2f} (over the steps "
            f"{steps_peak:.2f}; the rest is run_training's end, which gathers "
            f"the whole model and EMA) held bytes {held} "
            f"(predicted params/grads/EMA {pred['params']}, moments "
            f"{pred['moments']}; whole model {pred['whole']}) exchange: "
            f"{r['exchange']} ({ex_s:.3f} s in collectives = "
            f"{100 * ex_s / max(steps_s, 1e-9):.1f}% of the steps' "
            f"{steps_s:.3f} s; by op {r['exchange_s']}) launches="
            f"{r['launches']} (predicted {want}); forward shapes by layout "
            f"[layout, variant, shape, masked, launches] {r['shapes']}")
        rec["ranks"].append({"peak_gib": r["peak_gib"], "held": held,
                             "steps_peak_gib": steps_peak,
                             "exchange": r["exchange"], "exchange_s": ex_s,
                             "exchange_share": ex_s / max(steps_s, 1e-9),
                             "launches": r["launches"],
                             "expected_launches": want, "shapes": r["shapes"]})
        if r["launches"] != want:
            raise AssertionError(f"zero3_dynsp rank {i} launched other than "
                                 f"predicted")
        if held.get("grads", 0) > pred["grads"]:
            raise AssertionError(f"zero3_dynsp rank {i}: gradient bytes "
                                 f"{held.get('grads')} above 1/4 of the "
                                 f"sharded leaves ({pred['grads']})")
        for key in ("params", "ema", "moments"):
            if held.get(key) != pred[key]:
                raise AssertionError(f"zero3_dynsp rank {i}: {key} bytes "
                                     f"{held.get(key)} are not 1/4 of the "
                                     f"sharded leaves ({pred[key]})")
    if not (loss_rel <= PTRAIN_LIMITS["loss_rel"]
            and norm_rel <= PTRAIN_LIMITS["grad_norm_rel"]):
        raise AssertionError("zero3_dynsp disagrees with world 1")
    return rec


TINY_WORLDS = ("dp2", "sp2", "dp2sp2", "zero3_dp2sp2", "dynamic_sp")


def tiny_ptrain(fa, seed: int, backend: str, four=None,
                labels=TINY_WORLDS) -> dict:
    """A tiny fp32 configuration trained 3 steps at dp=2, sp=2 and dp=2 x
    sp=2 (ZeRO-1), at dp=2 x sp=2 under ZeRO-3 (hidden 128, so that its
    weights shard) and with dynamic sp (images at sp 1, clips at sp 4, a
    global batch of 4) on the card's kernels (ranks sharing it) against
    world 1 on the CPU (plain versions) on the same weights, plans and
    global batches: losses at 1e-4, grad norms at 1e-3 relative, as the
    tiny one-rank parity phase. `labels` picks the worlds; those of four
    ranks run on `four` when given."""
    import torch

    from videosys_tpu_torch import TrainConfig, run_training
    from videosys_tpu_torch.models.transformers.stdit3 import (
        STDiT3,
        STDiT3Config,
    )
    from videosys_tpu_torch.training.sampler import DCPPlanner

    models = {hidden: STDiT3Config(depth=2, hidden_size=hidden, num_heads=2,
                                   caption_channels=16, model_max_length=8,
                                   dtype=torch.float32)
              for hidden in (32, 128)}
    params = {}
    for hidden, mc in models.items():
        torch.manual_seed(seed)  # the same weights on the card and the CPU
        params[hidden] = {k: v.clone()
                          for k, v in STDiT3(mc).state_dict().items()}
    planner = DCPPlanner(profile={("144p", 1, "1.00"): {"time": 1.0, "sp": 1},
                                  ("144p", 51, "1.00"): {"time": 1.0, "sp": 4}})

    def config(dp, sp, hidden=32, batch=2, **kw):
        return TrainConfig(
            model=models[hidden],
            bucket_config={"144p": {1: (1.0, batch // dp),
                                    51: (1.0, batch // dp)}},
            mask_ratios={"identity": 0.5, "quarter_head": 0.25,
                         "random": 0.25},
            max_steps=3, log_every=1, warmup_steps=2, lr=1e-3, seed=seed,
            dataset_size=16, dp_size=dp, sp_size=sp, **kw)

    # (label, dp, sp, hidden, global batch, fields, planned)
    worlds = (("dp2", 2, 1, 32, 2, {}, False), ("sp2", 1, 2, 32, 2, {}, False),
              ("dp2sp2", 2, 2, 32, 2, {}, False),
              ("zero3_dp2sp2", 2, 2, 128, 2, {"zero3": True}, False),
              ("dynamic_sp", 2, 2, 32, 4, {"dynamic_sp": True}, True))
    cpu_runs = {}
    out = {}
    for label, dp, sp, hidden, batch, fields, planned in worlds:
        if label not in labels:
            continue
        plan = planner if planned else None
        if (hidden, batch, planned) not in cpu_runs:
            cpu_runs[hidden, batch, planned] = run_training(
                config(1, 1, hidden, batch), device="cpu",
                params=params[hidden], planner=plan)[2]
        cpu = cpu_runs[hidden, batch, planned]
        got = world_runs(config(dp, sp, hidden, batch, **fields), backend,
                         four, None, params[hidden], plan)[0]
        card = got[0]["history"]
        loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(card, cpu))
        norm_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                       for a, b in zip(card, cpu))
        launches = got[0]["launches"]
        layouts = sorted({str(h["mesh"]) for h in card})
        log(f"parallel_train tiny {label}: backend {backend}, {SHARED}; fp32 "
            f"card kernels vs CPU world 1 (plain), 3 steps on layouts "
            f"{layouts}: losses {[h['loss'] for h in card]} vs "
            f"{[h['loss'] for h in cpu]} max_abs_diff={loss_err:.3e} (tol "
            f"1e-4) grad_norm max_rel_diff={norm_err:.3e} (tol 1e-3) held "
            f"bytes rank 0 {got[0]['held']} launches rank 0 {launches}")
        if [h["bucket"] for h in card] != [h["bucket"] for h in cpu]:
            raise AssertionError(f"tiny {label} ran other plans than world 1")
        if not (loss_err <= 1e-4 and norm_err <= 1e-3):
            raise AssertionError(f"tiny parallel training {label} disagrees "
                                 f"with the CPU's world 1")
        if not (launches["f32"] > 0 and launches["bwd_fused_f32"] > 0):
            raise AssertionError(f"tiny {label} did not launch the kernels")
        out[label] = {"loss_max_abs_diff": loss_err,
                      "grad_norm_max_rel_diff": norm_err, "layouts": layouts}
    return out


def ptrain_kernel_shapes(fa) -> dict:
    """The kernels at one rank's new training rows of the sp=2 world (240p,
    51 frames: T 15 padded to 16, S 405 padded to 406, the pad masked)
    against their plain versions: the forwards and the backward each row
    takes; and the wide forward at one rank's share of the 480p decode
    under cp=2 x sp=2 (5 of a chunk's 17 frames)."""
    B = PTRAIN_BATCH  # sp=2: the whole global batch on the pair
    fwd = forward_shapes(fa, [
        ("ptrain_spatial", B * 8, 16, 406, 406, 72, 405),
        ("ptrain_cross", B * 16, 16, 203, 8, 72, False),
        ("ptrain_temporal", B * 203, 16, 16, 16, 72, 15),
        ("vae_mid_rank", 5, 1, 6360, 6360, 512, False)], seed=5,
        dtypes=("bf16",))
    bwd = backward_kernel_phase(fa, [
        ("ptrain_spatial", B * 8, 16, 406, 406, 72, 405, "blocked"),
        ("ptrain_cross", B * 16, 16, 203, 8, 72, False, "fused"),
        ("ptrain_temporal", B * 203, 16, 16, 16, 72, 15, "fused")])
    return {"fwd": fwd, "bwd": bwd}


# one rank's training rows in the zero3_dynsp world's new layouts: sp=4
# (240p, 51 frames, a global batch of 2: T 15 padded to 16, S 405 to 408)
# and dp=4 (a 144p image a rank: 144 tokens)
ZDS_ROWS = (("zds_sp4_spatial", 2 * 16 // 4, 16, 408, 408, 72, 405),
            ("zds_sp4_cross", 2 * 16, 16, 102, 8, 72, False),
            ("zds_sp4_temporal", 2 * 102, 16, 16, 16, 72, 15),
            ("zds_dp4_spatial", 1, 16, 144, 144, 72, False),
            ("zds_dp4_cross", 1, 16, 144, 8, 72, False))


def zds_kernel_shapes(fa, world: dict) -> dict:
    """The ZDS_ROWS (each among rank 0's logged forward shapes of its
    layout) against their plain versions, forward and the backward each
    takes, timed beside SDPA; their launches a rank from the world's log."""
    import torch

    logged = {(tuple(layout), tuple(shape)): n for layout, _, shape, _, n in
              world["ranks"][0]["shapes"] if layout}
    launches = {}
    for name, B, H, Nq, Nk, D, _ in ZDS_ROWS:
        layout = (1, 1, 4) if "sp4" in name else (4, 1, 1)
        n = logged.get((layout, (B, H, Nq, Nk, D)), 0)
        if n <= 0:
            raise AssertionError(f"the zero3_dynsp world never launched "
                                 f"{name} [{B}, {H}, {Nq}, {Nk}, {D}]")
        launches[name] = n
    fwd = forward_shapes(fa, list(ZDS_ROWS), seed=7, dtypes=("bf16",))
    bwd = backward_kernel_phase(fa, [
        row + (fa.backward_variant(*row[1:6], torch.bfloat16),)
        for row in ZDS_ROWS])
    for name in launches:
        log(f"zero3_dynsp row {name}: forward {fwd[name]['shape']} "
            f"{fwd[name]['ms']:.4f} ms (plain {fwd[name]['plain_ms']:.4f}, "
            f"SDPA {fwd[name]['library_ms']:.4f}, bound "
            f"{fwd[name]['bound_ms']:.4f} by {fwd[name]['bound_by']}); "
            f"backward {bwd[name]['backward']}: "
            + ", ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, "
                        f"SDPA {v['library_ms']:.4f}, bound "
                        f"{v['bound_ms']:.4f})" for k, v in bwd[name].items()
                        if isinstance(v, dict) and "ms" in v)
            + f"; forward launches a rank {launches[name]}")
    return {"fwd": fwd, "bwd": bwd, "launches": launches}


def parallel_train_phase(fa, seed: int) -> dict:
    """STDiT3-XL/2 trained over ranks sharing the card (dp=2, sp=2, dp=2 x
    sp=2; ZeRO-1, DSP under recompute; at 8 pairs), each against world 1
    on the same global batch and draws; zero3_dynsp (ZeRO-3 and dynamic
    sp at 28 pairs on three layouts) against its world 1; the tiny fp32
    worlds; the kernel rows of the sp=2 world and of the new layouts."""
    from videosys_tpu_torch.core.engine import Ranks
    from videosys_tpu_torch.core.worker import setup_train_rank

    t_start = time.perf_counter()
    backend = "gloo"  # NCCL refuses two ranks on one device (phase 16)
    out = {"worlds": {}}
    refs = {}
    for label, dp, sp, depth in PTRAIN_WORLDS:
        if depth not in refs:
            refs[depth] = ptrain_world1(fa, depth, seed)
        if dp * sp < 4:  # the driver is rank 0 of one world at a time
            out["worlds"][label] = ptrain_world(
                fa, label, dp, sp, depth, seed, backend, refs[depth])
    out["tiny"] = tiny_ptrain(fa, seed, backend, labels=("dp2", "sp2"))
    # the dp=2 x sp=2 ranks, spawned once for every four-rank world
    t0 = time.perf_counter()
    four = Ranks()
    four._spawn(4, setup_train_rank, (ptrain_config(2, 2, 1, seed),),
                [PARALLEL_DEVICE] * 4, backend, PTRAIN_TIMEOUT_S)
    log(f"parallel_train: the four dp=2 x sp=2 ranks spawned in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        for label, dp, sp, depth in PTRAIN_WORLDS:
            if dp * sp == 4:
                out["worlds"][label] = ptrain_world(
                    fa, label, dp, sp, depth, seed, backend, refs[depth], four)
        out["worlds"]["zero3_dynsp"] = zds_world(fa, seed, backend, four)
        out["tiny"].update(tiny_ptrain(
            fa, seed, backend, four,
            labels=("dp2sp2", "zero3_dp2sp2", "dynamic_sp")))
    finally:
        four.shutdown()
    out["kernel"] = ptrain_kernel_shapes(fa)
    out["zds_kernel"] = zds_kernel_shapes(fa, out["worlds"]["zero3_dynsp"])
    out["seconds"] = time.perf_counter() - t_start
    log(f"parallel_train phase: {out['seconds']:.1f} s")
    return out


ENTRY_SAMPLES = (("open_sora", ("run_base", "run_pab")),
                 ("latte", ("run_base", "run_pab")),
                 ("cogvideox", ("run_base", "run_pab")),
                 ("open_sora_plan", ("run_base", "run_v110", "run_pab")),
                 ("vchitect", ("run_base", "run_pab")))


def entry_points_phase(fa) -> dict:
    """Every port entry point's tiny mode on the card (no `device`: the
    default), each video kept as its frames (the engines' `save_video` is
    replaced here by a writer of .npy files: the card's machine may lack
    imageio) and read back finite with its frame count; each call's
    attention launches, which must not be 0."""
    import importlib
    import tempfile

    import numpy as np

    from videosys_tpu_torch.core import engine as engine_mod
    from videosys_tpu_torch.examples.eval import pab_experiments
    from videosys_tpu_torch.examples.gradio import cogvideox as demo

    def keep(video, output_path, fps=24):
        path = f"{output_path}.npy"
        np.save(path, np.asarray(video))
        return path

    def frames(path):
        arr = np.load(path)
        if arr.dtype != np.uint8 or arr.ndim != 4 or arr.shape[0] < 1:
            raise AssertionError(f"entry point wrote {arr.dtype} {arr.shape}")
        return list(arr.shape)

    def launched(label, t0):
        n = dict(fa.LAUNCHES)
        total = sum(n.values())
        if total <= 0:
            raise AssertionError(f"entry point {label} launched no kernel")
        return {"s": time.perf_counter() - t0,
                "launches": {k: v for k, v in n.items() if v}}

    out = {}
    saved = engine_mod._save_video
    engine_mod._save_video = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for family, names in ENTRY_SAMPLES:
                mod = importlib.import_module(
                    f"videosys_tpu_torch.examples.inference.{family}.sample")
                for name in names:
                    fa.reset_launches()
                    t0 = time.perf_counter()
                    path = getattr(mod, name)(tiny=True, outdir=tmp)
                    rec = launched(f"{family}.{name}", t0)
                    rec["frames"] = frames(path)
                    out[f"{family}.{name}"] = rec
            fa.reset_launches()
            t0 = time.perf_counter()
            quality = pab_experiments.run_pab_quality(tiny=True)
            out["pab_quality"] = dict(launched("pab_quality", t0), **quality)
            if not (quality["n"] == 1 and np.isfinite(quality["psnr"])):
                raise AssertionError(f"pab_quality read {quality}")
            fa.reset_launches()
            t0 = time.perf_counter()
            dense, pab = demo.build_engines(tiny=True)
            pair = demo.generate_pair(dense, pab, "Sunset over the sea.",
                                      steps=2, outdir=tmp, num_frames=5,
                                      height=32, width=32)
            rec = launched("gradio generate_pair", t0)
            rec["frames"] = {k: frames(p) for k, (p, _) in pair.items()}
            rec["seconds"] = {k: s for k, (_, s) in pair.items()}
            out["gradio_pair"] = rec
    finally:
        engine_mod._save_video = saved
    for label, rec in out.items():
        log(f"entry_points {label}: {rec['s']:.2f} s, frames "
            f"{rec.get('frames')}, launches {rec['launches']}"
            + (f", psnr {rec['psnr']:.2f} ssim {rec['ssim']:.4f}"
               if "psnr" in rec else ""))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10,
                    help="rflow sampling steps of the full-width requests "
                         "(serve and offload)")
    ap.add_argument("--cog5b-steps", type=int, default=COG_5B_STEPS,
                    help="DPM steps of the CogVideoX-5b request (the 2b "
                         f"runs {COG_STEPS} of the request's "
                         f"{COG_REQUEST_STEPS})")
    ap.add_argument("--vchitect-steps", type=int, default=VCHITECT_RUN_STEPS,
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
    if not set(phases) <= set(PHASES + OPT_IN_PHASES):
        ap.error(f"--phases takes a subset of {PHASES + OPT_IN_PHASES}")
    def timed(name: str, fn, *fn_args):
        t0 = time.perf_counter()
        result = fn(*fn_args)
        log(f"{name} phase: {time.perf_counter() - t0:.1f} s")
        return result

    if "kernel" in phases:  # phase 2: forward kernel against plain
        shapes = timed("kernel", kernel_phase, fa, text_len)
    if "serve" in phases:  # phase 3: the serving path
        served = timed("serve", serve_phase, fa, args.steps, args.seed,
                       args.profile)
    if "tiny" in phases:  # phase 4: tiny configuration, card against CPU
        timed("tiny", tiny_parity_phase, args.seed)
    if "t5" in phases:  # phase 5: the T5-XXL text encoder
        timed("t5", t5_phase, args.seed)
    if "offload" in phases:  # phase 6: T5, checkpoint loading, cpu_offload
        # 5 steps, to keep the script inside its time: the phase compares
        # the two requests' first step and video, not the step count
        timed("offload", offload_phase, fa, min(args.steps, 5), args.seed)
    if "bwd_kernel" in phases:  # phase 7: backward kernels against plain
        bwd_shapes = timed("bwd_kernel", backward_kernel_phase, fa)
    if "train" in phases:  # phase 8: the training path
        trained = timed("train", train_phase, fa, TRAIN_STEPS, args.seed,
                        args.profile, args.remat_policy)
    if "tiny_train" in phases:  # phase 9: tiny training, card against CPU
        timed("tiny_train", tiny_train_parity_phase, fa, args.seed)
    if "cogvideox" in phases:  # phase 10: CogVideoX serving, its kernel shapes
        cog = timed("cogvideox", cogvideox_phase, fa, args.seed,
                    args.cog5b_steps, args.profile)
    if "dcp" in phases:  # phase 11: training with the DCP profile phase
        dcp = timed("dcp", dcp_phase, fa, args.seed)
    if "raw_video" in phases:  # phase 12: raw video, preprocess, latents
        raw = timed("raw_video", raw_video_phase, fa, args.seed)
    if "latte" in phases:  # phase 13: Latte-1 serving, its kernel shapes
        latte = timed("latte", latte_phase, fa, args.seed, args.profile)
    if "open_sora_plan" in phases:  # phase 14: Open-Sora-Plan v1.1 and v1.2
        osp = timed("open_sora_plan", open_sora_plan_phase, fa, args.seed,
                    args.profile)
    if "vchitect" in phases:  # phase 15: Vchitect-2.0 serving, its shapes
        vch = timed("vchitect", vchitect_phase, fa, args.seed,
                    args.vchitect_steps, args.profile)
    if "parallel" in phases:  # phase 16: parallel serving, every family
        par_out = parallel_phase(fa, args.steps, args.seed)
    if "parallel_train" in phases:  # phase 17: training over ranks
        ptrain = parallel_train_phase(fa, args.seed)
    if "entry_points" in phases:  # phase 18: the entry points, tiny
        timed("entry_points", entry_points_phase, fa)
    if "parallel_fp32" in phases:  # opt-in: the DSP and cp drift in fp32
        parallel_fp32_phase(args.seed)
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
    # the long forward at CogVideoX's joint attention (the TPU takes it to
    # the blocked kernel: more than 4096 keys), launches from each width's
    # request
    for name in COG_WIDTHS:
        r = cog["kernel"][name]
        n = cog["launches"][name]["long"]
        if n <= 0:
            raise AssertionError(f"CogVideoX-{name} never launched "
                                 f"flash_fwd_long")
        kernels.append({
            "name": "flash_fwd_long", "route": "cuda",
            "source": FWD_SOURCES["long"],
            "replaces": "videosys_tpu/ops/flash_attention.py:49",
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    # the long forward at the 1080p training row, launches from the
    # training path (its 1080p image step)
    r = bwd_shapes["train1080"]
    if trained["launches"]["long"] <= 0:
        raise AssertionError("training never launched flash_fwd_long")
    kernels.append({
        "name": "flash_fwd_long", "route": "cuda",
        "source": FWD_SOURCES["long"],
        "replaces": "videosys_tpu/ops/flash_attention.py:49",
        "launches": trained["launches"]["long"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
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
    # that runs them: the long forward at head_dim 96 (more than 4096 keys
    # go to the blocked kernel on the TPU), the narrow forward at the 17-key
    # temporal rows and the cross-attention, and at the LatteT2V rows of
    # Latte-1 and v1.1; the short forward at Latte's 16-frame temporal rows;
    # the wide forward at the VAEs' mid attention
    for r, request, key, replaces in (
            (latte["kernel"]["latte_vae_mid"], latte["dense"], "wgmma", 49),
            (osp["kernel"]["osp480"], osp["29x480p"]["dense"], "long", 49),
            (osp["kernel"]["osp93"], osp["93x480p"]["dense"], "long", 49),
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
                     "short": "flash_fwd_short", "long": "flash_fwd_long"}[key],
            "route": "cuda", "source": FWD_SOURCES[key],
            "replaces": f"videosys_tpu/ops/flash_attention.py:{replaces}",
            "launches": n, "max_abs_err": r.get("max_abs_err",
                                                r.get("max_abs_err_bf16")),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    # one rank's shapes in the parallel worlds (ranks sharing the card),
    # launches per rank per request from rank 0 of the world that ran them
    for shape, world, key in (
            ("sp2_spatial", "sp2", "narrow"), ("sp2_cross", "sp2", "narrow"),
            ("sp2_temporal", "sp2", "short"),
            ("cp2_spatial", "cp2", "narrow"), ("cp2_cross", "cp2", "narrow"),
            ("cp2_temporal", "cp2", "short"),
            ("cp2sp2_spatial", "cp2sp2", "narrow"),
            ("cp2sp2_cross", "cp2sp2", "narrow"),
            ("cp2sp2_temporal", "cp2sp2", "short")):
        r = par_out["kernel"][shape]
        n = par_out["worlds"][world]["ranks"][0]["launches"][key]
        if n <= 0:
            raise AssertionError(f"world {world} never launched "
                                 f"flash_fwd_{key}")
        kernels.append({
            "name": f"flash_fwd_{key}", "route": "cuda",
            "source": "videosys_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "videosys_tpu/ops/flash_attention.py:125",
            "launches": n, "max_abs_err": r["max_abs_err_bf16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    # one rank's rows in the other families' worlds (Ulysses, DSP, cp),
    # launches per rank per request from rank 0's shape log
    for name, r in par_out["family_kernel"].items():
        if r["launches"] <= 0:
            raise AssertionError(f"world {r['world']} never launched {name}")
        kernels.append({
            "name": f"flash_fwd_{r['variant']}", "route": "cuda",
            "source": FWD_SOURCES[r["variant"]],
            "replaces": "videosys_tpu/ops/flash_attention.py:"
                        + ("49" if r["shape"][3] > 4096 else "125"),
            "launches": r["launches"],
            "max_abs_err": r.get("max_abs_err", r.get("max_abs_err_bf16")),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    # one rank's training rows of the sp=2 world (forwards and backwards),
    # launches per rank from its run; the wide forward at one rank's share
    # of the split 480p decode, launches from rank 0 of cp=2 x sp=2
    ptr = ptrain["worlds"]["sp2"]["ranks"][0]["launches"]
    for shape in ("ptrain_spatial", "ptrain_cross", "ptrain_temporal"):
        r = ptrain["kernel"]["fwd"][shape]
        key = fa.kernel_variant(torch.bfloat16, r["shape"][2], r["shape"][3],
                                r["shape"][4])
        kernels.append({
            "name": f"flash_fwd_{key}", "route": "cuda",
            "source": "videosys_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "videosys_tpu/ops/flash_attention.py:125",
            "launches": ptr[key], "max_abs_err": r["max_abs_err_bf16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
        b = ptrain["kernel"]["bwd"][shape]
        for kern in ("fused", "dq", "dkv"):
            if kern not in b:
                continue
            name = {"fused": "bwd_fused", "dq": "bwd_dq", "dkv": "bwd_dkv"}[kern]
            counter = name + ("_short" if kern == "fused"
                              and fa.fused_kind(b["shape"][2], b["shape"][3],
                                                torch.bfloat16) == "short"
                              else "")
            if ptr.get(counter, 0) <= 0:
                raise AssertionError(f"the sp=2 training world never launched "
                                     f"flash_{counter}")
            kernels.append({
                "name": f"flash_{counter}", "route": "cuda",
                "source": {"fused": fused_src, "dq": dq_src,
                           "dkv": dkv_src}[kern],
                "replaces": "videosys_tpu/ops/flash_attention.py:"
                            + {"fused": "326", "dq": "594", "dkv": "522"}[kern],
                "launches": ptr[counter],
                "max_abs_err": b[kern]["max_abs_err_bf16"],
                "ms": b[kern]["ms"], "plain_ms": b[kern]["plain_ms"],
                "bound_ms": b[kern]["bound_ms"],
                "bound_by": b[kern]["bound_by"],
                "library_ms": b[kern]["library_ms"], "shape": b["shape"]})
    r = ptrain["kernel"]["fwd"]["vae_mid_rank"]
    n = par_out["worlds"]["cp2sp2"]["ranks"][0]["launches"]["wgmma"]
    if n <= 0:
        raise AssertionError("the split decode never launched flash_fwd_wide")
    kernels.append({
        "name": "flash_fwd_wide", "route": "cuda",
        "source": "videosys_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "videosys_tpu/ops/flash_attention.py:49",
        "launches": n, "max_abs_err": r["max_abs_err_bf16"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`videosys_tpu_torch`) on one NVIDIA
card (an H100 is the target).

    python3 chip_smoke.py [--steps N]

Phases, each fatal on failure:
  1. build the flash-attention kernel from csrc/ and print the card;
  2. hold the kernel against its plain PyTorch version at the main path's
     shapes (STDiT3 spatial, cross and temporal attention, the VAE mid
     attention) in bf16 and fp32, and time it beside the plain version and
     torch's own scaled_dot_product_attention (a yardstick the port never
     calls);
  3. serve Open-Sora v1.2 text-to-video at full width (STDiT3-XL/2, depth
     28, hidden 1152; the full VAE) with random weights from a seed: one
     480p 9:16 2 s video and one 144p 1:1 image, checking that every
     attention call went through the kernel; then hold one full-width bf16
     STDiT3 forward at the 480p shapes against the same forward with the
     plain attention in place of the kernel;
  4. run a tiny configuration on the card and on the CPU (plain attention)
     with the same weights and noise, and compare the latents and video.

bf16 outputs are held by two relative measures, rel_l2 = |got - want|_2 /
|want|_2 and rel_max = max|got - want| / max|want|, at limits set per shape
from this script's readings of a correct kernel; beside each it prints the
same measures for a plain version that drops one key per row, the smallest
fault the limits must still catch. fp32 outputs are held at 2e-5 absolute.

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
F32_TOL = 2e-5
# bf16 limits per shape (rel_l2, rel_max), set from this script's readings
# on an H100 (PERF.md): the kernel read at most half of each, and a plain
# version that drops one key per row read at least twice one of them
BF16_LIMITS = {"spatial": (8e-3, 2e-2), "cross": (1e-2, 2e-2),
               "temporal": (1e-2, 2e-2), "vae_mid": (6.5e-3, 1.5e-2),
               "stdit3_forward": (1.8e-2, 2.5e-2)}


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


def check_bf16(name: str, got, want, fault) -> dict:
    """Hold a bf16 output against its reference at BF16_LIMITS[name]."""
    import torch

    l2, mx = rel_errors(got, want)
    f_l2, f_mx = rel_errors(fault, want)
    lim_l2, lim_mx = BF16_LIMITS[name]
    ok = l2 <= lim_l2 and mx <= lim_mx and bool(torch.isfinite(got).all())
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
                f"variant={fa.kernel_variant(tdt, D)} max_abs_err={err:.3e}")
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


def expected_launches(fa, pipe, num_frames: int, height: int, width: int,
                      steps: int) -> dict:
    """Kernel launches one request makes, by variant, from its shapes: per
    denoise step each depth runs spatial, temporal (unless T = 1) and two
    cross attentions; the VAE runs its mid attention once per frame
    micro-batch."""
    t_lat, _, _ = pipe.vae.get_latent_size((num_frames, height, width))
    mc = pipe.model_config
    per_step = mc.depth * (3 + (t_lat > 1))
    vae_cfg = pipe.vae.config
    n_vae, remaining = 0, num_frames
    for _ in range(0, t_lat, pipe.vae.micro_z_frame_size):
        nf = min(vae_cfg.micro_frame_size, remaining)
        n_vae += -(-nf // vae_cfg.micro_batch_size)
        remaining -= vae_cfg.micro_frame_size
    want = {key: 0 for key in fa.LAUNCHES}
    want[fa.kernel_variant(pipe.dtype, mc.hidden_size // mc.num_heads)] += \
        steps * per_step
    vae_mid_d = pipe.vae.spatial_vae.module.block_out_channels[-1]
    want[fa.kernel_variant(pipe.dtype, vae_mid_d)] += n_vae
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
        want = expected_launches(fa, pipe, nf, h, w, steps)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30,
                    help="rflow sampling steps of the full-width requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width denoise step")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "videosys_tpu_torch" / "csrc" / "flash_fwd.cu").exists():
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
    lib = fa.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {fa.build_info.get('seconds', 0.0):.1f} s)")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device_count={torch.cuda.device_count()}")

    # the cross-attention key length the first request will use
    y, m = StubTextEncoder(16, 300).encode(
        ["a drone shot of waves breaking on a rocky coast at sunset "
         "aesthetic score: 6.5."])
    text_len = bucket_text_kv(y, m, 300)[2]

    # phase 2: kernel against plain
    shapes = kernel_phase(fa, text_len)
    # phase 3: the main path
    served = serve_phase(fa, args.steps, args.seed, args.profile)
    # phase 4: tiny configuration, card against CPU
    tiny_parity_phase(args.seed)

    # the variants the main path launches (bf16), each with the TPU kernel
    # whose shapes it takes and the shape it is timed at
    kernels = []
    for key, shape, replaces in (
            ("mma", "spatial", "videosys_tpu/ops/flash_attention.py:125"),
            ("mma_split", "vae_mid", "videosys_tpu/ops/flash_attention.py:49")):
        r = shapes[shape]
        kernels.append({
            "name": f"flash_fwd_{key}", "route": "cuda",
            "source": "videosys_tpu_torch/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": served["launches"][key],
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

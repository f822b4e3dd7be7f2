"""Adapter of the `opensora-v1.2` configuration: Open-Sora v1.2 text to
video through `VideoSysEngine.generate`, dense or under PAB, and its check
against `reference/opensora_v1_2.py`.

The benchmark makes the weights (harness.weights: the transformer, the
VAE and T5-v1.1-XXL's encoder) and each request's initial noise from the
seed and hands the program all of them (`params=`, `text_encoder=`,
`latents=`), with its own tokenizer (harness.text). During the window it
keeps, from outside the program, the captions and the features T5 gave
for them, the inputs and output of a few denoise steps drawn from the
seed (`_step`, with the caption features the transformer got), the
latents the VAE decodes and the uint8 video. After the window the
reference, which remakes the weights from the seed, runs T5 in float32 on
the same token ids and follows the program from those states: it
recomputes each kept step from the step's input (model, guidance and
update) and decodes the kept latents.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from harness import serving as sv
from harness import text
from harness import weights as hw
from reference import opensora_v1_2 as ref
from reference import pab as ref_pab
from reference.common import Ops, no_tf32

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}

# Limits of the numbers compared, set from the readings in PERF.md (section
# 2): above the program's largest over a dozen seeds and more, below the
# control's least (the reference computed in float8 in the program's
# place). What the pipeline does with T5's features (the learned null
# caption, the mask, the bucketing) is compared exactly.
LIMITS = {
    "text_rel": 0.25,
    "text_exact_max_abs": 0.0,
    "step_rel": 0.4,
    "video_mae": 5.0,
}


def _model_config(cfg: dict, dtype: torch.dtype):
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config

    keys = ("input_sq_size", "in_channels", "hidden_size", "depth",
            "num_heads", "mlp_ratio", "caption_channels",
            "model_max_length", "qk_norm", "pred_sigma")
    return STDiT3Config(patch_size=tuple(cfg["patch_size"]), dtype=dtype,
                        **{k: cfg[k] for k in keys})


def _vae(cfg: dict, tiling: int):
    from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
        OpenSoraVAE, OpenSoraVAEConfig)
    from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
    from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal

    v = cfg["vae"]
    t = v["temporal"]
    return OpenSoraVAE(
        OpenSoraVAEConfig(micro_frame_size=v["micro_frame_size"],
                          micro_batch_size=tiling,
                          latent_channels=v["latent_channels"]),
        spatial=AutoencoderKL2D(
            block_out_channels=tuple(v["spatial"]["block_out_channels"]),
            layers_per_block=v["spatial"]["layers_per_block"],
            latent_channels=v["latent_channels"]),
        temporal=VAETemporal(
            in_out_channels=v["latent_channels"], filters=t["filters"],
            num_res_blocks=t["num_res_blocks"],
            channel_multipliers=tuple(t["channel_multipliers"]),
            temporal_downsample=tuple(t["temporal_downsample"])))


# the text encoder's input length, and whether only the tokens' rows of
# its output reach the transformer (the cross-attention masks the rest)
TEXT_LENGTH = "model_max_length"
TEXT_LIVE_ONLY = True


def text_calls(req: dict) -> List[List[str]]:
    """The texts of each encode a request makes, in order."""
    return [[req["prompt"]]]


def layouts(cfg: dict):
    """(module, [(name, shape)]) of the transformer, the VAE and the text
    encoder, read from the program's modules built on the meta device."""
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3

    if cfg["text_encoder"]["d_model"] != cfg["caption_channels"]:
        raise ValueError("the text encoder's width is not the captions'")
    with torch.device("meta"):
        model = STDiT3(_model_config(cfg, torch.bfloat16))
        vae = _vae(cfg, 8)
    return [("transformer", hw.layout(model)), ("vae", hw.layout(vae)),
            text.layout(cfg)]


def latent_shape(cfg: dict, req: dict):
    nf = req["num_frames"]
    t_lat = (nf // 17) * 5 + (-(-(nf % 17) // 4) if nf % 17 else 0)
    return (1, cfg["in_channels"], t_lat, req["height"] // 8,
            req["width"] // 8)


def initial_noise(cfg: dict, req: dict, device) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(int(req["seed"]))
    return torch.randn(latent_shape(cfg, req), generator=gen, device=device)


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, requests):
        from videosys_tpu_torch import OpenSoraConfig, VideoSysEngine

        self.cfg = cfg
        req0 = requests[0]
        opts = dict(mix.get("pipeline", {}))
        pab = opts.pop("pab_config", None)
        dtype = DTYPES[cfg["dtype"]]
        config = OpenSoraConfig(
            transformer=None, vae=None, text_encoder=None,
            dtype=cfg["dtype"], num_sampling_steps=req0["steps"],
            cfg_scale=req0["guidance"],
            transformer_config=_model_config(cfg, dtype), **opts)
        if pab is not None:
            from videosys_tpu_torch import OpenSoraPABConfig
            config.pab_config = OpenSoraPABConfig(**program_pab(pab))
        params = hw.make(layouts(cfg), seed, device, dtype)
        encoder = text.encoder(cfg, params.pop("text_encoder"),
                               text.tokenizer(cfg, mix, seed),
                               cfg[TEXT_LENGTH], device, dtype)
        with torch.device("meta"):
            vae = _vae(cfg, config.tiling_size)
        self.engine = VideoSysEngine(config, vae=vae, params=params,
                                     device=device, text_encoder=encoder)
        self.pipe = self.engine.pipeline
        self.noise = {i: initial_noise(cfg, r, device)
                      for i, r in enumerate(requests)}
        self.plans = plans(cfg, mix, req0)
        self.keep = kept_steps(seed, self.plans)
        self.captures: Dict[int, dict] = {}
        self._current = None
        self._hook()

    def _hook(self):
        pipe = self.pipe
        step, encode = pipe._step, pipe.text_encoder.encode
        decode = pipe.vae.decode_chunks_u8

        def kept_step(z, t, dt, y_all, kv_mask_all, *args, **kwargs):
            cap = self._current
            i = cap["step"]
            cap["step"] += 1
            with record_function("h100_bench.step"):
                out = step(z, t, dt, y_all, kv_mask_all, *args, **kwargs)
            if i in self.keep:
                cap["steps"][i] = dict(z_in=z.clone(), z_out=out.clone(),
                                       y_all=y_all.clone(),
                                       kv_mask=kv_mask_all.clone())
            return out

        def kept_encode(texts):
            with record_function("h100_bench.text"):
                hidden, mask = encode(texts)
            self._current["encodes"].append((list(texts), hidden.clone()))
            return hidden, mask

        def kept_decode(z, num_frames):
            self._current["z_final"] = z.clone()
            with record_function("h100_bench.vae"):
                return decode(z, num_frames)

        pipe._step = kept_step
        pipe.text_encoder.encode = kept_encode
        pipe.vae.decode_chunks_u8 = kept_decode

    def _generate(self, req, latents):
        return self.engine.generate(
            req["prompt"], resolution=req["resolution"],
            aspect_ratio=req["aspect_ratio"], num_frames=req["num_frames"],
            seed=req["seed"], latents=latents,
            guidance_scale=req["guidance"])

    def warmup(self, req):
        """One generate at the cell's shapes with a one-step ladder: the
        text, a denoise step and the VAE decode."""
        from videosys_tpu_torch.schedulers.rflow import RFlowScheduler

        full = self.pipe.scheduler
        self.pipe.scheduler = RFlowScheduler(dataclasses.replace(
            full.config, num_sampling_steps=1))
        self._current = dict(step=0, steps={}, encodes=[])
        try:
            self._generate(req, self.noise[0])
        finally:
            self.pipe.scheduler = full
            self._current = None

    def run(self, req, index: int) -> dict:
        cap = dict(req=req, step=0, steps={}, encodes=[])
        self._current = cap
        t0 = time.perf_counter()
        video = self._generate(req, self.noise[index % len(self.noise)]).video
        wall = time.perf_counter() - t0
        self._current = None
        cap["video"] = video
        self.captures[index] = cap
        T, H, W = latent_shape(self.cfg, req)[2:]
        pt, ph, pw = self.cfg["patch_size"]
        live = min(len(req["prompt"].split()) + 1,
                   self.cfg["model_max_length"])
        # model FLOPs of each step of the request, under its PAB plan
        flops = [ref.step_flops(self.cfg, 2, T // pt, (H // ph) * (W // pw),
                                [live, live], plan) for plan in self.plans]
        rec = dict(kind="generate", wall_s=wall,
                   timings=dict(self.pipe.last_timings),
                   steps=req["steps"], step_flops=flops)
        if getattr(self.pipe._config, "enable_pab", False):
            rec["pab_cache_bytes"] = self.pipe.last_pab_cache_bytes
        return rec

    def release(self):
        self.pipe = None
        self.engine = None
        self.noise = None


def program_pab(pab: dict) -> dict:
    """The traffic's PAB settings as the program's config takes them."""
    out = {k: tuple(v) if k.endswith("_threshold") else v
           for k, v in pab.items()}
    for k in ("mlp_spatial_broadcast_config", "mlp_temporal_broadcast_config"):
        if out.get(k) is not None:
            out[k] = {int(t): dict(spec) for t, spec in out[k].items()}
    return out


def plans(cfg: dict, mix: dict, req: dict) -> List[ref_pab.StepPlan]:
    """The reference's PAB plan of each step (no reads or writes dense)."""
    opts = mix.get("pipeline", {})
    if not opts.get("enable_pab"):
        return [ref_pab.StepPlan() for _ in range(req["steps"])]
    t, _ = ref.rflow_ladder(req["steps"], req["height"], req["width"],
                            req["num_frames"])
    return ref_pab.plans(opts["pab_config"], t, cfg["depth"],
                         DTYPES[cfg["dtype"]])


# the most steps the reference recomputes to follow the program into one
# step that reads the PAB cache
MAX_CLOSURE = 4


def kept_steps(seed: int, step_plans) -> List[int]:
    """The steps whose inputs and outputs the window keeps: the first and
    the last, and one drawn from the seed; under PAB that one reads the
    cache, and the steps that wrote what it reads come with it."""
    n = len(step_plans)
    reading = [i for i, p in enumerate(step_plans) if p.read and
               len(ref_pab.closure(step_plans, i)) <= MAX_CLOSURE]
    if not reading:
        return sv.steps_kept(seed, n)
    k = reading[int(np.random.default_rng([int(seed), 2]).integers(
        0, len(reading)))]
    return sorted({0, n - 1, *ref_pab.closure(step_plans, k)})


def build(cfg, mix, seed, device, requests):
    return Program(cfg, mix, seed, device, requests)


def reference_weights(cfg: dict, seed: int, device):
    made = hw.make(layouts(cfg), seed, device, DTYPES[cfg["dtype"]])
    return {**made["transformer"], **made["vae"]}, made["text_encoder"]


def check(cfg: dict, mix: dict, seed: int, captures: dict, device,
          precision: str = "fp32") -> dict:
    """The numbers compared, each with its limit. `precision="fp8"` puts
    the reference with float8 products in the program's place (the
    control) and compares it the same way."""
    if not captures:
        return {}
    no_tf32()
    cap = captures[sv.sample(seed, captures)]
    req = cap["req"]
    w, w_text = reference_weights(cfg, seed, device)
    truth = Ops(w, "fp32", device)
    cand = None if precision == "fp32" else Ops(w, precision, device)
    out = {}

    # T5's caption features against the float32 T5 on the same token ids
    tok = text.tokenizer(cfg, mix, seed)
    out["text_rel"] = text.text_rel(cfg, w_text, precision, tok,
                                    cap["encodes"], cfg[TEXT_LENGTH],
                                    TEXT_LIVE_ONLY, device)
    del w_text
    # what the transformer was given: the features bucketed to the first
    # live tokens, conditional rows first, the learned null after, the
    # reference's mask on both
    first = cap["steps"][min(cap["steps"])]
    L = first["y_all"].shape[1]
    feats = cap["encodes"][0][1]
    _, mask = tok.encode(cap["encodes"][0][0], cfg[TEXT_LENGTH])
    mask = torch.from_numpy(mask).to(device)
    mask_all = torch.cat([mask, mask])
    null = truth.p("y_embedder.y_embedding")[None, :L]
    if cand is None:
        out["text_exact_max_abs"] = float(max(
            (first["y_all"][:1].float() - feats[:, :L].float()).abs().max(),
            (first["y_all"][1:].float()
             - null.to(DTYPES[cfg["dtype"]]).float()).abs().max(),
            float((first["kv_mask"] != mask_all[:, :L]).sum()),
            float(mask_all[:, L:].sum())))

    # each kept step from the program's own input: the program's output
    # against the reference's, over the reference's increment; under PAB
    # the steps are taken in order, each reading the reference's own cache
    t, dts = ref.rflow_ladder(req["steps"], req["height"], req["width"],
                              req["num_frames"])
    step_plans = plans(cfg, mix, req)

    def follow(ops):
        model, cache, outs = ref.STDiT3(ops, cfg), {}, {}
        for i, s in sorted(cap["steps"].items()):
            outs[i] = ref.cfg_step(
                model, s["z_in"], float(t[i]), float(dts[i]),
                s["y_all"].float(), s["kv_mask"], 24.0, float(req["height"]), float(req["width"]),
                float(req["guidance"]), cfg["in_channels"], step_plans[i],
                cache)
        return outs

    want = follow(truth)
    got = {i: s["z_out"] for i, s in cap["steps"].items()} \
        if cand is None else follow(cand)
    out["step_rel"] = max(sv.step_error(got[i], want[i], s["z_in"])
                          for i, s in cap["steps"].items())
    del want, got

    # the VAE decode of the program's final latents, in uint8 levels
    want = ref.VAEDecoder(truth, cfg["vae"]).decode_u8(
        cap["z_final"], req["num_frames"])
    if cand is None:
        got = sv.as_tensor(cap["video"], device)
    else:
        got = ref.VAEDecoder(cand, cfg["vae"]).decode_u8(
            cap["z_final"], req["num_frames"])
    out["video_mae"] = sv.video_mae(got, want)
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in out.items()}

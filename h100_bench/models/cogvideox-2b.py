"""Adapter of the `cogvideox-2b` configuration: CogVideoX-2b text to video
through `VideoSysEngine.generate`, and its check against
`reference/cogvideox_2b.py`.

As for Open-Sora: the benchmark makes the weights (T5-v1.1-XXL's encoder
among them) and each request's initial noise from the seed and hands them
to the program with its own tokenizer; during the window it keeps, from
outside the program, the captions and the features T5 gave for them, the
features the transformer got and the inputs and outputs of a few denoise
steps drawn from the seed (`scheduler.step`, the transformer's forward),
and the uint8 video. After the window the reference, which remakes the
weights, runs T5 in float32 on the same token ids, recomputes each kept
step from its input and decodes the program's final latents.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from harness import serving as sv
from harness import text
from harness import weights as hw
from reference import cogvideox_2b as ref
from reference.common import Ops, no_tf32

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}

# the VAE tiles the check decodes (of 9 at 49 x 480 x 720), drawn from
# the seed: the whole float32 decode would take longer than the window
TILES_CHECKED = 2

# Limits of the numbers compared, set from the readings in PERF.md (section
# 2), as for Open-Sora.
LIMITS = {
    "text_rel": 0.2,
    "text_exact_max_abs": 0.0,
    "step_rel": 0.12,
    "video_mae": 1.1,
}


def _model_config(cfg: dict):
    from videosys_tpu_torch.models.transformers.cogvideox import \
        CogVideoXConfig

    return CogVideoXConfig(
        num_layers=cfg["num_layers"], num_heads=cfg["num_attention_heads"],
        head_dim=cfg["attention_head_dim"], in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"],
        time_embed_dim=cfg["time_embed_dim"],
        text_embed_dim=cfg["text_embed_dim"], patch_size=cfg["patch_size"],
        max_text_seq_length=cfg["max_text_seq_length"],
        temporal_compression_ratio=cfg["temporal_compression_ratio"],
        spatial_interpolation_scale=cfg["spatial_interpolation_scale"],
        temporal_interpolation_scale=cfg["temporal_interpolation_scale"],
        use_rotary_positional_embeddings=cfg[
            "use_rotary_positional_embeddings"],
        norm_eps=cfg["norm_eps"])


def _vae_config(cfg: dict):
    from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import \
        CogVideoXVAEConfig

    v = dict(cfg["vae"])
    v.pop("source", None)
    v["block_out_channels"] = tuple(v["block_out_channels"])
    return CogVideoXVAEConfig(**v)


# the text encoder's input length; every row of its output reaches the
# transformer (CogVideoX attends to the padded rows too)
TEXT_LENGTH = "max_text_seq_length"
TEXT_LIVE_ONLY = False


def text_calls(req: dict) -> List[List[str]]:
    """The texts of each encode a request makes, in order: the prompt,
    then the empty negative prompt."""
    return [[req["prompt"]], [""]]


def layouts(cfg: dict):
    from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import \
        AutoencoderKLCogVideoX
    from videosys_tpu_torch.models.transformers.cogvideox import \
        CogVideoXTransformer3D

    if cfg["text_encoder"]["d_model"] != cfg["text_embed_dim"]:
        raise ValueError("the text encoder's width is not the captions'")
    with torch.device("meta"):
        model = CogVideoXTransformer3D(_model_config(cfg))
        vae = AutoencoderKLCogVideoX(_vae_config(cfg))
    return [("transformer", hw.layout(model)), ("vae", hw.layout(vae)),
            text.layout(cfg)]


def initial_noise(cfg: dict, req: dict, device) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(int(req["seed"]))
    return torch.randn(ref.latent_shape(cfg, cfg["vae"], req), generator=gen,
                       device=device)


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, requests):
        from videosys_tpu_torch import CogVideoXConfig, VideoSysEngine
        from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox \
            import AutoencoderKLCogVideoX

        self.cfg = cfg
        opts = dict(mix.get("pipeline", {}))
        config = CogVideoXConfig(
            model_path=None, dtype=cfg["dtype"], scheduler=cfg["scheduler"],
            transformer_config=_model_config(cfg),
            vae_config=_vae_config(cfg), **opts)
        dtype = DTYPES[cfg["dtype"]]
        params = hw.make(layouts(cfg), seed, device, dtype)
        encoder = text.encoder(cfg, params.pop("text_encoder"),
                               text.tokenizer(cfg, mix, seed),
                               cfg[TEXT_LENGTH], device, dtype)
        with torch.device("meta"):
            vae = AutoencoderKLCogVideoX(_vae_config(cfg))
        self.engine = VideoSysEngine(config, vae=vae, params=params,
                                     device=device, text_encoder=encoder)
        self.pipe = self.engine.pipeline
        self.noise = {i: initial_noise(cfg, r, device)
                      for i, r in enumerate(requests)}
        self.steps = requests[0]["steps"]
        self.keep = sv.steps_kept(seed, self.steps)
        self.captures: Dict[int, dict] = {}
        self._current = None
        self._hook()

    def _hook(self):
        pipe = self.pipe
        step, encode = pipe.scheduler.step, pipe.text_encoder.encode
        decode = pipe.vae.decode
        ranges = []

        def kept_step(model_output, t, sample, *args, **kwargs):
            cap = self._current
            i = cap["step"]
            cap["step"] += 1
            out = step(model_output, t, sample, *args, **kwargs)
            if i in self.keep:
                cap["steps"][i] = dict(z_in=sample.clone(), z_out=out.clone(),
                                       t=int(t))
            return out

        def kept_encode(texts):
            with record_function("h100_bench.text"):
                hidden, mask = encode(texts)
            self._current["encodes"].append((list(texts), hidden.clone()))
            return hidden, mask

        def kept_decode(z):
            with record_function("h100_bench.vae"):
                return decode(z)

        def kept_forward(module, args, kwargs):
            cap = self._current
            if cap["step"] == 0:
                cap["enc_all"] = args[1].clone()
            ranges.append(record_function("h100_bench.step").__enter__())

        def forward_done(module, args, output):
            ranges.pop().__exit__(None, None, None)

        pipe.scheduler.step = kept_step
        pipe.text_encoder.encode = kept_encode
        pipe.vae.decode = kept_decode
        self._handles = [
            pipe.transformer.register_forward_pre_hook(kept_forward,
                                                       with_kwargs=True),
            pipe.transformer.register_forward_hook(forward_done)]

    def _generate(self, req, latents, steps):
        return self.engine.generate(
            req["prompt"], num_inference_steps=steps,
            guidance_scale=req["guidance"], num_frames=req["num_frames"],
            height=req["height"], width=req["width"], seed=req["seed"],
            latents=latents)

    def warmup(self, req):
        """One generate at the cell's shapes with one step: the text, a
        denoise step and the VAE decode."""
        self._current = dict(step=0, steps={}, encodes=[])
        keep, self.keep = self.keep, []
        try:
            self._generate(req, self.noise[0], 1)
        finally:
            self.keep = keep
            self._current = None

    def run(self, req, index: int) -> dict:
        cap = dict(req=req, step=0, steps={}, encodes=[])
        self._current = cap
        t0 = time.perf_counter()
        video = self._generate(req, self.noise[index % len(self.noise)],
                               self.steps).video
        wall = time.perf_counter() - t0
        self._current = None
        cap["video"] = video
        self.captures[index] = cap
        shape = ref.latent_shape(self.cfg, self.cfg["vae"], req)
        f = ref.step_flops(self.cfg, 2, shape[1], shape[3], shape[4],
                           self.cfg["max_text_seq_length"])
        rec = dict(kind="generate", wall_s=wall,
                   timings=dict(self.pipe.last_timings),
                   steps=self.steps, step_flops=[f] * self.steps)
        if getattr(self.pipe._config, "enable_pab", False):
            rec["pab_cache_bytes"] = self.pipe.last_pab_cache_bytes
        return rec

    def release(self):
        for handle in self._handles:
            handle.remove()
        self.pipe = None
        self.engine = None
        self.noise = None


def build(cfg, mix, seed, device, requests):
    return Program(cfg, mix, seed, device, requests)


def reference_weights(cfg: dict, seed: int, device):
    made = hw.make(layouts(cfg), seed, device, DTYPES[cfg["dtype"]])
    return made["transformer"], made["vae"], made["text_encoder"]


def check(cfg: dict, mix: dict, seed: int, captures: dict, device,
          precision: str = "fp32") -> dict:
    """The numbers compared, each with its limit; `precision="fp8"` puts
    the reference with float8 products in the program's place (the
    control)."""
    if not captures:
        return {}
    no_tf32()
    cap = captures[sv.sample(seed, captures)]
    req = cap["req"]
    w_model, w_vae, w_text = reference_weights(cfg, seed, device)
    truth = Ops(w_model, "fp32", device)
    cand = None if precision == "fp32" else Ops(w_model, precision, device)
    out = {}

    # T5's caption features against the float32 T5 on the same token ids
    out["text_rel"] = text.text_rel(
        cfg, w_text, precision, text.tokenizer(cfg, mix, seed),
        cap["encodes"], cfg[TEXT_LENGTH], TEXT_LIVE_ONLY, device)
    del w_text
    # the features the transformer got: the negative prompt's, then the
    # prompt's, as T5 gave them; the steps are recomputed from them
    enc = cap["enc_all"].float()
    if cand is None:
        out["text_exact_max_abs"] = float((enc - torch.cat(
            [cap["encodes"][1][1], cap["encodes"][0][1]]).float()
        ).abs().max())

    sched = ref.DDIM(req["steps"])
    model = ref.Transformer(truth, cfg)
    worst = 0.0
    for i, s in sorted(cap["steps"].items()):
        t = int(sched.timesteps[i])
        want = ref.cfg_step(model, sched, s["z_in"], t, enc, req["guidance"])
        got = s["z_out"] if cand is None else ref.cfg_step(
            ref.Transformer(cand, cfg), sched, s["z_in"], t, enc,
            req["guidance"])
        worst = max(worst, sv.step_error(got, want, s["z_in"]))
        del want, got
    out["step_rel"] = worst
    del model, truth, cand

    # the VAE decode of the program's final latents: the tiles drawn from
    # the seed, each compared where it alone gives the pixels
    z = cap["steps"][req["steps"] - 1]["z_out"]
    truth_vae = ref.VAEDecoder(Ops(w_vae, "fp32", device), cfg["vae"])
    cand_vae = None if precision == "fp32" else ref.VAEDecoder(
        Ops(w_vae, precision, device), cfg["vae"])
    video = sv.as_tensor(cap["video"], device)
    tiles = truth_vae.tiles(tuple(z.transpose(1, 2).shape))
    pick = np.random.default_rng([int(seed), 4]).choice(
        len(tiles), size=min(TILES_CHECKED, len(tiles)), replace=False)
    worst = 0.0
    for n in sorted(pick):
        tile = tiles[n]
        want = truth_vae.decode_tile_u8(z, tile)
        got = video[:, :, tile[2]:tile[3], tile[4]:tile[5]] \
            if cand_vae is None else cand_vae.decode_tile_u8(z, tile)
        worst = max(worst, sv.video_mae(got, want))
    out["video_mae"] = worst
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in out.items()}

"""Latte text-to-video pipeline (16 x 512 x 512, DDIM).

Port of `videosys_tpu/pipelines/latte/pipeline_latte.py` on one device:
`LatteConfig` -> `VideoSysEngine` -> `generate(prompt, negative_prompt,
num_inference_steps, guidance_scale, video_length, height, width, seed)` ->
uint8 video [B, T, H, W, 3]. Each step runs the CFG-doubled LatteT2V
(uncond first), keeps the first `in_channels` of its learned-sigma output,
combines the guidance and takes a DDIM step; with `enable_pab` the steps run
under the plans of `core/pab.py` (spatial, temporal, cross and the MLP rows).
The frames are decoded together by the 2D VAE (SD's AutoencoderKL,
scaling 0.18215).

Weights come from a local diffusers-layout snapshot at `model_path`
(`transformer/`, `vae/`, and `text_encoder/` with `tokenizer/`; see
utils/checkpoint.py) or from this package's `save_params` directory there.
The T5 runs at 120 tokens. `cpu_offload` keeps every module on the host and
fetches each onto the card for its phase only.

`num_gpus > 1` (`core/parallel.py`): one pipeline per rank over the ranks'
process groups (`groups=`; `VideoSysEngine` spawns the ranks). LatteT2V runs
DSP over sp (frames resident, tokens for the temporal attention); with
`enable_cp` the two halves of the CFG-doubled batch run on the two cp ranks
and are gathered for the guidance. Every rank draws the same noise, takes
the same steps and decodes the whole video; rank 0 alone returns it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.pab import PABConfig, build_plans
from videosys_tpu_torch.core.pipeline import (
    VideoSysPipeline,
    VideoSysPipelineOutput,
    build_modules,
    resolve_device,
    timed_request,
)
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
from videosys_tpu_torch.models.transformers.latte import LatteConfig as LatteModelConfig
from videosys_tpu_torch.models.transformers.latte import LatteT2V
from videosys_tpu_torch.pipelines.common import (
    bucket_text_kv,
    rank_groups,
    request_seed,
    snapshot_text_encoder,
)
from videosys_tpu_torch.pipelines.open_sora.data_process import text_preprocessing
from videosys_tpu_torch.schedulers.ddim import DDIMConfig, DDIMScheduler
from videosys_tpu_torch.utils.checkpoint import require_weights, try_load_params

VAE_SCALING = 0.18215
TEXT_TOKENS = 120
_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def LattePABConfig(**overrides) -> PABConfig:
    """Latte's PAB ladder: spatial, temporal and cross broadcast in
    (100, 800), and the MLP outputs of blocks 0-4 kept for two steps after
    each of five timesteps."""
    mlp_cfg = {t: {"block": [0, 1, 2, 3, 4], "skip_count": 2}
               for t in (720, 640, 560, 480, 400)}
    defaults = dict(
        spatial_broadcast=True, spatial_threshold=(100, 800), spatial_range=2,
        temporal_broadcast=True, temporal_threshold=(100, 800),
        temporal_range=3,
        cross_broadcast=True, cross_threshold=(100, 800), cross_range=6,
        mlp_broadcast=True,
        mlp_spatial_broadcast_config=mlp_cfg,
        mlp_temporal_broadcast_config=dict(mlp_cfg),
    )
    defaults.update(overrides)
    return PABConfig(**defaults)


@dataclasses.dataclass
class LatteConfig:
    """`model_path`: a local diffusers-layout Latte snapshot; None (with
    `transformer_config`, `vae_config`) runs random weights and the stub
    encoder. `vae_config`: AutoencoderKL2D keyword arguments. `vae`: a
    VAE module to use in place of the built one (the pipeline's `vae=`
    argument comes first)."""

    model_path: Optional[str] = "maxin-cn/Latte-1"
    num_gpus: int = 1  # ranks: sp = num_gpus, or num_gpus / 2 with cp
    # low-memory mode: the modules stay on the host and each phase fetches
    # the one it runs (text encoder, transformer, VAE) onto the card
    cpu_offload: bool = False
    enable_cp: bool = False  # CFG halves over 2 ranks (even num_gpus)
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    text_kv_bucket: bool = True
    enable_pab: bool = False
    pab_config: Optional[PABConfig] = None
    dtype: str = "bf16"
    # random-init hooks: model sizes when no checkpoint is loaded
    transformer_config: Optional[LatteModelConfig] = None
    vae_config: Optional[dict] = None
    vae: Optional[AutoencoderKL2D] = None

    def __post_init__(self):
        if self.pab_config is None:
            self.pab_config = LattePABConfig()
        self.pipeline_cls = LattePipeline


class LattePipeline(VideoSysPipeline):
    serves_parallel = True  # VideoSysEngine may spawn num_gpus ranks

    def __init__(self, config: LatteConfig, text_encoder=None,
                 vae: Optional[AutoencoderKL2D] = None,
                 params: Optional[dict] = None, seed: int = 42, device=None,
                 groups: Optional[par.Groups] = None):
        """`params`: optional {"transformer": state_dict, "vae": state_dict}
        (this package's key names, the reference's); a module not in it is
        loaded from `model_path`, or random-initialized from `seed` under
        the random-init hooks. Under `cpu_offload` the modules are built and
        kept on the host. `groups`: this rank's process groups
        (`pipelines.common.rank_groups`)."""
        self._config = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.dtype]
        self.groups = rank_groups(config, groups, self.device)
        self.model_config = config.transformer_config or LatteModelConfig(
            dtype=self.dtype)
        if text_encoder is None:
            text_encoder = (
                snapshot_text_encoder(str(config.model_path), TEXT_TOKENS,
                                      self.dtype, config.cpu_offload,
                                      self.device, "model_path")
                if config.model_path
                else StubTextEncoder(
                    output_dim=self.model_config.caption_channels,
                    max_length=TEXT_TOKENS, device=self.device))
        self.text_encoder = text_encoder

        vae = vae if vae is not None else config.vae
        params = dict(params or {})
        if not {"transformer", "vae"} <= set(params):
            loaded = try_load_params(config, family="latte") or {}
            params = {**loaded, **params}
            require_weights(params, config, vae=vae is None)
        modules = build_modules(
            {"transformer": lambda: LatteT2V(self.model_config),
             "vae": lambda: vae or AutoencoderKL2D(**(config.vae_config or {}))},
            params, seed, self.device, self.dtype, config.cpu_offload)
        self.transformer, self.vae = modules["transformer"], modules["vae"]
        self.scheduler = DDIMScheduler(DDIMConfig(
            beta_start=config.beta_start, beta_end=config.beta_end,
            beta_schedule=config.beta_schedule, clip_sample=False))

    def latent_shape(self, video_length: int, height: int, width: int,
                     batch: int = 1):
        """[B, C, T, h, w] of a request."""
        sf = 2 ** (len(self.vae.block_out_channels) - 1)
        return (batch, self.model_config.in_channels, video_length,
                height // sf, width // sf)

    @timed_request
    @torch.no_grad()
    def generate(self, prompt: str, negative_prompt: str = "",
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 video_length: int = 16, height: int = 512, width: int = 512,
                 seed: int = -1, latents: Optional[torch.Tensor] = None,
                 return_dict: bool = True):
        """Text to video. `latents`: the initial noise [B, C, T, h, w],
        drawn from a generator seeded with `seed` otherwise (a negative
        one: rank 0's draw)."""
        cfg = self._config
        mc = self.model_config
        seed = request_seed(seed, self.groups)
        gen = torch.Generator(self.device).manual_seed(seed)
        self.last_timings = dict.fromkeys(
            ("text", "denoise", "vae", "postprocess"), 0.0)
        with self._phase("text"):
            # uncond first (diffusers' convention)
            y_pos, m_pos = self.text_encoder.encode([text_preprocessing(prompt)])
            y_neg, m_neg = self.text_encoder.encode(
                [text_preprocessing(negative_prompt)])
            y_all = torch.cat([y_neg.to(self.device), y_pos.to(self.device)]
                              ).to(self.dtype)
            kv_mask = torch.cat([m_neg.to(self.device), m_pos.to(self.device)])
            self.last_text_kv_len = y_all.shape[1]
            if cfg.text_kv_bucket:
                y_all, kv_mask, self.last_text_kv_len = bucket_text_kv(
                    y_all, kv_mask, y_all.shape[1])
        B = y_pos.shape[0]
        shape = self.latent_shape(video_length, height, width, B)
        timesteps = self.scheduler.set_timesteps(num_inference_steps)
        pab = cfg.pab_config if cfg.enable_pab else None
        plans = build_plans(pab, timesteps.astype(np.float32), mc.num_layers)

        with self._phase("denoise", self.transformer, "transformer"), \
                par.use_groups(self.groups):
            # cp: this rank runs its half of the CFG-doubled batch
            y_in, kv_in = (par.split(a, 0, par.CP_AXIS)
                           for a in (y_all, kv_mask))
            rows = 2 * B // par.axis_size(par.CP_AXIS)
            if latents is not None:
                if tuple(latents.shape) != shape:
                    raise ValueError(f"latents shape {tuple(latents.shape)} "
                                     f"!= {shape}")
                z = latents.to(self.device, torch.float32)
            else:
                z = torch.randn(shape, device=self.device, generator=gen)
            cache = None
            if pab is not None:  # on the card with the transformer
                p = mc.patch_size
                cache = self.transformer.init_cache(
                    pab, rows, video_length,
                    (shape[3] // p) * (shape[4] // p))
                self.last_pab_cache_bytes = cache.nbytes
            for t_i, plan in zip(timesteps, plans):
                a_t, a_prev = self.scheduler.alphas_for_step(int(t_i))
                t_in = torch.full((rows,), float(t_i), device=self.device)
                z_in = par.split(torch.cat([z, z]).to(self.dtype), 0,
                                 par.CP_AXIS)
                out = self.transformer(z_in, t_in, y_in, kv_mask=kv_in,
                                       plan=plan, pab_cache=cache)
                # the learned sigma dropped
                eps = par.gather(out[:, :mc.in_channels], 0, par.CP_AXIS)
                eps = eps[:B] + guidance_scale * (eps[B:] - eps[:B])
                x0, eps = self.scheduler.predict_x0(z, eps, a_t)
                z = a_prev ** 0.5 * x0 + (1 - a_prev) ** 0.5 * eps
            del cache  # free the PAB cache before the VAE runs
        if getattr(self, "keep_latents", False):
            self.last_latents = z.cpu().numpy()

        with self._phase("vae", self.vae, "vae"):
            frames = z.transpose(1, 2).reshape(B * video_length, *shape[1:2],
                                               *shape[3:])
            video = self.vae.decode((frames / VAE_SCALING).to(self.dtype))

        if self.groups is not None and self.groups.rank != 0:
            return (None,) if not return_dict else VideoSysPipelineOutput(
                video=None)  # rank 0 alone returns the video
        with self._phase("postprocess"):
            video = torch.clamp(video.float() / 2 + 0.5, 0, 1) * 255
            video = video.to(torch.uint8).reshape(B, video_length,
                                                   *video.shape[1:])
            video = video.permute(0, 1, 3, 4, 2).cpu().numpy()
        if not return_dict:
            return (video,)
        return VideoSysPipelineOutput(video=video)

    def save_video(self, video, output_path: str, fps: int = 8):
        return super().save_video(video, output_path, fps=fps)

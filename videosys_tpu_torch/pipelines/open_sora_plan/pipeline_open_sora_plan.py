"""Open-Sora-Plan text-to-video pipeline: v1.1 (LatteT2V, PNDM, 65 or 221
frames at 512 x 512) and v1.2 (OpenSoraT2V, Euler-Ancestral, 29 or 93
frames at 480p or 720p).

Port of `videosys_tpu/pipelines/open_sora_plan/pipeline_open_sora_plan.py`
on one device: `OpenSoraPlanConfig` -> `VideoSysEngine` -> `generate(prompt,
negative_prompt, num_inference_steps, guidance_scale, seed)` -> uint8 video
[B, T, H, W, 3] cropped to the type's frame count. Each step runs the
CFG-doubled transformer (uncond first; v1.2 scales the input by its
sigma first), keeps the first `in_channels` of its output, combines the
guidance and takes the scheduler's step; with `enable_pab` the steps run
under the plans of `core/pab.py`. The causal VAE decodes in tiles
(`enable_tiling`, `tile_overlap_factor`).

Weights come from a local Open-Sora-Plan snapshot at `transformer` (the
`transformer_type` folder and `vae/`; see utils/checkpoint.py) or this
package's `save_params` directory there; the captions from a local T5
(v1.1) or mT5 (v1.2) snapshot at `text_encoder`. `cpu_offload` keeps every
module on the host and fetches each onto the card for its phase only.

`num_gpus > 1` (`core/parallel.py`): one pipeline per rank over the ranks'
process groups (`groups=`; `VideoSysEngine` spawns the ranks). The
transformer runs sequence parallel over sp: v1.2 Ulysses, v1.1 (LatteT2V)
DSP over frames; with `enable_cp` the two halves of the CFG-doubled batch
run on the two cp ranks and are gathered for the guidance. Every rank draws
the same noise, takes the same steps and decodes the whole video; rank 0
alone returns it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

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
from videosys_tpu_torch.models.autoencoders.autoencoder_causal_vae import (
    CausalVAE,
    CausalVAEConfig,
)
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
from videosys_tpu_torch.models.transformers.open_sora_plan_v110 import (
    OpenSoraPlanV110Config,
    OpenSoraPlanV110Transformer,
)
from videosys_tpu_torch.models.transformers.open_sora_plan_v120 import (
    OpenSoraPlanV120Config,
    OpenSoraPlanV120Transformer,
)
from videosys_tpu_torch.pipelines.common import (
    bucket_text_kv,
    rank_groups,
    request_seed,
    snapshot_text_encoder,
)
from videosys_tpu_torch.pipelines.open_sora.data_process import text_preprocessing
from videosys_tpu_torch.schedulers.euler_ancestral import EulerAncestralScheduler
from videosys_tpu_torch.schedulers.pndm import PNDMScheduler
from videosys_tpu_torch.utils.checkpoint import require_weights, try_load_params

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
# latent (h, w) per v1.2 transformer_type suffix; pixels = latent x 8
_V120_SAMPLE_SIZES = {"480p": (60, 80), "720p": (90, 120)}
TYPES = {"v110": ("65x512x512", "221x512x512"),
         "v120": ("93x480p", "93x720p", "29x480p", "29x720p")}
# caption tokens: T5-XXL for v1.1, mT5-XXL for v1.2
TEXT_TOKENS = {"v110": 300, "v120": 512}


def OpenSoraPlanV110PABConfig(**overrides) -> PABConfig:
    """v1.1's ladder: spatial, temporal and cross broadcast in (100, 850),
    and the MLP outputs of blocks 0-6 kept for two steps after each of 14
    timesteps (426, 450, ..., 738)."""
    mlp_cfg = {t: {"block": [0, 1, 2, 3, 4, 5, 6], "skip_count": 2}
               for t in range(426, 739, 24)}
    defaults = dict(
        spatial_broadcast=True, spatial_threshold=(100, 850), spatial_range=2,
        temporal_broadcast=True, temporal_threshold=(100, 850),
        temporal_range=4,
        cross_broadcast=True, cross_threshold=(100, 850), cross_range=6,
        mlp_broadcast=True,
        mlp_spatial_broadcast_config=mlp_cfg,
        mlp_temporal_broadcast_config=dict(mlp_cfg),
    )
    defaults.update(overrides)
    return PABConfig(**defaults)


def OpenSoraPlanV120PABConfig(**overrides) -> PABConfig:
    """v1.2's ladder: spatial and cross only (single-stream blocks)."""
    defaults = dict(
        spatial_broadcast=True, spatial_threshold=(100, 850), spatial_range=2,
        cross_broadcast=True, cross_threshold=(100, 850), cross_range=6,
    )
    defaults.update(overrides)
    return PABConfig(**defaults)


@dataclasses.dataclass
class OpenSoraPlanConfig:
    """`transformer`: a local Open-Sora-Plan snapshot (or `save_params`
    directory); `text_encoder`: a local T5 / mT5 snapshot with its
    tokenizer; None for either (with `transformer_config`, `vae_config`)
    runs random weights and the stub encoder. `vae`: a causal VAE module
    to use in place of the built one (the pipeline's `vae=` argument comes
    first); tiling is switched on it as on the built one."""

    version: str = "v120"
    transformer_type: str = "29x480p"
    transformer: Optional[str] = None
    text_encoder: Optional[str] = None
    num_gpus: int = 1  # ranks: sp = num_gpus, or num_gpus / 2 with cp
    enable_cp: bool = False  # CFG halves over 2 ranks (even num_gpus)
    cpu_offload: bool = False
    enable_tiling: bool = True
    tile_overlap_factor: float = 0.25
    text_kv_bucket: bool = True
    enable_pab: bool = False
    pab_config: Optional[PABConfig] = None
    dtype: str = "bf16"
    # random-init hooks: model sizes when no checkpoint is loaded
    transformer_config: Any = None
    vae_config: Optional[CausalVAEConfig] = None
    vae: Optional[CausalVAE] = None

    def __post_init__(self):
        if self.version not in TYPES:
            raise ValueError(f"version {self.version!r} not in {tuple(TYPES)}")
        if self.transformer_type not in TYPES[self.version]:
            raise ValueError(f"transformer_type {self.transformer_type!r} not "
                             f"in {TYPES[self.version]}")
        self.num_frames = int(self.transformer_type.split("x")[0])
        if self.pab_config is None:
            self.pab_config = (OpenSoraPlanV110PABConfig()
                               if self.version == "v110"
                               else OpenSoraPlanV120PABConfig())
        self.pipeline_cls = OpenSoraPlanPipeline


class OpenSoraPlanPipeline(VideoSysPipeline):
    serves_parallel = True  # VideoSysEngine may spawn num_gpus ranks

    def __init__(self, config: OpenSoraPlanConfig, text_encoder=None,
                 vae: Optional[CausalVAE] = None,
                 params: Optional[dict] = None, seed: int = 42, device=None,
                 groups: Optional[par.Groups] = None):
        """`params`: optional {"transformer": state_dict, "vae": state_dict}
        (this package's key names, the reference's); a module not in it is
        loaded from `transformer`, or random-initialized from `seed` under
        the random-init hooks. Under `cpu_offload` the modules are built and
        kept on the host. `groups`: this rank's process groups
        (`pipelines.common.rank_groups`)."""
        self._config = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.dtype]
        self.version = config.version
        self.groups = rank_groups(config, groups, self.device)
        v110 = self.version == "v110"
        if config.transformer_config is not None:
            self.model_config = config.transformer_config
        elif v110:
            self.model_config = OpenSoraPlanV110Config(
                config.transformer_type, dtype=self.dtype)
        else:
            self.model_config = OpenSoraPlanV120Config(
                sample_size=_V120_SAMPLE_SIZES[
                    config.transformer_type.split("x")[1]],
                sample_size_t=(config.num_frames - 1) // 4 + 1,
                dtype=self.dtype)
        model_cls = (OpenSoraPlanV110Transformer if v110
                     else OpenSoraPlanV120Transformer)
        if text_encoder is None:
            text_encoder = (
                snapshot_text_encoder(str(config.text_encoder),
                                      TEXT_TOKENS[self.version], self.dtype,
                                      config.cpu_offload, self.device)
                if config.text_encoder else StubTextEncoder(
                    output_dim=self.model_config.caption_channels,
                    max_length=TEXT_TOKENS[self.version], device=self.device))
        self.text_encoder = text_encoder

        vae = vae if vae is not None else config.vae
        params = dict(params or {})
        if not {"transformer", "vae"} <= set(params):
            loaded = try_load_params(config, family="osp") or {}
            params = {**loaded, **params}
            require_weights(params, config, vae=False)  # checked below
            if config.transformer and "vae" not in params and \
                    vae is None and config.vae_config is None:
                raise FileNotFoundError(
                    f"causal VAE weights not found under {config.transformer!r}"
                    f"/vae; set vae_config=... for random-init testing")
        vae_config = config.vae_config or (
            CausalVAEConfig() if v110 else CausalVAEConfig.v120())
        modules = build_modules(
            {"transformer": lambda: model_cls(self.model_config),
             "vae": lambda: vae or CausalVAE(vae_config, version=self.version)},
            params, seed, self.device, self.dtype, config.cpu_offload)
        self.transformer, self.vae = modules["transformer"], modules["vae"]
        if config.enable_tiling:
            self.vae.enable_tiling(config.tile_overlap_factor)
        self.scheduler = PNDMScheduler() if v110 else EulerAncestralScheduler()

    def latent_shape(self, batch: int = 1) -> Tuple[int, ...]:
        """[B, C, T, h, w]: the size the checkpoint was trained at."""
        mc = self.model_config
        if self.version == "v110":
            return (batch, mc.in_channels, mc.video_length, mc.sample_size,
                    mc.sample_size)
        return (batch, mc.in_channels, mc.sample_size_t) + tuple(mc.sample_size)

    def _tokens(self, shape) -> int:
        p = self.model_config.patch_size
        return (shape[3] // p) * (shape[4] // p)

    @timed_request
    @torch.no_grad()
    def generate(self, prompt: str, negative_prompt: str = "",
                 num_inference_steps: int = 100, guidance_scale: float = 7.5,
                 seed: int = -1, latents: Optional[torch.Tensor] = None,
                 draw: Optional[Callable[[str, Tuple[int, ...]],
                                         torch.Tensor]] = None,
                 return_dict: bool = True):
        """Text to video. Draws: `latents`, the initial noise [B, C, T, h, w]
        (before v1.2's init_noise_sigma); `draw(name, shape)`, v1.2's
        ancestral noise of each step ("euler/{step}/ancestral"); both from
        a generator seeded with `seed` otherwise (a negative one: rank 0's
        draw)."""
        cfg = self._config
        mc = self.model_config
        v110 = self.version == "v110"
        seed = request_seed(seed, self.groups)
        gen = torch.Generator(self.device).manual_seed(seed)

        def step_draw(prefix):
            def fn(name, shape):
                if draw is None:
                    return torch.randn(shape, device=self.device, generator=gen)
                return draw(f"{prefix}/{name}", shape).to(self.device,
                                                          torch.float32)
            return fn

        self.last_timings = dict.fromkeys(
            ("text", "denoise", "vae", "postprocess"), 0.0)
        with self._phase("text"):
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
        shape = self.latent_shape(B)
        timesteps = self.scheduler.set_timesteps(num_inference_steps)
        pab = cfg.pab_config if cfg.enable_pab else None
        plans = build_plans(pab, np.asarray(timesteps, np.float32),
                            mc.num_layers)

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
            if not v110:
                z = z * self.scheduler.init_noise_sigma
            cache = None
            if pab is not None:  # on the card with the transformer
                S = self._tokens(shape)
                cache = (self.transformer.init_cache(pab, rows, shape[2], S)
                         if v110 else
                         self.transformer.init_cache(pab, rows, shape[2] * S))
                self.last_pab_cache_bytes = cache.nbytes
            for i, (t_i, plan) in enumerate(zip(timesteps, plans)):
                z_in = torch.cat([z, z])
                if not v110:
                    z_in = self.scheduler.scale_model_input(z_in, i)
                z_in = par.split(z_in.to(self.dtype), 0, par.CP_AXIS)
                t_in = torch.full((rows,), float(t_i), device=self.device)
                if v110:
                    out = self.transformer(z_in, t_in, y_in, kv_mask=kv_in,
                                           plan=plan, pab_cache=cache)
                else:
                    out = self.transformer(z_in, y_in, t_in, kv_mask=kv_in,
                                           plan=plan, pab_cache=cache)
                # a learned sigma dropped
                eps = par.gather(out[:, :mc.in_channels], 0, par.CP_AXIS)
                eps = eps[:B] + guidance_scale * (eps[B:] - eps[:B])
                if v110:
                    z = self.scheduler.step(eps, int(t_i), z)
                else:
                    z = self.scheduler.step(eps, i, z, step_draw(f"euler/{i}"))
            del cache  # free the PAB cache before the VAE runs
        if getattr(self, "keep_latents", False):
            self.last_latents = z.cpu().numpy()

        with self._phase("vae", self.vae, "vae"):
            video = self.vae.decode(z)

        if self.groups is not None and self.groups.rank != 0:
            return (None,) if not return_dict else VideoSysPipelineOutput(
                video=None)  # rank 0 alone returns the video
        with self._phase("postprocess"):
            video = torch.clamp(video / 2 + 0.5, 0, 1) * 255
            video = video.permute(0, 2, 3, 4, 1).to(torch.uint8)
            video = video[:, :cfg.num_frames].cpu().numpy()
        if not return_dict:
            return (video,)
        return VideoSysPipelineOutput(video=video)

    def save_video(self, video, output_path: str, fps: int = 24):
        return super().save_video(video, output_path, fps=fps)

"""CogVideoX text-to-video pipeline (49 x 480 x 720, DDIM or DPM).

Port of `videosys_tpu/pipelines/cogvideox/pipeline_cogvideox.py` on one
device: `CogVideoXConfig` -> `VideoSysEngine` -> `generate(prompt,
num_frames, height, width, num_inference_steps, seed)` -> uint8 video
[B, T, H, W, 3]. Each step runs the CFG-doubled transformer (uncond
first), combines the guidance (optionally dynamic) and takes a DDIM or DPM
step, in a plain Python loop; with `enable_pab` the steps run under the
per-step plans of `core/pab.py` (spatial only: the joint attention). The
latent is [B, F, C, h, w] and is divided by the VAE's scaling factor
before the decode.

Weights come from a local diffusers-layout snapshot at `model_path`
(`transformer/`, `vae/`, and `text_encoder/` with `tokenizer/`; see
utils/checkpoint.py) or from this package's `save_params` directory there.
`cpu_offload` keeps every module on the host and fetches each onto the
card for its phase only (text, denoise, VAE).

`num_gpus > 1` (`core/parallel.py`): one pipeline per rank over the ranks'
process groups (`groups=`; `VideoSysEngine` spawns the ranks). Every rank
is sp, as in the JAX pipeline (no cp): the transformer runs Ulysses
sequence parallelism. Every rank draws the same noise, takes the same steps
and decodes the whole video; rank 0 alone returns it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

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
from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import (
    AutoencoderKLCogVideoX,
    CogVideoXVAEConfig,
)
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
from videosys_tpu_torch.models.transformers.cogvideox import (
    CogVideoXConfig as CogModelConfig,
)
from videosys_tpu_torch.models.transformers.cogvideox import CogVideoXTransformer3D
from videosys_tpu_torch.pipelines.common import (
    rank_groups,
    request_seed,
    snapshot_text_encoder,
)
from videosys_tpu_torch.schedulers.ddim import DDIMConfig, DDIMScheduler
from videosys_tpu_torch.schedulers.dpm_cogvideox import (
    CogVideoXDPMConfig,
    CogVideoXDPMScheduler,
)
from videosys_tpu_torch.utils.checkpoint import require_weights, try_load_params
from videosys_tpu_torch.utils.timing import SCHEDULER, STEP, span

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def CogVideoXPABConfig(**overrides) -> PABConfig:
    """Spatial-only PAB for CogVideoX (the joint attention)."""
    defaults = dict(spatial_broadcast=True, spatial_threshold=(100, 850),
                    spatial_range=2)
    defaults.update(overrides)
    return PABConfig(**defaults)


@dataclasses.dataclass
class CogVideoXConfig:
    """`model_path`: a local diffusers-layout CogVideoX snapshot ("5b" in
    the name picks the 5b widths); None or "" (with `transformer_config`,
    `vae_config`) runs random weights and the stub encoder."""

    model_path: Optional[str] = "THUDM/CogVideoX-2b"
    num_gpus: int = 1  # ranks, all sp (Ulysses)
    # low-memory mode: the modules stay on the host and each phase fetches
    # the one it runs (text encoder, transformer, VAE) onto the card
    cpu_offload: bool = False
    vae_tiling: bool = True
    enable_pab: bool = False
    pab_config: Optional[PABConfig] = None
    scheduler: str = "ddim"  # "ddim" (2b) | "dpm" (5b)
    dtype: str = "bf16"
    # random-init hooks: model sizes when no checkpoint is loaded
    transformer_config: Optional[CogModelConfig] = None
    vae_config: Optional[CogVideoXVAEConfig] = None

    def __post_init__(self):
        if self.pab_config is None:
            self.pab_config = CogVideoXPABConfig()
        self.pipeline_cls = CogVideoXPipeline


def dynamic_guidance(scale: float, t: float, num_steps: int) -> float:
    """The reference's dynamic CFG: 1 + g (1 - cos(pi ((N - t) / N)^5)) / 2,
    with t the timestep and N the step count."""
    return 1 + scale * ((1 - math.cos(
        math.pi * ((num_steps - t) / num_steps) ** 5.0)) / 2)


class CogVideoXPipeline(VideoSysPipeline):
    serves_parallel = True  # VideoSysEngine may spawn num_gpus ranks

    def __init__(self, config: CogVideoXConfig, text_encoder=None,
                 vae: Optional[AutoencoderKLCogVideoX] = None,
                 params: Optional[dict] = None, seed: int = 42, device=None,
                 groups: Optional[par.Groups] = None):
        """`params`: optional {"transformer": state_dict, "vae": state_dict}
        (tensors or numpy arrays, this package's key names; see
        utils/from_jax.py); a module not in it is loaded from `model_path`,
        or random-initialized from `seed` under the random-init hooks.
        Under `cpu_offload` the modules are built and kept on the host.
        `groups`: this rank's process groups (`pipelines.common.
        rank_groups`)."""
        self._config = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.dtype]
        self.groups = rank_groups(config, groups, self.device)
        is_5b = "5b" in (config.model_path or "")
        self.model_config = config.transformer_config or CogModelConfig(
            use_rotary_positional_embeddings=is_5b,
            num_layers=42 if is_5b else 30, num_heads=48 if is_5b else 30)
        self.text_encoder = text_encoder or self._load_text_encoder(config)

        params = dict(params or {})
        if not {"transformer", "vae"} <= set(params):
            loaded = try_load_params(config, family="cogvideox") or {}
            params = {**loaded, **params}
            require_weights(params, config)
        # inference weights are held in the pipeline dtype, as the
        # reference's torch_dtype and the JAX package's cast_float_params
        modules = build_modules(
            {"transformer": lambda: CogVideoXTransformer3D(self.model_config),
             "vae": lambda: vae or AutoencoderKLCogVideoX(
                 config.vae_config or CogVideoXVAEConfig())},
            params, seed, self.device, self.dtype, config.cpu_offload)
        self.transformer, self.vae = modules["transformer"], modules["vae"]
        if config.vae_tiling:
            self.vae.enable_tiling()

        if config.scheduler == "dpm":
            self.scheduler = CogVideoXDPMScheduler(CogVideoXDPMConfig())
        else:
            self.scheduler = DDIMScheduler(DDIMConfig(
                prediction_type="v_prediction", snr_shift_scale=3.0,
                rescale_betas_zero_snr=True, timestep_spacing="trailing",
                beta_start=0.00085, beta_end=0.012,
                beta_schedule="scaled_linear", set_alpha_to_one=True))

    def _load_text_encoder(self, config: CogVideoXConfig):
        mc = self.model_config
        if not config.model_path:
            return StubTextEncoder(output_dim=mc.text_embed_dim,
                                   max_length=mc.max_text_seq_length,
                                   device=self.device)
        return snapshot_text_encoder(str(config.model_path),
                                     mc.max_text_seq_length, self.dtype,
                                     config.cpu_offload, self.device,
                                     "model_path")

    def latent_shape(self, num_frames: int, height: int, width: int,
                     batch: int = 1) -> Tuple[int, ...]:
        """[B, F, C, h, w] of a request."""
        mc = self.model_config
        sf = self.vae.spatial_factor
        F_lat = (num_frames - 1) // mc.temporal_compression_ratio + 1
        return (batch, F_lat, mc.in_channels, height // sf, width // sf)

    @timed_request
    @torch.no_grad()
    def generate(self, prompt: str, negative_prompt: str = "",
                 num_inference_steps: int = 50, guidance_scale: float = 6.0,
                 use_dynamic_cfg: bool = False, num_frames: int = 49,
                 height: int = 480, width: int = 720, seed: int = -1,
                 latents: Optional[torch.Tensor] = None,
                 noise: Optional[Callable[[str, Tuple[int, ...]],
                                          torch.Tensor]] = None,
                 return_dict: bool = True):
        """Text to video. Draws: `latents`, the initial noise [B, F, C, h, w];
        `noise(name, shape)`, the DPM steps' noise ("dpm/{step}/first",
        "dpm/{step}/second"); both come from a generator seeded with `seed`
        otherwise (a negative one: rank 0's draw)."""
        cfg = self._config
        mc = self.model_config
        seed = request_seed(seed, self.groups)
        gen = torch.Generator(self.device).manual_seed(seed)

        def draw(prefix):
            def fn(name, shape):
                if noise is None:
                    return torch.randn(shape, device=self.device, generator=gen)
                return noise(f"{prefix}/{name}", shape).to(self.device,
                                                           torch.float32)
            return fn

        self.last_timings = dict.fromkeys(
            ("text", "denoise", "vae", "postprocess"), 0.0)
        with self._phase("text"):
            y_pos, _ = self.text_encoder.encode([prompt])
            y_neg, _ = self.text_encoder.encode([negative_prompt])
            enc_all = torch.cat([y_neg.to(self.device), y_pos.to(self.device)]
                                ).to(self.dtype)
        B = y_pos.shape[0]
        shape = self.latent_shape(num_frames, height, width, B)
        timesteps = self.scheduler.set_timesteps(num_inference_steps)
        pab = cfg.pab_config if cfg.enable_pab else None
        plans = build_plans(pab, timesteps.astype(np.float32), mc.num_layers)
        is_dpm = isinstance(self.scheduler, CogVideoXDPMScheduler)

        with self._phase("denoise", self.transformer, "transformer"), \
                par.use_groups(self.groups):
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
                    pab, 2 * B, shape[1] * (shape[3] // p) * (shape[4] // p),
                    enc_all.shape[1])
                self.last_pab_cache_bytes = cache.nbytes if cache else 0
            old_x0 = None
            for i, (t_i, plan) in enumerate(zip(timesteps, plans)):
                with span(STEP):
                    z_in = torch.cat([z, z]).to(self.dtype)
                    t_in = torch.full((2 * B,), float(t_i),
                                      device=self.device)
                    pred = self.transformer(z_in, enc_all, t_in, plan=plan,
                                            pab_cache=cache).float()
                    with span(SCHEDULER):
                        g = (dynamic_guidance(guidance_scale, float(t_i),
                                              num_inference_steps)
                             if use_dynamic_cfg else guidance_scale)
                        eps = pred[:B] + g * (pred[B:] - pred[:B])
                        if is_dpm:
                            t_back = int(timesteps[i - 1]) if i > 0 else None
                            z, old_x0 = self.scheduler.step(
                                eps, old_x0, int(t_i), t_back, z,
                                draw(f"dpm/{i}"))
                        else:
                            z = self.scheduler.step(eps, int(t_i), z)
            del cache  # free the PAB cache before the VAE runs
        if getattr(self, "keep_latents", False):
            self.last_latents = z.cpu().numpy()

        with self._phase("vae", self.vae, "vae"):
            lat = z.transpose(1, 2) / self.vae.config.scaling_factor
            video = self.vae.decode(lat)  # [B, 3, T, H, W]

        if self.groups is not None and self.groups.rank != 0:
            return (None,) if not return_dict else VideoSysPipelineOutput(
                video=None)  # rank 0 alone returns the video
        with self._phase("postprocess"):
            video = torch.round(
                torch.clamp(video.float() / 2 + 0.5, 0, 1) * 255)
            video = video.permute(0, 2, 3, 4, 1).to(torch.uint8).cpu().numpy()
        if not return_dict:
            return (video,)
        return VideoSysPipelineOutput(video=video)

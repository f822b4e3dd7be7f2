"""Vchitect-2.0 text-to-video pipeline (40 x 288 x 480, flow-match Euler).

Port of `videosys_tpu/pipelines/vchitect/pipeline_vchitect.py` on one
device: `VchitectConfig` -> `VideoSysEngine` -> `generate(prompt,
negative_prompt, num_inference_steps, guidance_scale, width, height,
frames, seed)` -> uint8 video [1, F, H, W, 3]. The SD3-style prompt
embedding comes from the CLIP-L + CLIP-G + T5 trio of a local snapshot
(`models/text_encoders/clip.py`) or, without one, from the word-hashing
`DualStubTextEncoder`. Each step runs the transformer twice, uncond then
cond (each with its own PAB cache under `enable_pab`), combines them with
the cosine-dynamic guidance scale and takes a flow-match Euler step. The
frames are decoded together by the 16-channel 2D VAE with the SD3 scaling
and shift; output fps 8.

Weights: the transformer from a local diffusers-layout snapshot's
`transformer/` folder at `model_path` (or this package's `save_params`
directory there), its depth read from the keys; the VAE is random-init from
the seed, as in the JAX package, which loads no Vchitect VAE.
`cpu_offload` keeps every module on the host and fetches each onto the
card for its phase only.

`num_gpus > 1` (`core/parallel.py`): one pipeline per rank over the ranks'
process groups (`groups=`; `VideoSysEngine` spawns the ranks). The
transformer runs DSP over sp (frames resident, tokens for the temporal
attention). The uncond and cond forwards run one after the other with B =
1, as in the JAX pipeline, so under `enable_cp` the two cp ranks of an sp
line compute the same rows: JAX's batch-over-(dp, cp) layout is degenerate
at B = 1. Every rank draws the same noise, takes the same steps and decodes
the whole video; rank 0 alone returns it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Optional, Sequence, Tuple

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
from videosys_tpu_torch.models.transformers.vchitect import (
    VchitectModelConfig,
    VchitectXLTransformer,
)
from videosys_tpu_torch.pipelines.common import rank_groups, request_seed
from videosys_tpu_torch.pipelines.open_sora.data_process import text_preprocessing
from videosys_tpu_torch.schedulers.flow_match_euler import FlowMatchEulerScheduler
from videosys_tpu_torch.utils.checkpoint import (
    require_weights,
    transformer_depth,
    try_load_params,
)

# SD3 VAE constants: latents / scaling + shift before the decode
VAE_SCALING = 1.5305
VAE_SHIFT = 0.0609
_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def VchitectPABConfig(**overrides) -> PABConfig:
    """Vchitect's PAB ladder: spatial, temporal and cross broadcast in
    (100, 800) with ranges 2, 4 and 6."""
    defaults = dict(
        spatial_broadcast=True, spatial_threshold=(100, 800), spatial_range=2,
        temporal_broadcast=True, temporal_threshold=(100, 800),
        temporal_range=4,
        cross_broadcast=True, cross_threshold=(100, 800), cross_range=6,
    )
    defaults.update(overrides)
    return PABConfig(**defaults)


class DualStubTextEncoder:
    """Offline stand-in for the CLIP-L + CLIP-G + T5 trio: word-hash
    embeddings shaped like the SD3 packing, `encode_dual(texts)` ->
    (prompt_embeds [B, clip_len + t5_len, joint_dim] with the CLIP rows
    `pooled_dim` wide and zero-padded, pooled [B, pooled_dim]), fp32 on
    `device` (None: the card); byte-equal to the JAX package's stub."""

    def __init__(self, joint_dim: int = 4096, pooled_dim: int = 2048,
                 clip_len: int = 77, t5_len: int = 256, device=None):
        self.joint_dim = joint_dim
        self.pooled_dim = pooled_dim
        self.clip_len = clip_len
        self.t5_len = t5_len
        self.device = resolve_device(device)

    def _vec(self, word: str, dim: int, salt: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256((salt + word).encode()).digest()[:4], "little")
        return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)

    def encode_dual(self, texts: Sequence[str]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = len(texts)
        embs = np.zeros((B, self.clip_len + self.t5_len, self.joint_dim),
                        np.float32)
        pooled = np.zeros((B, self.pooled_dim), np.float32)
        for i, text in enumerate(texts):
            words = text.split() if text else []
            for j, w in enumerate(words[: self.clip_len]):
                embs[i, j, : self.pooled_dim] = self._vec(w, self.pooled_dim,
                                                          "clip")
            for j, w in enumerate(words[: self.t5_len]):
                embs[i, self.clip_len + j] = self._vec(w, self.joint_dim, "t5")
            if words:
                pooled[i] = np.mean(
                    [self._vec(w, self.pooled_dim, "pool") for w in words],
                    axis=0)
        return (torch.from_numpy(embs).to(self.device),
                torch.from_numpy(pooled).to(self.device))


@dataclasses.dataclass
class VchitectConfig:
    """`model_path`: a local Vchitect snapshot (`transformer/`, and the
    text encoders when it has `text_encoder/`); None (with
    `transformer_config`) runs random weights and the stub encoder.
    `vae_config`: AutoencoderKL2D keyword arguments (16 latent channels
    unless given); `vae`: a VAE module to use in place of the built one
    (the pipeline's `vae=` argument comes first)."""

    model_path: Optional[str] = "Vchitect/Vchitect-2.0-2B"
    num_gpus: int = 1  # ranks: sp = num_gpus, or num_gpus / 2 with cp
    # cp ranks replicate the B = 1 forwards (as the JAX pipeline's mesh)
    enable_cp: bool = False
    # low-memory mode: the modules stay on the host and each phase fetches
    # the one it runs (text encoders, transformer, VAE) onto the card
    cpu_offload: bool = False
    enable_pab: bool = False
    pab_config: Optional[PABConfig] = None
    dtype: str = "bf16"
    # random-init hooks: model sizes when no checkpoint is loaded
    transformer_config: Optional[VchitectModelConfig] = None
    vae_config: Optional[dict] = None
    vae: Optional[AutoencoderKL2D] = None

    def __post_init__(self):
        if self.pab_config is None:
            self.pab_config = VchitectPABConfig()
        self.pipeline_cls = VchitectXLPipeline


class VchitectXLPipeline(VideoSysPipeline):
    serves_parallel = True  # VideoSysEngine may spawn num_gpus ranks

    def __init__(self, config: VchitectConfig, text_encoder=None,
                 vae: Optional[AutoencoderKL2D] = None,
                 params: Optional[dict] = None, seed: int = 42, device=None,
                 groups: Optional[par.Groups] = None):
        """`params`: optional {"transformer": state_dict, "vae": state_dict}
        (this package's key names, the reference's); a transformer not in
        it is loaded from `model_path`, or random-initialized from `seed`
        under `transformer_config`; the VAE is random-initialized unless
        given. Under `cpu_offload` the modules are built and kept on the
        host. `groups`: this rank's process groups
        (`pipelines.common.rank_groups`)."""
        self._config = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.dtype]
        self.groups = rank_groups(config, groups, self.device)
        params = dict(params or {})
        if "transformer" not in params:
            params = {**(try_load_params(config, family="vchitect") or {}),
                      **params}
            require_weights(params, config, vae=False)
        self.model_config = config.transformer_config or VchitectModelConfig(
            num_layers=(transformer_depth(params["transformer"])
                        if "transformer" in params else 18),
            dtype=self.dtype)
        mc = self.model_config
        if text_encoder is None:
            path = str(config.model_path or "")
            if path and os.path.isdir(os.path.join(path, "text_encoder")):
                from videosys_tpu_torch.models.text_encoders.clip import (
                    VchitectTripleTextEncoder,
                )

                text_encoder = VchitectTripleTextEncoder(
                    path, dtype=self.dtype, offload=config.cpu_offload,
                    device=self.device)
            else:
                text_encoder = DualStubTextEncoder(
                    joint_dim=mc.joint_attention_dim,
                    pooled_dim=mc.pooled_projection_dim, device=self.device)
        self.text_encoder = text_encoder

        vae = vae if vae is not None else config.vae
        vae_kw = {"latent_channels": mc.in_channels, **(config.vae_config or {})}
        modules = build_modules(
            {"transformer": lambda: VchitectXLTransformer(mc),
             "vae": lambda: vae or AutoencoderKL2D(**vae_kw)},
            params, seed, self.device, self.dtype, config.cpu_offload)
        self.transformer, self.vae = modules["transformer"], modules["vae"]
        self.scheduler = FlowMatchEulerScheduler()

    def latent_shape(self, frames: int, height: int, width: int):
        """[1, F, C, h, w] of a request."""
        sf = 2 ** (len(self.vae.block_out_channels) - 1)
        return (1, frames, self.model_config.in_channels, height // sf,
                width // sf)

    @timed_request
    @torch.no_grad()
    def generate(self, prompt: str, negative_prompt: str = "",
                 num_inference_steps: int = 100, guidance_scale: float = 7.5,
                 width: int = 480, height: int = 288, frames: int = 40,
                 seed: int = -1, latents: Optional[torch.Tensor] = None,
                 return_dict: bool = True):
        """Text to video. `latents`: the initial noise [1, F, C, h, w],
        drawn from a generator seeded with `seed` otherwise (a negative
        one: rank 0's draw)."""
        cfg = self._config
        mc = self.model_config
        seed = request_seed(seed, self.groups)
        gen = torch.Generator(self.device).manual_seed(seed)
        self.last_timings = dict.fromkeys(
            ("text", "denoise", "vae", "postprocess"), 0.0)
        with self._phase("text"):
            y_pos, pool_pos = self.text_encoder.encode_dual(
                [text_preprocessing(prompt)])
            y_neg, pool_neg = self.text_encoder.encode_dual(
                [text_preprocessing(negative_prompt)])
            y_pos, y_neg = (y.to(self.device, self.dtype) for y in (y_pos, y_neg))
            pool_pos, pool_neg = (p.to(self.device) for p in (pool_pos, pool_neg))
        shape = self.latent_shape(frames, height, width)
        timesteps = self.scheduler.set_timesteps(num_inference_steps)
        pab = cfg.pab_config if cfg.enable_pab else None
        plans = build_plans(pab, np.asarray(timesteps, np.float32),
                            mc.num_layers)

        with self._phase("denoise", self.transformer, "transformer"), \
                par.use_groups(self.groups):
            if latents is not None:
                if tuple(latents.shape) != shape:
                    raise ValueError(f"latents shape {tuple(latents.shape)} "
                                     f"!= {shape}")
                z = latents.to(self.device, torch.float32)
            else:
                z = torch.randn(shape, device=self.device, generator=gen)
            caches = (None, None)
            if pab is not None:  # on the card with the transformer
                p = mc.patch_size
                S = (shape[3] // p) * (shape[4] // p)
                caches = tuple(self.transformer.init_cache(
                    pab, 1, frames, S, y_pos.shape[1]) for _ in range(2))
                self.last_pab_cache_bytes = sum(c.nbytes for c in caches)
            for i, (t_i, plan) in enumerate(zip(timesteps, plans)):
                t_in = torch.full((1,), float(t_i), device=self.device)
                zin = z.to(self.dtype)
                v_uncond = self.transformer(zin, y_neg, pool_neg, t_in,
                                            plan=plan, pab_cache=caches[0])
                v_text = self.transformer(zin, y_pos, pool_pos, t_in,
                                          plan=plan, pab_cache=caches[1])
                # the cosine-dynamic guidance scale
                gs = 1 + guidance_scale * ((1 - math.cos(math.pi * (
                    (num_inference_steps - float(t_i))
                    / num_inference_steps) ** 5.0)) / 2)
                v = v_uncond + gs * (v_text - v_uncond)
                z = self.scheduler.step(v, i, z)
            del caches  # free the PAB caches before the VAE runs
        if getattr(self, "keep_latents", False):
            self.last_latents = z.cpu().numpy()

        with self._phase("vae", self.vae, "vae"):
            # every frame in one decode, with the SD3 scaling and shift
            video = self.vae.decode((z[0] / VAE_SCALING + VAE_SHIFT)
                                    .to(self.dtype))

        if self.groups is not None and self.groups.rank != 0:
            return (None,) if not return_dict else VideoSysPipelineOutput(
                video=None)  # rank 0 alone returns the video
        with self._phase("postprocess"):
            video = torch.clamp(video.float() / 2 + 0.5, 0, 1) * 255
            video = video.to(torch.uint8).permute(0, 2, 3, 1)[None]
            video = video.cpu().numpy()
        if not return_dict:
            return (video,)
        return VideoSysPipelineOutput(video=video)

    def save_video(self, video, output_path: str, fps: int = 8):
        return super().save_video(video, output_path, fps=fps)

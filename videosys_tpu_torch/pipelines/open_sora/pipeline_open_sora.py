"""Open-Sora v1.2 text-to-video pipeline.

Port of `videosys_tpu/pipelines/open_sora/pipeline_open_sora.py`, plain
text-to-video on one device: `OpenSoraConfig` -> `VideoSysEngine` ->
`generate(prompt, resolution, aspect_ratio, num_frames, seed)` -> uint8
video [B, T, H, W, 3]. Each denoise step runs the CFG-doubled STDiT3,
combines the guidance and takes an Euler step, in a plain Python loop.
Not ported yet: PAB (raises), condition frames (`reference`,
`mask_strategy`), `loop > 1`, CPU offload, multi-device runs, checkpoint
loading and the T5 encoder.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from videosys_tpu_torch.core.pipeline import VideoSysPipeline, VideoSysPipelineOutput
from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
    OpenSoraVAE,
    OpenSoraVAEConfig,
)
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3, STDiT3Config
from videosys_tpu_torch.pipelines.common import bucket_text_kv
from videosys_tpu_torch.pipelines.open_sora.data_process import (
    append_score_to_prompts,
    extract_prompts_loop,
    get_image_size,
    get_num_frames,
    merge_prompt,
    split_prompt,
    text_preprocessing,
)
from videosys_tpu_torch.schedulers.rflow import RFlowConfig, RFlowScheduler

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None; a CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return dev


@dataclasses.dataclass
class OpenSoraConfig:
    transformer: Optional[str] = "hpcai-tech/OpenSora-STDiT-v3"
    vae: Optional[str] = "hpcai-tech/OpenSora-VAE-v1.2"
    text_encoder: Optional[str] = "DeepFloyd/t5-v1_1-xxl"
    # ======== scheduler ========
    num_sampling_steps: int = 30
    cfg_scale: float = 7.0
    # ======== vae ========
    tiling_size: int = 8  # spatial-VAE frame micro-batch
    # ======== speedup ========
    text_kv_bucket: bool = True
    enable_pab: bool = False
    dtype: str = "bf16"
    # random-init hooks: model sizes when no checkpoint is loaded
    transformer_config: Optional[STDiT3Config] = None
    vae_config: Optional[OpenSoraVAEConfig] = None

    def __post_init__(self):
        if self.enable_pab:
            raise NotImplementedError("PAB is not ported yet")
        self.pipeline_cls = OpenSoraPipeline


class OpenSoraPipeline(VideoSysPipeline):
    def __init__(self, config: OpenSoraConfig, text_encoder=None,
                 vae: Optional[OpenSoraVAE] = None,
                 params: Optional[dict] = None, seed: int = 42, device=None):
        """`params`: optional {"transformer": state_dict, "vae": state_dict}
        in this package's key names (see utils/from_jax.py); modules are
        random-initialized from `seed` otherwise."""
        self._config = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.dtype]
        params = params or {}
        if "transformer" not in params and config.transformer \
                and config.transformer_config is None:
            raise FileNotFoundError(
                f"checkpoint loading ({config.transformer!r}) is not ported "
                f"yet; set transformer=None for random-init weights")
        if "vae" not in params and config.vae and config.vae_config is None \
                and vae is None:
            raise FileNotFoundError(
                f"checkpoint loading ({config.vae!r}) is not ported yet; set "
                f"vae=None for random-init weights")
        if config.text_encoder:
            raise NotImplementedError(
                "the T5 text encoder is not ported yet; set text_encoder=None "
                "for the offline stub")

        self.model_config = config.transformer_config or STDiT3Config(
            dtype=self.dtype)
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda), torch.device(self.device):
            torch.manual_seed(seed)
            self.transformer = STDiT3(self.model_config)
            self.vae = vae or OpenSoraVAE(
                config.vae_config
                or OpenSoraVAEConfig(micro_batch_size=config.tiling_size))
        self.vae.to(self.device)
        # inference weights are held in the half dtype, like the reference's
        # torch_dtype; the transformer computes in its config's dtype
        for name, module, dtype in (
                ("transformer", self.transformer, self.model_config.dtype),
                ("vae", self.vae, self.dtype)):
            if name in params:
                module.load_state_dict(
                    {k: torch.tensor(np.asarray(v))
                     for k, v in params[name].items()})
            module.to(dtype).eval().requires_grad_(False)
        self.text_encoder = text_encoder or StubTextEncoder(
            output_dim=self.model_config.caption_channels,
            max_length=self.model_config.model_max_length, device=self.device)
        self.scheduler = RFlowScheduler(RFlowConfig(
            num_sampling_steps=config.num_sampling_steps,
            cfg_scale=config.cfg_scale, use_timestep_transform=True))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def null_embed(self, n: int):
        """Uncond caption features for classifier-free guidance."""
        return self.transformer.y_embedder.null_embedding(n)

    def _step(self, z, t_scalar, dt, y_all, kv_mask_all, fps, height, width,
              guidance_scale):
        """One CFG-doubled model eval, guidance combine and Euler step."""
        B = z.shape[0]
        z_in = torch.cat([z, z]).to(self.dtype)
        t_in = torch.full((2 * B,), float(t_scalar), device=z.device)
        out = self.transformer(z_in, t_in, y_all, kv_mask=kv_mask_all,
                               fps=torch.cat([fps, fps]),
                               height=height, width=width)
        pred = out[:, : self.model_config.in_channels]
        v = self.scheduler.apply_cfg(pred[:B], pred[B:], guidance_scale)
        return self.scheduler.step(z, v, dt)

    @torch.no_grad()
    def generate(self, prompt, resolution: str = "480p",
                 aspect_ratio: str = "9:16", num_frames="2s", seed=-1,
                 guidance_scale: Optional[float] = None, aes: float = 6.5,
                 flow: Optional[float] = None,
                 camera_motion: Optional[float] = None, fps: int = 24,
                 latents: Optional[torch.Tensor] = None,
                 return_dict: bool = True):
        """Text to video. `prompt` may be a list (one batched denoise; row i
        uses seed + i). `latents`: optional initial noise [B, 4, T_lat, h,
        w]; drawn from a per-prompt seeded generator otherwise."""
        cfg = self._config
        height, width = get_image_size(resolution, aspect_ratio)
        num_frames = get_num_frames(num_frames)
        if guidance_scale is None:
            guidance_scale = cfg.cfg_scale
        prompts = list(prompt) if isinstance(prompt, (list, tuple)) else [prompt]
        B = len(prompts)
        if isinstance(seed, (list, tuple)):
            if len(seed) != B:
                raise ValueError(f"seed list length {len(seed)} != {B} prompts")
            seeds = [int(s) for s in seed]
        else:
            base = int(seed) if seed >= 0 else np.random.randint(0, 2**31 - 1)
            seeds = [base + i for i in range(B)]

        # --- text ---------------------------------------------------------- #
        t0 = time.perf_counter()
        merged = []
        for p in prompts:
            segs, loop_idx = split_prompt(p)
            segs = append_score_to_prompts(segs, aes=aes, flow=flow,
                                           camera_motion=camera_motion)
            merged.append(merge_prompt([text_preprocessing(s) for s in segs],
                                       loop_idx))
        y, kv_mask = self.text_encoder.encode(extract_prompts_loop(merged, 0))
        y_all = torch.cat([y.to(self.device), self.null_embed(B).to(y.dtype)
                           ]).to(self.dtype)
        kv_mask = kv_mask.to(self.device)
        kv_mask_all = torch.cat([kv_mask, kv_mask])
        self.last_text_kv_len = y_all.shape[1]
        if cfg.text_kv_bucket:
            y_all, kv_mask_all, self.last_text_kv_len = bucket_text_kv(
                y_all, kv_mask_all, self.model_config.model_max_length)
        self._sync()
        t_text = time.perf_counter() - t0

        # --- denoise --------------------------------------------------------- #
        t_lat, h_lat, w_lat = self.vae.get_latent_size((num_frames, height, width))
        shape = (B, self.vae.out_channels, t_lat, h_lat, w_lat)
        if latents is not None:
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents shape {tuple(latents.shape)} != {shape}")
            z = latents.to(self.device, torch.float32)
        else:
            z = torch.cat([
                torch.randn((1,) + shape[1:], device=self.device,
                            generator=torch.Generator(self.device).manual_seed(s))
                for s in seeds])
        timesteps = self.scheduler.prepare_timesteps(height, width, num_frames)
        dts = self.scheduler.prepare_dts(timesteps)
        fps_arr = torch.full((B,), float(fps), device=self.device)
        t0 = time.perf_counter()
        for t_i, dt_i in zip(timesteps, dts):
            z = self._step(z, t_i, dt_i, y_all, kv_mask_all, fps_arr,
                           float(height), float(width), float(guidance_scale))
        self._sync()
        t_denoise = time.perf_counter() - t0
        if getattr(self, "keep_latents", False):
            self.last_latents = z.cpu().numpy()

        # --- vae --------------------------------------------------------------- #
        t0 = time.perf_counter()
        chunks = self.vae.decode_chunks_u8(z, num_frames)
        self._sync()
        t_vae = time.perf_counter() - t0

        # --- postprocess ------------------------------------------------------- #
        t0 = time.perf_counter()
        video = torch.cat(chunks, dim=1).cpu().numpy()
        self.last_timings = {"text": t_text, "denoise": t_denoise,
                             "vae": t_vae,
                             "postprocess": time.perf_counter() - t0}
        if not return_dict:
            return (video,)
        return VideoSysPipelineOutput(video=video)

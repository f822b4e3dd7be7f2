"""Open-Sora v1.2 text-to-video pipeline.

Port of `videosys_tpu/pipelines/open_sora/pipeline_open_sora.py` on one
device: `OpenSoraConfig` -> `VideoSysEngine` -> `generate(prompt,
resolution, aspect_ratio, num_frames, seed)` -> uint8 video [B, T, H, W, 3].
Each denoise step runs the CFG-doubled STDiT3, combines the guidance and
takes an Euler step, in a plain Python loop. With `enable_pab` the steps run
under the per-step plans of `core/pab.py` with one PAB cache per loop.
Condition frames (`reference`, `mask_strategy`) and `loop > 1` clamp frames
to VAE-encoded references (`mask_strategy.py`).

Weights come from local directories (`utils/checkpoint.py`): the
transformer from a reference snapshot or, with the VAE, from this
package's `save_params` directory; the T5 encoder and its tokenizer from a
local HF snapshot. `cpu_offload` keeps every module on the host and fetches
each onto the card for its phase only (text, denoise, VAE).

`num_gpus > 1` (`core/parallel.py`): one pipeline per rank, each on its own
device, over the ranks' process groups (`groups=`; `VideoSysEngine` spawns
the ranks, a `torchrun` caller passes its own). STDiT3 runs sequence
parallel (DSP) over sp; with `enable_cp` the two halves of the CFG-doubled
batch run on the two cp ranks and are gathered for the guidance. Every rank
draws the same noise from the same seeds and takes the same steps; the VAE
(the decode, and the encodes of references and loop clips) runs split over
every rank (`OpenSoraVAE` under the groups: latent rows, then frames), and
rank 0 alone gathers, post-processes and returns the video.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

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
from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
    OpenSoraVAE,
    OpenSoraVAEConfig,
)
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder, T5TextEncoder
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3, STDiT3Config
from videosys_tpu_torch.pipelines.common import (
    bucket_text_kv,
    rank_groups,
    request_seed,
)
from videosys_tpu_torch.pipelines.open_sora import mask_strategy as ms
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
from videosys_tpu_torch.utils.checkpoint import require_weights, try_load_params
from videosys_tpu_torch.utils.timing import SCHEDULER, STEP, span

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def OpenSoraPABConfig(**overrides) -> PABConfig:
    """Default PAB thresholds for Open-Sora (pipeline_open_sora.py:32-69)."""
    mlp_cfg = {
        676: {"block": [0, 1, 2, 3, 4], "skip_count": 2},
        788: {"block": [0, 1, 2, 3, 4], "skip_count": 2},
        864: {"block": [0, 1, 2, 3, 4], "skip_count": 2},
    }
    defaults = dict(
        spatial_broadcast=True, spatial_threshold=(450, 930), spatial_range=2,
        temporal_broadcast=True, temporal_threshold=(450, 930), temporal_range=4,
        cross_broadcast=True, cross_threshold=(450, 930), cross_range=6,
        mlp_broadcast=True,
        mlp_spatial_broadcast_config=mlp_cfg,
        mlp_temporal_broadcast_config=dict(mlp_cfg),
    )
    defaults.update(overrides)
    return PABConfig(**defaults)


@dataclasses.dataclass
class OpenSoraConfig:
    """`transformer`: a local reference STDiT3 snapshot or a `save_params`
    directory; `text_encoder`: a local HF T5 snapshot with its tokenizer;
    None for either (with `transformer_config`, `vae_config`) runs random
    weights and the stub encoder. See utils/checkpoint.py."""

    transformer: Optional[str] = "hpcai-tech/OpenSora-STDiT-v3"
    vae: Optional[str] = "hpcai-tech/OpenSora-VAE-v1.2"
    text_encoder: Optional[str] = "DeepFloyd/t5-v1_1-xxl"
    # ======== distributed ========
    num_gpus: int = 1  # ranks: sp = num_gpus, or num_gpus / 2 with cp
    # low-memory mode: the modules stay on the host and each phase fetches
    # the one it runs (text encoder, transformer, VAE) onto the card
    cpu_offload: bool = False
    enable_cp: bool = False  # CFG halves over 2 ranks (even num_gpus)
    # ======== scheduler ========
    num_sampling_steps: int = 30
    cfg_scale: float = 7.0
    # ======== vae ========
    tiling_size: int = 8  # spatial-VAE frame micro-batch
    # ======== speedup ========
    # every CUDA tensor goes to the flash kernels: False raises on the card
    enable_flash_attn: bool = True
    text_kv_bucket: bool = True
    # ======== pab ========
    enable_pab: bool = False
    pab_config: Optional[PABConfig] = None
    dtype: str = "bf16"
    # random-init hooks: model sizes when no checkpoint is loaded
    transformer_config: Optional[STDiT3Config] = None
    vae_config: Optional[OpenSoraVAEConfig] = None

    def __post_init__(self):
        if self.pab_config is None:
            self.pab_config = OpenSoraPABConfig()
        self.pipeline_cls = OpenSoraPipeline


class OpenSoraPipeline(VideoSysPipeline):
    serves_parallel = True  # VideoSysEngine may spawn num_gpus ranks

    def __init__(self, config: OpenSoraConfig, text_encoder=None,
                 vae: Optional[OpenSoraVAE] = None,
                 params: Optional[dict] = None, seed: int = 42, device=None,
                 groups: Optional[par.Groups] = None):
        """`params`: optional {"transformer": state_dict, "vae": state_dict}
        (tensors or numpy arrays, this package's key names; see
        utils/from_jax.py); a module not in it is loaded from the config's
        paths, or random-initialized from `seed` under the random-init
        hooks. Under `cpu_offload` the modules are built and kept on the
        host. `groups`: this rank's process groups (`parallel.build_groups`,
        the counterpart of JAX's `mesh=`; `pipelines.common.rank_groups`)."""
        self._config = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.dtype]
        self.groups = rank_groups(config, groups, self.device)
        if not config.enable_flash_attn and self.device.type == "cuda":
            raise ValueError(
                "enable_flash_attn=False: on the card every attention runs "
                "the flash kernels; the plain attention runs only on the CPU")
        self.model_config = config.transformer_config or STDiT3Config(
            dtype=self.dtype)
        self.text_encoder = text_encoder or self._load_text_encoder(config)

        params = dict(params or {})
        if not {"transformer", "vae"} <= set(params):
            loaded = try_load_params(config) or {}
            params = {**loaded, **params}
            require_weights(params, config)
        # inference weights are held in the half dtype, like the reference's
        # torch_dtype; the transformer computes in its config's dtype
        modules = build_modules(
            {"transformer": lambda: STDiT3(self.model_config),
             "vae": lambda: vae or OpenSoraVAE(
                 config.vae_config
                 or OpenSoraVAEConfig(micro_batch_size=config.tiling_size))},
            params, seed, self.device,
            {"transformer": self.model_config.dtype, "vae": self.dtype},
            config.cpu_offload)
        self.transformer, self.vae = modules["transformer"], modules["vae"]
        self.scheduler = RFlowScheduler(RFlowConfig(
            num_sampling_steps=config.num_sampling_steps,
            cfg_scale=config.cfg_scale, use_timestep_transform=True))

    def _load_text_encoder(self, config: OpenSoraConfig):
        if config.text_encoder:
            try:
                return T5TextEncoder(
                    config.text_encoder,
                    max_length=self.model_config.model_max_length,
                    dtype=self.dtype, offload=config.cpu_offload,
                    device=self.device)
            except Exception as e:
                # the reference fails in from_pretrained; a configured encoder
                # is never replaced by the stub
                raise RuntimeError(
                    f"text encoder {config.text_encoder!r} could not be "
                    f"loaded ({e}); pass text_encoder=None for the offline "
                    f"stub, or a local HF snapshot path") from e
        return StubTextEncoder(
            output_dim=self.model_config.caption_channels,
            max_length=self.model_config.model_max_length, device=self.device)

    def null_embed(self, n: int):
        """Uncond caption features for classifier-free guidance."""
        return self.transformer.y_embedder.null_embedding(n)

    def _step(self, z, t_scalar, dt, y_all, kv_mask_all, fps, height, width,
              guidance_scale, x_mask=None, plan=None, cache=None):
        """One CFG-doubled model eval, guidance combine and Euler step;
        `plan` and `cache`: the PAB step plan and cache."""
        with span(STEP):
            B = z.shape[0]
            z_in = torch.cat([z, z]).to(self.dtype)
            t_in = torch.full((2 * B,), float(t_scalar), device=z.device)
            batch = [z_in, t_in, y_all, kv_mask_all, torch.cat([fps, fps]),
                     x_mask]
            # cp: this rank runs its half of the CFG-doubled batch
            z_in, t_in, y_all, kv_mask_all, fps_in, x_mask = (
                None if a is None else par.split(a, 0, par.CP_AXIS)
                for a in batch)
            out = self.transformer(z_in, t_in, y_all, kv_mask=kv_mask_all,
                                   x_mask=x_mask, fps=fps_in,
                                   height=height, width=width, plan=plan,
                                   pab_cache=cache)
            pred = par.gather(out[:, : self.model_config.in_channels], 0,
                              par.CP_AXIS)
            with span(SCHEDULER):
                v = self.scheduler.apply_cfg(pred[:B], pred[B:],
                                             guidance_scale)
                return self.scheduler.step(z, v, dt)

    def _masked_step(self, z, t_scalar, dt, y_all, kv_mask_all, fps, height,
                     width, guidance_scale, mask, noise_added, eps,
                     plan=None, cache=None):
        """A step with condition frames (scheduling_rflow_open_sora.py
        :226-257): frames whose edit threshold mask * T has not been passed
        stay clamped to their reference x0; a frame crossing it is re-noised
        with `eps` once. Returns (z, the frames noised so far)."""
        B = z.shape[0]
        t_b = torch.full((B,), float(t_scalar), device=z.device)
        x0 = z
        x_noise = self.scheduler.add_noise(x0, eps, t_b)
        upper = mask * float(self.scheduler.config.num_timesteps) >= t_b[:, None]
        add = (upper & ~noise_added)[:, None, :, None, None]
        z = torch.where(add, x_noise, x0)
        z = self._step(z, t_scalar, dt, y_all, kv_mask_all, fps, height,
                       width, guidance_scale, x_mask=torch.cat([upper, upper]),
                       plan=plan, cache=cache)
        return torch.where(upper[:, None, :, None, None], z, x0), upper

    def _encode_prompts(self, texts):
        """(y_all, kv_mask_all) of the CFG-doubled batch; sets
        last_text_kv_len."""
        y, kv_mask = self.text_encoder.encode(texts)
        # the null caption is the transformer's: fetch that part alone
        with self._on_device(self.transformer.y_embedder, "y_embedder"):
            y_all = torch.cat([y.to(self.device),
                               self.null_embed(len(texts)).to(y.dtype)
                               ]).to(self.dtype)
        kv_mask = kv_mask.to(self.device)
        kv_mask_all = torch.cat([kv_mask, kv_mask])
        self.last_text_kv_len = y_all.shape[1]
        if self._config.text_kv_bucket:
            y_all, kv_mask_all, self.last_text_kv_len = bucket_text_kv(
                y_all, kv_mask_all, self.model_config.model_max_length)
        return y_all, kv_mask_all

    @timed_request
    @torch.no_grad()
    def generate(self, prompt, resolution: str = "480p",
                 aspect_ratio: str = "9:16", num_frames="2s", seed=-1,
                 guidance_scale: Optional[float] = None, aes: float = 6.5,
                 flow: Optional[float] = None,
                 camera_motion: Optional[float] = None, fps: int = 24,
                 reference=None, mask_strategy: Optional[str] = None,
                 loop: int = 1, condition_frame_length: int = 5,
                 condition_frame_edit: float = 0.0, align: Optional[int] = 5,
                 latents: Union[None, torch.Tensor,
                                Sequence[torch.Tensor]] = None,
                 noise: Optional[Callable[[str, Tuple[int, ...]],
                                          torch.Tensor]] = None,
                 return_dict: bool = True):
        """Text to video. `prompt` may be a list (one batched denoise; row i
        uses seed + i). A negative `seed` draws one; on several ranks, rank
        0 draws it and sends it to the others.

        Condition frames: `reference` is pixels [C, T, H, W] in [-1, 1]
        (conditioned on its frame 0 unless `mask_strategy` says otherwise;
        see mask_strategy.py); with `loop` > 1 each later loop is
        conditioned on the last `condition_frame_length` latent frames of
        the clip before, and the clips are stitched without those frames.

        Draws: `latents`, the initial noise [B, 4, T_lat, h, w] (a list:
        one per loop), drawn from a per-prompt seeded generator otherwise;
        `noise(name, shape)`, the other draws: "reference/spatial",
        "reference/temporal/{i}" and "loop{l}/..." (the VAE encodes, see
        OpenSoraVAE.encode) and "mask/{l}/{step}" (a masked step's noise),
        drawn from the first prompt's generator otherwise."""
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
            base = request_seed(seed, self.groups)
            seeds = [base + i for i in range(B)]
        if isinstance(latents, torch.Tensor):
            latents = [latents]
        if latents is not None and len(latents) != loop:
            raise ValueError(f"{len(latents)} latents for {loop} loops")
        gens = [torch.Generator(self.device).manual_seed(s) for s in seeds]

        def draw(name, shape):
            if noise is None:
                return torch.randn(shape, device=self.device, generator=gens[0])
            return noise(name, shape).to(self.device, torch.float32)

        def draws(prefix):
            return lambda name, shape: draw(f"{prefix}/{name}", shape)

        # --- text ---------------------------------------------------------- #
        self.last_timings = dict.fromkeys(
            ("text", "denoise", "vae", "postprocess"), 0.0)
        with self._phase("text"):
            merged = []
            for p in prompts:
                segs, loop_idx = split_prompt(p)
                segs = append_score_to_prompts(segs, aes=aes, flow=flow,
                                               camera_motion=camera_motion)
                merged.append(merge_prompt(
                    [text_preprocessing(s) for s in segs], loop_idx))
            texts = extract_prompts_loop(merged, 0)
            y_all, kv_mask_all = self._encode_prompts(texts)

        # --- denoise, VAE: once per loop ------------------------------------ #
        t_lat, h_lat, w_lat = self.vae.get_latent_size((num_frames, height, width))
        shape = (B, self.vae.out_channels, t_lat, h_lat, w_lat)
        timesteps = self.scheduler.prepare_timesteps(height, width, num_frames)
        dts = self.scheduler.prepare_dts(timesteps)
        pab = cfg.pab_config if cfg.enable_pab else None
        plans = build_plans(pab, timesteps, self.model_config.depth, self.dtype)
        fps_arr = torch.full((B,), float(fps), device=self.device)
        # the VAE encodes of references and loop clips count as "vae"
        refs, strategies = [None] * B, [mask_strategy] * B
        if reference is not None:
            with self._phase("vae", self.vae, "vae"), \
                    par.use_groups(self.groups):
                ref = ms.load_reference(reference, self.vae, self.device,
                                        draws("reference"))
            refs = [[ref]] * B
            if mask_strategy is None:
                strategies = ["0"] * B  # condition on the reference's frame 0
        clips = []
        for loop_i in range(loop):
            if loop_i > 0:
                with self._phase("vae", self.vae, "vae"), \
                        par.use_groups(self.groups):
                    refs, strategies = ms.append_generated(
                        self.vae, clips[-1], refs, strategies, loop_i,
                        condition_frame_length, condition_frame_edit,
                        draws(f"loop{loop_i}"))
                texts_i = extract_prompts_loop(merged, loop_i)
                if texts_i != texts:  # per-loop prompt segments (|0| syntax)
                    with self._phase("text"):
                        texts = texts_i
                        y_all, kv_mask_all = self._encode_prompts(texts)
            with self._phase("denoise", self.transformer, "transformer"), \
                    par.use_groups(self.groups):
                if latents is not None:
                    if tuple(latents[loop_i].shape) != shape:
                        raise ValueError(
                            f"latents shape {tuple(latents[loop_i].shape)} "
                            f"!= {shape}")
                    z = latents[loop_i].to(self.device, torch.float32)
                else:
                    z = torch.cat([torch.randn((1,) + shape[1:],
                                               device=self.device, generator=g)
                                   for g in gens])
                mask = None
                if any(strategies) or any(refs):
                    z, mask = ms.apply_mask_strategy(z, refs, strategies,
                                                     loop_i, align=align)
                cache = None
                if pab is not None:  # on the card with the transformer
                    mc = self.model_config
                    T_tok = -(-t_lat // mc.patch_size[0])
                    S_tok = (-(-h_lat // mc.patch_size[1])) * (
                        -(-w_lat // mc.patch_size[2]))
                    cache = self.transformer.init_cache(
                        pab, 2 * B // par.axis_size(par.CP_AXIS), T_tok,
                        S_tok)
                    self.last_pab_cache_bytes = cache.nbytes
                args = (y_all, kv_mask_all, fps_arr, float(height),
                        float(width), float(guidance_scale))
                if mask is None:
                    for t_i, dt_i, plan in zip(timesteps, dts, plans):
                        z = self._step(z, t_i, dt_i, *args, plan=plan,
                                       cache=cache)
                else:
                    noise_added = mask >= 1.0
                    for i, (t_i, dt_i, plan) in enumerate(
                            zip(timesteps, dts, plans)):
                        eps = draw(f"mask/{loop_i}/{i}", shape)
                        z, noise_added = self._masked_step(
                            z, t_i, dt_i, *args, mask, noise_added, eps,
                            plan=plan, cache=cache)
                del cache  # free the PAB cache before the VAE runs
            if getattr(self, "keep_latents", False):
                self.last_latents = z.cpu().numpy()

            # split over the ranks: the uint8 chunks land on rank 0 alone;
            # a loop's clip on every rank (the next loop encodes it)
            with self._phase("vae", self.vae, "vae"), \
                    par.use_groups(self.groups):
                if loop == 1:
                    clips.append(self.vae.decode_chunks_u8(z, num_frames))
                else:
                    clips.append(self.vae.decode(z, num_frames))

        # --- postprocess ------------------------------------------------------- #
        if self.groups is not None and self.groups.rank != 0:
            return (None,) if not return_dict else VideoSysPipelineOutput(
                video=None)  # rank 0 alone returns the video
        with self._phase("postprocess"):
            if loop == 1:
                video = torch.cat(clips[0], dim=1)
            else:
                # stitch the loops, dropping each later clip's condition frames
                dpix = ms.dframe_to_frame(condition_frame_length)
                samples = torch.cat(
                    [clips[0]] + [c[:, :, dpix:] for c in clips[1:]], dim=2)
                u8 = torch.clamp(
                    (torch.clamp(samples, -1, 1) + 1) / 2 * 255 + 0.5, 0, 255)
                video = u8.to(torch.uint8).permute(0, 2, 3, 4, 1)
            video = video.cpu().numpy()
        if not return_dict:
            return (video,)
        return VideoSysPipelineOutput(video=video)

"""Open-Sora training loop on one device.

Port of `videosys_tpu/training/train.py`: `run_training(TrainConfig)`
trains STDiT3 with the rflow loss over bucketized batches of pre-encoded (or
synthetic) latents: caption dropout, frame masks, gradient accumulation,
AdamW with warmup, cosine decay and clipping, activation recompute, EMA and
checkpoints. Parameters are held in fp32 and the model computes in
`cfg.model.dtype` (bf16 by default). Not ported yet: the DCP profile phase
(`dynamic_profile`, `dynamic_recompute`), multi-device meshes (`dp_size`,
`sp_size`, `dynamic_sp`, `sp_balance`, `zero3`) and raw-video mode (`vae=`);
a `planner` built elsewhere can be passed in.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Optional

import numpy as np
import torch

from videosys_tpu_torch.models.transformers.stdit3 import STDiT3, STDiT3Config
from videosys_tpu_torch.pipelines.open_sora.pipeline_open_sora import resolve_device
from videosys_tpu_torch.schedulers.rflow import RFlowConfig, RFlowScheduler
from videosys_tpu_torch.training import ckpt as ckpt_io
from videosys_tpu_torch.training.buckets import Bucket
from videosys_tpu_torch.training.datasets import (
    DummyVariableVideoTextDataset,
    MaskGenerator,
)
from videosys_tpu_torch.training.ema import init_ema, update_ema
from videosys_tpu_torch.training.sampler import VariableVideoBatchSampler
from videosys_tpu_torch.training.train_step import (
    create_train_state,
    make_optimizer,
    make_train_step,
)

logger = logging.getLogger(__name__)

DEFAULT_BUCKET_CONFIG = {
    # {resolution: {frames: (keep_prob, batch_size)}}
    "144p": {1: (1.0, 32), 34: (1.0, 8), 51: (1.0, 4)},
    "240p": {1: (0.5, 16), 34: (0.5, 4), 51: (0.5, 2)},
}

DEFAULT_MASK_RATIOS = {
    "identity": 0.75, "quarter_head": 0.05, "quarter_tail": 0.05,
    "quarter_head_tail": 0.05, "interpolate": 0.05, "random": 0.05,
}


@dataclasses.dataclass
class TrainConfig:
    model: STDiT3Config = dataclasses.field(
        default_factory=lambda: STDiT3Config(dtype=torch.bfloat16))
    bucket_config: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_BUCKET_CONFIG))
    mask_ratios: Optional[dict] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_MASK_RATIOS))
    lr: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 1000
    grad_clip: Optional[float] = 1.0
    ema_decay: float = 0.99
    epochs: int = 1
    max_steps: Optional[int] = None
    seed: int = 42
    dataset_size: int = 64
    # activation recompute policy for the depth pairs: "full" | "dots" |
    # "none" (STDiT3's `remat_policy`); a planner may override it per bucket
    remat_policy: str = "full"
    ckpt_every: Optional[int] = None
    ckpt_dir: str = "./checkpoints"
    log_every: int = 10
    # caption dropout: trains y_embedder.y_embedding, the uncond branch of
    # classifier-free guidance
    class_dropout_prob: float = 0.1
    # experiment tracker: any callable(dict), called at every step with
    # step, loss, avg_loss (running mean) and lr (of the next update)
    tracker: Optional[Any] = None
    # cosine decay to lr * lr_min_ratio over lr_decay_steps after warmup
    # (None = warmup, then constant)
    lr_decay_steps: Optional[int] = None
    lr_min_ratio: float = 0.1


def latent_size(thw) -> tuple:
    """Latent (t, h, w) of a pixel (T, H, W): the Open-Sora VAE's factors
    (17 -> 5 frames, 8x in space)."""
    T, H, W = thw
    t_lat = max(1, T // 17 * 5) if T > 1 else 1
    return (t_lat, H // 8, W // 8)


def run_training(cfg: TrainConfig, dataset=None, text_embed_fn=None,
                 planner=None, device=None, params: Optional[dict] = None):
    """Train STDiT3 with the rflow loss over bucketized variable-length
    batches. Returns (train_state, ema_params, metrics_history).

    `dataset` exposes `shapes()` and `load_latents(indices, latent_thw,
    rng_seed=)` (default: `DummyVariableVideoTextDataset`); `text_embed_fn(
    indices) -> (y, kv_mask)` supplies caption features (default: random
    features of 8 tokens); `params` an initial state_dict of the model in
    this package's key names (random weights from `cfg.seed` otherwise).
    The model is built and trained on the card unless
    `device="cpu"` is passed; without a card and without `device` this
    raises. Every random draw (initial weights aside) comes from CPU
    generators seeded by `cfg.seed`, so a run draws the same captions,
    dropout flags, timesteps, noise and masks on every device."""
    device = resolve_device(device)
    cuda = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda), torch.device(device):
        torch.manual_seed(cfg.seed)
        model = STDiT3(cfg.model, remat=True, remat_policy=cfg.remat_policy,
                       compute_dtype=cfg.model.dtype)
    if params is not None:
        model.load_state_dict({
            k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in params.items()})
    model.to(device=device, dtype=torch.float32).train()
    scheduler = RFlowScheduler(RFlowConfig(
        use_timestep_transform=True, sample_method="logit-normal"))
    tx = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay,
                        cfg.warmup_steps, cfg.grad_clip,
                        decay_steps=cfg.lr_decay_steps,
                        lr_min_ratio=cfg.lr_min_ratio)

    if dataset is None:
        dataset = DummyVariableVideoTextDataset(size=cfg.dataset_size,
                                                seed=cfg.seed)
    bucket = Bucket(cfg.bucket_config)
    mask_gen = MaskGenerator(cfg.mask_ratios) if cfg.mask_ratios else None
    sampler = VariableVideoBatchSampler(
        bucket, dataset.shapes(), seed=cfg.seed, planner=planner)

    state = create_train_state(model, tx)
    ema_params = init_ema(model)
    generator = torch.Generator().manual_seed(cfg.seed)

    step_fns: dict = {}
    metrics_history = []
    global_step = 0
    loss_sum = 0.0

    def _build_batch(plan, lat_shape, step_seed):
        """gas micro-batches of distinct samples, stacked on a leading gas
        axis when gas > 1, on the training device."""
        micro_batches = plan.micro_batches()
        gas = len(micro_batches)
        t_lat = lat_shape[0]
        micros = []
        for k, micro_idx in enumerate(micro_batches):
            micro_seed = step_seed * gas + k
            x = torch.from_numpy(np.asarray(dataset.load_latents(
                micro_idx, lat_shape, rng_seed=micro_seed), np.float32))
            if text_embed_fn is not None:
                y, kv_mask = text_embed_fn(micro_idx)
                y = torch.as_tensor(np.asarray(y, np.float32))
                kv_mask = torch.as_tensor(np.asarray(kv_mask, bool))
            else:
                y = torch.randn(
                    len(micro_idx), 8, cfg.model.caption_channels,
                    generator=torch.Generator().manual_seed(
                        (cfg.seed << 20) + micro_seed))
                kv_mask = torch.ones(len(micro_idx), 8, dtype=torch.bool)
            mb = {"x": x, "y": y, "kv_mask": kv_mask,
                  "fps": torch.full((x.shape[0],), 24.0)}
            if mask_gen is not None and t_lat > 1:
                mb["mask"] = torch.from_numpy(mask_gen(
                    x.shape[0], t_lat, seed=cfg.seed + micro_seed))
            micros.append(mb)
        batch = micros[0] if gas == 1 else {
            k: torch.stack([mb[k] for mb in micros]) for k in micros[0]}
        return {k: v.to(device) for k, v in batch.items()}, gas

    def _log_and_ckpt(epoch, plan, metrics, seconds):
        nonlocal global_step, loss_sum
        global_step += 1
        logged = global_step % cfg.log_every == 0
        if logged or cfg.tracker is not None:
            loss = float(metrics["loss"])
        if cfg.tracker is not None:
            loss_sum += loss
            cfg.tracker({"step": global_step, "loss": loss,
                         "avg_loss": loss_sum / global_step, "lr": tx.lr})
        if logged:
            entry = {"step": global_step, "loss": loss,
                     "grad_norm": float(metrics["grad_norm"]),
                     "bucket": str(plan.bucket_id), "sp": plan.sp_size,
                     "thw": list(plan.thw), "gas": plan.gas,
                     "batch": len(plan.indices) // plan.gas,
                     "seconds": seconds}
            metrics_history.append(entry)
            logger.info("step %d bucket=%s loss=%.4f grad_norm=%.4f",
                        global_step, plan.bucket_id, loss, entry["grad_norm"])
        if cfg.ckpt_every and global_step % cfg.ckpt_every == 0:
            ckpt_io.save(cfg.ckpt_dir, state, ema_params, epoch, global_step,
                         sampler_state=sampler.state_dict(global_step))
        return bool(cfg.max_steps and global_step >= cfg.max_steps)

    for epoch in range(cfg.epochs):
        sampler.set_epoch(epoch)
        for plan in sampler:
            T, H, W = plan.thw
            gas = len(plan.micro_batches())
            key = (plan.bucket_id, gas)
            if key not in step_fns:
                pol = (planner.remat_policy(plan.bucket_id, cfg.remat_policy)
                       if planner is not None else cfg.remat_policy)
                step_fns[key] = (pol, make_train_step(
                    model, scheduler, tx, float(H), float(W),
                    num_frames=int(T), gas=gas,
                    class_dropout_prob=cfg.class_dropout_prob))
            model.remat_policy, fn = step_fns[key]
            t0 = time.perf_counter()
            batch, gas = _build_batch(plan, latent_size(plan.thw), global_step)
            state, metrics = fn(state, generator, batch)
            update_ema(ema_params, model, cfg.ema_decay)
            # the step's wall time is read only when it is logged (the loss
            # read synchronizes); otherwise steps are queued back to back
            if (global_step + 1) % cfg.log_every == 0:
                float(metrics["loss"])
            if _log_and_ckpt(epoch, plan, metrics, time.perf_counter() - t0):
                return state, ema_params, metrics_history
    return state, ema_params, metrics_history

"""Open-Sora training loop on one device, with DCP profiling.

Port of `videosys_tpu/training/train.py`: `run_training(TrainConfig)`
trains STDiT3 with the rflow loss over bucketized batches of pre-encoded,
synthetic or raw-video latents (raw clips through the VAE encoder): caption
dropout, frame masks, gradient accumulation, AdamW with warmup, cosine
decay and clipping, activation recompute, EMA and checkpoints. With
`dynamic_profile` the DCP profile phase (`core/dcp.py`) picks each bucket's
batch size, gradient accumulation and (`dynamic_recompute`) recompute
policy; `sp_balance` runs the packed-step loop. Parameters are held in fp32
and the model computes in `cfg.model.dtype` (bf16 by default).

`dp_size` x `sp_size` > 1 runs on that many ranks (the groups of
`ParallelConfig(dp, 1, sp)`): spawned as `VideoSysEngine` spawns its ranks
(`core/engine.py:run_training_ranks`), or joined where a default process
group exists (`parallel.set_distributed_state`, torchrun). The global batch
is the plan's batch x dp (the sampler's `batch_multiplier`, JAX train.py
:201): every rank runs the same sampler from the same seed, builds the
global batch and keeps its dp share; the sp ranks of a dp index train it
together (DSP), the optimizer is ZeRO-1 (train_step.py), or with `zero3`
ZeRO-3 (zero3.py: the parameters sharded too; the EMA is each rank's
slices, made whole before it is written or returned). Rank 0 logs and
writes checkpoints; every rank returns the same metrics history.

`dynamic_sp` (JAX train.py :134-136, :239-263): the dp_size x sp_size
ranks build a `parallel.GroupsPool`, one layout per power-of-two sp, and
each plan runs on the layout of the largest pool sp not above its own; the
sampler's batch multiplier stays dp_size, a rank's share of a plan's batch
and draws is taken under the plan's dp, and the gradient divisor is that
dp. The world axis, and so every ZeRO slice, is the same in each layout:
a switch moves no optimizer bytes. Each history entry carries the layout
it ran on ("mesh": (dp, 1, sp)). The DCP profile then tries each pool sp
as a whole step on that sp's groups (JAX's profile builds every sp
candidate as the same one-device step: ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Optional

import numpy as np
import torch

import torch.distributed as dist

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.dcp import Profiler
from videosys_tpu_torch.core.pipeline import resolve_device
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3, STDiT3Config
from videosys_tpu_torch.schedulers.rflow import RFlowConfig, RFlowScheduler
from videosys_tpu_torch.training import ckpt as ckpt_io
from videosys_tpu_torch.training.buckets import Bucket
from videosys_tpu_torch.training.datasets import (
    DummyVariableVideoTextDataset,
    MaskGenerator,
)
from videosys_tpu_torch.training.ema import init_ema, update_ema
from videosys_tpu_torch.training.sampler import (
    DCPPlanner,
    VariableVideoBatchSampler,
    pack_global_steps,
)
from videosys_tpu_torch.training.train_step import (
    _dp_share,
    create_train_state,
    make_apply_step,
    make_grad_step,
    make_optimizer,
    make_train_step,
)
from videosys_tpu_torch.training.zero3 import shard_model

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
    # dynamic sequence parallelism: each plan on the pool layout of its sp
    # (parallel.GroupsPool over the dp_size x sp_size ranks)
    dynamic_sp: bool = False
    # sp-balance: pack plans of differing sp into GlobalSteps (sampler.py
    # :576-871); each packed step accumulates gradients across its plans
    # and the optimizer updates once. On one device a packed step holds one
    # plan.
    sp_balance: bool = False
    # DCP profile phase: per bucket the largest batch that fits the card,
    # and gas to balance step times (core/dcp.py)
    dynamic_profile: bool = False
    # activation recompute policy for the depth pairs: "full" | "dots" |
    # "none" (STDiT3's `remat_policy`); with dynamic_recompute the profile
    # escalates none -> dots -> full per bucket and keeps the least
    # recompute that fits (the reference's dynamic_recompute,
    # core/dcp/profiler.py:584-622); a planner may override it per bucket
    remat_policy: str = "full"
    dynamic_recompute: bool = False
    ckpt_every: Optional[int] = None
    ckpt_dir: str = "./checkpoints"
    log_every: int = 10
    # ranks: data parallel x sequence parallel (DSP), ZeRO-1 over all
    dp_size: int = 1
    sp_size: int = 1
    # caption dropout: trains y_embedder.y_embedding, the uncond branch of
    # classifier-free guidance
    class_dropout_prob: float = 0.1
    # experiment tracker: set wandb_project to log loss/avg_loss/lr per step
    # through wandb (imported only then), or pass any callable(dict) as
    # `tracker`, called at every step with step, loss, avg_loss (running
    # mean) and lr (of the next update)
    wandb_project: Optional[str] = None
    tracker: Optional[Any] = None
    # ZeRO-3: the parameters sharded over every rank too (zero3.py); each
    # depth pair gathered for its forward, its gradient reduce-scattered
    zero3: bool = False
    # cosine decay to lr * lr_min_ratio over lr_decay_steps after warmup
    # (None = warmup, then constant)
    lr_decay_steps: Optional[int] = None
    lr_min_ratio: float = 0.1


def _check_config(cfg: TrainConfig) -> None:
    if cfg.zero3 and cfg.sp_balance:
        raise ValueError(
            "zero3 shards params per-mesh; sp_balance accumulates grads "
            "across pool meshes via the replicated pin — use one or the "
            "other")
    if cfg.dynamic_recompute and not cfg.dynamic_profile:
        raise ValueError(
            "dynamic_recompute picks the remat policy during the DCP "
            "profile phase; set dynamic_profile=True as well (or set a "
            "fixed remat_policy instead)")


def latent_size(thw) -> tuple:
    """Latent (t, h, w) of a pixel (T, H, W): the Open-Sora VAE's factors
    (17 -> 5 frames, 8x in space)."""
    T, H, W = thw
    t_lat = max(1, T // 17 * 5) if T > 1 else 1
    return (t_lat, H // 8, W // 8)




def encode_noise(seed: int, micro_seed: int, share=(0, 1)):
    """`noise(name, shape)` for the VAE encode of one raw-video micro-batch:
    standard normal draws, in the order the encode asks for them, from a
    CPU generator seeded by (seed, micro_seed). `share` (i, n): the encode
    is of share i of a batch n times as large (a dp rank's): each draw is
    made for the whole batch (dim 0 is batch-major) and share i kept."""
    gen = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, micro_seed]).generate_state(1)[0]))
    i, n = share

    def noise(name, shape):
        k = shape[0]
        return torch.randn((n * k,) + tuple(shape[1:]),
                           generator=gen)[i * k:(i + 1) * k]

    return noise


def _share(x, share):
    """Share i of n of `x` along dim 0."""
    i, n = share
    k = x.shape[0] // n
    return x[i * k:(i + 1) * k]


def _layout(groups: Optional[par.Groups]):
    """A history entry's "mesh": (dp, cp, sp) of the groups, None on one
    rank (JAX's mesh shape)."""
    if groups is None:
        return None
    c = groups.config
    return (c.dp_size, c.cp_size, c.sp_size)


def _rank_rows(global_rows: int, groups: Optional[par.Groups]) -> int:
    """A rank's rows of a global batch under the dp of `groups`."""
    dp = _dp_share(groups)[1]
    if global_rows % dp:
        raise ValueError(f"a global batch of {global_rows} does not split "
                         f"over the plan's dp of {dp} ({_layout(groups)})")
    return global_rows // dp


def _world_agree(peak: int, seconds: float, fits: bool):
    """Every rank's profile reading -> the world's: the largest peak and
    time, a fit only where every rank fitted (so that every rank takes the
    same next candidate)."""
    readings = [None] * dist.get_world_size()
    dist.all_gather_object(readings, (peak, seconds, fits))
    return (max(r[0] for r in readings), max(r[1] for r in readings),
            all(r[2] for r in readings))


def profile_buckets(cfg: TrainConfig, model: STDiT3, scheduler, bucket: Bucket,
                    lat_shape, masked: bool, device: torch.device,
                    groups: Optional[par.Groups] = None,
                    pool: Optional[par.GroupsPool] = None,
                    zero3=None) -> DCPPlanner:
    """The DCP profile phase (JAX train.py :170-195) over the run's own
    model: each candidate is a whole train step (forward, backward, clipped
    AdamW) on a zero batch of the bucket's shape, with the recompute policy
    switched on the model. It leaves no trace: the steps update a throwaway
    optimizer, whose moments are allocated before the first candidate so
    that every peak counts them as a real step's does; the weights are
    copied to the host before and back after; the run's optimizer, EMA and
    generators are never touched, and the global RNG is restored. Over
    ranks every rank profiles the same candidates (each a step of the
    whole world, ZeRO-1 included; `bs` is a dp rank's), the ranks agree on
    each build and each reading (the largest peak and time; a fit where all
    fit), a candidate that raises on a rank stops the world (`Profiler`),
    and the planner is rank 0's. With a `pool` (dynamic sp) the sp
    candidates are its sizes, each run on its own groups: the global batch
    (bs x dp_size, as the sampler makes it) split over that layout's dp, so
    that a bucket over the budget at sp 1 gets the smallest sp that fits.
    Under ZeRO-3 (`zero3`, the model's sharding) the steps are ZeRO-3's."""
    saved = {n: p.detach().to("cpu", copy=True)
             for n, p in model.named_parameters()}
    run_policy = model.remat_policy
    ptx = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay,
                         cfg.warmup_steps, cfg.grad_clip,
                         decay_steps=cfg.lr_decay_steps,
                         lr_min_ratio=cfg.lr_min_ratio, groups=groups,
                         zero3=zero3)
    for p in ptx.params:
        p.grad = torch.zeros_like(p)
    with par.use_groups(groups):
        ptx.update()  # allocates the moments
    pstate = create_train_state(model, ptx)
    pgen = torch.Generator().manual_seed(cfg.seed)
    mc = cfg.model

    def step_builder(thw, bs, sp, policy=cfg.remat_policy):
        T, H, W = thw
        t_lat, h, w = lat_shape(thw)
        g = pool.groups_for_sp(sp) if pool is not None else groups
        bs = _rank_rows(bs * cfg.dp_size, g)
        batch = {"x": torch.zeros(bs, mc.in_channels, t_lat, h, w, device=device),
                 "y": torch.zeros(bs, 8, mc.caption_channels, device=device),
                 "kv_mask": torch.ones(bs, 8, dtype=torch.bool, device=device),
                 "fps": torch.full((bs,), 24.0, device=device)}
        if masked and t_lat > 1:  # a frame mask runs the t0 branch
            batch["mask"] = torch.ones(bs, t_lat, dtype=torch.bool,
                                       device=device)
        step = make_train_step(model, scheduler, ptx, float(H), float(W),
                               num_frames=int(T),
                               class_dropout_prob=cfg.class_dropout_prob,
                               groups=g, zero3=cfg.zero3)

        def run():
            model.remat_policy = policy
            try:
                step(pstate, pgen, batch)
            finally:  # a step that failed part-way leaves gradients behind
                for p in model.parameters():
                    p.grad = None
        return run, ()

    cuda = [device] if device.type == "cuda" else []
    try:
        with torch.random.fork_rng(devices=cuda):
            profiler = Profiler(
                bucket, step_builder,
                sp_candidates=(tuple(pool.sp_sizes) if pool is not None
                               else (cfg.sp_size,)),
                remat_candidates=(("none", "dots", "full")
                                  if cfg.dynamic_recompute
                                  else (cfg.remat_policy,)),
                agree=_world_agree if groups is not None else None)
            profiler.profile_all()
    finally:
        ptx.opt.state.clear()
        model.remat_policy = run_policy
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved[n])
    if groups is None or groups.rank == 0:
        logger.info("DCP profile: %s", profiler.dump())
    return par.broadcast_from_rank0(profiler.make_planner(), groups)


def run_training(cfg: TrainConfig, dataset=None, text_embed_fn=None,
                 planner=None, device=None, params: Optional[dict] = None,
                 vae=None, vae_params: Optional[dict] = None,
                 groups: Optional[par.Groups] = None,
                 resume: Optional[str] = None, **rank_kwargs):
    """Train STDiT3 with the rflow loss over bucketized variable-length
    batches. Returns (train_state, ema_params, metrics_history).

    `dataset` exposes `shapes()` and `load_latents(indices, latent_thw,
    rng_seed=)` (default: `DummyVariableVideoTextDataset`), and may expose
    `prefetch(indices)`, called with a whole plan's rows before its first
    micro-batch; `text_embed_fn(indices) -> (y, kv_mask)` supplies caption
    features (default: random features of 8 tokens); `params` an initial
    state_dict of the model in this package's key names (random weights
    from `cfg.seed` otherwise); `planner` a DCP planner made elsewhere
    (`dynamic_profile` makes one).

    Raw-video mode: given a `vae` (an `OpenSoraVAE`, with `vae_params` its
    state_dict if not already loaded) and a dataset with `load_video(i,
    (T, H, W), seed=)`, each micro-batch is read, resize-cropped to the
    bucket shape and encoded to latents under no_grad in the VAE's dtype
    (JAX train.py :219-237), its noise from `encode_noise(cfg.seed,
    micro_seed)`; latent shapes come from `vae.get_latent_size`.

    The model is built and trained on the card unless `device="cpu"` is
    passed; without a card and without `device` this raises. Every random
    draw (initial weights aside) comes from CPU generators seeded by
    `cfg.seed`, so a run draws the same captions, dropout flags, timesteps,
    noise and masks on every device.

    Ranks (`dp_size` x `sp_size` > 1): with `groups` (this rank's, of
    `ParallelConfig(dp_size, 1, sp_size)`) the call is one rank's, on
    `groups.device`; without, and with a default process group, the groups
    are built over it; without either, the ranks are spawned
    (`run_training_ranks`, which takes `devices=`, `backend=` and
    `timeout=` in `rank_kwargs`; the other arguments go to every rank and
    must pickle) and rank 0's result is returned. `resume`: a checkpoint
    directory (`ckpt.save`, at any world size, under ZeRO-1 or ZeRO-3) to
    continue from: weights, moments, EMA, step, sampler and the draws'
    generator. Under ZeRO-3 the returned model and EMA are whole on every
    rank, as under ZeRO-1."""
    _check_config(cfg)
    world = par.ParallelConfig(cfg.dp_size, 1, cfg.sp_size)
    if world.world_size > 1 and groups is None:
        if not dist.is_initialized():
            from videosys_tpu_torch.core.engine import run_training_ranks

            return run_training_ranks(
                cfg, device=device, dataset=dataset,
                text_embed_fn=text_embed_fn, planner=planner, params=params,
                vae=vae, vae_params=vae_params, resume=resume, **rank_kwargs)
        groups = par.build_groups(world, device)
    if rank_kwargs:
        raise TypeError(f"unexpected arguments {sorted(rank_kwargs)}")
    if groups is not None:
        if groups.config != world:
            raise ValueError(f"groups of {groups.config} for {world}")
        device = groups.device
        if groups.world_size == 1:
            groups = None
    lead = groups is None or groups.rank == 0
    # dynamic sp: every layout of the ranks, built before the first step
    pool = par.GroupsPool(device) if cfg.dynamic_sp and groups is not None \
        else None
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

    if dataset is None:
        dataset = DummyVariableVideoTextDataset(size=cfg.dataset_size,
                                                seed=cfg.seed)
    bucket = Bucket(cfg.bucket_config)
    mask_gen = MaskGenerator(cfg.mask_ratios) if cfg.mask_ratios else None
    raw_video = vae is not None and hasattr(dataset, "load_video")
    if vae is not None:
        if vae_params is not None:
            vae.load_state_dict({
                k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                for k, v in vae_params.items()})
        vae.to(device).eval().requires_grad_(False)

    def lat_shape(thw) -> tuple:
        return tuple(vae.get_latent_size(thw)) if vae is not None \
            else latent_size(thw)

    zero3 = shard_model(model, groups) if cfg.zero3 else None
    ema_params = init_ema(model)  # held while the profile measures
    if cfg.dynamic_profile:
        planner = profile_buckets(cfg, model, scheduler, bucket, lat_shape,
                                  mask_gen is not None, device, groups, pool,
                                  zero3)
    # after the profile: under ZeRO-1 the optimizer makes the parameters
    # views into its flat buffer
    tx = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay,
                        cfg.warmup_steps, cfg.grad_clip,
                        decay_steps=cfg.lr_decay_steps,
                        lr_min_ratio=cfg.lr_min_ratio, groups=groups,
                        zero3=zero3)
    state = create_train_state(model, tx)
    sampler = VariableVideoBatchSampler(
        bucket, dataset.shapes(), batch_multiplier=cfg.dp_size,
        seed=cfg.seed, planner=planner)
    generator = torch.Generator().manual_seed(cfg.seed)

    metrics_history = []
    global_step = 0
    first_epoch = 0
    loss_sum = 0.0
    if resume is not None:
        state, ema, first_epoch, global_step, sampler_state = ckpt_io.load(
            resume, state, generator)
        ema_params = {k: v.to(device) for k, v in ema.items()}
        if sampler_state is not None:
            sampler.load_state_dict(sampler_state)

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _plan_groups(plan) -> Optional[par.Groups]:
        """The groups a plan runs on: its pool layout under dynamic sp."""
        return pool.groups_for_plan(plan.sp_size) if pool is not None \
            else groups

    def _load_micro_x(micro_idx, thw, lat, micro_seed, g):
        """Latents of one micro-batch: pre-encoded or synthetic (the global
        batch's), or raw clips of this rank's dp share (under `g`) through
        the VAE encoder (split over the sp ranks)."""
        if not raw_video:
            return torch.from_numpy(np.asarray(dataset.load_latents(
                micro_idx, lat, rng_seed=micro_seed), np.float32))
        share = _dp_share(g)
        clips = np.stack([dataset.load_video(int(i), thw, seed=micro_seed)
                          for i in _share(np.asarray(micro_idx), share)])
        with par.use_groups(g):
            return vae.encode(torch.from_numpy(clips).to(device),
                              encode_noise(cfg.seed, micro_seed, share)
                              ).float()

    def _build_batch(plan, step_seed, g):
        """gas micro-batches of distinct samples, stacked on a leading gas
        axis when gas > 1, on the training device: over ranks, this rank's
        dp share (under the plan's groups `g`) of the global batch."""
        micro_batches = plan.micro_batches()
        if hasattr(dataset, "prefetch"):
            # queue the whole plan's reads so that later micro-batches
            # stream in while earlier ones are encoded and stepped
            dataset.prefetch([int(i) for mb in micro_batches for i in mb])
        gas = len(micro_batches)
        lat = lat_shape(plan.thw)
        dp_share = _dp_share(g)
        micros = []
        for k, micro_idx in enumerate(micro_batches):
            _rank_rows(len(micro_idx), g)
            micro_seed = step_seed * gas + k
            x = _load_micro_x(micro_idx, plan.thw, lat, micro_seed, g)
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
            n = len(micro_idx)
            mb = {"y": y, "kv_mask": kv_mask, "fps": torch.full((n,), 24.0)}
            if mask_gen is not None and lat[0] > 1:
                mb["mask"] = torch.from_numpy(mask_gen(
                    n, lat[0], seed=cfg.seed + micro_seed))
            mb = {k: _share(v, dp_share) for k, v in mb.items()}
            mb["x"] = x if raw_video else _share(x, dp_share)
            micros.append({k: v.to(device) for k, v in mb.items()})
        batch = micros[0] if gas == 1 else {
            k: torch.stack([mb[k] for mb in micros]) for k in micros[0]}
        return batch, gas

    # experiment tracker (reference wandb per-step loss/avg_loss/lr,
    # train.py:390-401)
    tracker = cfg.tracker if lead else None
    if tracker is None and cfg.wandb_project and lead:
        try:
            import wandb

            wandb.init(project=cfg.wandb_project)
            tracker = lambda rec: wandb.log(rec, step=rec["step"])  # noqa: E731
        except Exception as e:  # not installed, or offline
            logger.warning("wandb tracker disabled: %s", e)

    def _policy(plan) -> str:
        return (planner.remat_policy(plan.bucket_id, cfg.remat_policy)
                if planner is not None else cfg.remat_policy)

    def _finish():
        """(train_state, ema, history); under ZeRO-3 the model and the EMA
        made whole on every rank first."""
        if zero3 is None:
            return state, ema_params, metrics_history
        ema = zero3.gather_dict(ema_params)
        zero3.unshard()
        return state, ema, metrics_history

    def _log_and_ckpt(epoch, plan, metrics, seconds, extra):
        nonlocal global_step, loss_sum
        global_step += 1
        logged = global_step % cfg.log_every == 0
        if logged and groups is not None:
            # one history on every rank: rank 0's clocks
            seconds, extra = par.broadcast_from_rank0((seconds, extra),
                                                      groups)
        if logged or tracker is not None:
            loss = float(metrics["loss"])
        if tracker is not None:
            loss_sum += loss
            tracker({"step": global_step, "loss": loss,
                     "avg_loss": loss_sum / global_step, "lr": tx.lr})
        if logged:
            entry = {"step": global_step, "loss": loss,
                     "grad_norm": float(metrics["grad_norm"]),
                     "bucket": str(plan.bucket_id), "sp": plan.sp_size,
                     "thw": list(plan.thw), "gas": plan.gas,
                     "batch": len(plan.indices) // plan.gas,
                     "remat_policy": _policy(plan), "seconds": seconds,
                     **extra}
            metrics_history.append(entry)
            if lead:
                logger.info("step %d bucket=%s loss=%.4f grad_norm=%.4f",
                            global_step, plan.bucket_id, loss,
                            entry["grad_norm"])
        if cfg.ckpt_every and global_step % cfg.ckpt_every == 0:
            ckpt_io.save(cfg.ckpt_dir, state, ema_params, epoch, global_step,
                         sampler_state=sampler.state_dict(global_step),
                         generator=generator)
        return bool(cfg.max_steps and global_step >= cfg.max_steps)

    def _timed_batch(plan, step_seed, logged, g):
        """The plan's batch, and the seconds its reads (and encodes) took:
        measured, with the device waited for, on logged steps only."""
        t0 = time.perf_counter()
        batch, gas = _build_batch(plan, step_seed, g)
        if logged:
            _sync()
        return batch, gas, time.perf_counter() - t0

    if cfg.sp_balance:
        # packed steps (JAX train.py :352-430): gradients accumulate over
        # the plans of a GlobalStep, then one update; one device holds one
        # plan a step
        grad_fns: dict = {}
        apply_fn = make_apply_step(tx)
        profile = planner.profile if planner is not None else None
        for epoch in range(first_epoch, cfg.epochs):
            sampler.set_epoch(epoch)
            for gstep in pack_global_steps(list(sampler), world.world_size,
                                           profile):
                t0 = time.perf_counter()
                logged = (global_step + 1) % cfg.log_every == 0
                grads_acc, losses, data_s = None, [], 0.0
                for plan in gstep.plans:
                    T, H, W = plan.thw
                    g = _plan_groups(plan)
                    key = (plan.bucket_id, _layout(g))
                    if key not in grad_fns:
                        grad_fns[key] = (_policy(plan), make_grad_step(
                            model, scheduler, float(H), float(W),
                            num_frames=int(T),
                            class_dropout_prob=cfg.class_dropout_prob,
                            groups=g))
                    model.remat_policy, gfn = grad_fns[key]
                    batch, gas, seconds = _timed_batch(
                        plan, global_step + len(losses), logged, g)
                    data_s += seconds
                    micros = [batch] if gas == 1 else [
                        {k: v[i] for k, v in batch.items()} for i in range(gas)]
                    for mb in micros:
                        loss, grads = gfn(generator, mb)
                        # each plan's sums divided by its own layout's dp
                        torch._foreach_div_(list(grads.values()), _dp_share(g)[1])
                        losses.append(loss)
                        if grads_acc is None:
                            grads_acc = grads
                        else:
                            torch._foreach_add_(list(grads_acc.values()),
                                                [grads[k] for k in grads_acc])
                state, metrics = apply_fn(state, grads_acc, len(losses), dp=1)
                metrics["loss"] = torch.stack(losses).mean()
                update_ema(ema_params, model, cfg.ema_decay)
                if logged:
                    float(metrics["loss"])
                if _log_and_ckpt(epoch, gstep.plans[0], metrics,
                                 time.perf_counter() - t0,
                                 {"data_seconds": data_s,
                                  "packed_plans": len(gstep.plans),
                                  "imbalance": gstep.imbalance,
                                  "mesh": "sp_balance",
                                  "meshes": [_layout(_plan_groups(p))
                                             for p in gstep.plans]}):
                    return _finish()
        return _finish()

    step_fns: dict = {}
    for epoch in range(first_epoch, cfg.epochs):
        sampler.set_epoch(epoch)
        for plan in sampler:
            T, H, W = plan.thw
            gas = len(plan.micro_batches())
            g = _plan_groups(plan)
            key = (plan.bucket_id, gas, _layout(g))
            if key not in step_fns:
                step_fns[key] = (_policy(plan), make_train_step(
                    model, scheduler, tx, float(H), float(W),
                    num_frames=int(T), gas=gas,
                    class_dropout_prob=cfg.class_dropout_prob,
                    groups=g, zero3=cfg.zero3))
            model.remat_policy, fn = step_fns[key]
            t0 = time.perf_counter()
            # the step's wall time is read only when it is logged (the loss
            # read synchronizes); otherwise steps are queued back to back
            logged = (global_step + 1) % cfg.log_every == 0
            batch, gas, data_s = _timed_batch(plan, global_step, logged, g)
            state, metrics = fn(state, generator, batch)
            update_ema(ema_params, model, cfg.ema_decay)
            if logged:
                float(metrics["loss"])
            if _log_and_ckpt(epoch, plan, metrics, time.perf_counter() - t0,
                             {"data_seconds": data_s, "mesh": _layout(g)}):
                return _finish()
    return _finish()

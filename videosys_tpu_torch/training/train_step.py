"""Training step: rflow loss with caption dropout, gradient accumulation,
global-norm clipping and AdamW with warmup and cosine decay, on one device.

Port of `videosys_tpu/training/train_step.py` without its sharding rules
(ZeRO-1/3 belong to the multi-device slice). optax's chain is spelled out:
`ClippedAdamW` scales the gradients by clip / max(norm, clip), reads the
learning-rate schedule at the number of updates already made (so the first
update has lr 0 under warmup) and applies `torch.optim.AdamW`, whose decay
(p <- p - lr * wd * p) and eps (outside the square root, after the bias
correction) sit where optax's `adamw` puts them. Parameters and gradients
are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from videosys_tpu_torch.schedulers.rflow import RFlowScheduler


def lr_schedule(lr: float, warmup_steps: int, decay_steps: Optional[int] = None,
                lr_min_ratio: float = 0.1) -> Callable[[int], float]:
    """count -> learning rate: linear warmup from 0 to `lr` over
    `warmup_steps`, then constant, or with `decay_steps` a cosine from `lr`
    down to `lr * lr_min_ratio` reached at `decay_steps` (optax's
    `linear_schedule` and `warmup_cosine_decay_schedule`)."""
    total = max(decay_steps, warmup_steps + 1) if decay_steps else None

    def schedule(count: int) -> float:
        if count < warmup_steps or not total:
            return lr * min(count, warmup_steps) / max(warmup_steps, 1) \
                if warmup_steps else lr
        span = total - warmup_steps
        frac = min(count - warmup_steps, span) / span
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr * ((1.0 - lr_min_ratio) * cosine + lr_min_ratio)

    return schedule


class ClippedAdamW:
    """Global-norm clipping, then AdamW (b1 0.9, b2 0.999, eps 1e-8) at the
    scheduled learning rate. `update()` consumes the `.grad` of its
    parameters and returns the gradient norm before clipping."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)

    @property
    def lr(self) -> float:
        """Learning rate of the next update."""
        return self.schedule(self.count)

    def update(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)).float())
        if self.grad_clip:
            scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
            torch._foreach_mul_(grads, scale)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0,
                   warmup_steps: int = 1000, grad_clip: Optional[float] = None,
                   decay_steps: Optional[int] = None,
                   lr_min_ratio: float = 0.1) -> ClippedAdamW:
    """AdamW over `params` (a module's parameters) with linear warmup, an
    optional cosine decay and global-norm clipping."""
    return ClippedAdamW(params,
                        lr_schedule(lr, warmup_steps, decay_steps, lr_min_ratio),
                        weight_decay=weight_decay, grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    tx: ClippedAdamW
    step: int = 0


def create_train_state(model: nn.Module, tx: ClippedAdamW) -> TrainState:
    return TrainState(model=model, tx=tx, step=0)


def _make_loss_fn(model, scheduler: RFlowScheduler, height: float,
                  width: float, num_frames, class_dropout_prob: float):
    """rflow loss with caption dropout: with probability
    `class_dropout_prob` a sample's caption rows are replaced by the learned
    null embedding, which trains `y_embedder.y_embedding` (the uncond branch
    of classifier-free guidance). `loss_fn(batch, generator)` draws the drop
    flags, the timesteps and the noise from `generator`, in that order, on
    the generator's device; `drop=`, `t=` and `noise=` replace the draws."""

    def loss_fn(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                drop=None, t=None, noise=None):
        y = batch["y"]
        if class_dropout_prob > 0:
            if drop is None:
                gdev = generator.device if generator is not None else y.device
                drop = torch.rand(y.shape[0], generator=generator,
                                  device=gdev) < class_dropout_prob
            y_null = model.y_embedder.y_embedding[: y.shape[1]].to(y.dtype)
            y = torch.where(drop.to(y.device)[:, None, None], y_null[None], y)

        def model_fn(x_t, t_):
            return model(x_t, t_, y, kv_mask=batch.get("kv_mask"),
                         x_mask=batch.get("mask"), fps=batch["fps"],
                         height=height, width=width)

        losses = scheduler.training_losses(
            model_fn, batch["x"], mask=batch.get("mask"), t=t, noise=noise,
            height=height, width=width, num_frames=num_frames,
            generator=generator)
        return losses.mean()

    return loss_fn


def make_train_step(model, scheduler: RFlowScheduler, tx: ClippedAdamW,
                    height: float, width: float,
                    num_frames: Optional[int] = None, gas: int = 1,
                    class_dropout_prob: float = 0.1):
    """Returns `train_step(state, generator, batch) -> (state, metrics)`.

    batch: dict(x [B,C,T,H,W] latents, y [B,L,Dc], kv_mask [B,L], fps [B],
    optional mask [B,T]). With `gas > 1` every batch tensor carries a
    leading gradient-accumulation axis [gas, B, ...]: the gradients of the
    micro-batches are averaged and the optimizer steps once. `num_frames`
    is the bucket's pixel frame count (for the timestep warp). metrics:
    loss, and grad_norm as it was before clipping, both tensors. Keyword
    draws (`drop`, `t`, `noise`; with a leading gas axis when gas > 1)
    replace the generator's."""
    loss_fn = _make_loss_fn(model, scheduler, height, width, num_frames,
                            class_dropout_prob)

    def train_step(state: TrainState, generator, batch, **draws):
        if gas == 1:
            loss = loss_fn(batch, generator, **draws)
            loss.backward()
            loss = loss.detach()
        else:
            losses = []
            for i in range(gas):
                micro = {k: v[i] for k, v in batch.items()}
                micro_draws = {k: v[i] for k, v in draws.items()}
                li = loss_fn(micro, generator, **micro_draws)
                (li / gas).backward()  # .grad accumulates the mean
                losses.append(li.detach())
            loss = torch.stack(losses).mean()
        gnorm = tx.update()
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_grad_step(model, scheduler: RFlowScheduler, height: float,
                   width: float, num_frames: int,
                   class_dropout_prob: float = 0.1):
    """`grad_step(generator, batch) -> (loss, grads)`: the gradient half of
    a step, for callers that accumulate over several plans before one
    update. grads: {parameter name: tensor}; `.grad` is left untouched."""
    loss_fn = _make_loss_fn(model, scheduler, height, width, num_frames,
                            class_dropout_prob)

    def grad_step(generator, batch, **draws):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        loss = loss_fn(batch, generator, **draws)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        return loss.detach(), {n: g if g is not None else torch.zeros_like(p)
                               for (n, p), g in zip(named, grads)}

    return grad_step


def make_apply_step(tx: ClippedAdamW):
    """`apply_step(state, grads, n_plans) -> (state, metrics)`: one update
    from gradients summed over `n_plans` evaluations."""

    def apply_step(state: TrainState, grads: Dict[str, torch.Tensor],
                   n_plans):
        for name, p in state.model.named_parameters():
            if name in grads:
                p.grad = grads[name] / n_plans
        gnorm = tx.update()
        state.step += 1
        return state, {"grad_norm": gnorm}

    return apply_step

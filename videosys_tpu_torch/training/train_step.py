"""Training step: rflow loss with caption dropout, gradient accumulation,
global-norm clipping and AdamW with warmup and cosine decay, on one device
or over ranks (dp, sp) with ZeRO-1 or ZeRO-3.

Port of `videosys_tpu/training/train_step.py`. optax's chain is spelled
out: `ClippedAdamW` scales the gradients by clip / max(norm, clip), reads
the learning-rate schedule at the number of updates already made (so the
first update has lr 0 under warmup) and applies `torch.optim.AdamW`, whose
decay (p <- p - lr * wd * p) and eps (outside the square root, after the
bias correction) sit where optax's `adamw` puts them. Parameters and
gradients are updated in place.

Over ranks (`groups=`, `parallel.build_groups` of ParallelConfig(dp, 1,
sp)): each rank runs its dp share of the global batch, its sp ranks
together through STDiT3's DSP (the collectives carry gradients, also inside
recompute; the step runs under `use_groups`). The draws are made for the
global batch from the same generator on every rank and each rank keeps its
dp share, so the sp ranks of a dp index draw the same, and the whole is
what one rank draws for the global batch. ZeRO-1 (JAX `zero1_shardings`,
which shards the moments over every device): the trainable parameters and
their gradients live in one flat fp32 buffer each (the parameters and
`.grad` are views into them), padded to a multiple of the world size N;
each rank keeps the AdamW moments of its 1/N slice. An update
reduce-scatters the gradients (the sum over every rank, divided by dp: the
sum over sp of the shares, averaged over dp), clips by the global norm (an
all-reduce of the squared norm), steps its slice and all-gathers the
parameters. The reported loss is the dp mean, the global batch's. The
divisor is the dp of the step's groups (`use_groups`, or `update(dp=)`):
under dynamic sp (`parallel.GroupsPool`) a plan's layout sets it, while
the world axis, and so every slice, stays the same.

ZeRO-3 (`make_optimizer(zero3=)`, a `training/zero3.py` sharding of the
model): the optimizer steps the model's parameters as they are then, the
whole small leaves and this rank's slices. The slices' gradients arrive
reduce-scattered by the backward (the sum over every rank); the small
leaves' are all-reduced in one flat buffer; both are divided by dp, clipped
by the global norm (an all-reduce of the slices' squared norms, the whole
leaves counted once) and stepped locally; nothing is gathered afterwards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from videosys_tpu_torch.core import parallel as par
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
    parameters and returns the gradient norm before clipping. With `groups`
    of more than one rank it is ZeRO-1 (see the module's doc): the same
    update, with each rank holding the moments of its slice only."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None,
                 groups: Optional[par.Groups] = None, zero3=None):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.groups = groups if groups is not None and \
            groups.world_size > 1 else None
        self.zero3 = zero3 if self.groups is not None else None
        adamw = dict(lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                     weight_decay=weight_decay)
        if self.groups is None or self.zero3 is not None:
            self.opt = torch.optim.AdamW(self.params, **adamw)
            if self.zero3 is not None:
                slices = {id(s) for s in self.zero3.slices}
                self.small = [p for p in self.params if id(p) not in slices]
            return
        n = self.groups.world_size
        total = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.flat = torch.zeros(-(-total // n) * n, dtype=torch.float32,
                                device=dev)
        self.flat_grad = torch.zeros_like(self.flat)
        self.views, off = [], 0
        for p in self.params:
            k = p.numel()
            self.views.append((self.flat[off:off + k].view_as(p),
                               self.flat_grad[off:off + k].view_as(p)))
            off += k
        self._bind()
        slice_len = self.flat.numel() // n
        r = self.groups.rank
        # a view: the update steps this rank's slice of the parameters
        self.shard = nn.Parameter(self.flat[r * slice_len:(r + 1) * slice_len])
        self.opt = torch.optim.AdamW([self.shard], **adamw)

    def _bind(self) -> None:
        """Make each parameter and its `.grad` views into the flat buffers
        (again, where something re-bound them: a gradient assigned, a
        parameter's data replaced), carrying their values over."""
        with torch.no_grad():
            for p, (pv, gv) in zip(self.params, self.views):
                if p.data_ptr() != pv.data_ptr():
                    pv.copy_(p.detach())
                    p.data = pv
                if p.grad is None:
                    gv.zero_()
                elif p.grad.data_ptr() != gv.data_ptr():
                    gv.copy_(p.grad)
                if p.grad is None or p.grad.data_ptr() != gv.data_ptr():
                    p.grad = gv

    @property
    def lr(self) -> float:
        """Learning rate of the next update."""
        return self.schedule(self.count)

    @property
    def moment_bytes(self) -> int:
        """Bytes of the AdamW moments this rank holds."""
        return sum(v.numel() * v.element_size()
                   for st in self.opt.state.values() for k, v in st.items()
                   if k in ("exp_avg", "exp_avg_sq"))

    def update(self, dp: Optional[int] = None) -> torch.Tensor:
        """One step; `dp` divides the ranks' summed gradients (default: the
        dp of the groups in force, the step's, else the optimizer's)."""
        if self.groups is not None:
            if dp is None:
                ax = (par.active_groups() or self.groups).axis(par.DP_AXIS)
                dp = 1 if ax is None else ax.size
            if self.zero3 is not None:
                return self._update_zero3(dp)
            return self._update_zero1(dp)
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

    @torch.no_grad()
    def _update_zero1(self, dp: int) -> torch.Tensor:
        self._bind()
        world = self.groups.axis(par.WORLD_AXIS)
        g = par.reduce_scatter_flat(self.flat_grad, world)  # a new buffer
        if dp > 1:
            g.div_(dp)
        norm = par.all_reduce(torch.linalg.vector_norm(g).square(),
                              world).sqrt()
        if self.grad_clip:
            g.mul_(self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        self.shard.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.shard.grad = None
        par.all_gather_flat(self.shard.detach().clone(), out=self.flat,
                            group=world)
        self.flat_grad.zero_()
        self.count += 1
        return norm

    @torch.no_grad()
    def _update_zero3(self, dp: int) -> torch.Tensor:
        world = self.groups.axis(par.WORLD_AXIS)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.small:  # this rank's shares of the whole leaves, summed
            flat = par.all_reduce_flat(
                torch.cat([p.grad.reshape(-1) for p in self.small]), world)
            torch._foreach_copy_(
                [p.grad for p in self.small],
                [f.view_as(p) for f, p in zip(
                    flat.split([p.numel() for p in self.small]), self.small)])
        grads = [p.grad for p in self.params]
        if dp > 1:
            torch._foreach_div_(grads, dp)

        def sq(ts):
            return torch.stack(torch._foreach_norm(ts)).square().sum() if ts \
                else torch.zeros((), device=self.params[0].device)

        slices = sq([s.grad for s in self.zero3.slices]).reshape(1)
        norm = (par.all_reduce_flat(slices, world)[0]
                + sq([p.grad for p in self.small])).sqrt()
        if self.grad_clip:
            torch._foreach_mul_(grads, self.grad_clip
                                / torch.clamp(norm, min=self.grad_clip))
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def _zero3_state_dict(self) -> dict:
        """The world-1 layout of the moments under ZeRO-3: the slices'
        gathered and cut into their leaves, by the whole model's order."""
        z3 = self.zero3
        opt = self.opt.state_dict()
        names = dict(z3.model.named_parameters())
        state = {}
        first = next(iter(self.opt.state.values()), None)
        if first is not None:
            moments = {}
            for k in ("exp_avg", "exp_avg_sq"):
                local = {n: self.opt.state[p][k] for n, p in names.items()}
                moments[k] = z3.gather_dict(local)
            for i, name in enumerate(z3.names):
                state[i] = {"step": first["step"].clone(),
                            **{k: moments[k][name] for k in moments}}
        groups = [dict(g, params=list(range(len(z3.names))))
                  for g in opt["param_groups"]]
        return {"opt": {"state": state, "param_groups": groups},
                "count": self.count}

    def _zero3_load_state_dict(self, state: dict) -> None:
        z3 = self.zero3
        opt = state["opt"]
        names = dict(z3.model.named_parameters())
        order = list(names)
        groups = [dict(g, params=list(range(len(order))))
                  for g in opt["param_groups"]]
        local_state = {}
        if opt["state"]:
            step = opt["state"][0]["step"]
            by_name = {k: {name: opt["state"][i][k]
                           for i, name in enumerate(z3.names)}
                       for k in ("exp_avg", "exp_avg_sq")}
            local = {k: z3.shard_dict(v) for k, v in by_name.items()}
            for j, name in enumerate(order):
                local_state[j] = {"step": step, **{
                    k: local[k][name].to(names[name].device)
                    for k in local}}
        self.opt.load_state_dict({"state": local_state,
                                  "param_groups": groups})

    def state_dict(self) -> dict:
        """The world-1 layout under ZeRO-1 and ZeRO-3 too (the moments
        gathered from every rank: a collective, every rank calls it)."""
        if self.zero3 is not None:
            return self._zero3_state_dict()
        if self.groups is None:
            return {"opt": self.opt.state_dict(), "count": self.count}
        opt = self.opt.state_dict()
        groups = [dict(g, params=list(range(len(self.params))))
                  for g in opt["param_groups"]]
        state = {}
        st = self.opt.state.get(self.shard)
        if st:
            world = self.groups.axis(par.WORLD_AXIS)
            whole = {k: par.all_gather_flat(st[k].contiguous(), group=world)
                     for k in ("exp_avg", "exp_avg_sq")}
            off = 0
            for i, p in enumerate(self.params):
                k = p.numel()
                state[i] = {"step": st["step"].clone(),
                            **{n: v[off:off + k].view_as(p).clone()
                               for n, v in whole.items()}}
                off += k
        return {"opt": {"state": state, "param_groups": groups},
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Loads the world-1 layout; under ZeRO-1 and ZeRO-3 each rank keeps
        its slice of the moments."""
        self.count = int(state["count"])
        if self.zero3 is not None:
            self._zero3_load_state_dict(state)
            return
        if self.groups is None:
            self.opt.load_state_dict(state["opt"])
            return
        opt = state["opt"]
        groups = [dict(g, params=[0]) for g in opt["param_groups"]]
        shard_state = {}
        if opt["state"]:
            n, r = self.groups.world_size, self.groups.rank
            slice_len = self.flat.numel() // n
            first = opt["state"][0]
            shard_state[0] = {"step": first["step"]}
            for k in ("exp_avg", "exp_avg_sq"):
                whole = torch.zeros_like(self.flat)
                off = 0
                for i, p in enumerate(self.params):
                    whole[off:off + p.numel()] = \
                        opt["state"][i][k].reshape(-1).to(whole.device)
                    off += p.numel()
                shard_state[0][k] = whole[r * slice_len:(r + 1) * slice_len]
        self.opt.load_state_dict({"state": shard_state,
                                  "param_groups": groups})


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0,
                   warmup_steps: int = 1000, grad_clip: Optional[float] = None,
                   decay_steps: Optional[int] = None,
                   lr_min_ratio: float = 0.1,
                   groups: Optional[par.Groups] = None,
                   zero3=None) -> ClippedAdamW:
    """AdamW over `params` (a module's parameters) with linear warmup, an
    optional cosine decay and global-norm clipping; ZeRO-1 over `groups`,
    or ZeRO-3 with `zero3` (the `training/zero3.py` sharding of the model
    whose parameters `params` are)."""
    return ClippedAdamW(params,
                        lr_schedule(lr, warmup_steps, decay_steps, lr_min_ratio),
                        weight_decay=weight_decay, grad_clip=grad_clip,
                        groups=groups, zero3=zero3)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    tx: ClippedAdamW
    step: int = 0


def create_train_state(model: nn.Module, tx: ClippedAdamW) -> TrainState:
    return TrainState(model=model, tx=tx, step=0)


def _dp_share(groups: Optional[par.Groups]):
    """(this rank's dp index, dp size)."""
    ax = None if groups is None else groups.axis(par.DP_AXIS)
    return (0, 1) if ax is None else (ax.rank, ax.size)


def _make_loss_fn(model, scheduler: RFlowScheduler, height: float,
                  width: float, num_frames, class_dropout_prob: float,
                  groups: Optional[par.Groups] = None):
    """rflow loss with caption dropout: with probability
    `class_dropout_prob` a sample's caption rows are replaced by the learned
    null embedding, which trains `y_embedder.y_embedding` (the uncond branch
    of classifier-free guidance). `loss_fn(batch, generator)` draws the drop
    flags, the timesteps and the noise from `generator`, in that order, on
    the generator's device; `drop=`, `t=` and `noise=` replace the draws.
    Under `groups` the batch and given draws are this rank's dp share; the
    generator draws the global batch's and keeps the share."""
    share = _dp_share(groups)

    def loss_fn(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                drop=None, t=None, noise=None):
        # under ZeRO-3 the rest of the model (the null caption among it) is
        # gathered once for the whole loss
        with model.unit_params(model.config.depth):
            return _loss(batch, generator, drop, t, noise)

    def _loss(batch, generator, drop, t, noise):
        y = batch["y"]
        if class_dropout_prob > 0:
            if drop is None:
                gdev = generator.device if generator is not None else y.device
                i, n = share
                B = y.shape[0]
                drop = torch.rand(n * B, generator=generator, device=gdev
                                  )[i * B:(i + 1) * B] < class_dropout_prob
            y_null = model.y_embedder.y_embedding[: y.shape[1]].to(y.dtype)
            y = torch.where(drop.to(y.device)[:, None, None], y_null[None], y)

        def model_fn(x_t, t_):
            return model(x_t, t_, y, kv_mask=batch.get("kv_mask"),
                         x_mask=batch.get("mask"), fps=batch["fps"],
                         height=height, width=width)

        losses = scheduler.training_losses(
            model_fn, batch["x"], mask=batch.get("mask"), t=t, noise=noise,
            height=height, width=width, num_frames=num_frames,
            generator=generator, share=share)
        return losses.mean()

    return loss_fn


def _dp_mean(loss: torch.Tensor) -> torch.Tensor:
    """The loss of the global batch: the mean of the dp ranks' (each sp
    rank of a dp index holds the same)."""
    return par.all_reduce(loss, par.DP_AXIS, "mean")


def _check_zero3(zero3: bool, model, groups: Optional[par.Groups]) -> None:
    """`zero3` must say whether the model is sharded (ZeRO-3 shards nothing
    at one rank)."""
    sharded = getattr(model, "zero3", None) is not None
    over_ranks = groups is not None and groups.world_size > 1
    if sharded != (zero3 and over_ranks):
        raise ValueError(
            f"zero3={zero3} over {groups.world_size if over_ranks else 1} "
            f"rank(s), but the model is {'' if sharded else 'not '}sharded "
            f"(training/zero3.py shard_model)")


def make_train_step(model, scheduler: RFlowScheduler, tx: ClippedAdamW,
                    height: float, width: float,
                    num_frames: Optional[int] = None, gas: int = 1,
                    class_dropout_prob: float = 0.1,
                    groups: Optional[par.Groups] = None, zero3: bool = False):
    """Returns `train_step(state, generator, batch) -> (state, metrics)`.

    batch: dict(x [B,C,T,H,W] latents, y [B,L,Dc], kv_mask [B,L], fps [B],
    optional mask [B,T]). With `gas > 1` every batch tensor carries a
    leading gradient-accumulation axis [gas, B, ...]: the gradients of the
    micro-batches are averaged and the optimizer steps once. `num_frames`
    is the bucket's pixel frame count (for the timestep warp). metrics:
    loss, and grad_norm as it was before clipping, both tensors. Keyword
    draws (`drop`, `t`, `noise`; with a leading gas axis when gas > 1)
    replace the generator's. `groups`: this rank's (dp, sp) groups; the
    batch and the draws are its dp share, the metrics the global batch's.
    `zero3`: the model's parameters are sharded (`training/zero3.py`) and
    `tx` steps the slices (JAX `make_train_step(zero3=True)`)."""
    _check_zero3(zero3, model, groups)
    loss_fn = _make_loss_fn(model, scheduler, height, width, num_frames,
                            class_dropout_prob, groups)

    def train_step(state: TrainState, generator, batch, **draws):
        with par.use_groups(groups):
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
            gnorm = tx.update()  # divided by the dp of `groups`
            loss = _dp_mean(loss)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_grad_step(model, scheduler: RFlowScheduler, height: float,
                   width: float, num_frames: int,
                   class_dropout_prob: float = 0.1,
                   groups: Optional[par.Groups] = None, zero3: bool = False):
    """`grad_step(generator, batch) -> (loss, grads)`: the gradient half of
    a step, for callers that accumulate over several plans before one
    update. grads: {parameter name: tensor} (under `groups` this rank's
    share, which the update reduces; under ZeRO-3 the slices' already
    summed over the ranks); the loss the global batch's; `.grad` is left
    untouched."""
    _check_zero3(zero3, model, groups)
    loss_fn = _make_loss_fn(model, scheduler, height, width, num_frames,
                            class_dropout_prob, groups)

    def grad_step(generator, batch, **draws):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        with par.use_groups(groups):
            loss = loss_fn(batch, generator, **draws)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True)
            loss = _dp_mean(loss.detach())
        return loss, {n: g if g is not None else torch.zeros_like(p)
                      for (n, p), g in zip(named, grads)}

    return grad_step


def make_apply_step(tx: ClippedAdamW, zero3: bool = False):
    """`apply_step(state, grads, n_plans, dp=None) -> (state, metrics)`: one
    update from gradients summed over `n_plans` evaluations; `dp` divides
    the ranks' sums (default the optimizer's dp; 1 where the caller divided
    each plan's by the dp of its own layout). `zero3` as `make_train_step`."""
    if zero3 != (tx.zero3 is not None) and tx.groups is not None:
        raise ValueError(f"zero3={zero3}, but the optimizer "
                         f"{'shards' if tx.zero3 else 'does not shard'} "
                         f"the parameters")

    def apply_step(state: TrainState, grads: Dict[str, torch.Tensor],
                   n_plans, dp: Optional[int] = None):
        for name, p in state.model.named_parameters():
            if name in grads:
                p.grad = grads[name] / n_plans
        gnorm = tx.update() if dp is None else tx.update(dp)
        state.step += 1
        return state, {"grad_norm": gnorm}

    return apply_step

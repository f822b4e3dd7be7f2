"""Process groups and the sequence- and CFG-parallel collectives.

Port of `videosys_tpu/core/parallel.py` on `torch.distributed`, in the
reference's own idiom (`videosys/core/distributed/parallel_mgr.py`,
`comm.py`): one process per rank, each with its own device; a
`ParallelConfig` (dp, cp, sp) laid out as `np.arange(n).reshape(dp, cp, sp)`
with sp innermost, as the JAX mesh is; one process group per line of each
axis; explicit all-to-all, split and all-gather where the JAX package flips
a sharding constraint.

DSP (Dynamic Sequence Parallelism) in STDiT3: activations [B, T, S, C] stay
S-sharded ([B, T, S/sp, C] on each rank); spatial attention switches its
input to T-sharded ([B, T/sp, S, C]) with one all-to-all and back with
another. T and S are padded to `token_pad_multiple()` (the reference's pad
registry, comm.py:268-304) and the pad is masked as keys. Latte,
Open-Sora-Plan v1.1 and Vchitect keep frames resident instead and switch
to tokens for their temporal attention with the same two helpers.

Ulysses (the joint-attention models, CogVideoX and Open-Sora-Plan v1.2):
tokens stay sharded ([B, N/sp, C], `shard_tokens`, N padded to sp); the
attention trades heads for the whole sequence with one all-to-all
(`ulysses_shard_heads`, H padded to sp with zero heads) and back
(`ulysses_shard_seq`); tokens every rank holds whole take their heads
locally (`split_heads`) and come back by `gather_heads`. `broadcast`
sends one sp rank's tensor to its line. CFG parallelism splits the
CFG-doubled batch over cp.

The Open-Sora VAE splits over the cp x sp ranks of a dp index (`CPSP_AXIS`;
every rank when serving): the temporal stage holds latent rows
(`shard_vae_rows`, h padded to the line's size, the pad marked in a
`RowShard`), its convolutions take one-row halos (`halo_exchange`) and its
group norms sum their statistics over the line (`all_reduce`); one
all-to-all crosses the seam into frames (`rows_to_frames`), which the 2D
stage decodes frame-locally and `gather_frames` collects on the line's
first rank. ZeRO-1 (training/train_step.py) reduce-scatters gradients and
all-gathers parameters over every rank (`WORLD_AXIS`) in flat buffers;
ZeRO-3 (training/zero3.py) gathers each unit of parameters for its forward
and reduce-scatters its gradient. `GroupsPool` holds one layout per sp for
dynamic sequence parallelism.

The groups in force are installed with `use_groups`. With none, or with one
rank, every helper returns its input: the one-card path gains no collective
and no copy. A failed collective raises; the package picks no other backend.

Gradients (training, after the reference's autograd collectives in
`comm.py`): `all_to_all`, `split`, `gather`, `broadcast`, `all_reduce` and
`halo_exchange` are `torch.autograd.Function`s. The loss is the one every
rank computes after the last `gather` (the same number on every rank). A
tensor that only this rank holds gets its gradient whole; a tensor every
rank holds gets this rank's share of it, and the shares sum over the line
to the whole. So the gradient of a replicated parameter is the sum of its
gradients over the sp ranks. Backward passes: `all_to_all` -> the reverse
all-to-all; `split` -> `gather` of the gradient, divided by the line's size
(the reference's `grad_scale="down"`: each rank's share of a tensor every
rank holds); `gather` -> `split` of the gradient (no factor); `broadcast`
-> a sum-reduce to its source (zero elsewhere); `all_reduce` -> an
all-reduce of the gradients; `halo_exchange` -> each halo's gradient sent
back to its owner and added. The backward's exchanges count in `EXCHANGE`
under keys of their own ("backward_calls", "backward_bytes"), the
optimizer's under "optimizer_calls", "optimizer_bytes".
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import random
import socket
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from videosys_tpu_torch.core.pipeline import resolve_device

# Canonical axis names, as in the JAX package.
DP_AXIS = "dp"   # data parallel (batch)
CP_AXIS = "cp"   # CFG-batch ("context") parallel, inference only
SP_AXIS = "sp"   # sequence parallel (DSP, Ulysses)
MESH_AXES = (DP_AXIS, CP_AXIS, SP_AXIS)
# The cp x sp ranks of one dp index (the VAE's rows and frames: JAX's
# shard_vae_rows puts h on (cp, sp) and, the batch being dp-major, its
# shard_frames gives each dp index its own frames), and every rank (ZeRO-1).
CPSP_AXIS = "cpsp"
WORLD_AXIS = "world"

# A collective waits this long for its peers before it raises.
DEFAULT_TIMEOUT_S = 600.0

# Collective calls and bytes sent since the last `reset_exchange()`: the
# forward's ("calls", "bytes"), autograd's backward ("backward_*") and the
# ZeRO optimizer's ("optimizer_*").
EXCHANGE: Dict[str, int] = {}


def reset_exchange() -> None:
    EXCHANGE.clear()
    for kind in ("", "backward_", "optimizer_"):
        EXCHANGE.update({kind + "calls": 0, kind + "bytes": 0})


reset_exchange()


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Static parallelism layout, mirroring ParallelManager(dp, cp, sp).

    Reference: `videosys/core/distributed/parallel_mgr.py:14-39`.
    """

    dp_size: int = 1
    cp_size: int = 1
    sp_size: int = 1

    @property
    def world_size(self) -> int:
        return self.dp_size * self.cp_size * self.sp_size

    @classmethod
    def from_world_size(cls, world_size: int, enable_cp: bool = False) -> "ParallelConfig":
        """Mimic `STDiT3.enable_parallel` (open_sora_transformer_3d.py:466-477):
        all devices go to sp; if cp is enabled and sp is even, split off cp=2."""
        sp = world_size
        cp = 1
        if enable_cp and sp % 2 == 0:
            sp //= 2
            cp = 2
        return cls(dp_size=1, cp_size=cp, sp_size=sp)


def rank_layout(config: ParallelConfig) -> np.ndarray:
    """Ranks on the (dp, cp, sp) grid, sp innermost: `build_mesh`'s device
    layout with rank r in place of device r."""
    return np.arange(config.world_size).reshape(
        config.dp_size, config.cp_size, config.sp_size)


def axis_lines(config: ParallelConfig, axis: str) -> List[List[int]]:
    """The rank lists of every line along `axis`, in a fixed order;
    `CPSP_AXIS` lines hold the cp x sp ranks of one dp index, the one
    `WORLD_AXIS` line every rank."""
    layout = rank_layout(config)
    if axis == CPSP_AXIS:
        grid = layout.reshape(config.dp_size, -1)
    elif axis == WORLD_AXIS:
        grid = layout.reshape(1, -1)
    else:
        grid = np.moveaxis(layout, MESH_AXES.index(axis), -1)
    return [list(map(int, line)) for line in grid.reshape(-1, grid.shape[-1])]


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's line along one axis: its process group (None when the
    line is this rank alone), its size and this rank's index in it."""

    group: Optional[object]
    ranks: Tuple[int, ...]
    rank: int

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Groups:
    """The groups of one rank: `axes` by name, `monitor` (a gloo group
    over every rank, for the watchdog's heartbeat only), the rank's
    device."""

    config: ParallelConfig
    rank: int
    axes: Dict[str, Axis]
    monitor: Optional[object]
    device: torch.device

    @property
    def world_size(self) -> int:
        return self.config.world_size

    def axis(self, name: str) -> Optional[Axis]:
        return self.axes.get(name)


def build_groups(config: ParallelConfig, device=None) -> Groups:
    """Counterpart of `build_mesh`: one `dist.new_group` for each sp line,
    each cp line and each dp line, then the watchdog's gloo group. Every
    rank calls this, with the same config, after `initialize`: each rank
    calls `new_group` for every group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("build_groups needs a process group: call "
                           "initialize() first")
    n, rank = dist.get_world_size(), dist.get_rank()
    if n != config.world_size:
        raise ValueError(f"{config} needs {config.world_size} ranks, the "
                         f"process group has {n}")
    axes = {}
    for name in (SP_AXIS, CP_AXIS, DP_AXIS):
        for line in axis_lines(config, name):
            group = dist.new_group(line) if len(line) > 1 else None
            if rank in line:
                axes[name] = Axis(group, tuple(line), line.index(rank))
    # the cp x sp line is the sp or the cp line when the other is 1; the
    # world is the default group
    if config.cp_size == 1 or config.sp_size == 1:
        axes[CPSP_AXIS] = axes[SP_AXIS if config.cp_size == 1 else CP_AXIS]
    else:
        for line in axis_lines(config, CPSP_AXIS):
            group = dist.new_group(line)
            if rank in line:
                axes[CPSP_AXIS] = Axis(group, tuple(line), line.index(rank))
    axes[WORLD_AXIS] = Axis(dist.group.WORLD if n > 1 else None,
                            tuple(range(n)), rank)
    monitor = dist.new_group(list(range(n)), backend="gloo") if n > 1 else None
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
    return Groups(config, rank, axes, monitor, torch.device(device))


class GroupsPool:
    """Counterpart of JAX's `MeshPool` (dynamic sequence parallelism): the
    `Groups` of `ParallelConfig(N // sp, 1, sp)` for each power of two sp
    that divides the world size N, built once (every rank builds all of
    them, in the same order: `new_group` is collective). Every layout puts
    rank r at the same place of the world axis, so ZeRO's slices (of every
    rank, `WORLD_AXIS`) are the same in each and a switch of layout moves
    no optimizer bytes and no parameter slices."""

    def __init__(self, device=None):
        n = dist.get_world_size()
        self._groups: Dict[int, Groups] = {}
        sp = 1
        while sp <= n:
            if n % sp == 0:
                self._groups[sp] = build_groups(
                    ParallelConfig(n // sp, 1, sp), device)
            sp *= 2

    @property
    def sp_sizes(self) -> List[int]:
        return sorted(self._groups)

    def groups_for_sp(self, sp_size: int) -> Groups:
        if sp_size not in self._groups:
            raise KeyError(f"sp_size {sp_size} not in pool {self.sp_sizes}")
        return self._groups[sp_size]

    def groups_for_plan(self, sp_size: int) -> Groups:
        """The layout a plan of `sp_size` runs on: the largest pool sp not
        above it (JAX train.py `_plan_mesh`)."""
        return self._groups[max(s for s in self._groups
                                if s <= max(1, sp_size))]


# --- active groups ------------------------------------------------------ #
# The pipeline installs its groups around the denoise loop; the model's
# helpers read them. With none installed the helpers are the identity.

_ACTIVE: List[Optional[Groups]] = [None]


class use_groups:
    """Context manager installing the groups the helpers use."""

    def __init__(self, groups: Optional[Groups]):
        self.groups = groups

    def __enter__(self):
        _ACTIVE.append(self.groups)
        return self.groups

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def active_groups() -> Optional[Groups]:
    return _ACTIVE[-1]


def _axis(group: Union[str, Axis, None]) -> Optional[Axis]:
    """The active groups' line along `group` (an axis name), or the Axis
    given; None when it is this rank alone."""
    if isinstance(group, Axis):
        ax = group
    else:
        groups = active_groups()
        if groups is None:
            return None
        ax = groups.axis(group)
    return ax if ax is not None and ax.size > 1 else None


def axis_size(group: Union[str, Axis] = SP_AXIS) -> int:
    ax = _axis(group)
    return 1 if ax is None else ax.size


def token_pad_multiple() -> int:
    """Divisibility requirement for token dims (T, S) under the active
    groups: the sp size (1 when none are active). STDiT3 pads T and S up
    to it after patchify and masks the pad as keys (JAX parallel.py
    :223-238)."""
    return axis_size(SP_AXIS)


def _count(x: torch.Tensor, kind: str = "") -> None:
    """Count one collective that sends `x`; `kind` "backward_" for
    autograd's backward, "optimizer_" for ZeRO-1."""
    EXCHANGE[kind + "calls"] += 1
    EXCHANGE[kind + "bytes"] += x.numel() * x.element_size()


def _via_host(ax: Axis, x: torch.Tensor) -> bool:
    """True where a collective stages a CUDA tensor through the host: on a
    gloo group (ranks that share one card)."""
    return x.is_cuda and dist.get_backend(ax.group) == "gloo"


def _all_to_all(x, scatter_dim: int, gather_dim: int, ax: Axis,
                kind: str = "") -> torch.Tensor:
    send = torch.stack(x.chunk(ax.size, scatter_dim))  # [n, ...], contiguous
    recv = torch.empty_like(send)
    _count(send, kind)
    dist.all_to_all_single(recv, send, group=ax.group)
    return torch.cat(recv.unbind(0), dim=gather_dim)


def _all_gather(x, dim: int, ax: Axis, kind: str = "") -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    _count(x, kind)
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x, ax: Axis, kind: str = "") -> torch.Tensor:
    x = x.contiguous().clone()
    _count(x, kind)
    dist.all_reduce(x, group=ax.group)
    return x


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scatter_dim, gather_dim, ax):
        ctx.dims, ctx.ax = (scatter_dim, gather_dim), ax
        return _all_to_all(x, scatter_dim, gather_dim, ax)

    @staticmethod
    def backward(ctx, g):
        scatter_dim, gather_dim = ctx.dims
        return (_all_to_all(g, gather_dim, scatter_dim, ctx.ax, "backward_"),
                None, None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return x.chunk(ax.size, dim)[ax.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        whole = _all_gather(g, ctx.dim, ctx.ax, "backward_")
        return whole / ctx.ax.size, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.ax.size, ctx.dim)[ctx.ax.rank].contiguous(), \
            None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, ax):
        ctx.src, ctx.ax = src, ax
        out = x.contiguous().clone() if ax.rank == src else torch.empty_like(x)
        if ax.rank == src:
            _count(out)
        dist.broadcast(out, src=ax.ranks[src], group=ax.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _count(g, "backward_")
        dist.reduce(g, dst=ctx.ax.ranks[ctx.src], group=ctx.ax.group)
        return (g if ctx.ax.rank == ctx.src else torch.zeros_like(g)), \
            None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, ax):
        ctx.mean, ctx.ax = mean, ax
        out = _all_reduce(x, ax)
        return out / ax.size if mean else out

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.ax, "backward_")
        return (g / ctx.ax.size if ctx.mean else g), None, None


def _edges(x, dim: int, width: int):
    """[first `width` rows, last `width` rows] of `x` along `dim`, stacked."""
    n = x.shape[dim]
    return torch.stack([x.narrow(dim, 0, width), x.narrow(dim, n - width,
                                                          width)])


class _Halo(torch.autograd.Function):
    """Each rank's edge rows go to every rank of the line in one
    all-gather (a few rows: cheaper to reason about than paired sends,
    and every backend has it); each rank keeps its neighbours'."""

    @staticmethod
    def forward(ctx, x, dim, width, ax):
        ctx.args = (dim, width, ax)
        edges = _all_gather(_edges(x, dim, width)[None], 0, ax)
        r, n = ax.rank, ax.size
        zeros = torch.zeros_like(edges[0, 0])
        before = edges[r - 1, 1] if r > 0 else zeros
        after = edges[r + 1, 0] if r < n - 1 else zeros
        return torch.cat([before, x, after], dim)

    @staticmethod
    def backward(ctx, g):
        dim, width, ax = ctx.args
        n_in = g.shape[dim] - 2 * width
        # the gradients of the rows this rank took from its neighbours go
        # back to them: its first halo to the rank before, its last after
        sent = torch.stack([g.narrow(dim, 0, width),
                            g.narrow(dim, width + n_in, width)])
        back = _all_gather(sent[None], 0, ax, "backward_")
        gx = g.narrow(dim, width, n_in).clone()
        r, n = ax.rank, ax.size
        if r > 0:  # the rank before took my first rows as its last halo
            gx.narrow(dim, 0, width).add_(back[r - 1, 1])
        if r < n - 1:  # the rank after took my last rows as its first halo
            gx.narrow(dim, n_in - width, width).add_(back[r + 1, 0])
        return gx, None, None, None


def all_to_all(x: torch.Tensor, scatter_dim: int, gather_dim: int,
               group: Union[str, Axis] = SP_AXIS) -> torch.Tensor:
    """Scatter `x` along `scatter_dim` over the group's ranks and gather
    their chunks along `gather_dim` (rank order), over
    `dist.all_to_all_single` on one contiguous buffer: the DSP switch
    (comm.py:139). Backward: the reverse all-to-all."""
    ax = _axis(group)
    if ax is None:
        return x
    if x.shape[scatter_dim] % ax.size:
        raise ValueError(f"dim {scatter_dim} of {tuple(x.shape)} does not "
                         f"split over {ax.size} ranks")
    return _AllToAll.apply(x, scatter_dim, gather_dim, ax)


def split(x: torch.Tensor, dim: int,
          group: Union[str, Axis] = SP_AXIS) -> torch.Tensor:
    """This rank's chunk of `x` along `dim` (no communication: every rank
    holds the whole of `x`). Backward: the gathered gradient over the
    line's size (this rank's share of a tensor every rank holds)."""
    ax = _axis(group)
    if ax is None:
        return x
    if x.shape[dim] % ax.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {ax.size} ranks")
    return _Split.apply(x, dim, ax)


def gather(x: torch.Tensor, dim: int,
           group: Union[str, Axis] = SP_AXIS) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order
    (all-gather; comm.py:256-260). Backward: this rank's chunk of the
    gradient."""
    ax = _axis(group)
    if ax is None:
        return x
    return _Gather.apply(x, dim, ax)


def broadcast(x: torch.Tensor, src: int = 0,
              group: Union[str, Axis] = SP_AXIS) -> torch.Tensor:
    """The `x` of the group's rank `src` (its index on the line) on every
    rank of the group; every rank passes a tensor of the same shape and
    dtype. Vchitect's cross-attention reads frame 0's context, which only
    the sp rank holding frame 0 has. Backward: the ranks' gradients summed
    on `src`, zero elsewhere."""
    ax = _axis(group)
    if ax is None:
        return x
    return _Broadcast.apply(x, src, ax)


def all_reduce(x: torch.Tensor, group: Union[str, Axis] = SP_AXIS,
               op: str = "sum") -> torch.Tensor:
    """The sum ("sum") or the mean ("mean") of the ranks' `x` on every rank
    of the group. Backward: the gradients all-reduced the same way."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op {op!r} is not 'sum' or 'mean'")
    ax = _axis(group)
    if ax is None:
        return x
    return _AllReduce.apply(x, op == "mean", ax)


def halo_exchange(x: torch.Tensor, dim: int, width: int = 1,
                  group: Union[str, Axis] = CPSP_AXIS) -> torch.Tensor:
    """`x` with the last `width` rows of the rank before on the line
    prepended along `dim` and the first `width` rows of the rank after
    appended; zeros past the line's ends. Every rank holds at least `width`
    rows. Backward: each halo's gradient added to the rows it came from."""
    ax = _axis(group)
    if ax is None:
        pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [width, width]
        return torch.nn.functional.pad(x, pad)
    if x.shape[dim] < width:
        raise ValueError(f"{x.shape[dim]} rows along dim {dim} hold no halo "
                         f"of {width}")
    return _Halo.apply(x, dim, width, ax)


# --- flat buffers (ZeRO-1), outside autograd ---------------------------- #

def reduce_scatter_flat(x: torch.Tensor,
                        group: Union[str, Axis] = WORLD_AXIS,
                        kind: str = "optimizer_") -> torch.Tensor:
    """This rank's 1/n slice of the sum of the ranks' 1-D `x` (its length
    a multiple of the group's size). `kind`: the `EXCHANGE` keys it counts
    under ("optimizer_"; ZeRO-3's gathers "" and "backward_")."""
    ax = _axis(group)
    if ax is None:
        return x
    host = _via_host(ax, x)
    src = x.cpu() if host else x
    out = src.new_empty(x.numel() // ax.size)
    _count(src, kind)
    dist.reduce_scatter(out, list(src.chunk(ax.size)), group=ax.group)
    return out.to(x.device) if host else out


def all_gather_flat(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                    group: Union[str, Axis] = WORLD_AXIS,
                    kind: str = "optimizer_") -> torch.Tensor:
    """The ranks' 1-D slices `x` concatenated in rank order, into `out`
    when given."""
    ax = _axis(group)
    if ax is None:
        return x if out is None else out.copy_(x)
    host = _via_host(ax, x)
    src = x.cpu() if host else x.contiguous()
    whole = src.new_empty(x.numel() * ax.size)
    _count(src, kind)
    dist.all_gather(list(whole.chunk(ax.size)), src, group=ax.group)
    if out is None:
        return whole.to(x.device)
    return out.copy_(whole)


def all_reduce_flat(x: torch.Tensor, group: Union[str, Axis] = WORLD_AXIS,
                    kind: str = "optimizer_") -> torch.Tensor:
    """The sum of the ranks' 1-D `x`, in place (ZeRO-3's whole leaves)."""
    ax = _axis(group)
    if ax is None:
        return x
    host = _via_host(ax, x)
    src = x.cpu() if host else x
    _count(src, kind)
    dist.all_reduce(src, group=ax.group)
    return x.copy_(src) if host else x


def broadcast_from_rank0(obj, groups: Optional[Groups]):
    """Rank 0's `obj` (a picklable host value) on every rank of `groups`,
    over the default process group; `obj` itself with no groups or one
    rank. For a value each rank would draw on its own, such as a seed."""
    if groups is None or groups.world_size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=0,
        device=groups.device if dist.get_backend() == "nccl" else None)
    return box[0]


# --- the DSP layouts of [B, T, S, C] ------------------------------------ #

def shard_temporal(x: torch.Tensor) -> torch.Tensor:
    """S-sharded [B, T, S/sp, C] -> T-sharded [B, T/sp, S, C]: the switch
    before spatial attention (open_sora_transformer_3d.py:288-315)."""
    return all_to_all(x, 1, 2)


def shard_spatial(x: torch.Tensor) -> torch.Tensor:
    """T-sharded [B, T/sp, S, C] -> the resident S-sharded layout."""
    return all_to_all(x, 2, 1)


def shard_batch_over_all(x: torch.Tensor) -> torch.Tensor:
    """Image case (T == 1): S-sharded [B, 1, S/sp, C] -> batch-sharded
    [ceil(B/sp), 1, S, C] (the reference scatters the batch over sp,
    open_sora_transformer_3d.py:293-302). A batch that does not divide is
    padded with zero rows; `unshard_batch` drops them."""
    n = axis_size(SP_AXIS)
    if n == 1:
        return x
    pad = -x.shape[0] % n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return all_to_all(x, 0, 2)


def unshard_batch(x: torch.Tensor, batch: int) -> torch.Tensor:
    """Inverse of `shard_batch_over_all` for a batch of `batch` rows."""
    if axis_size(SP_AXIS) == 1:
        return x
    return all_to_all(x, 2, 0)[:batch]


# --- the Open-Sora VAE: latent rows, then frames ------------------------ #
# JAX's shard_vae_rows and shard_frames (videosys_tpu/core/parallel.py
# :190-214) on the cp x sp line of this rank (every rank when serving). h is
# padded with zero rows to a multiple of the line's size; the pad rows sit at
# the end of the axis, so each rank's real rows are a prefix of its own.

@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's share of the latent rows (dim 3 of [B, C, T, h, w]):
    `local` rows a rank, of which the first `valid` are real (`rows` in
    all); the temporal VAE's convolutions take halos across `axis` and its
    group norms sum their statistics over it."""

    axis: Axis
    rows: int
    local: int

    @property
    def valid(self) -> int:
        return max(0, min(self.local, self.rows - self.axis.rank * self.local))

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        """`x` with its pad rows zeroed (a no-op where every row is real)."""
        if self.valid == self.local:
            return x
        keep = torch.arange(self.local, device=x.device) < self.valid
        return x * keep[:, None].to(x.dtype)


_ROWS: List[Optional[RowShard]] = [None]


class use_rows:
    """Context manager installing the row shard the temporal VAE reads."""

    def __init__(self, rows: Optional[RowShard]):
        self.rows = rows

    def __enter__(self):
        _ROWS.append(self.rows)
        return self.rows

    def __exit__(self, *exc):
        _ROWS.pop()
        return False


def active_rows() -> Optional[RowShard]:
    return _ROWS[-1]


def vae_rows(rows: int) -> Optional[RowShard]:
    """The `RowShard` of `rows` latent rows over this rank's cp x sp line;
    None on one rank."""
    ax = _axis(CPSP_AXIS)
    if ax is None:
        return None
    return RowShard(ax, rows, -(-rows // ax.size))


def shard_vae_rows(x: torch.Tensor) -> Tuple[torch.Tensor, Optional[RowShard]]:
    """This rank's latent rows of [B, C, T, h, w] (every rank holds the
    whole), h padded with zero rows to a multiple of the line's size, and
    the `RowShard` that marks them; (x, None) on one rank."""
    rows = vae_rows(x.shape[3])
    if rows is None:
        return x, None
    return split(pad_to_multiple(x, 3, rows.axis.size), 3, rows.axis), rows


def gather_rows(x: torch.Tensor, rows: Optional[RowShard]) -> torch.Tensor:
    """Inverse of `shard_vae_rows`: every rank's rows, the pad dropped, on
    every rank."""
    if rows is None:
        return x
    return gather(x, 3, rows.axis)[:, :, :, :rows.rows]


def rows_to_frames(x: torch.Tensor, rows: Optional[RowShard]
                   ) -> Tuple[torch.Tensor, int]:
    """The seam: row-sharded [B, C, T, h/n, w] -> this rank's frames
    [N/n, C, h, w] of the B*T frames (batch-major), N padded with zero
    frames to a multiple of n; one all-to-all. Returns (frames, B*T)."""
    B, C, T, hl, w = x.shape
    frames = x.transpose(1, 2).reshape(B * T, C, hl, w)
    if rows is None:
        return frames, B * T
    frames = pad_to_multiple(frames, 0, rows.axis.size)
    out = all_to_all(frames, 0, 2, rows.axis)
    return out[:, :, :rows.rows], B * T


def frames_to_rows(frames: torch.Tensor, rows: Optional[RowShard], B: int,
                   T: int) -> torch.Tensor:
    """Inverse of `rows_to_frames`: this rank's frames [N/n, C, h, w] ->
    row-sharded [B, C, T, h/n, w]; one all-to-all."""
    if rows is not None:
        frames = pad_to_multiple(frames, 2, rows.axis.size)
        frames = all_to_all(frames, 2, 0, rows.axis)[:B * T]
    return frames.reshape(B, T, *frames.shape[1:]).transpose(1, 2)


def shard_frames(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """This rank's block of the frames [N, ...] every rank holds, N padded
    with zero frames to a multiple of the line's size: JAX's frames over
    every mesh axis. Returns (frames, N)."""
    ax = _axis(CPSP_AXIS)
    if ax is None:
        return x, x.shape[0]
    return split(pad_to_multiple(x, 0, ax.size), 0, ax), x.shape[0]


def gather_frames(x: torch.Tensor, n_frames: int, everywhere: bool = False
                  ) -> Optional[torch.Tensor]:
    """Inverse of `shard_frames` on the line's first rank (the video's
    owner; None on the others), or with `everywhere` on every rank; the
    pad frames dropped."""
    ax = _axis(CPSP_AXIS)
    if ax is None:
        return x[:n_frames]
    if everywhere:
        return gather(x, 0, ax)[:n_frames]
    host = _via_host(ax, x)
    src = x.contiguous().cpu() if host else x.contiguous()
    parts = ([torch.empty_like(src) for _ in range(ax.size)]
             if ax.rank == 0 else None)
    _count(src)
    dist.gather(src, parts, dst=ax.ranks[0], group=ax.group)
    if ax.rank != 0:
        return None
    return torch.cat(parts)[:n_frames].to(x.device)


# --- token shards and Ulysses (heads <-> sequence) ---------------------- #
# JAX's `shard_tokens`, `ulysses_shard_heads` and `ulysses_shard_seq`
# (videosys_tpu/core/parallel.py:173-188). GSPMD pads an uneven dim on its
# own; here the pad is explicit: tokens are padded with zero rows to a
# multiple of sp (the caller masks them as keys and drops them after the
# gather), heads with zero heads, dropped on the way back.

def pad_to_multiple(x: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    """`x` with zeros appended along `dim` up to a multiple of `multiple`."""
    pad = -x.shape[dim] % multiple
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def shard_tokens(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's sp shard of the tokens along `dim`, padded with zero
    rows to a multiple of sp first: the resident layout of the
    joint-attention models (JAX P(batch, sp, None) on [B, N, C])."""
    n = axis_size(SP_AXIS)
    if n == 1:
        return x
    return split(pad_to_multiple(x, dim, n), dim)


def ulysses_shard_heads(x: torch.Tensor) -> torch.Tensor:
    """Sequence-sharded [B, N/sp, ..., H, D] -> heads over sp with the
    sequence gathered, [B, N, ..., ceil(H/sp), D]; H is padded with zero
    heads to a multiple of sp (CogVideoX-2b's 30 heads at sp=4). One
    all-to-all; q, k and v may go stacked on a dim before the heads."""
    n = axis_size(SP_AXIS)
    if n == 1:
        return x
    heads = x.ndim - 2
    return all_to_all(pad_to_multiple(x, heads, n), heads, 1)


def ulysses_shard_seq(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Inverse of `ulysses_shard_heads`: [B, N, ..., ceil(H/sp), D] ->
    [B, N/sp, ..., H, D] with the pad heads dropped."""
    if axis_size(SP_AXIS) == 1:
        return x
    return all_to_all(x, 1, x.ndim - 2)[..., :num_heads, :]


def split_heads(x: torch.Tensor) -> torch.Tensor:
    """This rank's heads of a tensor every sp rank holds whole,
    [B, L, ..., H, D] -> [B, L, ..., ceil(H/sp), D], as
    `ulysses_shard_heads` deals them (no communication): the text rows
    of a joint attention."""
    n = axis_size(SP_AXIS)
    if n == 1:
        return x
    return split(pad_to_multiple(x, x.ndim - 2, n), x.ndim - 2)


def gather_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Every sp rank's heads, [B, L, ..., ceil(H/sp), D] ->
    [B, L, ..., H, D] on every rank (all-gather), the pad heads dropped."""
    if axis_size(SP_AXIS) == 1:
        return x
    return gather(x, x.ndim - 2)[..., :num_heads, :]


# --- process set-up ------------------------------------------------------ #

def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(rank: int = 0, world_size: int = 1,
               coordinator_address: Optional[str] = None,
               seed: Optional[int] = None, backend: Optional[str] = None,
               device=None, timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """`videosys.initialize` (parallel_mgr.py:103-117): join the default
    process group as `rank` of `world_size` when `world_size > 1` or a
    `coordinator_address` or `backend` is given, at `coordinator_address`
    ("host:port"; None: the MASTER_ADDR / MASTER_PORT variables, or a free
    local port for one rank). `backend` defaults to
    `default_backend(device)`; `device` (default `cuda:rank`) becomes this
    process's CUDA device. A collective waits `timeout` seconds at most. `seed` seeds the host RNGs (random,
    numpy, torch's default generator); the pipelines draw from their own
    seeded generators."""
    if world_size > 1 or coordinator_address or backend is not None:
        dev = resolve_device(device if device is not None
                             else rank_devices(world_size)[rank])
        if dist.is_initialized():
            raise RuntimeError("a default process group already exists")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if coordinator_address is None:
            if world_size > 1 and "MASTER_ADDR" in os.environ:
                init_method = "env://"
            elif world_size == 1:
                init_method = f"tcp://localhost:{free_port()}"
            else:
                raise ValueError("world_size > 1 needs coordinator_address "
                                 "or MASTER_ADDR / MASTER_PORT")
        else:
            init_method = "tcp://" + coordinator_address.removeprefix(
                "tcp://")
        dist.init_process_group(
            backend or default_backend(dev), init_method=init_method,
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)


def set_distributed_state(distributed_profile: bool = False,
                          backend: Optional[str] = None, device=None,
                          timeout: float = DEFAULT_TIMEOUT_S):
    """Environment bootstrap mirroring the reference `set_distributed_state`
    (parallel_mgr.py:120-148): RANK/WORLD_SIZE (torchrun-style) or
    OMPI_COMM_WORLD_* (OpenMPI) envs resolve (rank, world_size, node_rank,
    node_size); ``distributed_profile`` rewrites a multi-node launch into
    independent single-node instances for the fast DCP profile phase.
    When MASTER_ADDR is set and world_size > 1 (and not profiling), joins
    the default process group through `initialize`, on `device` (default
    `cuda:LOCAL_RANK` under torchrun). Returns the tuple."""
    rank = int(os.getenv("RANK", os.getenv("OMPI_COMM_WORLD_RANK", "-1")))
    world_size = int(os.getenv("WORLD_SIZE",
                               os.getenv("OMPI_COMM_WORLD_SIZE", "-1")))
    node_rank = int(os.getenv("NODE_RANK",
                              os.getenv("OMPI_COMM_WORLD_NODE_RANK", "0")))
    node_size = int(os.getenv("NNODES", "1"))

    if distributed_profile and world_size > 0:
        # one independent instance per node (fast profile, :128-146); each
        # node profiles the bucket space locally with its own device count
        device_count = max(1, torch.cuda.device_count())
        node_rank = rank // device_count if device_count else 0
        node_size = max(1, world_size // device_count)
        rank, world_size = rank % device_count, device_count
        os.environ.update(NNODES="1", NODE_RANK="0", RANK=str(rank),
                          WORLD_SIZE=str(world_size), MASTER_ADDR="localhost")

    master = os.getenv("MASTER_ADDR")
    if world_size > 1 and master and not distributed_profile:
        if rank < 0:
            raise RuntimeError(
                "set_distributed_state: WORLD_SIZE/MASTER_ADDR are set but no "
                "rank env var was found — export RANK (torchrun-style) or "
                "OMPI_COMM_WORLD_RANK (OpenMPI)")
        port = os.getenv("MASTER_PORT", "29500")
        if device is None and "LOCAL_RANK" in os.environ:
            device = f"cuda:{os.environ['LOCAL_RANK']}"
        initialize(rank, world_size, f"{master}:{port}", backend=backend,
                   device=device, timeout=timeout)
    return rank, world_size, node_rank, node_size


def rank_devices(world_size: int, device=None,
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """Each rank's device: `devices` as given (one per rank), else `device`
    for every rank, where a CUDA device without an index means `cuda:r`
    for rank r (the default, as `build_mesh` takes the first devices)."""
    if devices is not None:
        if len(devices) != world_size:
            raise ValueError(f"{len(devices)} devices for {world_size} ranks")
        return [torch.device(d) for d in devices]
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", r) for r in range(world_size)]
    return [dev] * world_size

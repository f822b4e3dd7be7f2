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

The groups in force are installed with `use_groups`. With none, or with one
rank, every helper returns its input: the one-card path gains no collective
and no copy. The collectives are forward-only (serving): each raises where
autograd would need a gradient through it. A failed collective raises; the
package picks no other backend.
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

# A collective waits this long for its peers before it raises.
DEFAULT_TIMEOUT_S = 600.0

# Collective calls and bytes sent since the last `reset_exchange()`.
EXCHANGE: Dict[str, int] = {"calls": 0, "bytes": 0}


def reset_exchange() -> None:
    EXCHANGE.update(calls=0, bytes=0)


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
    """The rank lists of every line along `axis`, in a fixed order."""
    grid = np.moveaxis(rank_layout(config), MESH_AXES.index(axis), -1)
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

    def axis(self, name: str) -> Axis:
        return self.axes[name]


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
    monitor = dist.new_group(list(range(n)), backend="gloo") if n > 1 else None
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
    return Groups(config, rank, axes, monitor, torch.device(device))


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
    return ax if ax.size > 1 else None


def axis_size(group: Union[str, Axis] = SP_AXIS) -> int:
    ax = _axis(group)
    return 1 if ax is None else ax.size


def token_pad_multiple() -> int:
    """Divisibility requirement for token dims (T, S) under the active
    groups: the sp size (1 when none are active). STDiT3 pads T and S up
    to it after patchify and masks the pad as keys (JAX parallel.py
    :223-238)."""
    return axis_size(SP_AXIS)


def _forward_only(x: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"parallel.{what} is forward-only (serving); a gradient through "
            f"it is not ported (ROADMAP Queue 1 item 6e)")


def _count(x: torch.Tensor) -> None:
    """Count one collective that sends `x`."""
    EXCHANGE["calls"] += 1
    EXCHANGE["bytes"] += x.numel() * x.element_size()


def all_to_all(x: torch.Tensor, scatter_dim: int, gather_dim: int,
               group: Union[str, Axis] = SP_AXIS) -> torch.Tensor:
    """Scatter `x` along `scatter_dim` over the group's ranks and gather
    their chunks along `gather_dim` (rank order), over
    `dist.all_to_all_single` on one contiguous buffer: the DSP switch
    (comm.py:139)."""
    ax = _axis(group)
    if ax is None:
        return x
    _forward_only(x, "all_to_all")
    n = ax.size
    if x.shape[scatter_dim] % n:
        raise ValueError(f"dim {scatter_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    send = torch.stack(x.chunk(n, scatter_dim))  # [n, ...], contiguous
    recv = torch.empty_like(send)
    _count(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    return torch.cat(recv.unbind(0), dim=gather_dim)


def split(x: torch.Tensor, dim: int,
          group: Union[str, Axis] = SP_AXIS) -> torch.Tensor:
    """This rank's chunk of `x` along `dim` (no communication: every rank
    holds the whole of `x`)."""
    ax = _axis(group)
    if ax is None:
        return x
    if x.shape[dim] % ax.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {ax.size} ranks")
    return x.chunk(ax.size, dim)[ax.rank]


def gather(x: torch.Tensor, dim: int,
           group: Union[str, Axis] = SP_AXIS) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order
    (all-gather; comm.py:256-260)."""
    ax = _axis(group)
    if ax is None:
        return x
    _forward_only(x, "gather")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    _count(x)
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, src: int = 0,
              group: Union[str, Axis] = SP_AXIS) -> torch.Tensor:
    """The `x` of the group's rank `src` (its index on the line) on every
    rank of the group; every rank passes a tensor of the same shape and
    dtype. Vchitect's cross-attention reads frame 0's context, which only
    the sp rank holding frame 0 has."""
    ax = _axis(group)
    if ax is None:
        return x
    _forward_only(x, "broadcast")
    x = x.contiguous() if ax.rank == src else torch.empty_like(x)
    if ax.rank == src:
        _count(x)
    dist.broadcast(x, src=ax.ranks[src], group=ax.group)
    return x


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

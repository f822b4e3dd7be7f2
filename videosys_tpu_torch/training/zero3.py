"""ZeRO-3: the trainable parameters sharded over every rank.

Port of JAX's `zero3_shardings` and `make_train_step(zero3=True)`
(`videosys_tpu/training/train_step.py`): each parameter leaf of at least
`ZERO3_MIN_SHARD_BYTES` is held as 1/N of itself on each of the N ranks,
the forward all-gathers a layer's weights and the backward reduce-scatters
that layer's gradient; the update runs on the slice. Smaller leaves stay
whole on every rank (JAX `_zero3_param_leaf_sharding`); their gradients
are all-reduced at the update.

The unit of a gather is the model's (`model.param_unit(name)`): for STDiT3
each depth pair (the spatial and temporal block that one recompute call
runs), and the rest of the model (embedders, caption embedder, final
layer) as one more, as JAX gathers a scan layer's weights. Each unit is
one flat fp32 buffer padded to a multiple of N; a rank holds its slice of
it as a parameter of the model (`zero3_slices.{u}`) and the sharded leaves
are no parameters of their modules any more. `Zero3.gathered(u)` is a
context in which those leaves are views into the unit's gathered buffer,
made by an autograd Function (`_Gather`: forward all-gather, backward
reduce-scatter of the unit's gradient into the slice's, the sum over every
rank; the update divides it by the active dp, as ZeRO-1's does). STDiT3
enters it inside its checkpointed pair, so "full" recompute gathers again
in the backward and no rank holds the whole model's parameters or
gradients at once; under "none" autograd keeps each gathered unit until
its pair's backward, as XLA keeps residuals.

`model.named_parameters()` then yields the whole small leaves and this
rank's slices, so an EMA made from it keeps this rank's fragments only
(JAX's EMA keeps per-rank fp32 ZeRO fragments). `gather_dict` and
`shard_dict` convert such a dict to the whole model's names and back (a
collective); `unshard` makes the model whole again.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from videosys_tpu_torch.core import parallel as par

# Only leaves at least this large are sharded (JAX train_step.py
# ZERO3_MIN_SHARD_BYTES): the matmul weights hold nearly all the bytes.
ZERO3_MIN_SHARD_BYTES = 1 << 16
SLICES = "zero3_slices"


class _Gather(torch.autograd.Function):
    """A unit's slices -> its whole flat buffer; backward: the gradient
    reduce-scattered (summed over every rank) into the slice's."""

    @staticmethod
    def forward(ctx, shard, ax):
        ctx.ax = ax
        return par.all_gather_flat(shard, group=ax, kind="")

    @staticmethod
    def backward(ctx, g):
        return par.reduce_scatter_flat(g.contiguous(), ctx.ax,
                                       "backward_"), None


@dataclasses.dataclass(frozen=True)
class _Leaf:
    name: str
    module: nn.Module
    attr: str
    offset: int
    shape: torch.Size

    @property
    def numel(self) -> int:
        return self.shape.numel()


class Zero3:
    """The sharding of one model's trainable parameters over the ranks of
    `groups` (the world axis: the same in every layout of a `GroupsPool`).
    Made by `shard_model`."""

    def __init__(self, model: nn.Module, groups: par.Groups):
        self.model = model
        self.world = groups.axis(par.WORLD_AXIS)
        n, r = self.world.size, self.world.rank
        # the whole model's trainable names, in its own order (the world-1
        # layout of checkpoints and optimizer states)
        self.names = [k for k, p in model.named_parameters() if p.requires_grad]
        self.state_keys = list(model.state_dict())
        self._orders = {id(m): (m, list(m._parameters)) for m in model.modules()}
        modules = dict(model.named_modules())
        by_unit: Dict[int, List] = {}
        for name, p in model.named_parameters():
            if p.requires_grad and \
                    p.numel() * p.element_size() >= ZERO3_MIN_SHARD_BYTES:
                by_unit.setdefault(model.param_unit(name), []).append((name, p))
        self.units: List[List[_Leaf]] = []
        self.unit_ids: List[int] = []
        slices = []
        for u in sorted(by_unit):
            leaves, off = [], 0
            for name, p in by_unit[u]:
                mod_name, _, attr = name.rpartition(".")
                leaves.append(_Leaf(name, modules[mod_name], attr, off,
                                    p.shape))
                off += p.numel()
            length = -(-off // n)
            flat = torch.zeros(length * n, dtype=torch.float32,
                               device=by_unit[u][0][1].device)
            with torch.no_grad():
                for leaf, (_, p) in zip(leaves, by_unit[u]):
                    flat[leaf.offset:leaf.offset + leaf.numel] = p.reshape(-1)
            for leaf in leaves:
                delattr(leaf.module, leaf.attr)  # no parameter any more
                setattr(leaf.module, leaf.attr, None)
            slices.append(nn.Parameter(flat[r * length:(r + 1) * length].clone()))
            self.units.append(leaves)
            self.unit_ids.append(u)
        self.sharded = {leaf.name for leaves in self.units for leaf in leaves}
        setattr(model, SLICES, nn.ParameterList(slices))
        self._bound: set = set()
        model.zero3 = self

    @property
    def slices(self) -> List[nn.Parameter]:
        return list(getattr(self.model, SLICES))

    def slice_name(self, i: int) -> str:
        return f"{SLICES}.{i}"

    @contextlib.contextmanager
    def gathered(self, unit: int):
        """Unit `unit`'s sharded leaves as views into its gathered buffer for
        the duration (nothing where it is bound already or not sharded)."""
        if unit not in self.unit_ids or unit in self._bound:
            yield
            return
        i = self.unit_ids.index(unit)
        full = _Gather.apply(self.slices[i], self.world)
        for leaf in self.units[i]:
            setattr(leaf.module, leaf.attr,
                    full[leaf.offset:leaf.offset + leaf.numel].view(leaf.shape))
        self._bound.add(unit)
        try:
            yield
        finally:
            self._bound.discard(unit)
            for leaf in self.units[i]:
                setattr(leaf.module, leaf.attr, None)

    # --- whole <-> local dicts (collectives) ------------------------------ #

    @torch.no_grad()
    def _whole_units(self, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for i, leaves in enumerate(self.units):
            flat = par.all_gather_flat(
                local[self.slice_name(i)].detach().float().contiguous(),
                group=self.world)
            for leaf in leaves:
                out[leaf.name] = flat[leaf.offset:leaf.offset
                                      + leaf.numel].view(leaf.shape).clone()
        return out

    def gather_dict(self, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A dict by this model's local names (whole small leaves, this
        rank's slices; an EMA, the named parameters) -> the same values by
        the whole model's names, in its order. Every rank calls it."""
        whole = self._whole_units(local)
        return {k: whole[k] if k in whole else local[k].detach().clone()
                for k in self.names if k in whole or k in local}

    @torch.no_grad()
    def shard_dict(self, whole: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of `gather_dict`: this rank's slice of each unit."""
        n, r = self.world.size, self.world.rank
        out = {k: v for k, v in whole.items() if k not in self.sharded}
        for i, leaves in enumerate(self.units):
            length = self.slices[i].numel()
            flat = torch.zeros(length * n, dtype=torch.float32,
                               device=self.slices[i].device)
            for leaf in leaves:
                flat[leaf.offset:leaf.offset + leaf.numel] = \
                    whole[leaf.name].reshape(-1).to(flat.device)
            out[self.slice_name(i)] = flat[r * length:(r + 1) * length].clone()
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state_dict (a collective)."""
        local = self.model.state_dict()
        whole = self._whole_units(local)
        return {k: whole.get(k, local.get(k)) for k in self.state_keys}

    @torch.no_grad()
    def load_state_dict(self, whole: Dict[str, torch.Tensor]) -> None:
        """Load a whole state_dict: small leaves and buffers as they are,
        this rank's slice of each unit."""
        local = self.shard_dict({k: v for k, v in whole.items()
                                 if k in self.sharded})
        rest = {k: v for k, v in whole.items() if k not in self.sharded}
        self.model.load_state_dict({**rest, **local})

    @torch.no_grad()
    def unshard(self) -> None:
        """Make the model whole again on every rank (a collective): each
        sharded leaf a parameter of its module, in its module's order."""
        whole = self._whole_units(dict(self.model.named_parameters()))
        for leaves in self.units:
            for leaf in leaves:
                delattr(leaf.module, leaf.attr)
                leaf.module.register_parameter(
                    leaf.attr, nn.Parameter(whole[leaf.name]))
        for m, order in self._orders.values():
            params = dict(m._parameters)
            m._parameters.clear()
            m._parameters.update({k: params[k] for k in order if k in params})
        delattr(self.model, SLICES)
        self.model.zero3 = None


def shard_model(model: nn.Module,
                groups: Optional[par.Groups]) -> Optional[Zero3]:
    """Shard `model`'s trainable parameters over the ranks of `groups`
    (ZeRO-3); None, and nothing sharded, at one rank (JAX
    `_pin_params_zero3` returns the params unchanged there)."""
    if groups is None or groups.world_size == 1:
        return None
    return Zero3(model, groups)

"""Pyramid Attention Broadcast (PAB): per-step plans from the timestep ladder.

Port of `videosys_tpu/core/pab.py`. Every broadcast decision is a pure
function of the timestep ladder, so `build_plans` replays the reference's
counter logic (`videosys/core/pab/pab_mgr.py`, PABManager :54-174) once per
`generate` call and gives one `PABStepPlan` per sampling step. Each cache
slot then has a fixed mode per step, absent | read | write (| readwrite for
the dict-driven MLP rows): the models skip what a read step reads from the
cache (`PABCache`) and copy into the cache in place on a write step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def cache_torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype a `PABConfig.cache_dtype` name stands for (None: the
    model's dtype). A name torch has no dtype for raises: the cache never
    falls back to another dtype on its own."""
    if name is None:
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"PAB cache_dtype {name!r} is no torch dtype "
                         f"(e.g. 'float8_e4m3fn', 'bfloat16')")
    return dtype


@dataclasses.dataclass
class PABConfig:
    """Mirror of pab_mgr.PABConfig (:6-40), with the JAX package's
    extensions (`mlp_range`, `pair_broadcast`, `cache_dtype`)."""

    spatial_broadcast: bool = False
    spatial_threshold: tuple[int, int] = (0, 0)
    spatial_range: int = 1
    temporal_broadcast: bool = False
    temporal_threshold: tuple[int, int] = (0, 0)
    temporal_range: int = 1
    cross_broadcast: bool = False
    cross_threshold: tuple[int, int] = (0, 0)
    cross_range: int = 1
    mlp_broadcast: bool = False
    # {timestep:int -> {"block": [idx...], "skip_count": int}}
    mlp_spatial_broadcast_config: Optional[dict] = None
    mlp_temporal_broadcast_config: Optional[dict] = None
    # Range-based full-depth MLP broadcast: with mlp_range > 1 (and
    # mlp_broadcast) every block's MLP output is cached and broadcast under
    # its own (threshold, range) ladder like the attention branches; the
    # dict configs are then ignored.
    mlp_threshold: tuple[int, int] = (450, 930)
    mlp_range: int = 1
    # Pair-delta residual cache: the residual x_out - x_in of a whole
    # (spatial, temporal) depth pair in one [depth, B, T, S, C] slot; a read
    # step skips the whole pair. Subsumes the component ladders: when on,
    # build_plans ignores the component and MLP flags.
    pair_broadcast: bool = False
    pair_threshold: tuple[int, int] = (450, 930)
    pair_range: int = 1
    # cache storage dtype, a torch dtype name (None = the model's dtype);
    # "float8_e4m3fn" halves the cache's bytes
    cache_dtype: Optional[str] = None

    def __post_init__(self):
        cache_torch_dtype(self.cache_dtype)

    @property
    def enabled(self) -> bool:
        return (self.spatial_broadcast or self.temporal_broadcast
                or self.cross_broadcast or self.mlp_broadcast
                or self.pair_broadcast)

    @property
    def mlp_range_mode(self) -> bool:
        """Full-depth range-based MLP broadcast active."""
        return bool(self.mlp_broadcast and self.mlp_range > 1)


@dataclasses.dataclass(frozen=True)
class PABStepPlan:
    """Per-step broadcast decisions. MLP flags are per-depth bool tuples.

    ``spatial/temporal/cross`` mean READ the cache this step (broadcast);
    ``save_*`` mean WRITE the freshly computed value into the cache because
    the NEXT step broadcasts it."""

    spatial: bool = False
    temporal: bool = False
    cross: bool = False
    save_spatial: bool = False
    save_temporal: bool = False
    save_cross: bool = False
    # range-mode MLP broadcast (all depths at once)
    mlp: bool = False
    save_mlp: bool = False
    # pair-delta residual broadcast (skips whole depth pairs)
    pair: bool = False
    save_pair: bool = False
    # per-depth tuples: save into / read from the MLP cache row
    # (the reference's dict-driven mechanism, pab_mgr.py:93-174)
    mlp_spatial_save: tuple[bool, ...] = ()
    mlp_spatial_use: tuple[bool, ...] = ()
    mlp_temporal_save: tuple[bool, ...] = ()
    mlp_temporal_use: tuple[bool, ...] = ()

    @property
    def any_mlp(self) -> bool:
        return any(self.mlp_spatial_save) or any(self.mlp_spatial_use) or \
            any(self.mlp_temporal_save) or any(self.mlp_temporal_use)

    def slot_mode(self, branch: str, slot: str) -> str:
        """Cache-slot mode for this step: absent | read | write
        (| readwrite for the dict-driven MLP rows)."""
        if slot == "attn":
            read = self.spatial if branch == "spatial" else self.temporal
            write = self.save_spatial if branch == "spatial" else self.save_temporal
        elif slot == "cross":
            read, write = self.cross, self.save_cross
        elif slot == "delta":  # pair-delta residual slot
            read, write = self.pair, self.save_pair
        else:  # mlp
            if self.mlp or self.save_mlp:  # range mode: full-depth slot
                read, write = self.mlp, self.save_mlp
            else:  # dict mode: active (read+write rows) iff any flag set
                return "readwrite" if self.any_mlp else "absent"
        return "read" if read else ("write" if write else "absent")


def _broadcast_flags(
    enabled: bool, threshold: tuple[int, int], rng: int, timesteps: Sequence[int]
) -> list[bool]:
    """Replay of PABManager.if_broadcast_* (:54-91): per-step counter starts
    at 0 and increments once per step; broadcast when count % range != 0 and
    t inside the open interval."""
    flags = []
    for count, t in enumerate(timesteps):
        flags.append(
            bool(enabled and (count % rng != 0) and threshold[0] < t < threshold[1])
        )
    return flags


def _mlp_flags(
    cfg: Optional[dict], timesteps: Sequence[int], depth: int
) -> tuple[list[tuple[bool, ...]], list[tuple[bool, ...]]]:
    """Replay of if_skip_mlp / _is_t_in_skip_config (:93-139). Returns
    (save_flags, use_flags), each a per-step list of per-depth tuples."""
    n = len(timesteps)
    save = [[False] * depth for _ in range(n)]
    use = [[False] * depth for _ in range(n)]
    if cfg:
        for key_t, spec in cfg.items():
            if key_t not in timesteps:
                continue
            i = timesteps.index(key_t)
            blocks = spec["block"]
            skip_count = int(spec["skip_count"])
            for b in blocks:
                if b < depth:
                    save[i][b] = True
            for j in range(i + 1, min(i + 1 + skip_count, n)):
                for b in blocks:
                    if b < depth:
                        use[j][b] = True
    return [tuple(s) for s in save], [tuple(u) for u in use]


def quantize_timesteps(timesteps: np.ndarray,
                       dtype: Optional[torch.dtype] = None) -> list[int]:
    """The reference keys PAB decisions on int(t.to(model_dtype).item())
    (scheduling_rflow_open_sora.py:222): round the float32 ladder to the
    model dtype (nearest even), then truncate."""
    ts = np.asarray(timesteps)
    if dtype is not None:
        ts = torch.as_tensor(ts.astype(np.float32)).to(dtype).float().numpy()
    return [int(t) for t in ts]


def build_plans(
    config: Optional[PABConfig],
    timesteps: np.ndarray,
    depth: int,
    model_dtype: Optional[torch.dtype] = None,
) -> list[PABStepPlan]:
    """One plan per sampling step."""
    n = len(timesteps)
    if config is None or not config.enabled:
        return [PABStepPlan()] * n
    ts_int = quantize_timesteps(timesteps, model_dtype)

    def nxt(flags, i):
        # write needed iff this step computes and the next step broadcasts
        return (not flags[i]) and (i + 1 < n) and flags[i + 1]

    if config.pair_broadcast:
        # a pair-read step skips the whole block pair, so component save
        # flags could go stale: use ONLY the pair ladder
        pr = _broadcast_flags(True, tuple(config.pair_threshold),
                              config.pair_range, ts_int)
        return [PABStepPlan(pair=pr[i], save_pair=nxt(pr, i))
                for i in range(n)]

    sp = _broadcast_flags(config.spatial_broadcast, tuple(config.spatial_threshold),
                          config.spatial_range, ts_int)
    tp = _broadcast_flags(config.temporal_broadcast, tuple(config.temporal_threshold),
                          config.temporal_range, ts_int)
    cr = _broadcast_flags(config.cross_broadcast, tuple(config.cross_threshold),
                          config.cross_range, ts_int)
    empty = [()] * n
    ms_save = ms_use = mt_save = mt_use = empty
    ml = [False] * n
    if config.mlp_range_mode:
        ml = _broadcast_flags(True, tuple(config.mlp_threshold),
                              config.mlp_range, ts_int)
    elif config.mlp_broadcast:
        ms_save, ms_use = _mlp_flags(config.mlp_spatial_broadcast_config, ts_int, depth)
        mt_save, mt_use = _mlp_flags(config.mlp_temporal_broadcast_config, ts_int, depth)

    return [
        PABStepPlan(
            spatial=sp[i], temporal=tp[i], cross=cr[i],
            save_spatial=nxt(sp, i), save_temporal=nxt(tp, i),
            save_cross=nxt(cr, i),
            mlp=ml[i], save_mlp=nxt(ml, i),
            mlp_spatial_save=ms_save[i], mlp_spatial_use=ms_use[i],
            mlp_temporal_save=mt_save[i], mlp_temporal_use=mt_use[i],
        )
        for i in range(n)
    ]


def mlp_config_blocks(config: Optional[PABConfig]) -> tuple[int, ...]:
    """Union of block indices appearing in the MLP broadcast configs: the
    only depths that ever need a dict-mode MLP cache row."""
    if config is None or not config.mlp_broadcast:
        return ()
    blocks = set()
    for cfg in (config.mlp_spatial_broadcast_config,
                config.mlp_temporal_broadcast_config):
        for spec in (cfg or {}).values():
            blocks.update(int(b) for b in spec["block"])
    return tuple(sorted(blocks))


def num_step_variants(plans: Sequence[PABStepPlan]) -> int:
    """Distinct plans in a plan list."""
    return len(set(plans))


@dataclasses.dataclass
class PABCache:
    """The PAB cache of one `generate` loop. `slots[branch][slot]` holds
    one row per depth. STDiT3: [depth, B, T, S, C] (branch "spatial" or
    "temporal" with slots "attn", "cross", "mlp"; or branch "pair" with
    slot "delta"), except a dict-mode MLP slot, which holds one row per
    configured block: `mlp_rows` maps a depth to its row. CogVideoX: the
    joint attention's output [depth, B, L + N, C] in slot "attn" of branch
    "spatial"."""

    slots: Dict[str, Dict[str, torch.Tensor]]
    mlp_rows: Dict[int, int]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for slots in self.slots.values() for t in slots.values())

    def views(self, plan: PABStepPlan, branch: str, depth: int):
        """(read, write): this step's cache views of one block, by slot."""
        read, write = {}, {}
        for slot, tensor in self.slots.get(branch, {}).items():
            mode = plan.slot_mode(branch, slot)
            if mode == "readwrite":  # dict-mode MLP: per-depth flags
                if depth not in self.mlp_rows:
                    continue
                row = tensor[self.mlp_rows[depth]]
                if getattr(plan, f"mlp_{branch}_use")[depth]:
                    read[slot] = row
                elif getattr(plan, f"mlp_{branch}_save")[depth]:
                    write[slot] = row
            elif mode == "read":
                read[slot] = tensor[depth]
            elif mode == "write":
                write[slot] = tensor[depth]
        return read, write

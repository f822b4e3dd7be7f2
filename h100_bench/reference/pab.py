"""A frozen copy of Pyramid Attention Broadcast's planner (Open-Sora's
PABManager counters, hpcai-tech VideoSys `pab_mgr.py`), for the reference
and for counting the FLOPs a PAB step executes.

Each step's plan says, for each (branch, depth), which cache slots the
step reads instead of computing them ("attn", "cross", "mlp") and which it
computes and writes for a later step. Decisions key on the timestep
rounded to the served dtype and truncated, as the reference sampler does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

Slots = Dict[Tuple[str, int], Set[str]]


@dataclass
class StepPlan:
    read: Slots = field(default_factory=dict)
    write: Slots = field(default_factory=dict)

    def reads(self, branch: str, depth: int) -> Set[str]:
        return self.read.get((branch, depth), set())

    def writes(self, branch: str, depth: int) -> Set[str]:
        return self.write.get((branch, depth), set())


def quantize(timesteps, dtype: torch.dtype) -> List[int]:
    t = torch.as_tensor(np.asarray(timesteps, np.float32)).to(dtype).float()
    return [int(x) for x in t.numpy()]


def _flags(on: bool, threshold, rng: int, ts: Sequence[int]) -> List[bool]:
    return [bool(on and i % rng != 0 and threshold[0] < t < threshold[1])
            for i, t in enumerate(ts)]


def _mlp(cfg, ts: Sequence[int], depth: int):
    n = len(ts)
    save = [[False] * depth for _ in range(n)]
    use = [[False] * depth for _ in range(n)]
    for key, spec in (cfg or {}).items():
        if int(key) not in ts:
            continue
        i = ts.index(int(key))
        blocks = [b for b in spec["block"] if b < depth]
        for b in blocks:
            save[i][b] = True
        for j in range(i + 1, min(i + 1 + int(spec["skip_count"]), n)):
            for b in blocks:
                use[j][b] = True
    return save, use


def plans(pab: dict, timesteps, depth: int, dtype: torch.dtype
          ) -> List[StepPlan]:
    """One plan a step for the component ladders (spatial, temporal,
    cross attention) and the MLP rows of the per-timestep tables."""
    ts = quantize(timesteps, dtype)
    n = len(ts)
    ladders = {
        "spatial": _flags(pab.get("spatial_broadcast", False),
                          pab.get("spatial_threshold", (0, 0)),
                          pab.get("spatial_range", 1), ts),
        "temporal": _flags(pab.get("temporal_broadcast", False),
                           pab.get("temporal_threshold", (0, 0)),
                           pab.get("temporal_range", 1), ts),
    }
    cross = _flags(pab.get("cross_broadcast", False),
                   pab.get("cross_threshold", (0, 0)),
                   pab.get("cross_range", 1), ts)
    mlp = {b: _mlp(pab.get(f"mlp_{b}_broadcast_config") if
                   pab.get("mlp_broadcast") else None, ts, depth)
           for b in ("spatial", "temporal")}

    def writes_next(flags, i):
        return (not flags[i]) and i + 1 < n and flags[i + 1]

    out = []
    for i in range(n):
        p = StepPlan()
        for branch in ("spatial", "temporal"):
            for d in range(depth):
                r, w = set(), set()
                for slot, flags in (("attn", ladders[branch]),
                                    ("cross", cross)):
                    if flags[i]:
                        r.add(slot)
                    elif writes_next(flags, i):
                        w.add(slot)
                save, use = mlp[branch]
                if use[i][d]:
                    r.add("mlp")
                elif save[i][d]:
                    w.add("mlp")
                if r:
                    p.read[(branch, d)] = r
                if w:
                    p.write[(branch, d)] = w
        out.append(p)
    return out


def writer(plans: Sequence[StepPlan], step: int, key, slot: str) -> int:
    """The last step before `step` that wrote `slot` of `key`."""
    for j in range(step - 1, -1, -1):
        if slot in plans[j].write.get(key, ()):
            return j
    raise ValueError(f"step {step} reads {key} {slot}, never written")


def closure(plans: Sequence[StepPlan], step: int) -> List[int]:
    """The steps whose outputs `step` reads, theirs in turn, and `step`:
    what the reference recomputes, each from the program's input, to
    follow the program into `step`."""
    need, todo = set(), [step]
    while todo:
        s = todo.pop()
        if s in need:
            continue
        need.add(s)
        for key, slots in plans[s].read.items():
            for slot in slots:
                todo.append(writer(plans, s, key, slot))
    return sorted(need)

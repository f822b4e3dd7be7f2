"""Checkpoint and resume for training.

Port of `videosys_tpu/training/ckpt.py` with the same directory layout: a
checkpoint is `epoch{E}-global_step{S}/` holding `state.pt` (model,
optimizer, EMA and the draws' generator; `torch.save` in place of orbax)
and `running_states.json` (epoch, step, sampler state).

Under ZeRO-1 and ZeRO-3 (an optimizer over ranks) every rank calls `save`:
the moment slices are gathered (under ZeRO-3 the parameters' and the EMA's
too), and rank 0 writes the same files a one-rank run writes. `load` reads
them at any world size and under either: each rank keeps its slice of the
moments (and under ZeRO-3 of the parameters and the EMA).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from videosys_tpu_torch.training.train_step import TrainState


def save(path: str, train_state: TrainState,
         ema_params: Optional[Dict[str, torch.Tensor]], epoch: int, step: int,
         sampler_state: Optional[dict] = None,
         extra: Optional[dict] = None,
         generator: Optional[torch.Generator] = None) -> str:
    ckpt_dir = os.path.abspath(
        os.path.join(path, f"epoch{epoch}-global_step{step}"))
    optimizer = train_state.tx.state_dict()  # a collective under ZeRO
    zero3 = train_state.tx.zero3
    if zero3 is not None:  # collectives too
        model = zero3.state_dict()
        if ema_params is not None:
            ema_params = zero3.gather_dict(ema_params)
    else:
        model = train_state.model.state_dict()
    groups = train_state.tx.groups
    if groups is not None and groups.rank != 0:
        return ckpt_dir
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = {"model": model, "optimizer": optimizer,
            "step": train_state.step, "ema": ema_params}
    if generator is not None:
        blob["generator"] = generator.get_state()
    torch.save(blob, os.path.join(ckpt_dir, "state.pt"))
    running = {"epoch": epoch, "step": step,
               "sampler": sampler_state, **(extra or {})}
    with open(os.path.join(ckpt_dir, "running_states.json"), "w") as f:
        json.dump(running, f)
    return ckpt_dir


def load(path: str, train_state: TrainState,
         generator: Optional[torch.Generator] = None
         ) -> Tuple[TrainState, Optional[dict], int, int, Optional[dict]]:
    """Restore a checkpoint directory into `train_state` (its model and
    optimizer are loaded in place, on their own device; `generator`, given,
    takes the saved state) and return (train_state, ema, epoch, step,
    sampler_state); under ZeRO-3 the EMA is this rank's (its slices)."""
    device = next(train_state.model.parameters()).device
    blob = torch.load(os.path.join(os.path.abspath(path), "state.pt"),
                      map_location=device, weights_only=True)
    zero3 = train_state.tx.zero3
    if zero3 is not None:
        zero3.load_state_dict(blob["model"])
        if blob["ema"] is not None:
            blob["ema"] = zero3.shard_dict(blob["ema"])
    else:
        train_state.model.load_state_dict(blob["model"])
    train_state.tx.load_state_dict(blob["optimizer"])
    train_state.step = int(blob["step"])
    if generator is not None and "generator" in blob:
        generator.set_state(blob["generator"].cpu())
    with open(os.path.join(path, "running_states.json")) as f:
        running = json.load(f)
    return (train_state, blob["ema"], running["epoch"], running["step"],
            running.get("sampler"))

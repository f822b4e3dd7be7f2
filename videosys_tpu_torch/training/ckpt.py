"""Checkpoint and resume for training.

Port of `videosys_tpu/training/ckpt.py` with the same directory layout: a
checkpoint is `epoch{E}-global_step{S}/` holding `state.pt` (model,
optimizer, EMA; `torch.save` in place of orbax) and `running_states.json`
(epoch, step, sampler state).
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
         extra: Optional[dict] = None) -> str:
    ckpt_dir = os.path.abspath(
        os.path.join(path, f"epoch{epoch}-global_step{step}"))
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({"model": train_state.model.state_dict(),
                "optimizer": train_state.tx.state_dict(),
                "step": train_state.step, "ema": ema_params},
               os.path.join(ckpt_dir, "state.pt"))
    running = {"epoch": epoch, "step": step,
               "sampler": sampler_state, **(extra or {})}
    with open(os.path.join(ckpt_dir, "running_states.json"), "w") as f:
        json.dump(running, f)
    return ckpt_dir


def load(path: str, train_state: TrainState
         ) -> Tuple[TrainState, Optional[dict], int, int, Optional[dict]]:
    """Restore a checkpoint directory into `train_state` (its model and
    optimizer are loaded in place, on their own device) and return
    (train_state, ema, epoch, step, sampler_state)."""
    device = next(train_state.model.parameters()).device
    blob = torch.load(os.path.join(os.path.abspath(path), "state.pt"),
                      map_location=device, weights_only=True)
    train_state.model.load_state_dict(blob["model"])
    train_state.tx.load_state_dict(blob["optimizer"])
    train_state.step = int(blob["step"])
    with open(os.path.join(path, "running_states.json")) as f:
        running = json.load(f)
    return (train_state, blob["ema"], running["epoch"], running["step"],
            running.get("sampler"))

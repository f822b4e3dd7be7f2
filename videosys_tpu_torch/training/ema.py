"""Exponential moving average of the model's parameters.

Port of `videosys_tpu/training/ema.py`: the EMA is a dict of fp32 tensors
by parameter name, a copy that shares no storage with the model.
`update_ema` updates it in place. Over ranks the parameters are replicated
(ZeRO-1 shards the moments only), and so is the EMA: every rank keeps it.
"""

from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn as nn

Params = Union[nn.Module, Dict[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def init_ema(params: Params) -> Dict[str, torch.Tensor]:
    """fp32 copy of the parameters (a module or a name -> tensor dict)."""
    return {k: v.detach().to(torch.float32, copy=True)
            for k, v in _named(params).items()}


@torch.no_grad()
def update_ema(ema_params: Dict[str, torch.Tensor], params: Params,
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """ema <- decay * ema + (1 - decay) * params, in fp32, in place; returns
    `ema_params`."""
    named = _named(params)
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    new = [named[k].detach().to(torch.float32) for k in keys]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, new, alpha=1.0 - decay)
    return ema_params

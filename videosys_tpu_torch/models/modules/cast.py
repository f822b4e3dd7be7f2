"""Linear layers that hold their parameters in one dtype and compute in
another: the JAX package's `nn.Dense(dtype=...)` rule. Training keeps fp32
master weights and casts weight, bias and input to the compute dtype (bf16)
at each use, so gradients arrive in fp32. With no compute dtype set the
layer is `torch.nn.Linear`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None or dt == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Set the compute dtype of every `Linear` under `module`."""
    for m in module.modules():
        if isinstance(m, Linear):
            m.compute_dtype = dtype


def compute_dtype_of(linear: Linear) -> torch.dtype:
    """The dtype `linear` computes in."""
    return linear.compute_dtype or linear.weight.dtype

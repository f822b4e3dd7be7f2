"""Attention dispatch: the CUDA flash kernels for CUDA tensors, plain
attention on the CPU.

Port of `videosys_tpu/ops/attention.py`. Its size thresholds were tuned on
a TPU and are not carried over: on CUDA every call goes to the kernels,
temporal (N = 15) and cross attention (Nk <= 300) included, forward and,
when an input needs a gradient, backward; a shape the kernels cannot take
(head_dim > 512 forward, > 128 backward) raises. A CUDA tensor never
reaches a plain version. `.contiguous()` on the heads is a differentiable
copy, so the graph is kept; with `force_flash` on the CPU a call that needs
gradients goes through `FlashAttentionFunction` and its plain backward
versions, otherwise `reference_attention` is differentiated by autograd.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from videosys_tpu_torch.ops.flash_attention import flash_attention


def reference_attention(q, k, v, scale: Optional[float] = None,
                        kv_mask: Optional[torch.Tensor] = None):
    """Plain attention with an fp32 softmax; masked keys score -1e9.
    q, k, v: [B, H, N, D]; kv_mask: [B, Nk] bool, True = attend."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q * scale, k.transpose(-1, -2)).float()
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], -1e9)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def scaled_dot_product_attention(q, k, v, scale: Optional[float] = None,
                                 kv_mask: Optional[torch.Tensor] = None,
                                 force_flash: Optional[bool] = None):
    """q: [B, H, Nq, D]; k, v: [B, H, Nk, D]; kv_mask: optional [B, Nk]
    bool (True = attend). CUDA tensors always launch the kernel. On the CPU
    `reference_attention` runs unless `force_flash` (or, when it is None,
    the VIDEOSYS_FORCE_FLASH environment variable) asks for the kernel's
    plain version; forcing the kernel off on CUDA tensors raises."""
    if force_flash is None:
        env = os.environ.get("VIDEOSYS_FORCE_FLASH")
        if env is not None:
            force_flash = env not in ("0", "false", "")
    if q.device.type == "cuda":
        if force_flash is False:
            raise ValueError("CUDA tensors always take the flash kernel: "
                             "force_flash=False (VIDEOSYS_FORCE_FLASH=0) "
                             "only applies on the CPU")
        force_flash = True
    if force_flash:
        if kv_mask is not None:
            kv_mask = kv_mask.contiguous()
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               scale=scale, kv_mask=kv_mask)
    return reference_attention(q, k, v, scale=scale, kv_mask=kv_mask)

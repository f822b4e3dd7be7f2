"""Plain PyTorch building blocks of the references, in float32 with TF32
off, on weights held by name.

`Ops(weights, precision)`: every product (linear, convolution, attention)
and every residual sum goes through one place, so that the control runs
the same code one step below the configuration's precision (bfloat16):
with `precision="fp8"` what the served model holds in its own dtype, each
product's inputs and output and the residual stream after each sum, is
rounded to float8 e4m3 with one scale a tensor (its largest magnitude at
448); the products accumulate and the norms compute in float32.

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
# score rows computed at once by `attention`: bounds its memory to about
# ATTN_CHUNK_ELEMS floats
ATTN_CHUNK_ELEMS = 1 << 28


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale, back in float32."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    def __init__(self, weights: Dict[str, torch.Tensor], precision: str,
                 device: torch.device):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.w = weights
        self.precision = precision
        self.device = device

    def p(self, name: str) -> torch.Tensor:
        """A weight in float32 on the device."""
        return self.w[name].to(self.device, torch.float32)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor held at the run's precision."""
        t = t.float()
        return fp8_round(t) if self.precision == "fp8" else t

    def add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """A residual sum, held at the run's precision."""
        return self.q(x + y)

    def linear(self, x: torch.Tensor, prefix: str, bias: bool = True):
        b = self.p(prefix + ".bias") if bias else None
        return self.q(F.linear(self.q(x), self.q(self.p(prefix + ".weight")),
                               b))

    def conv(self, fn, x: torch.Tensor, prefix: str, bias: bool = True,
             **kw):
        b = self.p(prefix + ".bias") if bias else None
        return self.q(fn(self.q(x), self.q(self.p(prefix + ".weight")), b,
                         **kw))

    def attention(self, q, k, v, scale: float,
                  kv_mask: Optional[torch.Tensor] = None):
        """q [B, H, Nq, D], k, v [B, H, Nk, D]; kv_mask [B, Nk] bool (True =
        attend). Softmax over the live keys, in blocks of query rows."""
        q, k, v = self.q(q), self.q(k), self.q(v)
        B, H, Nq, D = q.shape
        Nk = k.shape[2]
        out = torch.empty(B, H, Nq, v.shape[-1], device=q.device,
                          dtype=torch.float32)
        bias = None
        if kv_mask is not None:
            bias = torch.zeros(B, 1, 1, Nk, device=q.device)
            bias.masked_fill_(~kv_mask[:, None, None, :], float("-inf"))
        # whole rows of several batch entries, or blocks of one entry's rows
        per_b = H * Nq * Nk
        bc = max(1, ATTN_CHUNK_ELEMS // per_b)
        rows = Nq if bc > 1 else max(1, ATTN_CHUNK_ELEMS // (H * Nk))
        for b in range(0, B, bc):
            for i in range(0, Nq, rows):
                s = torch.matmul(q[b:b + bc, :, i:i + rows],
                                 k[b:b + bc].transpose(-1, -2)) * scale
                if bias is not None:
                    s = s + bias[b:b + bc]
                p = torch.softmax(s, dim=-1)
                out[b:b + bc, :, i:i + rows] = torch.matmul(self.q(p),
                                                            v[b:b + bc])
        return self.q(out)


def layer_norm(x, eps: float, weight=None, bias=None):
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias, eps)


def group_norm(x, groups: int, weight, bias, eps: float):
    return F.group_norm(x.float(), groups, weight, bias, eps)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoid of t, cos first: [N] -> [N, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))

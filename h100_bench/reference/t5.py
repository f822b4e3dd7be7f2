"""Plain float32 reference of the T5-v1.1 encoder, the text encoder of
Open-Sora v1.2 and CogVideoX (DeepFloyd/t5-v1_1-xxl).

A frozen, independent copy of the encoder's equations (Hugging Face's
`T5EncoderModel`): the token embedding, then in each block an RMS norm
(no mean, no bias), self-attention with unscaled scores plus the relative
position bias of block 0 (bidirectional buckets, shared by every block)
and the padded keys masked, a residual sum, an RMS norm, the gated-gelu
feed-forward (tanh gelu of wi_0 times wi_1, then wo) and a residual sum;
a final RMS norm. Written on weights held by name (HF's key names, the
embedding under `shared.weight`); every product and residual sum goes
through `common.Ops`, so the control is this code one precision down.
Imports torch only: nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import Ops


def position_buckets(length: int, num_buckets: int, max_distance: int,
                     device) -> torch.Tensor:
    """[L, L] bucket of key position minus query position."""
    pos = torch.arange(length, device=device)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    out = (rel > 0).long() * half
    rel = rel.abs()
    exact = half // 2
    far = exact + (torch.log(rel.float().clamp(min=1) / exact)
                   / math.log(max_distance / exact)
                   * (half - exact)).long()
    return out + torch.where(rel < exact, rel, far.clamp(max=half - 1))


class T5Encoder:
    def __init__(self, ops: Ops, cfg: dict):
        self.o = ops
        self.c = cfg

    def rms(self, x, name):
        x = x.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                            + self.c["layer_norm_epsilon"])
        return self.o.p(name) * x

    def attention(self, x, prefix, bias):
        B, L, _ = x.shape
        H, D = self.c["num_heads"], self.c["d_kv"]

        def heads(name):
            y = self.o.linear(x, f"{prefix}.{name}", bias=False)
            return self.o.q(y.view(B, L, H, D).transpose(1, 2))

        q, k, v = heads("q"), heads("k"), heads("v")
        p = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        out = self.o.q(self.o.q(p) @ v)
        return self.o.linear(out.transpose(1, 2).reshape(B, L, H * D),
                             f"{prefix}.o", bias=False)

    def feed_forward(self, x, prefix):
        gate = F.gelu(self.o.linear(x, f"{prefix}.wi_0", bias=False),
                      approximate="tanh")
        up = self.o.linear(x, f"{prefix}.wi_1", bias=False)
        return self.o.linear(gate * up, f"{prefix}.wo", bias=False)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids [B, L] int, mask [B, L] bool (True = a token) -> the last
        hidden state [B, L, d_model], every row (padded rows too)."""
        c = self.c
        L = ids.shape[1]
        x = self.o.q(self.o.p("shared.weight")[ids])
        table = self.o.p(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
            ".weight")
        buckets = position_buckets(L, c["relative_attention_num_buckets"],
                                   c["relative_attention_max_distance"],
                                   ids.device)
        bias = table[buckets].permute(2, 0, 1)[None]
        bias = bias.masked_fill(~mask[:, None, None, :], float("-inf"))
        for i in range(c["num_layers"]):
            p = f"encoder.block.{i}.layer"
            x = self.o.add(x, self.attention(
                self.rms(x, f"{p}.0.layer_norm.weight"),
                f"{p}.0.SelfAttention", bias))
            x = self.o.add(x, self.feed_forward(
                self.rms(x, f"{p}.1.layer_norm.weight"),
                f"{p}.1.DenseReluDense"))
        return self.o.q(self.rms(x, "encoder.final_layer_norm.weight"))

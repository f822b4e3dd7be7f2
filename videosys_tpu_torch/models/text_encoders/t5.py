"""Text encoders: the T5 encoder and an offline deterministic stub.

Port of `videosys_tpu/models/text_encoders/t5.py`. `T5EncoderModel` is the
T5 encoder stack written here in PyTorch, with Hugging Face's `state_dict`
key names, so a local HF T5 snapshot (`DeepFloyd/t5-v1_1-xxl`: v1.1, XXL,
gated-gelu) loads into it as it is. mT5 snapshots (`google/mt5-xxl`, Open-Sora-Plan
v1.2's captions) load the same way. `T5TextEncoder` wraps it with the
snapshot's tokenizer: `encode(texts)` -> (last_hidden_state [B, L, d_model],
mask [B, L]), padded and truncated to `max_length` (the reference's
get_text_embeddings, max_length 300). `StubTextEncoder` hashes words to
fixed gaussian vectors with the same contract, so the pipeline runs
without weights.

T5 attention adds a relative position bias to unscaled scores (1/sqrt(d)
is folded into the weights); it runs as plain matmul / softmax / matmul, as
the JAX package runs it in XLA outside its flash kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.core.pipeline import offload_to_host, on_device, resolve_device
from videosys_tpu_torch.utils import safetensors_io
from videosys_tpu_torch.utils.timing import T5, span

# feed_forward_proj -> the feed-forward activation; a "gated-" one runs
# act(wi_0 x) * wi_1 x. HF's gated-gelu is gelu_new, the tanh form.
_ACTS = {"relu": F.relu,
         "gated-gelu": functools.partial(F.gelu, approximate="tanh")}


@dataclasses.dataclass(frozen=True)
class T5Config:
    """The fields of an HF T5 or mT5 `config.json` the encoder reads; the
    defaults are T5-v1.1-XXL's. `feed_forward_proj`: "gated-gelu" (v1.1 and
    mT5, the tanh gelu on wi_0 times wi_1) or "relu" (v1.0). mT5 differs
    only in its vocabulary (250112) and in untied input and output
    embeddings, which an encoder does not see: its input embedding is
    `shared` either way."""

    MODEL_TYPES = ("t5", "mt5")

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    model_type: str = "t5"

    @classmethod
    def from_json(cls, path: str) -> "T5Config":
        with open(path) as f:
            raw = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})

    def __post_init__(self):
        if self.model_type not in self.MODEL_TYPES:
            raise ValueError(f"model_type {self.model_type!r} is not one of "
                             f"{self.MODEL_TYPES}")
        if self.feed_forward_proj not in _ACTS:
            raise ValueError(f"feed_forward_proj {self.feed_forward_proj!r} "
                             f"is not one of {sorted(_ACTS)}")

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 buckets of integer relative positions (memory -
    query): half the buckets for each sign, exact below num_buckets / 4,
    logarithmic up to max_distance, in float32 as HF and Flax compute
    them (call it on the CPU: an ulp of another device's log could move a
    bucket at an integer boundary)."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class T5LayerNorm(nn.Module):
    """RMS norm with no mean and no bias; the variance in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps)
        return self.weight * x.to(self.weight.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def position_bias(self, length: int) -> torch.Tensor:
        """[1, H, L, L] bias of the relative position of key to query."""
        pos = torch.arange(length)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        weight = self.relative_attention_bias.weight
        return weight[buckets.to(weight.device)].permute(2, 0, 1)[None]

    def forward(self, x, bias):
        B, L, _ = x.shape
        H, D = self.cfg.num_heads, self.cfg.d_kv

        def heads(t):
            return t.view(B, L, H, D).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = q @ k.transpose(-1, -2) + bias
        weights = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        return self.o((weights @ v).transpose(1, 2).reshape(B, L, H * D))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)
        self.act = _ACTS[cfg.feed_forward_proj]

    def forward(self, x):
        return self.wo(self.act(self.wi(x)))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)
        self.act = _ACTS[cfg.feed_forward_proj]

    def forward(self, x):
        return self.wo(self.act(self.wi_0(x)) * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = (T5DenseGatedActDense(cfg) if cfg.is_gated
                               else T5DenseActDense(cfg))
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(cfg, has_relative_attention_bias),
            T5LayerFF(cfg)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, embed_tokens: nn.Embedding):
        super().__init__()
        self.embed_tokens = embed_tokens
        # block 0 holds the relative bias every layer shares
        self.block = nn.ModuleList(T5Block(cfg, i == 0)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids, attention_mask=None):
        x = self.embed_tokens(input_ids)
        bias = self.block[0].layer[0].SelfAttention.position_bias(
            input_ids.shape[1])
        if attention_mask is not None:  # padded keys get finfo.min
            masked = torch.where(attention_mask.bool(), 0.0,
                                 torch.finfo(x.dtype).min)
            bias = bias + masked[:, None, None, :].to(x.dtype)
        for block in self.block:
            x = block(x, bias)
        return self.final_layer_norm(x)


class T5EncoderModel(nn.Module):
    """The T5 encoder: forward(input_ids [B, L], attention_mask [B, L]) ->
    last_hidden_state [B, L, d_model]. Keys as HF's `T5EncoderModel`:
    `shared.weight` (also `encoder.embed_tokens.weight`, the same tensor),
    `encoder.block.{i}.layer.{0,1}...`, `encoder.final_layer_norm.weight`.
    Weights are drawn as HF initializes them."""

    def __init__(self, config: T5Config = T5Config()):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config, self.shared)
        self._init_weights()

    def _init_weights(self):
        cfg = self.config
        d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
        with torch.no_grad():
            self.shared.weight.normal_(0.0, 1.0)
            for name, p in self.encoder.block.named_parameters():
                if "layer_norm" in name:
                    continue  # ones
                std = {"q": (d * cfg.d_kv) ** -0.5, "o": inner ** -0.5,
                       "wo": cfg.d_ff ** -0.5}.get(name.split(".")[-2], d ** -0.5)
                p.normal_(0.0, std)

    def forward(self, input_ids, attention_mask=None):
        with span(T5):
            return self.encoder(input_ids, attention_mask)

    @classmethod
    def from_pretrained(cls, path: str, dtype: torch.dtype = torch.float32
                        ) -> "T5EncoderModel":
        """The encoder of a local HF snapshot (`config.json` plus
        safetensors or pytorch_model*.bin, sharded or not), on the host in
        `dtype` (cast one tensor at a time)."""
        config = T5Config.from_json(os.path.join(path, "config.json"))
        sd = safetensors_io.load_dir(path)
        if sd is None:
            raise FileNotFoundError(f"no T5 weights (*.safetensors or "
                                    f"pytorch_model*.bin) in {path!r}")
        with torch.device("meta"):
            model = cls(config)
        model.load_state_dict(encoder_state_dict(sd, dtype), assign=True)
        return model


def encoder_state_dict(sd: Mapping[str, torch.Tensor],
                       dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, torch.Tensor]:
    """An HF T5 state_dict as `T5EncoderModel` loads it strictly: a full
    encoder-decoder's `decoder.*` and `lm_head.*` dropped, the tied
    embedding under both of its names, each tensor cast to `dtype`."""
    out = {k: (v.to(dtype) if dtype is not None else v) for k, v in sd.items()
           if not k.startswith(("decoder.", "lm_head."))}
    shared = out.get("shared.weight", out.get("encoder.embed_tokens.weight"))
    if shared is not None:
        out["shared.weight"] = out["encoder.embed_tokens.weight"] = shared
    return out


class T5TextEncoder:
    """T5 encoder plus its tokenizer, on `device` (None: the card).

    `path`: a local HF snapshot; the tokenizer comes from transformers'
    `AutoTokenizer` (imported here only), the weights from
    `T5EncoderModel.from_pretrained`. A ready `tokenizer` (called as HF
    tokenizers are, returning numpy "input_ids" and "attention_mask") and
    `model` may be passed instead. The model is held in `dtype`.
    `offload`: the weights stay on the host and are fetched onto the device
    for each `encode` only (the pipeline's cpu_offload)."""

    def __init__(self, path: Optional[str] = None, max_length: int = 300,
                 dtype: torch.dtype = torch.float32, offload: bool = False,
                 device=None, tokenizer=None,
                 model: Optional[T5EncoderModel] = None):
        self.device = resolve_device(device)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(path,
                                                      local_files_only=True)
        if model is None:
            model = T5EncoderModel.from_pretrained(path, dtype)
        if offload:
            offload_to_host(model, self.device.type == "cuda", dtype)
        else:
            model.to(self.device, dtype)
        model.eval().requires_grad_(False)
        self.tokenizer, self.model = tokenizer, model
        self.max_length = max_length
        self.offload = offload
        self.output_dim = model.config.d_model

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        tok = self.tokenizer(
            list(texts), max_length=self.max_length, padding="max_length",
            truncation=True, return_attention_mask=True,
            add_special_tokens=True, return_tensors="np")
        ids = torch.from_numpy(np.asarray(tok["input_ids"])).to(self.device)
        mask = torch.from_numpy(np.asarray(tok["attention_mask"])).to(
            self.device).bool()
        fetch = (on_device(self.model, self.device, "text_encoder")
                 if self.offload else contextlib.nullcontext())
        with fetch:
            hidden = self.model(ids, mask)
        return hidden, mask


class StubTextEncoder:
    def __init__(self, output_dim: int = 4096, max_length: int = 300,
                 device=None):
        """`device`: where `encode` puts its outputs; None is the card, and
        a CUDA device without a card raises (pass "cpu" to run there)."""
        self.output_dim = output_dim
        self.max_length = max_length
        self.device = resolve_device(device)

    def _word_vec(self, word: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
        return np.random.default_rng(seed).standard_normal(self.output_dim).astype(np.float32)

    def encode(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L = len(texts), self.max_length
        embs = np.zeros((B, L, self.output_dim), np.float32)
        mask = np.zeros((B, L), bool)
        for i, text in enumerate(texts):
            words = text.split()[: L - 1] if text else []
            for j, w in enumerate(words):
                embs[i, j] = self._word_vec(w)
            embs[i, len(words)] = self._word_vec("</s>")
            mask[i, : len(words) + 1] = True
        return (torch.from_numpy(embs).to(self.device),
                torch.from_numpy(mask).to(self.device))

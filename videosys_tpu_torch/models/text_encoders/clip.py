"""CLIP text encoders and the CLIP-L + CLIP-G + T5 trio of Vchitect-2.0.

Port of `videosys_tpu/models/text_encoders/clip.py`. `CLIPTextModelWithProjection`
is the CLIP text tower written here in PyTorch with Hugging Face's
`state_dict` key names (`text_model.embeddings.{token,position}_embedding`,
`text_model.encoder.layers.{i}.{self_attn.{q,k,v,out}_proj, layer_norm1,
layer_norm2, mlp.fc1, mlp.fc2}`, `text_model.final_layer_norm`,
`text_projection`), so a local HF snapshot loads as it is. Its attention is
causal and runs as plain matmul / softmax / matmul, as transformers' CLIP
computes it in the JAX package (it was never a Pallas kernel).

The SD3 packing (the reference pipeline's encode_prompt): each CLIP gives
hidden_states[-2] (clip_skip None) and its projected pooled vector, pooled
at `input_ids.argmax(-1)` as HF's Flax CLIP pools; the two CLIPs'
embeddings are concatenated on channels and zero-padded to the T5 width,
then stacked with the T5's on the sequence axis; the pooled vectors are
concatenated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videosys_tpu_torch.core.pipeline import offload_to_host, on_device, resolve_device
from videosys_tpu_torch.models.text_encoders.t5 import T5EncoderModel, T5TextEncoder
from videosys_tpu_torch.utils import safetensors_io


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


# config.json's hidden_act -> the MLP activation ("gelu" is the exact one)
_ACTS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """HF's CLIPTextConfig; the defaults are CLIP ViT-L/14's text tower
    (SD3's `text_encoder`). CLIP-bigG (`text_encoder_2`): hidden 1280,
    intermediate 5120, 32 layers, 20 heads, projection 1280, "gelu"."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    projection_dim: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    def __post_init__(self):
        if self.hidden_act not in _ACTS:
            raise ValueError(f"hidden_act {self.hidden_act!r} not in "
                             f"{tuple(_ACTS)}")

    @classmethod
    def from_json(cls, path: str) -> "CLIPTextConfig":
        with open(path) as f:
            raw = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        C = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)
        self.v_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, C)

    def forward(self, x):
        B, L, C = x.shape
        H = self.num_heads
        D = C // H

        def heads(t):
            return t.reshape(B, L, H, D).transpose(1, 2)

        q = heads(self.q_proj(x) * D ** -0.5)
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        s = torch.matmul(q, k.transpose(-1, -2)).float()
        s = s.masked_fill(~causal, torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        return self.out_proj(torch.matmul(p, v).transpose(1, 2).reshape(B, L, C))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _ACTS[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class CLIPTextModelWithProjection(nn.Module):
    """forward(input_ids [B, L]) -> (hidden_states[-2] [B, L, C], the
    projected pooled vector [B, projection_dim]). Weights are drawn as HF
    initializes them (factor 1)."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)
        self.text_projection = nn.Linear(config.hidden_size,
                                         config.projection_dim, bias=False)
        self._init_weights()

    def _init_weights(self):
        cfg = self.config
        C, n = cfg.hidden_size, cfg.num_hidden_layers
        in_std = C ** -0.5 * (2 * n) ** -0.5
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.split(".")[-2]
                if "layer_norm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                elif leaf in ("token_embedding", "position_embedding"):
                    p.normal_(0.0, 0.02)
                elif leaf in ("fc1", "out_proj", "text_projection"):
                    p.normal_(0.0, (2 * C if leaf == "fc1" else C) ** -0.5)
                else:  # q, k, v projections and fc2
                    p.normal_(0.0, in_std)

    def forward(self, input_ids):
        tm = self.text_model
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + \
            tm.embeddings.position_embedding(pos)[None]
        for layer in tm.encoder.layers[:-1]:
            x = layer(x)
        penultimate = x
        last = tm.final_layer_norm(tm.encoder.layers[-1](x))
        pooled = last[torch.arange(x.shape[0], device=x.device),
                      input_ids.argmax(-1)]
        return penultimate, self.text_projection(pooled)

    @classmethod
    def from_pretrained(cls, path: str, dtype: torch.dtype = torch.float32
                        ) -> "CLIPTextModelWithProjection":
        """The model of a local HF snapshot folder (`config.json` plus
        safetensors or pytorch_model*.bin), on the host in `dtype`."""
        config = CLIPTextConfig.from_json(os.path.join(path, "config.json"))
        sd = safetensors_io.load_dir(path)
        if sd is None:
            raise FileNotFoundError(f"no CLIP weights (*.safetensors or "
                                    f"pytorch_model*.bin) in {path!r}")
        sd = {k: v.to(dtype) for k, v in sd.items()
              if k != "text_model.embeddings.position_ids"}
        with torch.device("meta"):
            model = cls(config)
        model.load_state_dict(sd, assign=True)
        return model


def _hf_tokenizer(path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, local_files_only=True)


class ClipTextEncoder:
    """One CLIP of the trio with its tokenizer, on `device` (None: the
    card): `encode(texts)` -> (hidden_states[-2] [B, 77, C], projected
    pooled [B, P]). `path`: a local snapshot whose `subfolder_tok` holds the
    tokenizer (transformers' `AutoTokenizer`, imported here only) and
    `subfolder_enc` the model; or pass a ready `tokenizer` (called as HF
    tokenizers are) and `model`. `offload`: the weights stay on the host
    and are fetched for each `encode`."""

    def __init__(self, path: Optional[str] = None,
                 subfolder_tok: str = "tokenizer",
                 subfolder_enc: str = "text_encoder", max_length: int = 77,
                 dtype: torch.dtype = torch.float32, offload: bool = False,
                 device=None, tokenizer=None,
                 model: Optional[CLIPTextModelWithProjection] = None):
        self.device = resolve_device(device)
        if tokenizer is None:
            tokenizer = _hf_tokenizer(os.path.join(path, subfolder_tok))
        if model is None:
            model = CLIPTextModelWithProjection.from_pretrained(
                os.path.join(path, subfolder_enc), dtype)
        if offload:
            offload_to_host(model, self.device.type == "cuda", dtype)
        else:
            model.to(self.device, dtype)
        model.eval().requires_grad_(False)
        self.tokenizer, self.model = tokenizer, model
        self.max_length = max_length
        self.offload = offload
        self.hidden_dim = model.config.hidden_size
        self.pooled_dim = model.config.projection_dim

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        tok = self.tokenizer(list(texts), padding="max_length",
                             max_length=self.max_length, truncation=True,
                             return_tensors="np")
        ids = torch.from_numpy(np.asarray(tok["input_ids"])).long().to(
            self.device)
        fetch = (on_device(self.model, self.device, "text_encoder")
                 if self.offload else contextlib.nullcontext())
        with fetch:
            return self.model(ids)


def pack_sd3_embeds(emb_l, pool_l, emb_g, pool_g, t5_embeds):
    """The SD3 packing: (prompt_embeds [B, L_clip + L_t5, t5 width], pooled
    [B, P_l + P_g])."""
    clip_embeds = torch.cat([emb_l, emb_g], dim=-1)
    clip_embeds = F.pad(clip_embeds,
                        (0, t5_embeds.shape[-1] - clip_embeds.shape[-1]))
    return (torch.cat([clip_embeds, t5_embeds], dim=-2),
            torch.cat([pool_l, pool_g], dim=-1))


class VchitectTripleTextEncoder:
    """CLIP-L + CLIP-G + T5 with the SD3 packing the Vchitect transformer
    takes: `encode_dual(texts)` -> (prompt_embeds [B, 77 + t5_max_length,
    joint_dim], pooled [B, P_l + P_g]), the contract of the offline
    `DualStubTextEncoder`. `model_path`: a local Vchitect snapshot
    (`tokenizer{,_2,_3}/`, `text_encoder{,_2,_3}/`; the T5's tokenizer is
    read from `text_encoder_3/` when `tokenizer_3/` is absent, where the
    JAX package reads it); or pass the three encoders ready."""

    def __init__(self, model_path: Optional[str] = None,
                 t5_max_length: int = 256, dtype: torch.dtype = torch.float32,
                 offload: bool = False, device=None,
                 clip_l: Optional[ClipTextEncoder] = None,
                 clip_g: Optional[ClipTextEncoder] = None,
                 t5: Optional[T5TextEncoder] = None):
        kw = dict(dtype=dtype, offload=offload, device=device)
        self.clip_l = clip_l or ClipTextEncoder(model_path, "tokenizer",
                                                "text_encoder", **kw)
        self.clip_g = clip_g or ClipTextEncoder(model_path, "tokenizer_2",
                                                "text_encoder_2", **kw)
        if t5 is None:
            enc_dir = os.path.join(model_path, "text_encoder_3")
            tok_dir = os.path.join(model_path, "tokenizer_3")
            t5 = T5TextEncoder(
                max_length=t5_max_length,
                tokenizer=_hf_tokenizer(tok_dir if os.path.isdir(tok_dir)
                                        else enc_dir),
                model=T5EncoderModel.from_pretrained(enc_dir, dtype), **kw)
        self.t5 = t5

    def encode_dual(self, texts: Sequence[str]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        emb_l, pool_l = self.clip_l.encode(texts)
        emb_g, pool_g = self.clip_g.encode(texts)
        t5_embeds, _ = self.t5.encode(texts)
        return pack_sd3_embeds(emb_l, pool_l, emb_g, pool_g, t5_embeds)

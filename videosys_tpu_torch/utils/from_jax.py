"""Carry the JAX package's Flax parameters over to this package.

`stdit3_from_jax`, `open_sora_vae_from_jax`, `t5_from_jax`,
`cogvideox_from_jax` and `cogvideox_vae_from_jax` take a Flax param tree as
numpy arrays (nested dicts) and return a state_dict for the modules here:

* a Dense kernel [in, out] becomes a Linear weight [out, in];
* a Conv kernel HWIO / THWIO becomes OIHW / OITHW;
* GroupNorm `scale` and an Embed `embedding` become `weight`;
* the `nn.scan`-stacked `blocks` axis 0 becomes one module per layer;
* module names are mapped onto the reference checkpoint's names, which this
  package uses.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a.b.c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def to_torch_leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """Map one Flax leaf (by its last name) to its torch name and layout."""
    head, _, leaf = name.rpartition(".")
    prefix = head + "." if head else ""
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        else:  # [*K, I, O] -> [O, I, *K]
            nd = value.ndim
            value = value.transpose((nd - 1, nd - 2) + tuple(range(nd - 2)))
        return prefix + "weight", np.ascontiguousarray(value)
    if leaf == "scale":
        return prefix + "weight", value
    return name, value


def convert(tree: Mapping, renames: Iterable[Tuple[str, str]] = ()
            ) -> Dict[str, np.ndarray]:
    """Flatten a Flax tree, rename its module paths by the (regex,
    replacement) pairs in order, and convert every leaf."""
    out = {}
    for name, value in flatten(tree).items():
        for pat, rep in renames:
            name = re.sub(pat, rep, name)
        key, val = to_torch_leaf(name, value)
        out[key] = val
    return out


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


STDIT3_RENAMES = (
    (r"(^|\.)mlp_(\d)\.", r"\1mlp.\2."),  # Sequential(Linear, SiLU, Linear)
    (r"^t_block\.", "t_block.1."),
    (r"^final_linear\.", "final_layer.linear."),
    (r"^final_scale_shift_table$", "final_layer.scale_shift_table"),
)


def stdit3_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """STDiT3 Flax params ({"params": ...} or the inner tree) -> state_dict
    of `models.transformers.stdit3.STDiT3`. A gradient tree of the same
    structure maps the same way (each layout change is a transpose), to
    gradients by parameter name."""
    p = dict(_params(params))
    blocks = p.pop("blocks")
    sd = convert(p, STDIT3_RENAMES)
    for branch in ("spatial", "temporal"):
        stacked = flatten(blocks[branch])
        depth = next(iter(stacked.values())).shape[0]
        for i in range(depth):
            layer = {k: v[i] for k, v in stacked.items()}
            for name, value in layer.items():
                key, val = to_torch_leaf(name, value)
                sd[f"{branch}_blocks.{i}.{key}"] = val
    return sd


_VAE2D_RENAMES = (
    (r"^down_(\d+)_res_(\d+)\.", r"down_blocks.\1.resnets.\2."),
    (r"^down_(\d+)_downsample\.", r"down_blocks.\1.downsamplers.0.conv."),
    (r"^mid_res_(\d)\.", r"mid_block.resnets.\1."),
    (r"^mid_attn\.to_out\.", "mid_block.attentions.0.to_out.0."),
    (r"^mid_attn\.", "mid_block.attentions.0."),
    (r"^up_(\d+)_res_(\d+)\.", r"up_blocks.\1.resnets.\2."),
    (r"^up_(\d+)_upsample\.", r"up_blocks.\1.upsamplers.0.conv."),
)

_VAE_TEMPORAL_RENAMES = (
    (r"^first_res_(\d+)\.", r"res_blocks.\1."),  # decoder
    (r"^final_res_(\d+)\.", r"res_blocks.\1."),  # encoder
    (r"^conv_down_(\d+)\.", r"conv_blocks.\1."),
    (r"^block_(\d+)_res_(\d+)\.", r"block_res_blocks.\1.\2."),
    (r"^conv_up_(\d+)\.", r"conv_blocks.\1."),
)


def open_sora_vae_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """OpenSoraVAE Flax params {"spatial": ..., "temporal": ...} -> the
    state_dict of `models.autoencoders.autoencoder_open_sora.OpenSoraVAE`:
    encoder, decoder, quant_conv and post_quant_conv of both stages."""
    sd = {}
    for part, renames, prefix in (
            ("spatial", _VAE2D_RENAMES, "spatial_vae.module."),
            ("temporal", _VAE_TEMPORAL_RENAMES, "temporal_vae.")):
        p = _params(params[part])
        for coder in ("encoder", "decoder"):
            sd.update({f"{prefix}{coder}.{k}": v
                       for k, v in convert(p[coder], renames).items()})
        sd.update({prefix + k: v for k, v in convert(
            {c: p[c] for c in ("quant_conv", "post_quant_conv")}).items()})
    return sd


def t5_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """FlaxT5EncoderModel params -> the state_dict of
    `models.text_encoders.t5.T5EncoderModel` (HF's names: Flax's module
    paths are the same), the tied embedding under both of its names."""
    sd = convert(_params(params), ((r"\.embedding$", ".weight"),))
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    return sd


_COGVIDEOX_RENAMES = (
    (r"^patch_proj\.", "patch_embed.proj."),
    (r"^text_proj\.", "patch_embed.text_proj."),
    (r"^time_embedding\.mlp_0\.", "time_embedding.linear_1."),
    (r"^time_embedding\.mlp_2\.", "time_embedding.linear_2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
    (r"^norm_out_norm\.", "norm_out.norm."),
)

_COGVIDEOX_BLOCK_RENAMES = (
    (r"^attn1\.to_out\.", "attn1.to_out.0."),
    (r"^ff_in\.", "ff.net.0.proj."),
    (r"^ff_out\.", "ff.net.2."),
)


def cogvideox_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """CogVideoXTransformer3D Flax params ({"params": ...} or the inner
    tree) -> state_dict of `models.transformers.cogvideox`, the
    scan-stacked `blocks.block` axis 0 becoming `transformer_blocks.{i}`."""
    p = dict(_params(params))
    stacked = flatten(p.pop("blocks")["block"])
    sd = convert(p, _COGVIDEOX_RENAMES)
    depth = next(iter(stacked.values())).shape[0]
    for i in range(depth):
        layer = convert({k: v[i] for k, v in stacked.items()},
                        _COGVIDEOX_BLOCK_RENAMES)
        sd.update({f"transformer_blocks.{i}.{k}": v for k, v in layer.items()})
    return sd


_COGVIDEOX_VAE_RENAMES = (
    (r"^down_(\d+)_res_(\d+)\.", r"down_blocks.\1.resnets.\2."),
    (r"^down_(\d+)_downsample\.", r"down_blocks.\1.downsamplers.0."),
    (r"^mid_res_(\d)\.", r"mid_block.resnets.\1."),
    (r"^up_(\d+)_res_(\d+)\.", r"up_blocks.\1.resnets.\2."),
    (r"^up_(\d+)_upsample\.", r"up_blocks.\1.upsamplers.0."),
)


def cogvideox_vae_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """AutoencoderKLCogVideoX Flax params {"encoder": ..., "decoder": ...}
    -> state_dict of `models.autoencoders.autoencoder_cogvideox`."""
    sd = {}
    for coder in ("encoder", "decoder"):
        sd.update({f"{coder}.{k}": v for k, v in convert(
            _params(params[coder]), _COGVIDEOX_VAE_RENAMES).items()})
    return sd

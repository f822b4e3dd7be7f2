"""Carry the JAX package's Flax parameters over to this package.

`stdit3_from_jax`, `open_sora_vae_from_jax`, `t5_from_jax`,
`cogvideox_from_jax`, `cogvideox_vae_from_jax`, `latte_from_jax`,
`osp_v120_from_jax`, `vae2d_from_jax`, `causal_vae_from_jax`,
`vchitect_from_jax` and `clip_from_jax` take a Flax param tree as numpy
arrays (nested dicts) and return a state_dict for the modules here:

* a Dense kernel [in, out] becomes a Linear weight [out, in];
* a Conv kernel HWIO / THWIO becomes OIHW / OITHW;
* GroupNorm `scale` and an Embed `embedding` become `weight`;
* the `nn.scan`-stacked `blocks` axis 0 becomes one module per layer;
* a fused qkv (or kv) Dense is split into the reference's to_q, to_k, to_v;
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
    sd = {f"spatial_vae.module.{k}": v
          for k, v in vae2d_from_jax(params["spatial"]).items()}
    p = _params(params["temporal"])
    for coder in ("encoder", "decoder"):
        sd.update({f"temporal_vae.{coder}.{k}": v for k, v in
                   convert(p[coder], _VAE_TEMPORAL_RENAMES).items()})
    sd.update({f"temporal_vae.{k}": v for k, v in convert(
        {c: p[c] for c in ("quant_conv", "post_quant_conv")}).items()})
    return sd


def vae2d_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """AutoencoderKL2D Flax params -> the state_dict of
    `models.autoencoders.vae2d.AutoencoderKL2D` (diffusers' names)."""
    p = _params(params)
    sd = {}
    for coder in ("encoder", "decoder"):
        sd.update({f"{coder}.{k}": v for k, v in
                   convert(p[coder], _VAE2D_RENAMES).items()})
    sd.update(convert({c: p[c] for c in ("quant_conv", "post_quant_conv")}))
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


def _stacked_layers(stacked: Mapping):
    """The per-layer {name: array} trees of a scan-stacked subtree."""
    flat = flatten(stacked)
    depth = next(iter(flat.values())).shape[0]
    return [{k: v[i] for k, v in flat.items()} for i in range(depth)]


def _split_dense(layer: Mapping, fused: str, names) -> Dict[str, np.ndarray]:
    """A fused Dense's kernel and bias split on the output axis into one
    torch Linear per name (rows in `names` order)."""
    out = {}
    n = len(names)
    kernel = layer[f"{fused}.kernel"]
    for name, w in zip(names, np.split(kernel, n, axis=-1)):
        out[f"{name}.weight"] = np.ascontiguousarray(w.T)
    if f"{fused}.bias" in layer:
        for name, b in zip(names, np.split(layer[f"{fused}.bias"], n)):
            out[f"{name}.bias"] = b
    return out


_LATTE_RENAMES = (
    (r"^pos_embed_proj\.", "pos_embed.proj."),
    (r"^adaln_single_emb\.mlp_0\.", "adaln_single.emb.timestep_embedder.linear_1."),
    (r"^adaln_single_emb\.mlp_2\.", "adaln_single.emb.timestep_embedder.linear_2."),
    (r"^adaln_single_linear\.", "adaln_single.linear."),
    (r"^caption_projection\.fc1\.", "caption_projection.linear_1."),
    (r"^caption_projection\.fc2\.", "caption_projection.linear_2."),
    (r"^final_scale_shift_table$", "scale_shift_table"),
)

_LATTE_BLOCK_RENAMES = (
    (r"^attn1\.proj\.", "attn1.to_out.0."),
    (r"^attn2\.q_linear\.", "attn2.to_q."),
    (r"^attn2\.proj\.", "attn2.to_out.0."),
    (r"^ff\.proj_in\.", "ff.net.0.proj."),
    (r"^ff\.proj_out\.", "ff.net.2."),
)


def latte_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """LatteT2V Flax params ({"params": ...} or the inner tree) -> the
    state_dict of `models.transformers.latte.LatteT2V` (the reference's
    names): the fused attn1 qkv and attn2 kv split into to_q / to_k / to_v,
    the stacked blocks into `transformer_blocks.{i}` and
    `temporal_transformer_blocks.{i}`."""
    p = dict(_params(params))
    blocks = p.pop("blocks")
    sd = convert(p, _LATTE_RENAMES)
    for branch, prefix in (("spatial", "transformer_blocks"),
                           ("temporal", "temporal_transformer_blocks")):
        for i, layer in enumerate(_stacked_layers(blocks[branch])):
            out = _split_dense(layer, "attn1.qkv",
                               ("attn1.to_q", "attn1.to_k", "attn1.to_v"))
            if "attn2.kv_linear.kernel" in layer:
                out.update(_split_dense(layer, "attn2.kv_linear",
                                        ("attn2.to_k", "attn2.to_v")))
            rest = {k: v for k, v in layer.items()
                    if not k.startswith(("attn1.qkv.", "attn2.kv_linear."))}
            out.update(convert(rest, _LATTE_BLOCK_RENAMES))
            sd.update({f"{prefix}.{i}.{k}": v for k, v in out.items()})
    return sd


_OSP_V120_RENAMES = (
    (r"^patch_proj\.", "pos_embed.proj."),
    (r"^adaln_single\.emb\.mlp_0\.", "adaln_single.emb.timestep_embedder.linear_1."),
    (r"^adaln_single\.emb\.mlp_2\.", "adaln_single.emb.timestep_embedder.linear_2."),
    (r"^caption_in\.", "caption_projection.linear_1."),
    (r"^caption_out\.", "caption_projection.linear_2."),
)

_OSP_V120_BLOCK_RENAMES = (
    (r"^(attn\d)\.to_out\.", r"\1.to_out.0."),
    (r"^ff_in\.", "ff.net.0.proj."),
    (r"^ff_out\.", "ff.net.2."),
)


def osp_v120_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """OpenSoraPlanV120Transformer Flax params -> the state_dict of
    `models.transformers.open_sora_plan_v120` (the reference's names)."""
    p = dict(_params(params))
    stacked = p.pop("blocks")["block"]
    sd = convert(p, _OSP_V120_RENAMES)
    for i, layer in enumerate(_stacked_layers(stacked)):
        sd.update({f"transformer_blocks.{i}.{k}": v for k, v in
                   convert(layer, _OSP_V120_BLOCK_RENAMES).items()})
    return sd


# module names of the causal VAE's coders: Flax -> the reference's
_CAUSAL_VAE_RENAMES = (
    (r"^(down|up)(\d+)_block(\d+)\.", r"\1.\2.block.\3."),
    (r"^(down|up)(\d+)_attn(\d+)\.", r"\1.\2.attn.\3."),
    (r"^(down|up)(\d+)_(time_downsample|downsample|time_upsample|upsample)\.",
     r"\1.\2.\3."),
    (r"^mid_block(\d)\.", r"mid.block_\1."),
    (r"^mid_attn\.", "mid.attn_1."),
)
# ops whose Flax and torch modules nest their convolutions differently
_CAUSAL_VAE_OP_RENAMES = {
    "Conv2d": ((r"conv\.(kernel|bias)$", r"\1"),),
    "ResnetBlock2D": ((r"(conv\d|nin_shortcut)\.conv\.", r"\1."),),
    "SpatialDownsample2x": ((r"conv\.(kernel|bias)$", r"conv.conv.\1"),),
    "SpatialUpsample2x": ((r"conv\.(kernel|bias)$", r"conv.conv.\1"),),
}


def _causal_vae_ops(config) -> Dict[str, str]:
    """Flax module name -> registry op of each coder module that holds
    weights."""
    cfg = config
    n = len(cfg.hidden_size_mult)
    ops = {}
    for coder, spatial, temporal, res_blocks, blocks in (
            ("encoder", cfg.encoder_spatial_downsample,
             cfg.encoder_temporal_downsample, cfg.encoder_resnet_blocks,
             cfg.num_res_blocks),
            ("decoder", cfg.decoder_spatial_upsample,
             cfg.decoder_temporal_upsample, cfg.decoder_resnet_blocks,
             cfg.num_res_blocks + 1)):
        kind = "down" if coder == "encoder" else "up"
        attn = getattr(cfg, f"{coder}_attention")
        ops.update({f"{coder}.conv_in": getattr(cfg, f"{coder}_conv_in"),
                    f"{coder}.conv_out": getattr(cfg, f"{coder}_conv_out"),
                    f"{coder}.mid_block1": getattr(cfg, f"{coder}_mid_resnet"),
                    f"{coder}.mid_block2": getattr(cfg, f"{coder}_mid_resnet"),
                    f"{coder}.mid_attn": attn})
        for i in range(n):
            for j in range(blocks):
                ops[f"{coder}.{kind}{i}_block{j}"] = res_blocks[i]
                ops[f"{coder}.{kind}{i}_attn{j}"] = attn
            ops[f"{coder}.{kind}{i}_{'downsample' if kind == 'down' else 'upsample'}"] = spatial[i]
            ops[f"{coder}.{kind}{i}_time_{'downsample' if kind == 'down' else 'upsample'}"] = temporal[i]
    return ops


def causal_vae_from_jax(params: Mapping, config) -> Dict[str, np.ndarray]:
    """CausalVAEModule Flax params -> the state_dict of
    `models.autoencoders.autoencoder_causal_vae.CausalVAE` (the reference's
    names), driven by the registry config both were built from."""
    ops = _causal_vae_ops(config)
    sd = {}
    for name, value in flatten(_params(params)).items():
        coder, _, rest = name.partition(".")
        if coder in ("encoder", "decoder"):
            module = rest.split(".")[0]
            for pat, rep in _CAUSAL_VAE_OP_RENAMES.get(
                    ops.get(f"{coder}.{module}"), ()):
                rest = module + "." + re.sub(pat, rep, rest[len(module) + 1:])
            for pat, rep in _CAUSAL_VAE_RENAMES:
                rest = re.sub(pat, rep, rest)
            name = f"{coder}.{rest}"
        key, val = to_torch_leaf(name, value)
        sd[key] = val
    return sd


_VCHITECT_RENAMES = (
    (r"^patch_proj\.", "pos_embed.proj."),
    (r"^time_embed\.mlp_0\.", "time_text_embed.timestep_embedder.linear_1."),
    (r"^time_embed\.mlp_2\.", "time_text_embed.timestep_embedder.linear_2."),
    (r"^pooled_in\.", "time_text_embed.text_embedder.linear_1."),
    (r"^pooled_out\.", "time_text_embed.text_embedder.linear_2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
)

_VCHITECT_BLOCK_RENAMES = (
    (r"^attn\.to_out\.", "attn.to_out.0."),
    (r"^ff_in\.", "ff.net.0.proj."),
    (r"^ff_out\.", "ff.net.2."),
    (r"^ff_context_in\.", "ff_context.net.0.proj."),
    (r"^ff_context_out\.", "ff_context.net.2."),
    (r"^norm1_context_linear\.", "norm1_context.linear."),
)


def vchitect_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """VchitectXLTransformer Flax params ({"params": ...} or the inner
    tree) -> the state_dict of `models.transformers.vchitect` (the
    reference's names): the scan-stacked `blocks.block` axis 0 becomes
    `transformer_blocks.{i}` and `final_block` the last of them."""
    p = dict(_params(params))
    layers = _stacked_layers(p.pop("blocks")["block"])
    layers.append(flatten(p.pop("final_block")))
    sd = convert(p, _VCHITECT_RENAMES)
    for i, layer in enumerate(layers):
        sd.update({f"transformer_blocks.{i}.{k}": v for k, v in
                   convert(layer, _VCHITECT_BLOCK_RENAMES).items()})
    return sd


def clip_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """transformers' FlaxCLIPTextModelWithProjection params -> the
    state_dict of `models.text_encoders.clip.CLIPTextModelWithProjection`
    (HF's torch names: Flax's module paths are the same)."""
    return convert(_params(params), ((r"\.embedding$", ".weight"),))

"""Checkpoint loading and saving for the pipelines.

Port of `videosys_tpu/utils/checkpoint.py`. This package keeps the
reference checkpoint's `state_dict` key names, so a reference snapshot
directory loads with no conversion: an STDiT3 snapshot
(`hpcai-tech/OpenSora-STDiT-v3`: safetensors, possibly sharded, or
`pytorch_model*.bin`), a diffusers-layout CogVideoX or Latte snapshot
(`THUDM/CogVideoX-2b`, `maxin-cn/Latte-1`: the same files under
`transformer/` and `vae/`), a Vchitect snapshot (`Vchitect/Vchitect-2.0-2B`:
its `transformer/` only; the JAX package loads no Vchitect VAE), or an
Open-Sora-Plan snapshot
(`LanguageBind/Open-Sora-Plan-v1.1.0` / `-v1.2.0`: one folder per
transformer type, `65x512x512/`, `29x480p/`, ..., and the causal VAE under
`vae/`). In place of the JAX package's `path/orbax`, `save_params` writes
this package's own `path/torch_params/{module}.safetensors`;
`try_load_params` reads either layout from `config.transformer`
(Open-Sora, Open-Sora-Plan) or `config.model_path` (CogVideoX, Latte,
Vchitect) and
refuses an orbax directory, which only the JAX package reads. Tensors stay
on the host; the pipeline casts and places them.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from videosys_tpu_torch.models.modules.embeddings import rope_freqs
from videosys_tpu_torch.utils import safetensors_io

PARAMS_DIR = "torch_params"  # this package's counterpart of `path/orbax`

StateDict = Dict[str, torch.Tensor]


def _drop_computed(sd: StateDict) -> StateDict:
    """The reference STDiT3 stores its rotary frequencies (`rope.freqs`, a
    parameter that never trains); this package computes them. Drop the key
    after checking that it holds the same table."""
    freqs = sd.pop("rope.freqs", None)
    if freqs is not None:
        want = rope_freqs(2 * freqs.numel())
        if not np.allclose(freqs.float().numpy(), want, rtol=1e-6, atol=0):
            raise ValueError("checkpoint key 'rope.freqs' differs from the "
                             "rotary frequencies this package computes")
    return sd


FAMILIES = ("stdit3", "cogvideox", "latte", "osp_v110", "osp_v120",
            "causal_vae", "vchitect")
# the diffusers snapshot's folders of the modules each family loads
SNAPSHOT_MODULES = {"cogvideox": ("transformer", "vae"),
                    "latte": ("transformer", "vae"),
                    "vchitect": ("transformer",)}


def load_torch_checkpoint(path: str, family: str = "stdit3"):
    """A local reference checkpoint directory on the host, in its stored
    dtype. "stdit3", "osp_v110" / "osp_v120" (an Open-Sora-Plan transformer
    folder, `65x512x512/`, `29x480p/`, ...) and "causal_vae" (its `vae/`
    folder): the directory's state_dict, None when it holds no weights.
    "cogvideox" and "latte": {module: state_dict} of the diffusers
    snapshot's `transformer/` and `vae/` folders that hold weights, None
    when neither does; "vchitect" the same of `transformer/` alone."""
    if family not in FAMILIES:
        raise NotImplementedError(
            f"model family {family!r} is not one the JAX package loads; "
            f"{', '.join(repr(f) for f in FAMILIES)} load")
    if family in SNAPSHOT_MODULES:
        loaded = {name: safetensors_io.load_dir(os.path.join(path, name))
                  for name in SNAPSHOT_MODULES[family]}
        loaded = {k: v for k, v in loaded.items() if v is not None}
        return loaded or None
    sd = safetensors_io.load_dir(path)
    if sd is None or family != "stdit3":
        return sd
    return _drop_computed(sd)


def load_stdit3_torch_checkpoint(path: str, depth: int = 28
                                 ) -> Optional[StateDict]:
    """An STDiT3 reference checkpoint directory
    (hpcai-tech/OpenSora-STDiT-v3 layout) as this package's state_dict,
    None when it holds no weights. Like the JAX package's
    `convert_stdit3(sd, depth=depth)`, it keeps the first `depth` spatial
    and temporal blocks and raises KeyError when the checkpoint has fewer."""
    sd = load_torch_checkpoint(path, "stdit3")
    if sd is None:
        return None
    for kind in ("spatial", "temporal"):
        if not any(k.startswith(f"{kind}_blocks.{depth - 1}.") for k in sd):
            raise KeyError(f"{kind}_blocks.{depth - 1}: the checkpoint at "
                           f"{path!r} has fewer than {depth} blocks")
    block = re.compile(r"(spatial|temporal)_blocks\.(\d+)\.")
    return {k: v for k, v in sd.items()
            if not (m := block.match(k)) or int(m.group(2)) < depth}


def _weights_path(config) -> Optional[str]:
    """Where a pipeline's weights live: `config.transformer` (Open-Sora,
    Open-Sora-Plan) or `config.model_path` (CogVideoX, Latte)."""
    return getattr(config, "transformer", None) or getattr(
        config, "model_path", None)


def try_load_params(config, family: str = "stdit3"
                    ) -> Optional[Dict[str, StateDict]]:
    """{module: state_dict} from the local directory of the config's
    weights: this package's `save_params` output ({"transformer", "vae"})
    or a reference checkpoint ({"transformer"} of an STDiT3 snapshot; the
    modules of a CogVideoX, Latte or Vchitect snapshot; for family "osp", an
    Open-Sora-Plan snapshot's `config.transformer_type` folder and its
    `vae/`); None when the path is unset, not a directory, or holds
    neither."""
    path = _weights_path(config)
    if not path or not os.path.isdir(str(path)):
        return None
    path = str(path)
    if os.path.isdir(os.path.join(path, "orbax")):
        raise ValueError(
            f"{path!r} holds an orbax checkpoint, the JAX package's format "
            f"(videosys_tpu.utils.checkpoint.save_params); this package reads "
            f"its own {PARAMS_DIR}/ directory (save_params here) or a "
            f"reference safetensors / pytorch_model.bin snapshot")
    own = os.path.join(path, PARAMS_DIR)
    if os.path.isdir(own):
        return {os.path.basename(f)[: -len(".safetensors")]:
                safetensors_io.load_file(f)
                for f in sorted(glob.glob(os.path.join(own, "*.safetensors")))}
    if family == "osp":
        loaded = {"transformer": load_torch_checkpoint(
            os.path.join(path, config.transformer_type),
            f"osp_{config.version}"),
            "vae": load_torch_checkpoint(os.path.join(path, "vae"),
                                         "causal_vae")}
        return {k: v for k, v in loaded.items() if v is not None} or None
    sd = load_torch_checkpoint(path, family)
    if family in SNAPSHOT_MODULES or sd is None:
        return sd
    return {"transformer": sd}


def transformer_depth(sd: Mapping) -> int:
    """The number of `transformer_blocks.{i}` in a state_dict."""
    blocks = {int(m.group(1)) for m in
              (re.match(r"transformer_blocks\.(\d+)\.", k) for k in sd) if m}
    if not blocks:
        raise ValueError("no transformer_blocks.{i} keys in the state_dict")
    return max(blocks) + 1


def require_weights(loaded: Mapping, config, vae: bool = True) -> None:
    """Raise when a configured model path did not resolve to weights and no
    random-init hook (`transformer_config`, `vae_config`) is set, as the
    reference's from_pretrained fails instead of generating noise. The VAE
    path is `config.vae` (Open-Sora) or the snapshot at `model_path`
    (CogVideoX); `vae=False` checks the transformer only (Vchitect, whose
    VAE the JAX package never loads)."""
    path = _weights_path(config)
    if "transformer" not in loaded and path and \
            config.transformer_config is None:
        raise FileNotFoundError(
            f"transformer weights not found at {path!r} (need a local "
            f"{PARAMS_DIR}/ dir or HF safetensors snapshot); set the path to "
            f"None with transformer_config=... for random-init testing")
    vae_path = getattr(config, "vae", None) or getattr(config, "model_path",
                                                       None)
    if vae and "vae" not in loaded and vae_path and config.vae_config is None:
        raise FileNotFoundError(
            f"VAE weights not found at {vae_path!r}; set the path to None "
            f"with vae_config=... for random-init testing")


def save_params(params: Mapping[str, Mapping], path: str) -> str:
    """Write {module: state_dict} (tensors or numpy arrays) to
    `path/torch_params/{module}.safetensors`; returns that directory."""
    own = os.path.join(os.path.abspath(path), PARAMS_DIR)
    os.makedirs(own, exist_ok=True)
    for name, sd in params.items():
        safetensors_io.save_file(
            {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
             for k, v in sd.items()},
            os.path.join(own, f"{name}.safetensors"), {"format": "pt"})
    return own

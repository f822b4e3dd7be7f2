"""Read and write `.safetensors` files, and read checkpoint directories.

A `.safetensors` file is an 8-byte little-endian header length N, a JSON
header of N bytes, `{name: {"dtype", "shape", "data_offsets": [begin,
end]}}` plus an optional `"__metadata__"` of strings, then the raw
little-endian bytes, offsets counted from the end of the header. Files are
read through a private memory map, so a large file is not copied on the
host before its tensors are cast or moved.

`load_dir` reads a checkpoint directory as Hugging Face lays it out: a
sharded `*.safetensors.index.json` (its `weight_map`), every `*.safetensors`
file, or `pytorch_model*.bin` files (`torch.load(..., mmap=True)`, with or
without their `.index.json`).
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# safetensors dtype -> (torch dtype, numpy dtype the bytes are read as)
DTYPES = {
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.int16),  # numpy has no bf16: read as int16
    "I64": (torch.int64, np.int64),
    "I32": (torch.int32, np.int32),
    "BOOL": (torch.bool, np.bool_),
}
_NAMES = {tdt: name for name, (tdt, _) in DTYPES.items()}


def read_header(path: str) -> tuple:
    """(header dict, byte offset of the data) of a .safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the host, backed by a
    copy-on-write memory map of the file."""
    header, base = read_header(path)
    header.pop("__metadata__", None)
    mm = np.memmap(path, dtype=np.uint8, mode="c") if header else None
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which is not read here "
                             f"({sorted(DTYPES)})")
        tdt, ndt = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        raw = mm[base + begin: base + end]
        if (base + begin) % np.dtype(ndt).itemsize:
            raw = raw.copy()  # unaligned: copy to an aligned buffer
        arr = raw.view(ndt).reshape(info["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(tdt) if tdt == torch.bfloat16 else t
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (any device; moved to the host one at a time) to a
    .safetensors file, the widest dtypes first so every tensor is aligned."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    if metadata:
        header["__metadata__"] = dict(metadata)
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not "
                             f"written here ({sorted(DTYPES)})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-(8 + len(blob)) % 8)  # the data starts 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().data)


def save_sharded(tensors: Mapping[str, torch.Tensor], path: str,
                 shards: int = 1, prefix: str = "model") -> None:
    """Write `tensors` into directory `path` as Hugging Face does: one
    `{prefix}.safetensors`, or `shards` files `{prefix}-0000i-of-0000n
    .safetensors` of about equal bytes plus `{prefix}.safetensors.index.json`."""
    os.makedirs(path, exist_ok=True)
    if shards <= 1:
        save_file(tensors, os.path.join(path, f"{prefix}.safetensors"),
                  {"format": "pt"})
        return
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    groups = [dict() for _ in range(shards)]
    done = 0
    for name, t in tensors.items():
        groups[min(shards - 1, done * shards // max(total, 1))][name] = t
        done += t.numel() * t.element_size()
    weight_map = {}
    for i, group in enumerate(groups):
        fname = f"{prefix}-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file(group, os.path.join(path, fname), {"format": "pt"})
        weight_map.update({name: fname for name in group})
    with open(os.path.join(path, f"{prefix}.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)


def _load_bin(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def load_dir(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """Every tensor of a checkpoint directory (see the module docstring) on
    the host, or None when it holds no weight file."""
    for pattern, load in (("*.safetensors", load_file),
                          ("pytorch_model*.bin", _load_bin)):
        index = sorted(glob.glob(os.path.join(path, pattern + ".index.json")))
        if index:
            with open(index[0]) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
            files = [os.path.join(path, name) for name in files]
        else:
            files = sorted(glob.glob(os.path.join(path, pattern)))
        if files:
            out: Dict[str, torch.Tensor] = {}
            for file in files:
                out.update(load(file))
            return out
    return None

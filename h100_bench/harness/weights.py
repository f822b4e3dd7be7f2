"""Weights made from the seed on the card, in the dtype they are served in.

One `randn` over every parameter of a module fills one flat buffer; each
parameter is a view of it, scaled by its fan-in as a default-initialised
layer would be (standard deviation 1/sqrt(3 fan_in), the std of PyTorch's
default uniform), norm scales around 1 and biases small. The same seed
gives the same values on the same card, so the reference remakes them
instead of reading the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, ...]]]


def layout(module: torch.nn.Module) -> Layout:
    """(name, shape) of every parameter and buffer, in state_dict order."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def make(layouts: Sequence[Tuple[str, Layout]], seed: int,
         device: torch.device, dtype: torch.dtype
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {name: tensor}} for each (module, layout), in order, from
    one generator seeded with `seed`."""
    gen = torch.Generator(device).manual_seed(int(seed))
    out = {}
    for module, lay in layouts:
        total = sum(math.prod(s) for _, s in lay)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        tensors, off = {}, 0
        for name, shape in lay:
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            if len(shape) >= 2:
                t.mul_(1.0 / math.sqrt(3.0 * (n // shape[0])))
            elif name.endswith("weight"):
                t.mul_(0.1).add_(1.0)  # a norm's scale
            else:
                t.mul_(0.02)
            tensors[name] = t
        out[module] = tensors
    return out

"""Brackets around the program's attention calls, put there from outside.

`AttentionProbe.install()` replaces the attention entry point
(`scaled_dot_product_attention` of `videosys_tpu_torch.ops.attention`) in
every loaded module of the program that imported it, by a wrapper that
records the call's shapes and live keys and fills a one-element int16
tensor on the call's stream before and after it (the trace finds these
fills by their kernel's name), each fill inside a range of its
own; `remove()` puts the original back. The trace's reduction gives the
device seconds of what the stream ran between a call's two fills, and the
work of each call is counted by `harness.roofline`, whatever kernel ran.
"""

from __future__ import annotations

import sys
from typing import List

import torch

from harness import roofline
from harness.trace import BEGIN, END, Reduction

PACKAGE = "videosys_tpu_torch"
ENTRY = "scaled_dot_product_attention"
DTYPES = {torch.bfloat16: "bf16", torch.float16: "fp16",
          torch.float32: "fp32"}


class AttentionProbe:
    def __init__(self):
        self.calls: List[dict] = []
        self._patched = []
        self._marks = {}

    def install(self) -> None:
        from videosys_tpu_torch.ops import attention

        original = getattr(attention, ENTRY)

        def wrapper(q, k, v, scale=None, kv_mask=None, **kw):
            i = len(self.calls)
            B, H, Nq, D = q.shape
            self.calls.append(dict(
                B=B, H=H, Nq=Nq, Nk=k.shape[2], D=D, dtype=q.dtype,
                itemsize=q.element_size(),
                live=None if kv_mask is None else kv_mask.sum(dim=1)))
            mark = self._marks.get(q.device)
            if mark is None:
                # made without a kernel: the fills are the only ones
                mark = self._marks[q.device] = torch.empty(
                    1, dtype=torch.int16, device=q.device)
            with torch.profiler.record_function(f"{BEGIN}{i}"):
                mark.fill_(1)
            out = original(q, k, v, scale=scale, kv_mask=kv_mask, **kw)
            with torch.profiler.record_function(f"{END}{i}"):
                mark.fill_(2)
            return out

        for name, mod in list(sys.modules.items()):
            if (name == PACKAGE or name.startswith(PACKAGE + ".")) and \
                    getattr(mod, ENTRY, None) is original:
                setattr(mod, ENTRY, wrapper)
                self._patched.append((mod, original))

    def remove(self) -> None:
        for mod, original in self._patched:
            setattr(mod, ENTRY, original)
        self._patched = []

    def calls_with_times(self, trace: Reduction) -> List[dict]:
        """Each call with its bound seconds (its forward work) and its
        device seconds."""
        out = []
        for i, c in enumerate(self.calls):
            live = None if c["live"] is None else [
                int(n) for n in c["live"].tolist()]
            flops, nbytes = roofline.attention_work(
                c["B"], c["H"], c["Nq"], c["Nk"], c["D"], c["itemsize"],
                live=live, masked=live is not None)
            out.append(dict(
                shape=[c["B"], c["H"], c["Nq"], c["Nk"], c["D"]],
                bound_s=roofline.bound_seconds(
                    flops, nbytes, DTYPES.get(c["dtype"], "fp32")),
                device_s=trace.attn_device_s.get(i, 0.0)))
        return out

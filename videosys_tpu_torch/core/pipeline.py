"""Pipeline base classes, device choice and the low-memory helpers.

`cpu_offload` (the reference's low-memory mode; JAX `core/pipeline.py`
`_offload_params_to_host`, `_exec_put`): a module's weights live on the host,
in pinned memory when the card is the target (`offload_to_host`), and a
phase fetches the module onto the card for its span only (`on_device`).
Inference never changes the weights, so the host tensors are kept and only
each parameter's (and buffer's) `.data` is swapped: dropping the device copy
moves nothing back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from videosys_tpu_torch.utils import timing

# called as hook(name, module, seconds, nbytes) after each fetch, with the
# module on the card
FETCH_HOOKS: List[Callable[[str, nn.Module, float, int], None]] = []


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None; a CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def _tensors(module: nn.Module) -> List[torch.Tensor]:
    return list(module.parameters()) + list(module.buffers())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def offload_to_host(module: nn.Module, pin: bool,
                    dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Move the module's weights into one host buffer, pinned when `pin`
    (the card's copies are fast only from pinned memory; one buffer is one
    pinning instead of one per tensor), casting floating ones to `dtype` on
    the way."""
    tensors = _tensors(module)
    dtypes = [dtype if dtype is not None and t.is_floating_point()
              else t.dtype for t in tensors]
    offsets, total = [], 0
    for t, dt in zip(tensors, dtypes):
        offsets.append(total)
        total += -(-t.numel() * dt.itemsize // 64) * 64
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    for t, dt, off in zip(tensors, dtypes, offsets):
        host = buf[off: off + t.numel() * dt.itemsize].view(dt).view(t.shape)
        host.copy_(t.data)
        t.data = host
    return module


def build_modules(factories: Mapping[str, Callable[[], nn.Module]],
                  params: Mapping[str, Mapping], seed: int,
                  device: torch.device,
                  dtype: Union[torch.dtype, Mapping[str, torch.dtype]],
                  offload: bool) -> Dict[str, nn.Module]:
    """Make each module with its factory, in order, with weights drawn
    from `seed` (a module `params` holds a state_dict for is built on the
    meta device and its tensors or numpy arrays assigned: strictly, so
    missing and unexpected keys raise, named); then hold it on `device` in
    `dtype` (one for all, or one per module name), or under `offload` in
    one pinned host buffer, in eval mode without gradients."""
    home = torch.device("cpu") if offload else device
    cuda = [device] if device.type == "cuda" else []
    modules = {}
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(seed)
        for name, make in factories.items():
            with torch.device("meta" if name in params else home):
                modules[name] = make()
    for name, module in modules.items():
        dt = dtype[name] if isinstance(dtype, Mapping) else dtype
        if name in params:
            module.load_state_dict(
                {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
                 for k, v in params[name].items()}, assign=True)
        if offload:
            offload_to_host(module, device.type == "cuda", dt)
        else:
            module.to(device, dt)
        module.eval().requires_grad_(False)
    return modules


@contextlib.contextmanager
def on_device(module: nn.Module, device: torch.device, name: str = ""):
    """Fetch a host-resident module onto `device` for the with-block and
    drop the device copy at its end. The copy is made even on the CPU, so
    a CPU run takes the same steps."""
    host = [(t, t.data) for t in _tensors(module)]
    t0 = time.perf_counter()
    try:
        for t, data in host:
            t.data = data.to(device, non_blocking=True, copy=True)
        _sync(device)
        nbytes = sum(d.numel() * d.element_size() for _, d in host)
        for hook in FETCH_HOOKS:
            hook(name, module, time.perf_counter() - t0, nbytes)
        yield module
    finally:
        _sync(device)
        for t, data in host:
            t.data = data


@dataclasses.dataclass
class VideoSysPipelineOutput:
    """`.video`: uint8 array [B, T, H, W, C]."""

    video: Any


def timed_request(generate):
    """Decorator of a pipeline's `generate`: the call is one
    `videosys.request` span, and the phases' CUDA events (`_phase`) are
    read into `last_timings` at its end, once, when the video's copy to
    the host has already waited for the card."""

    @functools.wraps(generate)
    def run(self, *args, **kwargs):
        self._phase_events = []
        try:
            with timing.span(timing.REQUEST):
                return generate(self, *args, **kwargs)
        finally:
            events, self._phase_events = self._phase_events, []
            for timer, start, end in events:
                end.synchronize()
                self.last_timings[timer] += start.elapsed_time(end) / 1e3

    return run


# the span of each phase `_phase` times
PHASE_SPANS = {"text": timing.TEXT, "denoise": timing.DENOISE,
               "vae": timing.VAE, "postprocess": timing.POSTPROCESS}


class VideoSysPipeline:
    """Subclasses implement generate(...) -> VideoSysPipelineOutput,
    decorated with `timed_request`, and set `_config` and `device`."""

    def generate(self, *args, **kwargs) -> VideoSysPipelineOutput:
        raise NotImplementedError

    def __call__(self, *args, **kwargs) -> VideoSysPipelineOutput:
        return self.generate(*args, **kwargs)

    def save_video(self, video, output_path: str, fps: int = 24):
        """Write `generate`'s uint8 video (`utils.video.save_video`)."""
        from videosys_tpu_torch.utils.video import save_video

        return save_video(video, output_path, fps=fps)

    def _on_device(self, module: Optional[nn.Module], name: str = ""):
        """`on_device` under the config's `cpu_offload`; otherwise (or with
        no module) this does nothing: the module is resident."""
        if module is None or not getattr(self._config, "cpu_offload", False):
            return contextlib.nullcontext(module)
        return on_device(module, self.device, name)

    @contextlib.contextmanager
    def _phase(self, timer: str, module: Optional[nn.Module] = None,
               name: str = ""):
        """Add the with-block's time, to the end of its device work, to
        `last_timings[timer]`, and open its span; under cpu_offload
        `module` is on the card for the block only. On the card the time
        is the stream's between two CUDA events, read at the end of the
        request (`timed_request`); on the CPU, and under cpu_offload, whose
        fetches wait for the card in order, the host clock to a sync."""
        with timing.span(PHASE_SPANS[timer]):
            if self.device.type == "cuda" and not getattr(
                    self._config, "cpu_offload", False):
                stream = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                yield
                end.record(stream)
                self._phase_events.append((timer, start, end))
                return
            t0 = time.perf_counter()
            with self._on_device(module, name):
                yield
                _sync(self.device)
            self.last_timings[timer] += time.perf_counter() - t0

"""Timers (reference `videosys/utils/training.py:71-156` Timer/GroupTimer).

Port of `videosys_tpu/utils/timing.py`. The reference's Timer is
`torch.cuda.synchronize` around wall time plus the CUDA allocator's
counters; here a Timer on the card times with CUDA events and reads the
allocator, and on the CPU it reads `time.perf_counter`. GroupTimer's exit
also waits for every rank of its groups (the reference's all-reduce).
`profile_trace` captures a trace of the with-block (the JAX package's
`jax.profiler` trace) as a Chrome / Perfetto trace file.

`span(name)` marks a region of the program in such a trace: while a torch
profiler records it is a `torch.profiler.record_function` range, whose
host times share the clock of the device ops in the exported trace;
otherwise it is one shared null context and costs a flag check. Every
name is declared once, in `SPANS`.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as autograd_profiler
import torch.distributed as dist

# The program's spans, each opened where its work happens:
REQUEST = "videosys.request"  # a whole `generate`
TEXT = "videosys.text"  # the pipeline's phases (`VideoSysPipeline._phase`)
DENOISE = "videosys.denoise"
VAE = "videosys.vae"
POSTPROCESS = "videosys.postprocess"
T5 = "videosys.t5"  # the T5 encoder's forward, tokenizing left out
STEP = "videosys.step"  # one denoise step: CFG doubling to scheduler update
FORWARD = "videosys.forward"  # the transformer's forward
EMBED = "videosys.embed"  # timestep, caption, patch and position embeddings
FINAL = "videosys.final"  # final layer and unpatchify
BLOCK = "videosys.block"  # a CogVideoX block
BLOCK_SPATIAL = "videosys.block.spatial"  # STDiT3's blocks
BLOCK_TEMPORAL = "videosys.block.temporal"
MODULATE = "videosys.modulate"  # a block's norm, modulate, gate and residual
ATTN = "videosys.attn"  # a block's self-attention (or its PAB cache read)
CROSS = "videosys.cross"  # a block's cross-attention (or its cache read)
MLP = "videosys.mlp"  # a block's feed-forward (or its cache read)
SCHEDULER = "videosys.scheduler"  # guidance combine and scheduler step
VAE_CHUNK = "videosys.vae.chunk"  # a temporal chunk of Open-Sora's decode
VAE_TILE = "videosys.vae.tile"  # a tile of CogVideoX's tiled decode
SPANS = (REQUEST, TEXT, DENOISE, VAE, POSTPROCESS, T5, STEP, FORWARD, EMBED,
         FINAL, BLOCK, BLOCK_SPATIAL, BLOCK_TEMPORAL, MODULATE, ATTN, CROSS,
         MLP, SCHEDULER, VAE_CHUNK, VAE_TILE)

_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span(STEP): ...`: a `record_function` range named `name`
    while a torch profiler records, else a null context."""
    if autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def device_memory_stats(device=None) -> dict:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of the card's caching
    allocator (allocated bytes now and at their peak since the last
    `torch.cuda.reset_peak_memory_stats`, and the card's memory); {} for the
    CPU, which has no such allocator."""
    # imported here: core.pipeline imports this module for `span`
    from videosys_tpu_torch.core.pipeline import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": stats["allocated_bytes.all.current"],
            "peak_bytes_in_use": stats["allocated_bytes.all.peak"],
            "bytes_limit": torch.cuda.mem_get_info(dev)[1]}


class Timer:
    """`with Timer("fwd", log=True) as t: ...` -> `t.elapsed` seconds and
    `t.memory` (`device_memory_stats` at exit). On the card (`device` None
    or CUDA) the time is that of the device's stream between two CUDA
    events, waited for at exit; on the CPU the host clock."""

    def __init__(self, name: str, log: bool = False, device=None):
        from videosys_tpu_torch.core.pipeline import resolve_device

        self.name = name
        self.log = log
        self.device = resolve_device(device)
        self.elapsed = 0.0
        self.memory: dict = {}

    def __enter__(self):
        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            start, end = self._events
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            self.elapsed = start.elapsed_time(end) / 1e3
        else:
            self.elapsed = time.perf_counter() - self._t0
        self.memory = device_memory_stats(self.device)
        if self.log:
            mem = self.memory.get("peak_bytes_in_use")
            extra = f" peak={mem / 2**30:.2f}GiB" if mem else ""
            print(f"[timer] {self.name}: {self.elapsed:.3f}s{extra}")
        return False


class GroupTimer(Timer):
    """Timer whose exit also waits for every rank of `groups` (the
    reference's all-reduce, utils/training.py:120-148: a one-element
    all-reduce over the groups' world), so that the time includes the wait
    for the slowest rank; on one rank a plain Timer. Every rank of the
    groups must exit its GroupTimer."""

    def __init__(self, name: str, groups=None, log: bool = False,
                 device=None):
        if groups is not None and device is None:
            device = groups.device
        super().__init__(name, log=log, device=device)
        self.groups = groups if groups is not None and \
            groups.world_size > 1 else None

    def __exit__(self, *exc):
        if self.groups is not None:
            token = torch.ones(1, device=self.groups.device)
            dist.all_reduce(token)  # the default group: every rank
        return super().__exit__(*exc)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """`with profile_trace(logdir): ...` records the block's host (CPU)
    activity and, when a card is present, its CUDA kernels and copies with
    `torch.profiler`, and on exit writes them to
    `logdir/trace_{pid}_{time_ns}.json` (open it in Perfetto or
    chrome://tracing), also when the block raises. Yields `logdir`;
    starts no work of its own."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:  # as the JAX package's: the trace is written if the block raises
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

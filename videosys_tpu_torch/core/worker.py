"""A rank of a multi-rank `VideoSysEngine`: the worker processes' entry
point and the set-up every rank runs (the reference's
`core/engine/mp_utils.py` workers).

Each rank joins the default process group and builds its target: a
serving rank (`setup_rank`) the groups of
`ParallelConfig.from_world_size(num_gpus, enable_cp)` (enable_cp False
where the config has none) and the configured pipeline on its own device;
a training rank (`setup_train_rank`) the groups of
`ParallelConfig(dp_size, 1, sp_size)` for `run_training`. A worker then
serves the driver's calls over its end of a pipe: after ("setup", setup,
setup_args, numerics), ("call", method, args, kwargs) runs `method` (a
method's name of the target, or a function called with the target first)
and answers ("ok", result); ("stop",) ends it. A call that raises answers ("error",
the traceback) and the worker exits, so the ranks blocked on it in a
collective fail at once instead of at the timeout.
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Callable, Union

import torch
import torch.distributed as dist

from videosys_tpu_torch.core import parallel as par


def numerics() -> dict:
    """The process-wide float settings a rank's kernels depend on; the
    workers take the driver's, so that every rank computes as rank 0."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def set_numerics(values: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = values["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = values["cudnn_tf32"]
    torch.backends.cudnn.benchmark = values["cudnn_benchmark"]


def setup_rank(rank: int, world_size: int, address: str, backend: str,
               timeout: float, device, config, pipeline_kwargs: dict):
    """Join the world and build this rank's groups and pipeline."""
    par.initialize(rank, world_size, address, backend=backend, device=device,
                   timeout=timeout)
    groups = par.build_groups(par.ParallelConfig.from_world_size(
        world_size, enable_cp=getattr(config, "enable_cp", False)), device)
    return config.pipeline_cls(config, device=device, groups=groups,
                               **pipeline_kwargs)


class TrainRank:
    """A training rank's target: its config, device and groups."""

    def __init__(self, cfg, device, groups):
        self.cfg, self.device, self.groups = cfg, device, groups

    def run(self, **kwargs):
        """`run_training` on this rank: rank 0 gets its whole result, the
        others (train_state, ema) None and the metrics history, which every
        rank holds the same."""
        from videosys_tpu_torch.training.train import run_training

        out = run_training(self.cfg, device=self.device, groups=self.groups,
                           **kwargs)
        return out if self.groups.rank == 0 else (None, None, out[2])


def setup_train_rank(rank: int, world_size: int, address: str, backend: str,
                     timeout: float, device, cfg) -> TrainRank:
    """Join the world and build this rank's training groups."""
    par.initialize(rank, world_size, address, backend=backend, device=device,
                   timeout=timeout)
    groups = par.build_groups(par.ParallelConfig(cfg.dp_size, 1,
                                                 cfg.sp_size), device)
    return TrainRank(cfg, device, groups)


def call(pipeline, method: Union[str, Callable], args, kwargs) -> Any:
    if isinstance(method, str):
        return getattr(pipeline, method)(*args, **kwargs)
    return method(pipeline, *args, **kwargs)


def worker_main(rank: int, world_size: int, address: str, backend: str,
                timeout: float, device, conn) -> None:
    """The entry point of worker process `rank` (spawned). Its first
    message is ("setup", setup, setup_args, the driver's `numerics`): sent
    after the start, so that the workers start together (a large argument
    of the start itself blocks the driver until that worker has imported
    torch); `setup(rank, world_size, address, backend, timeout, device,
    *setup_args)` builds the rank's target (`setup_rank`,
    `setup_train_rank`)."""
    try:
        _, setup, setup_args, values = conn.recv()
        set_numerics(values)
        pipeline = setup(rank, world_size, address, backend, timeout, device,
                         *setup_args)
        conn.send(("ok", None))
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            _, method, args, kwargs = msg
            conn.send(("ok", call(pipeline, method, args, kwargs)))
    except EOFError:  # the driver is gone
        os._exit(1)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        os._exit(1)
    dist.destroy_process_group()
    conn.send(("ok", None))
    conn.close()
    os._exit(0)  # skip the interpreter's teardown: nothing is left to flush

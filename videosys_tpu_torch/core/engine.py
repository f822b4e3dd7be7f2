"""VideoSysEngine, the public entry point: builds the configured pipeline
and delegates to it; `initialize`, the reference's process setup.

With `config.num_gpus = N > 1` the engine is the reference's multi-process
engine (`videosys/core/engine/engine.py`, `mp_utils.py`): it spawns N - 1
worker processes (`core/worker.py`), the driver is rank 0, every rank joins
one process group and builds the same pipeline on its own device, and each
call runs on every rank. A monitor thread (the reference's WorkerMonitor,
mp_utils.py:111-151) reads the workers' answers and watches their
processes: a worker that raises or dies fails the driver's call with the
worker's error. `run_training_ranks` spawns training ranks the same way
(`core/worker.py`'s `setup_train_rank`), rank 0 in the caller's process.
"""

from __future__ import annotations

import queue
import threading
import time
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.parallel import initialize
from videosys_tpu_torch.core.worker import (
    call,
    numerics,
    setup_rank,
    setup_train_rank,
    worker_main,
)
from videosys_tpu_torch.utils.video import save_video as _save_video

__all__ = ["VideoSysEngine", "WorkerError", "initialize",
           "run_training_ranks"]

# after the driver's own call fails, how long it waits for a worker's error
FAILURE_WAIT_S = 10.0


class WorkerError(RuntimeError):
    """A worker rank raised or died; the message carries its traceback."""


class _Monitor(threading.Thread):
    """Reads every worker's answers into its queue and watches the worker
    processes. The first error or death is kept in `failure`; under NCCL
    it also aborts the driver's process group, so that a collective the
    driver is blocked in returns (gloo's return when the worker's sockets
    close)."""

    def __init__(self, workers, backend: str):
        super().__init__(daemon=True, name="videosys-worker-monitor")
        self.workers = workers
        self.backend = backend
        self.replies = [queue.Queue() for _ in workers]
        self.failure: Optional[str] = None
        self.stopping = False

    def _fail(self, message: str) -> None:
        if self.failure is None:
            self.failure = message
            abort = getattr(dist.distributed_c10d, "_abort_process_group",
                            None)
            if self.backend == "nccl" and abort is not None:
                abort()

    def run(self) -> None:
        conns = {conn: i for i, (_, conn) in enumerate(self.workers)}
        procs = {p.sentinel: i for i, (p, _) in enumerate(self.workers)}
        while conns or procs:
            for ready in wait(list(conns) + list(procs)):
                if ready in conns:
                    i = conns[ready]
                    try:
                        msg = ready.recv()
                    except (EOFError, OSError):
                        del conns[ready]
                        continue
                    if msg[0] == "error":
                        self._fail(f"rank {i + 1} raised:\n{msg[1]}")
                    self.replies[i].put(msg)
                else:
                    i = procs.pop(ready)
                    if not self.stopping:
                        # a worker that raised sent its error before exiting
                        self._fail(f"rank {i + 1} exited with code "
                                   f"{self.workers[i][0].exitcode}")


class Ranks:
    """Rank 0 in this process and N - 1 spawned workers (`worker_main`),
    each of which builds its target with `setup(rank, world_size, address,
    backend, timeout, device, *setup_args)`; `_run_workers` runs a call on
    every rank, a monitor thread fails it with the first worker's error.
    The driver's target is `driver_worker`."""

    def _spawn(self, n: int, setup: Callable, setup_args: tuple, devs,
               backend: Optional[str], timeout: float) -> None:
        self.world_size = n
        self.timeout = timeout
        self._workers: List = []
        self._broken: Optional[str] = None
        self.backend = backend or par.default_backend(devs[0])
        address = f"localhost:{par.free_port()}"
        ctx = torch.multiprocessing.get_context("spawn")
        for r in range(1, n):
            conn, child = ctx.Pipe()
            p = ctx.Process(
                target=worker_main, name=f"videosys-rank{r}", daemon=True,
                args=(r, n, address, self.backend, timeout, devs[r], child))
            p.start()
            child.close()
            self._workers.append((p, conn))
        self._monitor = _Monitor(self._workers, self.backend)
        self._monitor.start()
        try:
            for _, conn in self._workers:
                conn.send(("setup", setup, setup_args, numerics()))
            self.driver_worker = setup(0, n, address, self.backend, timeout,
                                       devs[0], *setup_args)
        except BaseException as e:
            self._fail(e)
        self._answers()

    def _answers(self) -> List[Any]:
        """Each worker's answer to the last call, in rank order."""
        out = []
        for i, replies in enumerate(self._monitor.replies):
            try:
                msg = replies.get(timeout=self.timeout)
            except queue.Empty:
                self._fail(WorkerError(f"rank {i + 1} did not answer in "
                                       f"{self.timeout} s"))
            if msg[0] != "ok":
                self._fail(None)
            out.append(msg[1])
        return out

    def _fail(self, error: Optional[BaseException]):
        """Stop every worker and raise the first worker's failure (from
        `error`, the driver's own) or else `error`; the engine is unusable
        afterwards."""
        deadline = time.monotonic() + FAILURE_WAIT_S
        while self._monitor.failure is None and time.monotonic() < deadline:
            time.sleep(0.05)  # a failing worker's error is on its way
        failure = self._monitor.failure
        self._broken = failure or repr(error)
        self._stop_workers(graceful=False)
        if failure is not None:
            raise WorkerError(failure) from error
        raise error

    def _run_workers(self, method: Union[str, Callable], *args, **kwargs):
        """Run `method` (a pipeline method's name, or a function called with
        the pipeline first) on every rank; each rank's result, rank 0
        first."""
        if self._broken is not None:
            raise RuntimeError(f"the engine failed before ({self._broken}); "
                               f"make a new one")
        try:
            for _, conn in self._workers:
                conn.send(("call", method, args, kwargs))
            own = call(self.driver_worker, method, args, kwargs)
        except BaseException as e:
            if not self._workers:
                raise
            self._fail(e)
        return [own] + (self._answers() if self._workers else [])

    def _stop_workers(self, graceful: bool) -> None:
        if self._monitor is not None:
            self._monitor.stopping = True
        for p, conn in self._workers:
            if not p.is_alive():
                continue
            if not graceful:  # it may be blocked in a collective
                p.kill()
                continue
            try:
                conn.send(("stop",))
            except OSError:
                pass
        for p, _ in self._workers:
            p.join(timeout=self.timeout)
            if p.is_alive():
                p.kill()
                p.join()
        if dist.is_initialized():
            dist.destroy_process_group()
        self._workers = []

    def shutdown(self):
        """Stop and join the worker processes and leave the process group;
        a one-rank engine has none."""
        if self._workers:
            self._stop_workers(graceful=self._broken is None)
            self._broken = self._broken or "shut down"


class VideoSysEngine(Ranks):
    """`VideoSysEngine(config).generate(prompt)`; the pipeline is
    `driver_worker` (also `pipeline`).

    With `config.num_gpus = N > 1`: `devices` names each rank's device
    (default `cuda:r` for rank r; `device=` sets one device for every rank,
    e.g. "cpu"), `backend` the process group's ("nccl" for CUDA devices,
    "gloo" for the CPU, by default), `timeout` how long a collective or a
    worker's answer may take, in seconds. `generate` returns rank 0's
    video; `shutdown` stops the workers."""

    def __init__(self, config: Any, devices: Optional[Sequence] = None,
                 backend: Optional[str] = None,
                 timeout: float = par.DEFAULT_TIMEOUT_S, **pipeline_kwargs):
        self.config = config
        self.world_size = getattr(config, "num_gpus", 1)
        self.timeout = timeout
        self._workers: List = []
        self._monitor: Optional[_Monitor] = None
        self._broken: Optional[str] = None
        if self.world_size <= 1:
            self.driver_worker = config.pipeline_cls(config, **pipeline_kwargs)
            return
        if not getattr(config.pipeline_cls, "serves_parallel", False):
            raise NotImplementedError(
                f"{config.pipeline_cls.__name__} runs on one rank: it does "
                f"not take process groups (num_gpus={self.world_size})")
        n = self.world_size
        devs = par.rank_devices(n, pipeline_kwargs.pop("device", None),
                                devices)
        self._spawn(n, setup_rank, (config, pipeline_kwargs), devs, backend,
                    timeout)

    @property
    def pipeline(self):
        return self.driver_worker

    def generate(self, *args, **kwargs):
        return self._run_workers("generate", *args, **kwargs)[0]

    def save_video(self, video, output_path: str, fps: int = 24):
        return _save_video(video, output_path, fps=fps)


def run_training_ranks(cfg, devices: Optional[Sequence] = None,
                       backend: Optional[str] = None,
                       timeout: float = par.DEFAULT_TIMEOUT_S, **kwargs):
    """`run_training(cfg, **kwargs)` on dp_size x sp_size ranks: N - 1
    spawned workers and rank 0 in this process, each on its device
    (`devices`, else `device=` for every rank, else `cuda:r`), over
    `backend`'s process group. Returns rank 0's (train_state, ema,
    metrics_history); the workers are stopped before it returns."""
    n = cfg.dp_size * cfg.sp_size
    devs = par.rank_devices(n, kwargs.pop("device", None), devices)
    ranks = Ranks()
    ranks._spawn(n, setup_train_rank, (cfg,), devs, backend, timeout)
    try:
        return ranks._run_workers("run", **kwargs)[0]
    finally:
        ranks.shutdown()

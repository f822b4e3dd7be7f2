"""Hang watchdog — host-side heartbeat over the device and the ranks.

Port of `videosys_tpu/utils/watchdog.py`, same API with `groups=` in place
of `mesh=`. Behavioral reference: the reference builds a Gloo twin of every
NCCL sp group "for monitoring hangs by nccl internal error" with a 60 s
timeout (core/distributed/parallel_mgr.py:58-80) and an engine
WorkerMonitor that fails futures when a worker dies
(core/engine/mp_utils.py:111-151; here `core/engine.py`).

A daemon thread periodically runs a beat: a one-element op on the rank's
device, then, when groups of more than one rank are given, a one-element
all-reduce over their `monitor` group — a gloo group built for the
heartbeat alone at start-up (`parallel.build_groups`). The beat never uses
a group that carries the model's collectives: two threads issuing
collectives on one group can reach the ranks in different orders, and then
the ranks deadlock. Every rank runs its own watchdog at the same interval.
If a beat misses its deadline, ``on_hang`` is called (default: log
CRITICAL with thread stacks); it may abort the process for an external
supervisor to restart.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import sys
import threading
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def _default_beat(groups=None) -> float:
    device = groups.device if groups is not None else (
        torch.device("cuda") if torch.cuda.is_available() else
        torch.device("cpu"))
    value = float(torch.ones((), device=device) + 1.0)  # device round trip
    if groups is not None and groups.monitor is not None:
        x = torch.ones(1)
        dist.all_reduce(x, group=groups.monitor)  # every rank answers
        value = float(x)
    return value


def _log_hang(elapsed: float):
    frames = sys._current_frames()
    stacks = "\n".join(
        f"--- thread {tid}\n" + "".join(traceback.format_stack(frame))
        for tid, frame in frames.items())
    logger.critical(
        "watchdog: heartbeat missed its deadline (%.1fs) — the device or a "
        "rank appears hung. Thread stacks:\n%s", elapsed, stacks)


class Watchdog:
    """Periodic heartbeat with a deadline.

    >>> wd = Watchdog(interval=30.0, timeout=60.0, groups=groups)
    >>> wd.start()
    ... serving ...
    >>> wd.stop()
    """

    def __init__(self, interval: float = 30.0, timeout: float = 60.0,
                 groups=None, beat_fn: Optional[Callable] = None,
                 on_hang: Optional[Callable[[float], None]] = None):
        self.interval = interval
        self.timeout = timeout
        self.groups = groups
        self.beat_fn = beat_fn or (lambda: _default_beat(self.groups))
        self.on_hang = on_hang or _log_hang
        self.beats = 0
        self.hangs = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the beat itself runs in a worker so a wedged runtime cannot also
        # wedge the watchdog loop
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="watchdog-beat")
        self._pending: Optional[cf.Future] = None

    def _loop(self):
        while not self._stop.is_set():
            if self._pending is not None and not self._pending.done():
                # a previous beat is still wedged in the single worker: a new
                # submit would only queue behind it (and would never run if
                # the runtime stays hung), so wait on the SAME future — the
                # moment it completes the runtime has recovered and the next
                # iteration beats normally.
                fut = self._pending
            else:
                fut = self._pool.submit(self.beat_fn)
            self._pending = fut
            try:
                fut.result(timeout=self.timeout)
                self.beats += 1
                self._pending = None
            except cf.TimeoutError:
                self.hangs += 1
                self.on_hang(self.timeout)
            except Exception as e:  # runtime raised — also a failure signal
                self.hangs += 1
                self._pending = None
                logger.critical("watchdog: heartbeat failed: %s", e)
                self.on_hang(0.0)
            self._stop.wait(self.interval)

    def start(self) -> "Watchdog":
        if self._thread is None:
            # stop() shuts the pool down; a restarted watchdog needs a live one
            if getattr(self._pool, "_shutdown", False):
                self._pool = cf.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="watchdog-beat")
            self._pending = None
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="watchdog")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + self.interval)
            self._thread = None
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

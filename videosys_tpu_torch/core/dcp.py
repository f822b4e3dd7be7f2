"""DCP (Data-Centric Parallel) profiler on one CUDA device.

Port of `videosys_tpu/core/dcp.py`. Behavioral reference:
`videosys/core/dcp/profiler.py` (Profiler :157-903: a profile run with bs
doubling until OOM :498-764, sp escalation :651-708, dynamics selection
:799-822) and `core/dcp/recompute.py`.

The JAX package reads each candidate's memory from the compiled XLA plan
without running it. Torch has no such plan, so here each candidate is run:
one warm step, then one timed step (CUDA events). Its memory is the peak of
the card's caching allocator over both, `torch.cuda.max_memory_reserved()`
after `empty_cache()` and `reset_peak_memory_stats()`: reserved bytes
include the fragmentation that makes an allocation fail, which allocated
bytes do not show. With `measure_wall_time=False` the one step run is
counted by `FlopCounterMode` instead, for the JAX package's time prior
(FLOPs / 1e12); a timed candidate is not counted, because the counter
keeps the tensors of a recomputed forward alive until it exits (on an H100
a recomputed 240p step then held ~54 GiB more at its optimizer update). A
candidate
fits iff that peak is within `memory_budget_bytes * alloc_memory_fraction`
and the run raised nothing; an out-of-memory error (or any other error of
the run) is a non-fit, recorded in `failures` with phase "execute" (over
ranks it stops the world instead: see `Profiler`). On the
CPU there is no allocator to read: pass `peak_bytes(thw, bs, sp, policy)`.
"""

from __future__ import annotations

import dataclasses
import gc
import inspect
import logging
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import torch

from videosys_tpu_torch.utils.timing import Timer

if TYPE_CHECKING:  # the training package imports this module
    from videosys_tpu_torch.training.buckets import Bucket, BucketId
    from videosys_tpu_torch.training.sampler import DCPPlanner

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BucketProfile:
    bucket_id: BucketId
    bs: int
    sp: int
    time: float            # seconds per step (measured, or FLOPs / 1e12)
    memory_bytes: int      # peak reserved by the allocator over the run
    flops: float           # FLOPs of one step (counted only when not timed)
    fits: bool
    remat_policy: str = "full"


class Profiler:
    """Per-bucket profiling of a train step.

    `step_builder(thw, bs, sp[, policy]) -> (fn, args)` returns the train
    step specialized to one bucket shape (with a `policy` keyword it is
    asked for each recompute policy in `remat_candidates`); `fn(*args)`
    runs one whole step. The profiler calls it twice per candidate (warm,
    then timed), or once with `measure_wall_time=False`, so the step must
    be repeatable and should leave nothing the caller needs changed.

    `memory_budget_bytes` defaults to the card's memory; `peak_bytes`
    replaces the allocator's reading (required without a card). `agree(peak,
    seconds, fits) -> (peak, seconds, fits)`, given, turns a rank's reading
    into the one every rank of a world acts on, so that all run the same
    candidates: the ranks agree on each build (a candidate that one rank
    fails to build is skipped by all) and on each reading. A run that
    raises on one rank leaves the others inside the step's collectives, so
    under `agree` it stops the world with an error, and the bs ladder takes
    a rung only where twice the last rung's peak fits the budget (a step's
    peak at twice the batch is at most twice its peak). `trials`
    lists every candidate profiled, in order; `results` the chosen one per
    bucket; `failures` every candidate that failed to build or to run."""

    def __init__(
        self,
        bucket: Bucket,
        step_builder: Callable,
        memory_budget_bytes: Optional[int] = None,
        sp_candidates: Tuple[int, ...] = (1,),
        measure_wall_time: bool = True,
        alloc_memory_fraction: float = 0.92,
        remat_candidates: Tuple[str, ...] = ("full",),
        bs_escalate: bool = True,
        max_bs: int = 128,
        peak_bytes: Optional[Callable[..., int]] = None,
        agree: Optional[Callable] = None,
    ):
        self.bucket = bucket
        self.agree = agree
        self.step_builder = step_builder
        self.peak_bytes = peak_bytes
        self.device = torch.device("cuda" if peak_bytes is None else "cpu")
        if peak_bytes is None and not torch.cuda.is_available():
            raise RuntimeError(
                "the profiler reads the card's allocator; without a card "
                "pass peak_bytes(thw, bs, sp, policy)")
        if memory_budget_bytes is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no card to take the memory budget from; "
                                   "pass memory_budget_bytes")
            memory_budget_bytes = torch.cuda.get_device_properties(0).total_memory
        # the reference caps at 0.70 of the card (profiler.py:500-503) for
        # fragmentation; the peak read here is reserved bytes, fragmentation
        # included, so the margin covers only what one step cannot show
        self.memory_budget = int(memory_budget_bytes * alloc_memory_fraction)
        self.sp_candidates = tuple(sorted(sp_candidates))
        # recompute escalation, least recompute first; consulted only if
        # step_builder takes a `policy` keyword
        self.remat_candidates = tuple(remat_candidates)
        try:
            self._builder_takes_policy = (
                "policy" in inspect.signature(step_builder).parameters)
        except (TypeError, ValueError):
            self._builder_takes_policy = False
        self.measure_wall_time = measure_wall_time
        # bs ladder: after a (sp, policy) fit, keep doubling bs while the
        # step still fits (the reference's bs doubling until OOM)
        self.bs_escalate = bs_escalate
        self.max_bs = max_bs
        self.results: Dict[BucketId, BucketProfile] = {}
        self.trials: List[BucketProfile] = []
        self.failures: List[dict] = []

    # ------------------------------------------------------------------ #
    def _build(self, thw, bs: int, sp: int, policy: str):
        if self._builder_takes_policy:
            return self.step_builder(thw, bs, sp, policy=policy)
        return self.step_builder(thw, bs, sp)

    def _run(self, fn, args, thw, bs: int, sp: int,
             policy: str) -> Tuple[int, float, float]:
        """(peak bytes, seconds, FLOPs) of the step: a warm run and a timed
        one, or one run whose FLOPs give the time prior."""
        from torch.utils.flop_counter import FlopCounterMode

        if self.peak_bytes is None:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        flops = 0.0
        if self.measure_wall_time:
            fn(*args)
            with Timer("dcp step", device=self.device) as timer:
                fn(*args)
            seconds = timer.elapsed
        else:
            counter = FlopCounterMode(display=False)
            with counter:
                fn(*args)
            flops = float(counter.get_total_flops())
            seconds = flops / 1e12
        if self.peak_bytes is not None:
            peak = int(self.peak_bytes(thw, bs, sp, policy))
        else:
            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_reserved())
        return peak, seconds, flops

    def _candidate(self, bucket_id, thw, bs: int, sp: int,
                   policy: str) -> Optional[BucketProfile]:
        """Build and run one candidate; None when it failed to build. A run
        that raises is a non-fit; its error is recorded and every reference
        to it (and to the activations its frames hold) is dropped before
        the card's cache is emptied for the next candidate."""
        where = {"bucket": bucket_id, "bs": bs, "sp": sp, "policy": policy}
        error = None
        try:
            fn, args = self._build(thw, bs, sp, policy)
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
        if self.agree is not None:  # a candidate any rank failed to build
            built = self.agree(0, 0.0, error is None)[2]  # is skipped by all
            if error is None and not built:
                error = "another rank failed to build it"
        if error is not None:
            self.failures.append({**where, "error": error})
            logger.warning("DCP profile failed to build bucket=%s bs=%d sp=%d "
                           "policy=%s: %s", bucket_id, bs, sp, policy, error)
            return None
        try:
            peak, seconds, flops = self._run(fn, args, thw, bs, sp, policy)
        except Exception as e:  # out of memory, or any fault of the run
            if self.agree is not None:
                # the other ranks wait inside the step's collectives, which
                # no call of this rank can meet: the world stops
                raise RuntimeError(
                    f"DCP profile candidate {where} failed on this rank of a "
                    f"world ({type(e).__name__}: {e}); the world cannot go "
                    f"on") from e
            error = f"{type(e).__name__}: {e}"
        fn = args = None
        if self.agree is not None:
            peak, seconds, fits = self.agree(
                0 if error else peak, float("inf") if error else seconds,
                error is None and peak <= self.memory_budget)
            if not fits and error is None:
                error = "another rank did not fit"
        if error is not None:
            gc.collect()
            if self.peak_bytes is None:
                torch.cuda.empty_cache()
            self.failures.append({**where, "phase": "execute", "error": error})
            logger.warning("DCP profile run failed for bucket=%s bs=%d sp=%d "
                           "policy=%s: %s", bucket_id, bs, sp, policy, error)
            prof = BucketProfile(bucket_id, bs, sp, float("inf"), 0, 0.0,
                                 False, policy)
        else:
            prof = BucketProfile(bucket_id, bs, sp, seconds, peak, flops,
                                 peak <= self.memory_budget, policy)
        self.trials.append(prof)
        return prof

    def profile_bucket(self, bucket_id: BucketId, bs: int) -> BucketProfile:
        """Escalate sp (x2, :651-708), and within each sp the recompute
        policy, until a candidate fits; then climb the bs ladder."""
        thw = self.bucket.get_thw(bucket_id)
        policies = (self.remat_candidates
                    if self._builder_takes_policy else ("full",))
        last = None
        for sp in self.sp_candidates:
            for policy in policies:
                prof = self._candidate(bucket_id, thw, bs, sp, policy)
                if prof is None:
                    continue
                last = prof
                if last.fits:
                    break
            if last is not None and last.fits:
                break
        if last is None:
            last = BucketProfile(bucket_id, bs, self.sp_candidates[0],
                                 float("inf"), 0, 0.0, False, policies[-1])
        if last.fits and self.bs_escalate:
            last = self._escalate_bs(thw, last)
        self.results[bucket_id] = last
        return last

    def _escalate_bs(self, thw, prof: BucketProfile) -> BucketProfile:
        """Double bs at the fitting (sp, policy) while the step fits the
        budget; a rung that does not fit, or fails, ends the ladder and the
        last rung that fitted is kept. Under `agree` the ladder also ends
        before a rung whose peak could pass the budget."""
        best = prof
        bs = prof.bs * 2
        while bs <= self.max_bs:
            if self.agree is not None and 2 * best.memory_bytes > \
                    self.memory_budget:
                break  # a rung that might not fit could stop the world
            rung = self._candidate(prof.bucket_id, thw, bs, prof.sp,
                                   prof.remat_policy)
            if rung is None or not rung.fits:
                break
            best = rung
            bs *= 2
        if best.bs != prof.bs:
            logger.info("DCP bs ladder: bucket=%s bs %d -> %d (mem %.2f GiB)",
                        prof.bucket_id, prof.bs, best.bs,
                        best.memory_bytes / 2**30)
        return best

    def profile_all(self) -> Dict[BucketId, BucketProfile]:
        for hw_id, t_probs in self.bucket.bucket_probs.items():
            for t_id in t_probs:
                ar_id = next(iter(self.bucket.ar_criteria[hw_id]))
                bid = (hw_id, t_id, ar_id)
                bs = max(1, self.bucket.get_batch_size(bid))
                self.profile_bucket(bid, bs)
        return self.results

    # ------------------------------------------------------------------ #
    def make_planner(self) -> DCPPlanner:
        """Profiles -> the sampler's (sp, gas, policy, bs) planner
        (optimize_dynamics :799-822: balance every step to the slowest
        bucket's step time)."""
        from videosys_tpu_torch.training.sampler import DCPPlanner

        profile = {
            bid: {"time": p.time, "sp": p.sp, "remat_policy": p.remat_policy,
                  "bs": p.bs}
            for bid, p in self.results.items() if p.fits
        }
        target = max((p["time"] for p in profile.values()), default=None)
        return DCPPlanner(profile=profile, target_time=target)

    def dump(self) -> dict:
        out = {
            str(bid): dataclasses.asdict(p) for bid, p in self.results.items()
        }
        if self.failures:
            out["_failures"] = [dict(f, bucket=str(f["bucket"]))
                                for f in self.failures]
        return out

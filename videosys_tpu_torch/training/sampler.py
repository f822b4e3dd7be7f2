"""Variable-video batch sampler with DCP dynamic scheduling.

Behavioral reference: `videosys/training/datasets/open_sora/sampler.py`
(VariableVideoBatchSampler :73-1098 — bucketization :300-326, plain
bucketized schedule :142-285, grad-acc balance :328-575, sp-balance
:576-871, resumable state :1090-1098).

A copy of `videosys_tpu/training/sampler.py` (numpy only). The sampler
emits global batch plans: each `BatchPlan` is one bucket's batch of one
shape, tagged with the (sp_size, gas) a DCP profile selected.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from videosys_tpu_torch.training.buckets import Bucket, BucketId


@dataclasses.dataclass
class BatchPlan:
    bucket_id: BucketId
    indices: List[int]      # dataset rows: bs * gas samples (gas micro-batches)
    sp_size: int = 1
    gas: int = 1            # gradient accumulation steps
    thw: Tuple[int, int, int] = (1, 0, 0)

    def micro_batches(self) -> List[List[int]]:
        """Split into `gas` equal micro-batches (the reference's collate
        groups rows by gas the same way, dataloader.py:105-120)."""
        bs = len(self.indices) // self.gas
        return [self.indices[k * bs:(k + 1) * bs] for k in range(self.gas)]


@dataclasses.dataclass
class GlobalStep:
    """One mesh-wide step under dynamic sp: concurrent plans whose sp sizes
    sum to the device count (the reference packs buckets of differing sp into
    exactly world_size GPUs, sampler.py:576-871). `imbalance` mirrors the
    reference's telemetry (:929-958)."""

    plans: List[BatchPlan]
    est_times: List[float]

    @property
    def imbalance(self) -> float:
        if not self.est_times or max(self.est_times) == 0:
            return 0.0
        return 1.0 - (sum(self.est_times) / len(self.est_times)) / max(self.est_times)


def pack_global_steps(plans: Sequence[BatchPlan], world_size: int,
                      profile: Optional[dict] = None) -> List[GlobalStep]:
    """sp-balance packing: greedy first-fit-decreasing of plans into steps of
    exactly `world_size` chips. Each plan occupies `sp_size` chips for
    `time(bucket) * gas` seconds (estimated from the DCP profile); plans in a
    step run concurrently on disjoint device groups.
    """
    def est(p: BatchPlan) -> float:
        if profile and p.bucket_id in profile:
            return float(profile[p.bucket_id].get("time", 1.0)) * p.gas
        return float(p.gas)

    order = sorted(plans, key=est, reverse=True)
    steps: List[dict] = []
    for p in order:
        t = est(p)
        placed = False
        for st in steps:
            if st["chips"] + p.sp_size <= world_size:
                st["plans"].append(p)
                st["times"].append(t)
                st["chips"] += p.sp_size
                placed = True
                break
        if not placed:
            steps.append({"plans": [p], "times": [t], "chips": p.sp_size})
    return [GlobalStep(st["plans"], st["times"]) for st in steps]


@dataclasses.dataclass
class DCPPlanner:
    """Per-bucket (sp, gas) decisions from a profile table
    {bucket_id: {"time": seconds_per_micro_batch, "sp": sp_size}}.
    `optimize_dynamics` mirrors profiler.optimize_dynamics
    (core/dcp/profiler.py:799-822): pick the profiled sp, and choose gas so
    each global step costs about `target_time`."""

    profile: Dict[BucketId, dict]
    target_time: Optional[float] = None

    def _entry(self, bucket_id: BucketId) -> Optional[dict]:
        entry = self.profile.get(bucket_id)
        if entry is None:
            # the profiler measures one representative aspect ratio per
            # (resolution, frames) bucket (reference ProfileDataIter uses the
            # DEFAULT_AR_MAP shape, profiler.py:121-149) — match by prefix
            for bid, e in self.profile.items():
                if bid[:2] == bucket_id[:2]:
                    entry = e
                    break
        return entry

    def plan(self, bucket_id: BucketId) -> Tuple[int, int]:
        entry = self._entry(bucket_id)
        if entry is None:
            return 1, 1
        sp = int(entry.get("sp", 1))
        gas = 1
        if self.target_time and entry.get("time"):
            gas = max(1, round(self.target_time / float(entry["time"])))
        return sp, gas

    def remat_policy(self, bucket_id: BucketId, default: str = "full") -> str:
        """Per-bucket recompute policy chosen by the profiler (dynamic
        recompute — least recompute that fits memory)."""
        entry = self._entry(bucket_id)
        return (entry or {}).get("remat_policy", default)

    def bs(self, bucket_id: BucketId) -> Optional[int]:
        """Profiler-discovered max-fit micro-batch size for the bucket
        (the bs-doubling ladder, reference profiler.py:498-764); None when
        the bucket was not profiled — caller keeps the configured bs."""
        entry = self._entry(bucket_id)
        b = (entry or {}).get("bs")
        return int(b) if b else None


class VariableVideoBatchSampler:
    """Groups dataset rows into buckets and yields shape-static batch plans."""

    def __init__(
        self,
        bucket: Bucket,
        sample_shapes: Sequence[Tuple[int, int, int]],  # (T, H, W) per row
        batch_multiplier: int = 1,   # dp size: global batch = bs * multiplier
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        frame_interval: int = 1,
        planner: Optional[DCPPlanner] = None,
        verbose: bool = False,
    ):
        self.bucket = bucket
        self.sample_shapes = list(sample_shapes)
        self.batch_multiplier = batch_multiplier
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.frame_interval = frame_interval
        self.planner = planner
        self.verbose = verbose
        self.epoch = 0
        self.start_index = 0  # resume support (sampler.py:228-240)
        self.effective_samples = 0
        self.last_bucket_stats: Dict[BucketId, int] = {}

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def group_by_bucket(self) -> "OrderedDict[BucketId, List[int]]":
        """sampler.py:300-326 (pandarallel loop -> plain loop)."""
        groups: Dict[BucketId, List[int]] = defaultdict(list)
        for i, (T, H, W) in enumerate(self.sample_shapes):
            bid = self.bucket.get_bucket_id(
                T, H, W, self.frame_interval, seed=self.seed + self.epoch)
            if bid is not None:
                groups[bid].append(i)
        return OrderedDict(sorted(groups.items(), key=lambda kv: str(kv[0])))

    def _build_plans(self) -> List[BatchPlan]:
        rng = np.random.default_rng(self.seed + self.epoch)
        groups = self.group_by_bucket()
        self.last_bucket_stats = {k: len(v) for k, v in groups.items()}
        plans: List[BatchPlan] = []
        self.effective_samples = 0
        for bid, idxs in groups.items():
            idxs = np.asarray(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            base_bs = self.bucket.get_batch_size(bid)
            if self.planner is not None:
                # profiler-discovered max-fit bs (bs-doubling ladder)
                base_bs = self.planner.bs(bid) or base_bs
            bs = base_bs * self.batch_multiplier
            if bs <= 0:
                continue
            sp, gas = self.planner.plan(bid) if self.planner else (1, 1)
            # a plan carries gas micro-batches of bs DISTINCT samples each
            # (_calculate_grad_accumulation_num, sampler.py:328-368)
            chunk_size = bs * gas
            n_full = len(idxs) // chunk_size
            for j in range(n_full):
                chunk = idxs[j * chunk_size:(j + 1) * chunk_size].tolist()
                plans.append(BatchPlan(bid, chunk, sp, gas,
                                       self.bucket.get_thw(bid)))
                self.effective_samples += len(chunk)
            rem = len(idxs) % chunk_size
            if not self.drop_last and rem >= bs:
                # keep whole micro-batches only (shape-static)
                n_micro = rem // bs
                chunk = idxs[n_full * chunk_size:
                             n_full * chunk_size + n_micro * bs].tolist()
                plans.append(BatchPlan(bid, chunk, sp, n_micro,
                                       self.bucket.get_thw(bid)))
                self.effective_samples += len(chunk)
        if self.shuffle:
            order = rng.permutation(len(plans))
            plans = [plans[i] for i in order]
        return plans

    def __iter__(self) -> Iterator[BatchPlan]:
        plans = self._build_plans()
        for i, plan in enumerate(plans):
            if i < self.start_index:
                continue
            yield plan
        self.start_index = 0

    def __len__(self) -> int:
        return len(self._build_plans())

    # --- resume (sampler.py:1090-1098) -------------------------------- #
    def state_dict(self, step: int) -> dict:
        return {"seed": self.seed, "epoch": self.epoch, "start_index": step}

    def load_state_dict(self, state: dict):
        self.seed = state["seed"]
        self.epoch = state["epoch"]
        self.start_index = state["start_index"]

"""The DCP profile phase and `sp_balance` over ranks (dp=2 on gloo ranks on
the CPU): every rank profiles the same candidates at the run's own sp,
the ranks agree on each build and reading, rank 0's planner is every
rank's, and a candidate that raises on one rank stops the world instead
of leaving the others in a collective; the packed-step loop accumulates
each rank's gradient shares and updates once through ZeRO-1, with world
1's losses.

The CPU has no caching allocator: every rank's `Profiler` reads the same
table of peaks (`tiny_table`), installed in each worker by its set-up.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from videosys_tpu_torch.core import dcp as PD
from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.engine import Ranks, WorkerError
from videosys_tpu_torch.core.worker import setup_train_rank
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config
from videosys_tpu_torch.training import train as PTR
from videosys_tpu_torch.training.buckets import Bucket

GiB = 1 << 30


def tiny_table(thw, bs, sp, policy="full"):
    """Images fit with no recompute up to bs 2; 34-frame clips need
    "dots" and stop at bs 1 (a rank's batch)."""
    if thw[0] == 1:
        return (2 if bs <= 2 else 9) * GiB
    return {"none": 9, "dots": 2 if bs <= 1 else 9, "full": 1}[policy] * GiB


class TableProfiler(PD.Profiler):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, memory_budget_bytes=8 * GiB, peak_bytes=tiny_table,
                         alloc_memory_fraction=1.0, measure_wall_time=False,
                         **kw)
        self.made.append(self)


def setup_table_rank(rank, world_size, address, backend, timeout, device,
                     cfg):
    PTR.Profiler = TableProfiler  # this worker's profiler reads the table
    return setup_train_rank(rank, world_size, address, backend, timeout,
                            device, cfg)


def _config(**kw):
    base = dict(
        model=STDiT3Config(depth=1, hidden_size=32, num_heads=2,
                           caption_channels=16, model_max_length=8),
        bucket_config={"144p": {1: (1.0, 1), 34: (1.0, 1)}},
        mask_ratios=None, lr=2e-3, warmup_steps=1, max_steps=3, log_every=1,
        dataset_size=48, seed=3, dp_size=2)
    base.update(kw)
    return PTR.TrainConfig(**base)


def setup_plain_rank(rank, world_size, address, backend, timeout, device):
    """Join the world; the rank's target is its index."""
    par.initialize(rank, world_size, address, backend=backend, device=device,
                   timeout=timeout)
    return rank


def profile_on_rank(rank: int, fail: str):
    """One image bucket profiled on this rank under the world's `agree`,
    each step an all-reduce over the world; rank 1 fails policy "none" at
    its build or at its run (`fail`). bs 2 peaks at 5 GiB of 8, bs 4 would
    at 9. (trials, failures) of this rank."""

    def step_builder(thw, bs, sp, policy):
        if rank == 1 and policy == "none" and fail == "build":
            raise ValueError("injected build failure")

        def run():
            if rank == 1 and policy == "none" and fail == "run":
                raise RuntimeError("injected run failure")
            dist.all_reduce(torch.ones(1))  # the step's collective
        return run, ()

    prof = PD.Profiler(
        Bucket({"144p": {1: (1.0, 2)}}), step_builder,
        memory_budget_bytes=8 * GiB, alloc_memory_fraction=1.0,
        peak_bytes=lambda thw, bs, sp, policy: (5 if bs <= 2 else 9) * GiB,
        remat_candidates=("none", "dots"), agree=PTR._world_agree)
    prof.profile_all()
    return ([(p.bs, p.remat_policy, p.fits) for p in prof.trials],
            [f["error"] for f in prof.failures])


def _profile_world(fail: str):
    ranks = Ranks()
    ranks._spawn(2, setup_plain_rank, (), ["cpu", "cpu"], "gloo", 60.0)
    try:
        return ranks._run_workers(profile_on_rank, fail)
    finally:
        ranks.shutdown()


def test_profile_over_ranks_agrees_on_builds():
    """A candidate that one rank fails to build is skipped by every rank
    (so that their steps' collectives still meet), and the bs ladder stops
    before a rung whose peak could pass the budget (2 x 5 GiB > 8): a rung
    that ran out of memory on one rank would stop the world."""
    (trials0, fail0), (trials1, fail1) = _profile_world("build")
    assert trials0 == trials1 == [(2, "dots", True)]
    assert fail0 == ["another rank failed to build it"]
    assert fail1 == ["ValueError: injected build failure"]


def test_profile_run_failure_on_one_rank_stops_the_world():
    """A run that raises on rank 1 while rank 0 waits in the step's
    all-reduce stops the world with rank 1's error, well inside the
    collective's 60 s timeout, instead of hanging or mismatching calls."""
    t0 = time.monotonic()
    with pytest.raises(WorkerError, match="injected run failure"):
        _profile_world("run")
    assert time.monotonic() - t0 < 50


def _run(cfg, **kwargs):
    ranks = Ranks()
    ranks._spawn(2, setup_table_rank, (cfg,), ["cpu", "cpu"], "gloo", 300.0)
    try:
        return ranks._run_workers("run", **kwargs)
    finally:
        ranks.shutdown()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every rank computes on one CPU thread (the ranks share this CPU)."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"  # read by the spawned workers
    yield
    torch.set_num_threads(threads)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_dynamic_profile_over_ranks(monkeypatch):
    """dp=2 with the profile phase: the candidates and decisions of the
    table on every rank (rank 0's recorded here), the run trains with
    them, every rank's history the same."""
    monkeypatch.setattr(PTR, "Profiler", TableProfiler)
    TableProfiler.made = []
    cfg = _config(dynamic_profile=True, dynamic_recompute=True)
    results = _run(cfg)
    (prof,) = TableProfiler.made  # rank 0's, in this process
    decided = {bid[:2]: (p.bs, p.remat_policy)
               for bid, p in prof.results.items()}
    assert decided == {("144p", 1): (2, "none"), ("144p", 34): (1, "dots")}
    histories = [r[2] for r in results]
    assert histories[0] == histories[1] and len(histories[0]) == 3
    # the sampler's global batch: the planner's bs a rank x dp
    assert {(h["batch"], h["remat_policy"]) for h in histories[0]} <= {
        (4, "none"), (2, "dots")}
    assert all(np.isfinite(h["loss"]) for h in histories[0])


def test_sp_balance_over_ranks(monkeypatch):
    """The packed-step loop at dp=2: each GlobalStep packs two plans (one
    a rank of the world, as JAX packs by its device count), each rank's
    gradient shares are summed and ZeRO-1 updates once; the losses equal
    world 1's on the same global batch packed the same way."""
    planner = PTR.DCPPlanner({("144p", 1, "0.38"): {"time": 1.0, "sp": 1}},
                             target_time=2.0)  # gas 2
    cfg = _config(bucket_config={"144p": {1: (1.0, 1)}}, sp_balance=True)
    packed = _run(cfg, planner=planner)[0][2]
    pack = PTR.pack_global_steps
    monkeypatch.setattr(PTR, "pack_global_steps",
                        lambda plans, n, profile: pack(plans, 2, profile))
    one = PTR.run_training(dataclasses.replace(
        cfg, dp_size=1, bucket_config={"144p": {1: (1.0, 2)}}),
        device="cpu", planner=planner)[2]
    assert [h["packed_plans"] for h in packed] == [2, 2, 2]
    assert [h["packed_plans"] for h in one] == [2, 2, 2]
    np.testing.assert_allclose([h["loss"] for h in packed],
                               [h["loss"] for h in one], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in packed],
                               [h["grad_norm"] for h in one], rtol=1e-4)

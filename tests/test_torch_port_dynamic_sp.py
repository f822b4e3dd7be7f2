"""Dynamic sequence parallelism in the port (`TrainConfig(dynamic_sp=True)`:
a `parallel.GroupsPool` of one layout per power-of-two sp, each plan on
the layout of its sp) on 4 gloo ranks on the CPU: the counterpart of
`tests/test_training.py`'s dynamic-sp tests on 4 ranks.

A given planner puts 34-frame clips at sp 4 and images at sp 1. The
history's (bucket, sp, layout) sequence equals JAX's `run_training` on 4
of the suite's 8 CPU devices; the ZeRO-1 moments are a 1/4 slice that no
switch of layout moves; the losses follow the port's world-1 run of the
same plans (1e-4). `sp_balance` packs plans of both layouts into one
update, ZeRO-3 runs under the pool, and the DCP profile over the pool
gives a bucket that a memory reading puts over the budget at sp 1 the
smallest sp that fits.

The world is spawned once (the module fixture `world`); the workers import
this module to find the functions the driver sends them, so JAX is
imported only inside the fixtures.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from videosys_tpu_torch.core import dcp as PD
from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.engine import Ranks
from videosys_tpu_torch.core.worker import setup_train_rank
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config
from videosys_tpu_torch.training import train as PTR
from videosys_tpu_torch.training import train_step as PT
from videosys_tpu_torch.training.sampler import DCPPlanner

GiB = 1 << 30
SIZES = dict(depth=1, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8)
PROFILE = {("144p", 34, "1.00"): {"time": 0.2, "sp": 4},
           ("144p", 1, "1.00"): {"time": 0.05, "sp": 1}}
RUN = dict(bucket_config={"144p": {1: (1.0, 8), 34: (1.0, 8)}},
           mask_ratios=None, lr=1e-3, warmup_steps=1, max_steps=6,
           log_every=1, dataset_size=48, seed=0)


def config(**kw):
    base = dict(model=STDiT3Config(**SIZES, dtype=torch.float32),
                dynamic_sp=True, dp_size=1, sp_size=4, **RUN)
    base.update(kw)
    return PTR.TrainConfig(**base)


def table(thw, bs, sp, policy="full"):
    """Images fit at sp 1 up to bs 8; the 34-frame clips do not fit at sp
    1 and fit at sp 2 up to bs 8 (of a budget of 8 GiB)."""
    if bs > 8:
        return 9 * GiB
    if thw[0] == 1:
        return 1 * GiB
    return (9 if sp == 1 else 3) * GiB


class TableProfiler(PD.Profiler):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, memory_budget_bytes=8 * GiB, peak_bytes=table,
                         alloc_memory_fraction=1.0, measure_wall_time=False,
                         **kw)
        self.made.append(self)


# --- on every rank -------------------------------------------------------- #

def setup_rank(rank, world_size, address, backend, timeout, device, cfg):
    PTR.Profiler = TableProfiler  # this worker's profiler reads the table
    return setup_train_rank(rank, world_size, address, backend, timeout,
                            device, cfg)


def rank_run(target, **fields):
    """`run_training` of `config(**fields)` on this rank, with the ZeRO
    moments' bytes and storage recorded after every update."""
    moments = []
    update = PT.ClippedAdamW.update

    def recorded(tx, dp=None):
        norm = update(tx, dp)
        st = [v for s in tx.opt.state.values()
              for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")]
        moments.append((tx.moment_bytes, [v.data_ptr() for v in st]))
        return norm

    PT.ClippedAdamW.update = recorded
    try:
        planner = None if fields.get("dynamic_profile") else \
            DCPPlanner(profile=dict(PROFILE))
        state, _, hist = PTR.run_training(
            config(**fields), device="cpu", groups=target.groups,
            planner=planner)
    finally:
        PT.ClippedAdamW.update = update
    chosen = {str(b): p.sp for b, p in TableProfiler.made[-1].results.items()} \
        if fields.get("dynamic_profile") else None
    return {"history": hist, "moments": moments, "chosen": chosen,
            "param_count": sum(p.numel() for p in state.model.parameters())}


# --- fixtures --------------------------------------------------------------- #

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


RUNS = {"zero1": {}, "zero3": dict(zero3=True),
        "sp_balance": dict(sp_balance=True, epochs=3, max_steps=3),
        "profile": dict(dynamic_profile=True, max_steps=4)}


@pytest.fixture(scope="module")
def world(jax_run):
    """The 4 ranks (dp_size 1 x sp_size 4), spawned once: every run (while
    JAX's run compiles on a thread)."""
    cfg = config()
    ranks = Ranks()
    ranks._spawn(4, setup_rank, (cfg,), ["cpu"] * 4, "gloo", 300.0)
    try:
        return {name: ranks._run_workers(rank_run, **fields)
                for name, fields in RUNS.items()}
    finally:
        ranks.shutdown()


@pytest.fixture(scope="module")
def world1():
    """The same plans on one rank (the global batch there)."""
    return PTR.run_training(config(dynamic_sp=False, sp_size=1),
                            device="cpu",
                            planner=DCPPlanner(profile=dict(PROFILE)))[2]


def jax_training():
    from videosys_tpu.models.transformers.stdit3 import (
        STDiT3Config as JConfig,
    )
    from videosys_tpu.training.sampler import DCPPlanner as JPlanner
    from videosys_tpu.training.train import TrainConfig, run_training

    cfg = TrainConfig(model=JConfig(**SIZES), dynamic_sp=True, dp_size=1,
                      sp_size=4, **RUN)
    return run_training(cfg, planner=JPlanner(profile=dict(PROFILE)))[2]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's run_training with dynamic_sp on 4 of the 8 CPU devices, on a
    thread (XLA compiles off the GIL)."""
    pool = ThreadPoolExecutor(1)
    yield pool.submit(jax_training)
    pool.shutdown()


@pytest.fixture(scope="module")
def jax_history(jax_run, world):
    return jax_run.result()


def key(h):
    return h["bucket"], h["sp"], h["mesh"]


# --- tests ------------------------------------------------------------------ #

def test_layouts_switch_as_jax(world, jax_history):
    """Clips run at sp 4 on the (1, 1, 4) layout, images at sp 1 on (4, 1,
    1); the (bucket, sp, layout) sequence is JAX's, on every rank."""
    for rank in world["zero1"]:
        hist = rank["history"]
        assert {h["sp"] for h in hist} == {1, 4}
        assert {h["mesh"] for h in hist} == {(4, 1, 1), (1, 1, 4)}
        assert [key(h) for h in hist] == [key(h) for h in jax_history]


def test_moments_are_a_slice_that_never_moves(world):
    """Each rank holds the moments of 1/4 of the parameters (the flat
    buffer padded to a multiple of 4) in the same storage at every update,
    whichever layout the step ran on."""
    for rank in world["zero1"]:
        P = rank["param_count"]
        sizes = {b for b, _ in rank["moments"]}
        assert sizes == {2 * 4 * -(-P // 4)}
        assert len({tuple(ptrs) for _, ptrs in rank["moments"]}) == 1


@pytest.mark.parametrize("run", ["zero1", "zero3"])
def test_losses_match_world1(world, world1, run):
    """Every rank's losses and grad norms against world 1's on the same
    plans, under ZeRO-1 and under ZeRO-3 with the pool."""
    for rank in world[run]:
        hist = rank["history"]
        assert [(h["bucket"], h["sp"]) for h in hist] == \
            [(h["bucket"], h["sp"]) for h in world1]
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in world1], rtol=1e-4)
        np.testing.assert_allclose([h["grad_norm"] for h in hist],
                                   [h["grad_norm"] for h in world1],
                                   rtol=1e-4)


def test_sp_balance_packs_plans_of_two_layouts(world):
    """sp_balance with dynamic sp: one update a packed step, at least one
    step packs two plans, each plan's gradients on its own layout."""
    for rank in world["sp_balance"]:
        hist = rank["history"]
        assert [h["step"] for h in hist] == [1, 2, 3]
        assert max(h["packed_plans"] for h in hist) >= 2
        assert all(h["mesh"] == "sp_balance" for h in hist)
        layouts = {m for h in hist for m in h["meshes"]}
        assert layouts <= {(4, 1, 1), (1, 1, 4)} and (4, 1, 1) in layouts
        assert np.isfinite([h["loss"] for h in hist]).all()


def test_profile_takes_the_smallest_sp_that_fits(world):
    """The profile over the pool: the clips, over the budget at sp 1, get
    sp 2 and run on the (2, 1, 2) layout; the images keep sp 1."""
    for rank in world["profile"]:
        assert {b[:12]: sp for b, sp in rank["chosen"].items()} == {
            "('144p', 1, ": 1, "('144p', 34,": 2}
        ran = {(h["bucket"][:12], h["sp"], h["mesh"]) for h in rank["history"]}
        assert ("('144p', 34,", 2, (2, 1, 2)) in ran
        assert ran <= {("('144p', 34,", 2, (2, 1, 2)),
                       ("('144p', 1, ", 1, (4, 1, 1))}


def test_plan_dp_must_divide_the_global_batch():
    """A global batch the plan's layout cannot split raises, naming both."""
    groups = par.Groups(par.ParallelConfig(4, 1, 1), 0,
                        {par.DP_AXIS: par.Axis(None, (0, 1, 2, 3), 0)},
                        None, torch.device("cpu"))
    with pytest.raises(ValueError, match="global batch of 6.*dp of 4"):
        PTR._rank_rows(6, groups)
    assert PTR._rank_rows(8, groups) == 2
    assert dataclasses.replace(config(), zero3=True).zero3

"""Training over ranks in the port (dp and sp with ZeRO-1, the autograd
collectives of `core/parallel.py`) on gloo ranks on the CPU, against JAX's
`make_train_step` under the same mesh with `zero1_shardings` on the suite's
8-device CPU backend, and against the port's world 1.

A tiny fp32 STDiT3 (T = 5 latent frames and S = 16 tokens: sp=2 pads T)
takes 2 steps on a global batch of 4 with a frame mask, fed JAX's draws
(each rank its dp share): losses and grad norms at 1e-4, parameters at
2e-4 of each tensor's largest magnitude. Each world is spawned once (the
module fixture `worlds`), where every rank also checks each collective's
gradient against autograd through the same computation done whole in one
process (1e-4, `tests/test_attention.py`'s gradient tolerance), and times
a `GroupTimer`.

The JAX imports are inside the fixtures: the workers import this module to
find the functions the driver sends them, and need no JAX.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.core.engine import Ranks
from videosys_tpu_torch.models.transformers import stdit3 as P
from videosys_tpu_torch.schedulers import rflow as PR
from videosys_tpu_torch.training import train_step as PT
from videosys_tpu_torch.utils.timing import GroupTimer

SIZES = dict(depth=1, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8)
B, T, H, W, L = 4, 5, 8, 8, 8
PIXELS = dict(height=64.0, width=64.0, num_frames=17)
OPT = dict(lr=1e-3, weight_decay=0.01, warmup_steps=1, grad_clip=0.5)
PROB = 0.5
STEPS = 2
GRAD_TOL = 1e-4
WORLDS = {"dp2": par.ParallelConfig(2, 1, 1),
          "sp2": par.ParallelConfig(1, 1, 2),
          "dp2sp2": par.ParallelConfig(2, 1, 2)}


def batch_of(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B, 4, T, H, W)).astype(np.float32),
            "y": rng.standard_normal((B, L, 16)).astype(np.float32),
            "kv_mask": np.arange(L)[None] < np.array([[5], [8], [3], [8]]),
            "fps": np.full((B,), 24.0, np.float32),
            "mask": np.array([[True, True, False, True, True],
                              [False, True, True, True, False],
                              [True, True, True, True, True],
                              [True, False, True, True, True]])}


def port_model(sd):
    pm = P.STDiT3(P.STDiT3Config(**SIZES), remat=True)
    pm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return pm.train()


def share(tree, groups):
    """This rank's dp share of a tree of global-batch numpy arrays."""
    ax = None if groups is None else groups.axis(par.DP_AXIS)
    i, n = (0, 1) if ax is None else (ax.rank, ax.size)
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[i * len(v) // n:(i + 1) * len(v) // n])) for k, v in tree.items()}


def train(sd, steps, groups=None):
    """STEPS train steps of the port fed `steps` [(batch, draws)]: losses,
    grad norms, the parameters after, this rank's moment bytes."""
    model = port_model(sd)
    tx = PT.make_optimizer(model.parameters(), groups=groups, **OPT)
    state = PT.create_train_state(model, tx)
    sched = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=True,
                                             sample_method="logit-normal"))
    step = PT.make_train_step(model, sched, tx, PIXELS["height"],
                              PIXELS["width"], PIXELS["num_frames"],
                              class_dropout_prob=PROB, groups=groups)
    losses, norms = [], []
    for batch, draws in steps:
        state, m = step(state, None, share(batch, groups),
                        **share(draws, groups))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
            "moment_bytes": tx.moment_bytes,
            "param_bytes": sum(p.numel() * 4 for p in tx.params)}


# --- collectives: each rank's gradient, and the whole in one process ------- #

def _inputs(n):
    """Every rank's inputs and loss weights, the same on every rank."""
    gen = torch.Generator().manual_seed(11)
    return {"shards": torch.randn(n, 2 * n, 3, generator=gen),
            "rows": torch.randn(n, 3, 4, generator=gen),
            "w_a2a": torch.randn(n, 2, 3 * n, generator=gen),
            "w_split": torch.randn(n, 2, 3, generator=gen),
            "w_gather": torch.randn(2 * n * n, 3, generator=gen),
            "w_each": torch.randn(n, 2 * n, 3, generator=gen),
            "w_halo": torch.randn(n, 5, 4, generator=gen)}


def collective_loss(case, x, r, ops):
    """Rank r's loss of one collective case, written once for the ranks
    (`ops`: the port's collectives) and once for the whole (plain tensor
    ops over every rank's inputs)."""
    if case == "all_to_all":
        return (x["w_a2a"][r] * ops["a2a"](x["shards"])).sum()
    if case == "split":
        return (x["w_split"][r] * ops["split"](x["shards"][0])).sum()
    if case == "gather":
        return (x["w_gather"] * ops["gather"](x["shards"])).sum()
    if case == "broadcast":
        return (x["w_each"][r] * ops["bcast"](x["shards"])).sum()
    if case.startswith("all_reduce"):
        return (x["w_each"][r] * ops["allreduce"](
            x["shards"], case.endswith("mean"))).sum()
    return (x["w_halo"][r] * ops["halo"](x["rows"])).sum()


CASES = ("all_to_all", "split", "gather", "broadcast", "all_reduce_sum",
         "all_reduce_mean", "halo")


def rank_collective_grads(target):
    """Each collective's input gradient on this rank, over every rank."""
    ax = target.groups.axis(par.WORLD_AXIS)
    r, n = ax.rank, ax.size
    out = {}
    for case in CASES:
        x = {k: v.requires_grad_() for k, v in _inputs(n).items()}
        # this rank holds only its own shard (or the replicated input)
        shard, rows = x["shards"][r], x["rows"][r]
        ops = {"a2a": lambda s: par.all_to_all(shard, 0, 1, ax),
               "split": lambda s: par.split(s, 0, ax),
               "gather": lambda s: par.gather(shard, 0, ax),
               "bcast": lambda s: par.broadcast(shard, 1, ax),
               "allreduce": lambda s, mean: par.all_reduce(
                   shard, ax, "mean" if mean else "sum"),
               "halo": lambda s: par.halo_exchange(rows, 0, 1, ax)}
        collective_loss(case, x, r, ops).backward()
        out[case] = {k: x[k].grad.numpy() for k in ("shards", "rows")
                     if x[k].grad is not None}
    return out


def whole_collective_grads(n):
    """The same computations done whole in one process: the gradient of
    the sum of every rank's loss (the loss after `gather`, the same on
    every rank, counts once)."""
    out = {}
    for case in CASES:
        x = {k: v.requires_grad_() for k, v in _inputs(n).items()}
        total = 0
        for r in range(n if case != "gather" else 1):
            ops = {"a2a": lambda s, r=r: torch.cat(
                       [s[q].chunk(n, 0)[r] for q in range(n)], 1),
                   "split": lambda s, r=r: s.chunk(n, 0)[r],
                   "gather": lambda s: torch.cat(list(s), 0),
                   "bcast": lambda s: s[1],
                   "allreduce": lambda s, mean: s.mean(0) if mean
                   else s.sum(0),
                   "halo": lambda s, r=r: torch.cat(
                       [s[r - 1][-1:] if r > 0 else torch.zeros(1, 4), s[r],
                        s[r + 1][:1] if r < n - 1 else torch.zeros(1, 4)])}
            total = total + collective_loss(case, x, r, ops)
        total.backward()
        out[case] = {k: x[k].grad.numpy() for k in ("shards", "rows")
                     if x[k].grad is not None}
    return out


# --- on every rank -------------------------------------------------------- #

def setup_train_rank(rank, world_size, address, backend, timeout, device,
                     config):
    par.initialize(rank, world_size, address, backend=backend, device=device,
                   timeout=timeout)
    return SimpleNamespace(groups=par.build_groups(config, device))


def rank_train(target, sd, steps):
    return train(sd, steps, target.groups)


def rank_group_timer(target):
    """A GroupTimer, entered by every rank together (a barrier first),
    whose rank 1 arrives 0.5 s late: every rank's time covers the wait."""
    torch.distributed.barrier()
    with GroupTimer("step", groups=target.groups) as t:
        if target.groups.rank == 1:
            time.sleep(0.5)
    return t.elapsed


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


@pytest.fixture(scope="module")
def inputs():
    """The port's seeded weights, perturbed; the global batches and JAX's
    draws; JAX's ZeRO-1 step traced under each world's mesh, its programs
    compiling in the background (XLA compiles off the GIL) while the port's
    worlds run."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from videosys_tpu.core import parallel as jpar
    from videosys_tpu.models.transformers import stdit3 as J
    from videosys_tpu.schedulers import rflow as JR
    from videosys_tpu.training import train_step as JT
    from videosys_tpu.utils.convert import convert_stdit3

    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    sd = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in P.STDiT3(P.STDiT3Config(**SIZES)).state_dict().items()}
    params = convert_stdit3(sd, SIZES["depth"])
    jm = J.STDiT3(J.STDiT3Config(**SIZES))
    js = JR.RFlowScheduler(JR.RFlowConfig(use_timestep_transform=True,
                                          sample_method="logit-normal"))
    tx = JT.make_optimizer(**OPT)
    steps = []
    for i in range(STEPS):
        batch, key = batch_of(10 + i), jax.random.key(20 + i)
        k, dkey = jax.random.split(key)
        drop = np.array(jax.random.bernoulli(dkey, PROB, (B,)))
        rng_t, rng_n = jax.random.split(k)
        t = js.transform_training_t(js.sample_t(rng_t, B), **PIXELS)
        noise = jax.random.normal(rng_n, (B, 4, T, H, W), jnp.float32)
        steps.append((batch, {"drop": drop, "t": np.array(t),
                              "noise": np.array(noise)}, key))
    fn = JT.make_train_step(jm, js, tx, PIXELS["height"], PIXELS["width"],
                            num_frames=PIXELS["num_frames"],
                            class_dropout_prob=PROB)
    pool = ThreadPoolExecutor(len(WORLDS))
    jax_steps = {}
    for name, cfg in WORLDS.items():
        mesh = jpar.build_mesh(jpar.ParallelConfig(cfg.dp_size, 1,
                                                   cfg.sp_size))
        state = JT.create_train_state(params, tx)
        state_sh = JT.zero1_shardings(mesh, state)
        state = jax.device_put(state, state_sh)
        batch_sh = NamedSharding(mesh, PartitionSpec(jpar.BATCH_AXES))
        batches = [{k: jax.device_put(jnp.asarray(v), batch_sh)
                    for k, v in batch.items()} for batch, _, _ in steps]
        with jpar.use_mesh(mesh):  # the mesh is read while tracing
            lowered = jax.jit(fn, out_shardings=(state_sh, None)).lower(
                state, steps[0][2], batches[0])
        jax_steps[name] = (pool.submit(lowered.compile), state, batches)
    yield {"sd": sd, "steps": [s[:2] for s in steps],
           "keys": [s[2] for s in steps], "jax": jax_steps}
    pool.shutdown()


@pytest.fixture(scope="module")
def jax_runs(inputs, worlds):
    """JAX's STEPS ZeRO-1 steps under each world's mesh (after the port's
    worlds, which run while JAX compiles)."""
    import jax

    from videosys_tpu_torch.utils.from_jax import stdit3_from_jax

    out = {}
    for name, (compiled, state, batches) in inputs["jax"].items():
        step = compiled.result()
        losses, norms = [], []
        for key, jb in zip(inputs["keys"], batches):
            state, m = step(state, key, jb)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {"loss": losses, "grad_norm": norms,
                     "params": stdit3_from_jax(jax.tree.map(np.asarray,
                                                            state.params))}
    return out


@pytest.fixture(scope="module")
def world1(inputs):
    return train(inputs["sd"], inputs["steps"])


@pytest.fixture(scope="module")
def worlds(inputs):
    """Each world spawned once: every rank's STEPS steps, collective
    gradients and GroupTimer time."""
    out = {}
    for name, cfg in WORLDS.items():
        ranks = Ranks()
        ranks._spawn(cfg.world_size, setup_train_rank, (cfg,),
                     ["cpu"] * cfg.world_size, "gloo", 300.0)
        try:
            out[name] = ranks._run_workers(rank_train, inputs["sd"],
                                           inputs["steps"])
            out[name, "grads"] = ranks._run_workers(rank_collective_grads)
            out[name, "timer"] = ranks._run_workers(rank_group_timer)
        finally:
            ranks.shutdown()
    return out


def close_params(got, want, tol=2e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(got[k] - w).max() <= tol * scale, k


# --- tests ------------------------------------------------------------------ #

@pytest.mark.parametrize("world", list(WORLDS))
def test_collective_gradients_match_whole_autograd(world, worlds):
    """Each collective's gradient on every rank against autograd through
    the whole computation in one process: shards' gradients whole, a
    replicated input's (split) a share that sums to the whole."""
    ranks = worlds[world, "grads"]
    n = len(ranks)
    want = whole_collective_grads(n)
    for case, w in want.items():
        for key, g_whole in w.items():
            if case == "split":  # the replicated input: shares summed
                got = sum(r[case][key] for r in ranks)
            elif key == "rows":
                got = np.stack([r[case][key][q] for q, r in enumerate(ranks)])
            else:  # each rank's own shard
                got = np.stack([r[case][key][q] for q, r in enumerate(ranks)])
            scale = max(np.abs(g_whole).max(), 1e-12)
            assert np.abs(got - g_whole).max() <= GRAD_TOL * scale, \
                (case, key)


@pytest.mark.parametrize("world", list(WORLDS))
def test_train_steps_match_jax_zero1_mesh(world, worlds, jax_runs):
    """Losses and grad norms of every rank against JAX's ZeRO-1 steps
    under the same mesh at 1e-4; the parameters after 2 steps at 2e-4."""
    want = jax_runs[world]
    for got in worlds[world]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        close_params(got["params"], want["params"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_train_steps_match_world1(world, worlds, world1):
    """The same against the port's world 1 on the global batch."""
    for got in worlds[world]:
        np.testing.assert_allclose(got["loss"], world1["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], world1["grad_norm"],
                                   rtol=1e-4)
        close_params(got["params"], world1["params"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_zero1_moments_are_a_slice(world, worlds, world1):
    """Each rank holds the moments of 1/N of the parameters (the flat
    buffer padded to a multiple of N), world 1 of all of them."""
    n = WORLDS[world].world_size
    total = worlds[world][0]["param_bytes"]
    assert world1["moment_bytes"] == 2 * total
    for got in worlds[world]:
        padded = -(-total // 4 // n) * n * 4
        assert got["moment_bytes"] == 2 * padded // n


@pytest.mark.parametrize("world", list(WORLDS))
def test_group_timer_waits_for_every_rank(world, worlds):
    """A GroupTimer whose rank 1 sleeps 0.5 s inside: every rank's time
    covers it (less the spread of the ranks' exits from the barrier)."""
    assert all(t >= 0.4 for t in worlds[world, "timer"])

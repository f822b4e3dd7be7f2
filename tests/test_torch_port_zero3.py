"""ZeRO-3 in the port (`training/zero3.py`: parameters sharded over every
rank, each depth pair gathered inside its recompute call, its gradient
reduce-scattered) on 4 gloo ranks on the CPU as dp=2 x sp=2.

A tiny fp32 STDiT3 at hidden 128 (so that its weights clear
`ZERO3_MIN_SHARD_BYTES`, as in `tests/test_parallel.py`'s ZeRO-3 test)
takes 2 steps, fed JAX's draws, against JAX's `make_train_step(zero3=True)`
under `zero3_shardings` on the same mesh (losses and grad norms at 1e-4,
parameters at 2e-4 of each tensor's largest magnitude) and against the
port's ZeRO-1 on the same world (JAX's own ZeRO-3 vs ZeRO-1 tolerances).
Each rank holds 1/N of the sharded leaves' parameters, gradients, EMA and
moments and the whole small leaves. A checkpoint written under ZeRO-3
resumes under ZeRO-1 and at world 1 with the same next step.

The world is spawned once (the module fixture `world`); the workers import
this module to find the functions the driver sends them, so JAX is
imported only inside the fixtures.
"""

import os
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
from videosys_tpu_torch.training import zero3 as Z
from videosys_tpu_torch.training.ema import init_ema
from videosys_tpu_torch.training.train import TrainConfig, run_training

SIZES = dict(depth=2, hidden_size=128, num_heads=4, caption_channels=32,
             model_max_length=8)
B, T, H, W, L = 4, 5, 8, 8, 8
PIXELS = dict(height=64.0, width=64.0, num_frames=17)
OPT = dict(lr=1e-3, weight_decay=0.01, warmup_steps=1, grad_clip=0.5)
PROB = 0.5
STEPS = 2
WORLD = par.ParallelConfig(2, 1, 2)


def batch_of(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B, 4, T, H, W)).astype(np.float32),
            "y": rng.standard_normal((B, L, 32)).astype(np.float32),
            "kv_mask": np.arange(L)[None] < np.array([[5], [8], [3], [8]]),
            "fps": np.full((B,), 24.0, np.float32),
            "mask": np.array([[True, True, False, True, True],
                              [False, True, True, True, False],
                              [True, True, True, True, True],
                              [True, False, True, True, True]])}


def share(tree, groups):
    """This rank's dp share of a tree of global-batch numpy arrays."""
    i, n = PT._dp_share(groups)
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[i * len(v) // n:(i + 1) * len(v) // n])) for k, v in tree.items()}


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def train(sd, steps, groups=None, zero3=False):
    """STEPS steps of the port fed `steps` [(batch, draws)]: losses, grad
    norms, the whole parameters after, and the bytes this rank held."""
    model = P.STDiT3(P.STDiT3Config(**SIZES), remat=True)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    model.train()
    sharding = Z.shard_model(model, groups) if zero3 else None
    tx = PT.make_optimizer(model.parameters(), groups=groups, zero3=sharding,
                           **OPT)
    ema = init_ema(model)
    state = PT.create_train_state(model, tx)
    sched = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=True,
                                             sample_method="logit-normal"))
    step = PT.make_train_step(model, sched, tx, PIXELS["height"],
                              PIXELS["width"], PIXELS["num_frames"],
                              class_dropout_prob=PROB, groups=groups,
                              zero3=zero3)
    grad_bytes = []
    update = tx.update

    def counted(dp=None):  # the gradients held when the update starts
        grad_bytes.append(nbytes(p.grad for p in tx.params
                                 if p.grad is not None))
        return update(dp)

    tx.update = counted
    losses, norms = [], []
    for batch, draws in steps:
        state, m = step(state, None, share(batch, groups),
                        **share(draws, groups))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    held = {"params": nbytes(model.parameters()), "ema": nbytes(ema.values()),
            "moments": tx.moment_bytes, "grads": grad_bytes}
    if sharding is not None:
        sharding.unshard()
    return {"loss": losses, "grad_norm": norms, "held": held,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()}}


def expected_held(sd, n):
    """Bytes a rank should hold of each: 1/n of every unit's sharded
    leaves (the unit padded to a multiple of n) plus the small leaves."""
    model = P.STDiT3(P.STDiT3Config(**SIZES))
    units, small = {}, 0
    for name, p in model.named_parameters():
        b = p.numel() * 4
        if b < Z.ZERO3_MIN_SHARD_BYTES:
            small += b
        else:
            u = model.param_unit(name)
            units[u] = units.get(u, 0) + p.numel()
    return sum(-(-k // n) * 4 for k in units.values()) + small, small


def config(zero3, dp=2, sp=2, tmp=None, **kw):
    """A run of 2 steps of the 144p 34-frame bucket on the dummy dataset:
    a global batch of 4."""
    return TrainConfig(
        model=P.STDiT3Config(**SIZES, dtype=torch.float32),
        bucket_config={"144p": {34: (1.0, 4 // dp)}}, mask_ratios=None,
        lr=2e-3, warmup_steps=1, log_every=1, dataset_size=16, seed=0,
        max_steps=2, dp_size=dp, sp_size=sp, zero3=zero3,
        ckpt_dir=str(tmp), **kw)


# --- on every rank -------------------------------------------------------- #

def setup_rank(rank, world_size, address, backend, timeout, device, config):
    par.initialize(rank, world_size, address, backend=backend, device=device,
                   timeout=timeout)
    return SimpleNamespace(groups=par.build_groups(config, device))


def rank_train(target, sd, steps, zero3):
    return train(sd, steps, target.groups, zero3)


def rank_checkpoint(target, tmp):
    """ZeRO-3 for 2 steps, a checkpoint after each; then the same from the
    first checkpoint under ZeRO-1. Rank 0's parameters and EMA after."""
    out = {}
    for name, cfg, resume in (
            ("zero3", config(True, tmp=f"{tmp}/z3", ckpt_every=1), None),
            ("zero1", config(False, tmp=f"{tmp}/z1"),
             f"{tmp}/z3/epoch0-global_step1")):
        state, ema, hist = run_training(cfg, device="cpu",
                                        groups=target.groups, resume=resume)
        out[name] = {"history": hist, "ema": {k: v.numpy().copy()
                                              for k, v in ema.items()},
                     "params": {k: v.detach().numpy().copy() for k, v in
                                state.model.state_dict().items()}}
    return out


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
    draws; JAX's ZeRO-3 step traced under the dp=2 x sp=2 mesh, compiling
    in the background while the port's world runs."""
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
    jm = J.STDiT3(J.STDiT3Config(**SIZES), remat=True)
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
                            class_dropout_prob=PROB, zero3=True)
    mesh = jpar.build_mesh(jpar.ParallelConfig(2, 1, 2))
    state = JT.create_train_state(params, tx)
    state_sh = JT.zero3_shardings(mesh, state)
    state = jax.device_put(state, state_sh)
    batch_sh = NamedSharding(mesh, PartitionSpec(jpar.BATCH_AXES))
    batches = [{k: jax.device_put(jnp.asarray(v), batch_sh)
                for k, v in batch.items()} for batch, _, _ in steps]
    with jpar.use_mesh(mesh):  # the mesh is read while tracing
        lowered = jax.jit(fn, out_shardings=(state_sh, None)).lower(
            state, steps[0][2], batches[0])
    pool = ThreadPoolExecutor(1)
    yield {"sd": sd, "steps": [s[:2] for s in steps],
           "keys": [s[2] for s in steps],
           "jax": (pool.submit(lowered.compile), state, batches)}
    pool.shutdown()


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The dp=2 x sp=2 world, spawned once: every rank's ZeRO-3 and ZeRO-1
    steps and the checkpoint runs."""
    tmp = tmp_path_factory.mktemp("zero3")
    ranks = Ranks()
    ranks._spawn(WORLD.world_size, setup_rank, (WORLD,),
                 ["cpu"] * WORLD.world_size, "gloo", 300.0)
    try:
        out = {mode: ranks._run_workers(rank_train, inputs["sd"],
                                        inputs["steps"], mode == "zero3")
               for mode in ("zero3", "zero1")}
        out["ckpt"] = ranks._run_workers(rank_checkpoint, str(tmp))
    finally:
        ranks.shutdown()
    out["tmp"] = tmp
    return out


@pytest.fixture(scope="module")
def jax_run(inputs, world):
    """JAX's STEPS ZeRO-3 steps (after the port's world, which runs while
    JAX compiles)."""
    import jax

    from videosys_tpu_torch.utils.from_jax import stdit3_from_jax

    compiled, state, batches = inputs["jax"]
    step = compiled.result()
    losses, norms = [], []
    for key, jb in zip(inputs["keys"], batches):
        state, m = step(state, key, jb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms,
            "params": stdit3_from_jax(jax.tree.map(np.asarray, state.params))}


def close_params(got, want, tol=2e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(got[k] - w).max() <= tol * scale, k


# --- tests ------------------------------------------------------------------ #

def test_zero3_steps_match_jax_zero3_mesh(world, jax_run):
    """Every rank's losses and grad norms against JAX's ZeRO-3 steps on the
    same mesh at 1e-4; the whole parameters after 2 steps at 2e-4."""
    for got in world["zero3"]:
        np.testing.assert_allclose(got["loss"], jax_run["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], jax_run["grad_norm"],
                                   rtol=1e-4)
        close_params(got["params"], jax_run["params"])


def test_zero3_matches_zero1(world):
    """ZeRO-3 against ZeRO-1 on the same world and inputs, at JAX's own
    tolerances for the pair (`tests/test_parallel.py`): losses 2e-5, grad
    norms 2e-4."""
    for z3, z1 in zip(world["zero3"], world["zero1"]):
        np.testing.assert_allclose(z3["loss"], z1["loss"], rtol=2e-5)
        np.testing.assert_allclose(z3["grad_norm"], z1["grad_norm"],
                                   rtol=2e-4)


def test_zero3_rank_holds_a_slice(world, inputs):
    """Each rank holds 1/N of the sharded leaves (each unit padded to a
    multiple of N) plus the whole small leaves, of its parameters, its
    gradients at each update and its EMA, and twice that of moments; and
    less than ZeRO-1's whole parameters."""
    n = WORLD.world_size
    want, small = expected_held(inputs["sd"], n)
    whole = sum(v.size * 4 for v in inputs["sd"].values())
    assert small < whole / 20  # nearly every byte is sharded
    for got in world["zero3"]:
        held = got["held"]
        assert held["params"] == held["ema"] == want
        assert held["grads"] == [want] * STEPS
        assert held["moments"] == 2 * want
    for got in world["zero1"]:
        assert got["held"]["params"] == whole


@pytest.mark.parametrize("resumed_at", ["zero1", "world1"])
def test_zero3_checkpoint_resumes(world, resumed_at):
    """A ZeRO-3 checkpoint after step 1 resumes under ZeRO-1 on the same
    world and at world 1 (the global batch on one rank): step 2's loss and
    grad norm at 1e-4 and the parameters and EMA after at 2e-4 of the
    straight ZeRO-3 run's, which are whole on every rank."""
    ranks = world["ckpt"]
    straight = ranks[0]["zero3"]
    for r in ranks[1:]:
        assert r["zero3"]["history"] == straight["history"]
    if resumed_at == "zero1":
        got = ranks[0]["zero1"]
    else:
        state, ema, hist = run_training(
            config(False, dp=1, sp=1, tmp=world["tmp"] / "w1"), device="cpu",
            resume=str(world["tmp"] / "z3" / "epoch0-global_step1"))
        got = {"history": hist,
               "ema": {k: v.numpy() for k, v in ema.items()},
               "params": {k: v.detach().numpy()
                          for k, v in state.model.state_dict().items()}}
    assert [h["step"] for h in got["history"]] == [2]
    want = straight["history"][1]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["history"][0][key], want[key],
                                   rtol=1e-4)
    close_params(got["params"], straight["params"])
    close_params(got["ema"], straight["ema"])

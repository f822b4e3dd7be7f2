"""Training of the PyTorch port against the JAX package, on the CPU in fp32
with a tiny STDiT3: the rflow losses, the loss and every parameter gradient
of one step, the optimizer against optax, gradient accumulation, caption
dropout, recompute policies, EMA, checkpoints and `run_training`.

The two frameworks draw different numbers from the same seed, so each
comparison makes the JAX draws (dropout flags, timesteps, noise) with the
JAX package's own calls and feeds them to the port. Multi-step runs are
compared by their losses, not their parameters: Adam turns a 1e-8 gradient
difference near zero into a full-size update.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videosys_tpu.models.transformers import stdit3 as J
from videosys_tpu.schedulers import rflow as JR
from videosys_tpu.training import train_step as JT
from videosys_tpu_torch.models.transformers import stdit3 as P
from videosys_tpu_torch.schedulers import rflow as PR
from videosys_tpu_torch.training import ckpt as ckpt_io
from videosys_tpu_torch.training import train_step as PT
from videosys_tpu_torch.training.ema import init_ema, update_ema
from videosys_tpu_torch.training.train import TrainConfig, run_training
from videosys_tpu_torch.utils.from_jax import stdit3_from_jax

SIZES = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8)
B, T, H, W, L = 2, 5, 8, 8, 8
PIXELS = dict(height=64.0, width=64.0, num_frames=17)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4  # relative to each tensor's largest gradient


def _batch(seed=0, masked=True):
    rng = np.random.default_rng(seed)
    batch = {"x": rng.standard_normal((B, 4, T, H, W)).astype(np.float32),
             "y": rng.standard_normal((B, L, 16)).astype(np.float32),
             "kv_mask": np.arange(L)[None] < np.array([[5], [8]]),
             "fps": np.full((B,), 24.0, np.float32)}
    if masked:
        batch["mask"] = np.array([[True, True, False, True, True],
                                  [False, True, True, True, False]])
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_draws(sched, rng, x_shape, prob):
    """The draws `_make_loss_fn` and `training_losses` make from `rng`."""
    drop = None
    if prob > 0:
        rng, dkey = jax.random.split(rng)
        drop = np.array(jax.random.bernoulli(dkey, prob, (x_shape[0],)))
    rng_t, rng_n = jax.random.split(rng)
    t = sched.sample_t(rng_t, x_shape[0])
    if sched.config.use_timestep_transform:
        t = sched.transform_training_t(t, PIXELS["height"], PIXELS["width"],
                                       PIXELS["num_frames"])
    noise = jax.random.normal(rng_n, x_shape, dtype=jnp.float32)
    draws = {"t": torch.from_numpy(np.array(t)),
             "noise": torch.from_numpy(np.array(noise))}
    if drop is not None:
        draws["drop"] = torch.from_numpy(drop)
    return draws


@pytest.fixture(scope="module")
def models():
    batch = _batch()
    jm = J.STDiT3(J.STDiT3Config(**SIZES))
    params = jm.init(jax.random.key(0), jnp.asarray(batch["x"]),
                     jnp.zeros((B,)), jnp.asarray(batch["y"]),
                     height=64.0, width=64.0)
    rng = np.random.default_rng(1)
    leaves, tree = jax.tree.flatten(params)
    leaves = [np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
              for a in leaves]
    params = jax.tree.unflatten(tree, leaves)
    return jm, params, stdit3_from_jax(params)


def _port_model(sd, **kw):
    pm = P.STDiT3(P.STDiT3Config(**SIZES), **kw)
    pm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return pm.train()


@pytest.mark.parametrize("sample_method,masked", [
    ("uniform", False), ("logit-normal", True)])
def test_training_losses_match_jax(sample_method, masked):
    kw = dict(use_timestep_transform=True, sample_method=sample_method)
    js = JR.RFlowScheduler(JR.RFlowConfig(**kw))
    ps = PR.RFlowScheduler(PR.RFlowConfig(**kw))
    batch = _batch(2, masked)
    rng = jax.random.key(3)
    weights = np.linspace(0.5, 1.5, 1000).astype(np.float32)

    def j_model(x_t, t):
        return jnp.concatenate([0.3 * x_t + t[:, None, None, None, None] / 1e3,
                                x_t], axis=1)

    def p_model(x_t, t):
        return torch.cat([0.3 * x_t + t[:, None, None, None, None] / 1e3,
                          x_t], dim=1)

    mask = batch.get("mask")
    want = js.training_losses(
        j_model, rng, jnp.asarray(batch["x"]),
        mask=None if mask is None else jnp.asarray(mask),
        weights=jnp.asarray(weights), **PIXELS)
    draws = _jax_draws(js, rng, batch["x"].shape, 0.0)
    got = ps.training_losses(
        p_model, torch.from_numpy(batch["x"]),
        mask=None if mask is None else torch.from_numpy(mask),
        weights=torch.from_numpy(weights), **draws, **PIXELS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    # the timestep warp alone, and the port's own draws
    t = np.linspace(0.0, 999.0, 7).astype(np.float32)
    np.testing.assert_allclose(
        ps.transform_training_t(torch.from_numpy(t), 240.0, 426.0, 51).numpy(),
        np.asarray(js.transform_training_t(jnp.asarray(t), 240.0, 426.0, 51)),
        rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    own = ps.training_losses(p_model, torch.from_numpy(batch["x"]),
                             generator=gen, **PIXELS)
    assert own.shape == (B,) and bool(torch.isfinite(own).all())
    t_own = ps.sample_t(4096, torch.Generator().manual_seed(1))
    assert 0.0 <= float(t_own.min()) and float(t_own.max()) < 1000.0
    assert abs(float(t_own.mean()) - 500.0) < 25.0


@pytest.mark.parametrize("force_flash", [False, True])
def test_loss_and_every_gradient_match_jax(models, force_flash, monkeypatch):
    """One step's loss and all parameter gradients against
    `jax.value_and_grad` of the JAX loss function, with caption dropout, a
    ragged text mask and a frame mask. With `force_flash` the port's
    attention goes through `FlashAttentionFunction` (plain backward
    versions), as it goes through the kernels on a card."""
    jm, params, sd = models
    js = JR.RFlowScheduler(JR.RFlowConfig(use_timestep_transform=True,
                                          sample_method="logit-normal"))
    ps = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=True,
                                          sample_method="logit-normal"))
    batch, rng, prob = _batch(), jax.random.key(6), 0.5
    loss_fn = JT._make_loss_fn(jm, js, PIXELS["height"], PIXELS["width"],
                               PIXELS["num_frames"], prob)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(params, rng,
                                                        _to_jax(batch))
    want_grads = stdit3_from_jax(jax.tree.map(np.asarray, want_grads))
    draws = _jax_draws(js, rng, batch["x"].shape, prob)
    assert draws["drop"].any() and not draws["drop"].all()

    monkeypatch.setenv("VIDEOSYS_FORCE_FLASH", "1" if force_flash else "0")
    pm = _port_model(sd, remat=True)
    loss = PT._make_loss_fn(pm, ps, PIXELS["height"], PIXELS["width"],
                            PIXELS["num_frames"], prob)(_to_torch(batch),
                                                        **draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert set(got) == set(want_grads)
    for name, w in want_grads.items():
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(got[name] - w).max() <= GRAD_TOL * scale, name


def test_remat_policies_give_equal_values(models):
    _, _, sd = models
    batch = _to_torch(_batch())
    t = torch.tensor([500.0, 130.0])
    outs, grads = {}, {}
    for policy in P.STDiT3.REMAT_POLICIES:
        pm = _port_model(sd, remat=True, remat_policy=policy)
        out = pm(batch["x"], t, batch["y"], kv_mask=batch["kv_mask"],
                 x_mask=batch["mask"], fps=batch["fps"], height=64.0, width=64.0)
        out.square().mean().backward()
        outs[policy] = out.detach()
        grads[policy] = {k: p.grad for k, p in pm.named_parameters()}
    for policy in ("dots", "none"):
        assert torch.equal(outs[policy], outs["full"])
        for k, g in grads["full"].items():
            torch.testing.assert_close(grads[policy][k], g, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        P.STDiT3(P.STDiT3Config(**SIZES), remat_policy="some")


def test_compute_dtype_keeps_fp32_master_weights(models):
    """bf16 compute over fp32 parameters: bf16 activations, fp32 gradients,
    values near the fp32 model's; without `compute_dtype` nothing changes."""
    _, _, sd = models
    batch = _to_torch(_batch())
    t = torch.tensor([500.0, 130.0])
    kw = dict(kv_mask=batch["kv_mask"], fps=batch["fps"], height=64.0, width=64.0)
    ref = _port_model(sd)(batch["x"], t, batch["y"], **kw)
    pm = _port_model(sd, compute_dtype=torch.bfloat16)
    seen = []
    pm.spatial_blocks[0].attn.qkv.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    out = pm(batch["x"], t, batch["y"], **kw)
    out.square().mean().backward()
    assert seen == [torch.bfloat16] and out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    grads = [p.grad for p in pm.parameters() if p.grad is not None]
    assert len(grads) > 50 and all(g.dtype == torch.float32 for g in grads)
    assert (out - ref).abs().max() <= 0.05 * ref.abs().max()


@pytest.mark.parametrize("decay_steps", [None, 4])
def test_optimizer_matches_optax(decay_steps):
    """5 updates on injected gradients well above eps: warmup (the first
    update has lr 0), cosine decay, clipping by the global norm, weight
    decay."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i % 2 else 0.2) + 0.5)
              .astype(np.float32) for k, s in shapes.items()} for i in range(5)]
    kw = dict(lr=1e-2, weight_decay=0.05, warmup_steps=2, grad_clip=1.0,
              decay_steps=decay_steps, lr_min_ratio=0.1)
    tx = JT.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    pp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    ptx = PT.make_optimizer(pp.values(), **kw)
    assert ptx.lr == 0.0
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in pp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = ptx.update()
        want_norm = float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        assert all(p.grad is None for p in pp.values())
        for k in shapes:
            np.testing.assert_allclose(pp[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-5)
            if i == 0:  # lr 0: nothing moved
                np.testing.assert_array_equal(pp[k].detach().numpy(), init[k])
    assert ptx.count == 5 and not np.array_equal(pp["a"].detach().numpy(), init["a"])


def test_train_steps_follow_jax_losses(models):
    """Three optimizer steps: losses and gradient norms (reported before
    clipping) against the JAX train step."""
    jm, params, sd = models
    kw = dict(use_timestep_transform=True, sample_method="logit-normal")
    js, ps = JR.RFlowScheduler(JR.RFlowConfig(**kw)), PR.RFlowScheduler(PR.RFlowConfig(**kw))
    opt = dict(lr=1e-3, weight_decay=0.0, warmup_steps=1, grad_clip=0.5)
    tx = JT.make_optimizer(**opt)
    jstate = JT.create_train_state(params, tx)
    jstep = jax.jit(JT.make_train_step(jm, js, tx, 64.0, 64.0, num_frames=17,
                                       class_dropout_prob=0.1))
    pm = _port_model(sd, remat=True)
    ptx = PT.make_optimizer(pm.parameters(), **opt)
    pstate = PT.create_train_state(pm, ptx)
    pstep = PT.make_train_step(pm, ps, ptx, 64.0, 64.0, num_frames=17,
                               class_dropout_prob=0.1)
    for i in range(3):
        batch, rng = _batch(10 + i), jax.random.key(20 + i)
        jstate, want = jstep(jstate, rng, _to_jax(batch))
        pstate, got = pstep(pstate, None, _to_torch(batch),
                            **_jax_draws(js, rng, batch["x"].shape, 0.1))
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"].item(),
                                   float(want["grad_norm"]), rtol=1e-3)
        assert got["grad_norm"].item() > opt["grad_clip"]  # unclipped norm
    assert pstate.step == 3 and int(jstate.step) == 3


def test_gas_two_equals_mean_of_micro_batches(models):
    _, _, sd = models
    ps = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=True))
    pm = _port_model(sd)
    micro = [_to_torch(_batch(30)), _to_torch(_batch(31))]
    gen = torch.Generator().manual_seed(0)
    draws = [{"drop": torch.tensor([False, True]),
              "t": torch.rand(B, generator=gen) * 1000,
              "noise": torch.randn(B, 4, T, H, W, generator=gen)} for _ in micro]
    grad_step = PT.make_grad_step(pm, ps, 64.0, 64.0, 17, 0.1)
    singles = [grad_step(None, mb, **d) for mb, d in zip(micro, draws)]
    assert all(p.grad is None for p in pm.parameters())

    tx = PT.make_optimizer(pm.parameters(), lr=1e-3, warmup_steps=10)
    seen = {}
    update = tx.update
    tx.update = lambda: (seen.update({k: p.grad.clone() for k, p in
                                      pm.named_parameters()}), update())[1]
    step = PT.make_train_step(pm, ps, tx, 64.0, 64.0, num_frames=17, gas=2,
                              class_dropout_prob=0.1)
    stacked = {k: torch.stack([mb[k] for mb in micro]) for k in micro[0]}
    state, metrics = step(PT.create_train_state(pm, tx), None, stacked,
                          **{k: torch.stack([d[k] for d in draws]) for k in draws[0]})
    assert state.step == 1 and tx.count == 1
    np.testing.assert_allclose(metrics["loss"].item(),
                               np.mean([s[0].item() for s in singles]), rtol=1e-6)
    for k, g in seen.items():
        torch.testing.assert_close(g, (singles[0][1][k] + singles[1][1][k]) / 2,
                                   atol=1e-7, rtol=1e-5)
    # the apply half of a split step: summed gradients over n evaluations
    apply = PT.make_apply_step(tx)
    summed = {k: singles[0][1][k] + singles[1][1][k] for k in seen}
    state, m2 = apply(state, summed, 2)
    torch.testing.assert_close(m2["grad_norm"], metrics["grad_norm"],
                               atol=1e-6, rtol=1e-5)
    assert state.step == 2


def test_caption_dropout_trains_null_embedding(models):
    _, _, sd = models
    ps = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=True))
    batch = _to_torch(_batch(masked=False))

    def grad_null(prob):
        pm = _port_model(sd)
        PT._make_loss_fn(pm, ps, 64.0, 64.0, 17, prob)(
            batch, torch.Generator().manual_seed(1)).backward()
        g = pm.y_embedder.y_embedding.grad
        return 0.0 if g is None else g.abs().max().item()

    assert grad_null(1.0) > 0, "dropout=1 must train the null embedding"
    assert grad_null(0.0) == 0, "dropout=0 must not touch it"


def test_ema_update():
    params = {"w": torch.ones(4), "b": torch.zeros(2, dtype=torch.bfloat16)}
    ema = init_ema(params)
    assert ema["b"].dtype == torch.float32
    assert ema["w"].data_ptr() != params["w"].data_ptr()
    ema = update_ema(ema, {"w": torch.full((4,), 2.0),
                           "b": torch.ones(2, dtype=torch.bfloat16)}, decay=0.5)
    np.testing.assert_allclose(ema["w"].numpy(), np.full(4, 1.5))
    np.testing.assert_allclose(ema["b"].numpy(), np.full(2, 0.5))
    np.testing.assert_array_equal(params["w"].numpy(), np.ones(4))
    lin = torch.nn.Linear(2, 2)
    assert set(init_ema(lin)) == {"weight", "bias"}


def _tiny_config(tmp_path, **kw):
    return TrainConfig(
        model=P.STDiT3Config(depth=1, hidden_size=32, num_heads=2,
                             caption_channels=16, model_max_length=8),
        bucket_config={"144p": {1: (1.0, 2), 34: (1.0, 2)}},
        lr=2e-3, warmup_steps=1, max_steps=8, log_every=1, dataset_size=64,
        seed=0, ckpt_every=8, ckpt_dir=str(tmp_path / "ckpt"), **kw)


def test_run_training_and_checkpoint_round_trip(tmp_path):
    tracked = []
    cfg = _tiny_config(tmp_path, tracker=tracked.append)
    state, ema, history = run_training(cfg, device="cpu")
    assert state.step == 8 and state.tx.count == 8 and len(history) == 8
    assert np.isfinite([h["loss"] for h in history]).all()
    assert np.isfinite([h["grad_norm"] for h in history]).all()
    assert {h["thw"][0] for h in history} <= {1, 34}
    assert [r["step"] for r in tracked] == list(range(1, 9))
    assert tracked[0]["lr"] == cfg.lr and "avg_loss" in tracked[-1]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    moved = max((ema[k] - p.detach()).abs().max().item()
                for k, p in state.model.named_parameters())
    assert moved > 0, "the EMA trails the parameters"

    ckpt_dir = tmp_path / "ckpt" / "epoch0-global_step8"
    assert sorted(os.listdir(ckpt_dir)) == ["running_states.json", "state.pt"]
    fresh = P.STDiT3(cfg.model, remat=True)
    new = PT.create_train_state(
        fresh, PT.make_optimizer(fresh.parameters(), cfg.lr, warmup_steps=1))
    new, ema2, epoch, step, sampler = ckpt_io.load(str(ckpt_dir), new)
    assert (epoch, step, new.step, new.tx.count) == (0, 8, 8, 8)
    assert sampler == {"seed": 0, "epoch": 0, "start_index": 8}
    for k, v in state.model.state_dict().items():
        assert torch.equal(new.model.state_dict()[k], v), k
    for k, v in ema.items():
        assert torch.equal(ema2[k], v), k
    old_opt, new_opt = state.tx.opt.state_dict(), new.tx.opt.state_dict()
    for i, s in old_opt["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(new_opt["state"][i][name], s[name])


def test_run_training_is_reproducible_and_takes_params(tmp_path):
    """Same seed, same losses; `params=` replaces the random weights."""
    cfg = _tiny_config(tmp_path)
    cfg.max_steps, cfg.ckpt_every = 3, None
    a = run_training(cfg, device="cpu")[2]
    b = run_training(cfg, device="cpu")[2]
    assert [h["loss"] for h in a] == [h["loss"] for h in b]
    torch.manual_seed(7)
    params = P.STDiT3(cfg.model).state_dict()
    c = run_training(cfg, device="cpu", params=params)[2]
    assert [h["bucket"] for h in c] == [h["bucket"] for h in a]
    assert c[0]["loss"] != a[0]["loss"]


def test_run_training_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(_tiny_config(tmp_path))

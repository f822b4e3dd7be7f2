"""The DCP profiler and the training loop's DCP options of the PyTorch port
against the JAX package, on the CPU.

The CPU has no caching allocator, so the port's `Profiler` reads a memory
table through `peak_bytes`, and the JAX `Profiler`'s compiled plan is
replaced by the same table (its `_analyze` is patched in the test): both
then decide from the same numbers. FLOPs come from matmuls of known size,
so the time priors (FLOPs / 1e12) and with them the planners' gas agree.
"""

import dataclasses
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.core import dcp as JD
from videosys_tpu.training import train as JTR
from videosys_tpu.training.buckets import Bucket as JBucket
from videosys_tpu_torch.core import dcp as PD
from videosys_tpu_torch.core import parallel as par
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config
from videosys_tpu_torch.training import train as PTR
from videosys_tpu_torch.training.buckets import Bucket
from videosys_tpu_torch.utils.timing import GroupTimer, Timer, device_memory_stats

GiB = 1 << 30
BUDGET = 80 * GiB  # x 0.92 = 73.6 GiB
BUCKETS = {"144p": {51: (1.0, 4), 1: (1.0, 8)}, "240p": {51: (1.0, 2)}}
# per-sample GiB by (resolution, frames, policy) over 20 GiB of fixed state
PER_SAMPLE = {("144p", 51): {"none": 16, "dots": 6, "full": 1.2},
              ("144p", 1): {"none": 0.5, "dots": 0.3, "full": 0.1},
              ("240p", 51): {"none": 45, "dots": 9, "full": 3.5}}


def _name(thw):
    """The resolution of a profiled shape (the first aspect ratio's)."""
    return "144p" if thw[1] * thw[2] < 2 * 144 * 256 else "240p"


def table(thw, bs, sp, policy="full"):
    """Peak bytes of a candidate: the fixed state plus the activations,
    split over sp."""
    per = PER_SAMPLE[(_name(thw), thw[0])][policy]
    return int((20 + per * bs / sp) * GiB)


def flops(bs, sp):
    return 2.0 * (bs * 64 // sp) * 32 * 16


def port_builder(fail=()):
    def build(thw, bs, sp, policy="full"):
        if (_name(thw), bs, sp, policy) in fail:
            raise RuntimeError(f"synthetic build failure {bs} {sp} {policy}")
        a, b = torch.ones(bs * 64 // sp, 32), torch.ones(32, 16)
        return (lambda: torch.mm(a, b)), ()
    return build


def jax_profiler(monkeypatch, fail=(), **kw):
    """The JAX Profiler with its compiled plan replaced by `table`."""
    def analyze(self, thw, bs, sp, policy="full"):
        if (_name(thw), bs, sp, policy) in fail:
            raise RuntimeError(f"synthetic build failure {bs} {sp} {policy}")
        return table(thw, bs, sp, policy), flops(bs, sp), None, ()

    monkeypatch.setattr(JD.Profiler, "_analyze", analyze)
    return JD.Profiler(JBucket(BUCKETS),
                       lambda thw, bs, sp, policy="full": None,
                       memory_budget_bytes=BUDGET, measure_wall_time=False, **kw)


CASES = {
    "recompute": dict(remat_candidates=("none", "dots", "full")),
    "recompute_build_failure": dict(
        remat_candidates=("none", "dots", "full"),
        fail={("240p", 2, 1, "dots"), ("144p", 16, 1, "dots")}),
    "sp": dict(sp_candidates=(1, 2), remat_candidates=("none", "full"),
               fail={("240p", 2, 1, "full")}),
    "fixed_policy_max_bs": dict(remat_candidates=("full",), max_bs=16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiler_decides_as_jax(case, monkeypatch):
    kw = dict(CASES[case])
    fail = kw.pop("fail", ())
    want = jax_profiler(monkeypatch, fail, **kw)
    want.profile_all()
    got = PD.Profiler(Bucket(BUCKETS), port_builder(fail),
                      memory_budget_bytes=BUDGET, measure_wall_time=False,
                      peak_bytes=table, **kw)
    got.profile_all()
    assert got.memory_budget == want.memory_budget
    assert list(got.results) == list(want.results)
    for bid, w in want.results.items():
        g = got.results[bid]
        assert (g.bs, g.sp, g.remat_policy, g.fits) == \
            (w.bs, w.sp, w.remat_policy, w.fits), bid
        if w.fits:
            assert (g.memory_bytes, g.flops, g.time) == \
                (w.memory_bytes, w.flops, w.time), bid
    key = ("bucket", "bs", "sp", "policy")
    assert [tuple(f[k] for k in key) for f in got.failures] == \
        [tuple(f[k] for k in key) for f in want.failures]
    assert got.dump().keys() == want.dump().keys()
    pw, pg = want.make_planner(), got.make_planner()
    assert pg.target_time == pw.target_time
    for bid in want.results:
        assert (pg.plan(bid), pg.remat_policy(bid), pg.bs(bid)) == \
            (pw.plan(bid), pw.remat_policy(bid), pw.bs(bid)), bid
    # every candidate run is listed, the chosen ones among them
    assert all(any(t is r for t in got.trials) for r in got.results.values()
               if r.fits)


def test_profiler_reports_failures():
    """A broken step_builder candidate is reported, not swallowed (the JAX
    package's test_dcp_profiler_reports_failures)."""
    def build(thw, bs, sp):
        if sp == 1:
            raise RuntimeError("synthetic builder failure at sp=1")
        x = torch.ones(bs, 4)
        return (lambda: (x * 2.0).sum()), ()

    prof = PD.Profiler(Bucket({"144p": {1: (1.0, 2)}}), build,
                       sp_candidates=(1, 2), measure_wall_time=False,
                       memory_budget_bytes=GiB,
                       peak_bytes=lambda thw, bs, sp, policy: 1 << 20)
    prof.profile_all()
    assert prof.failures and prof.failures[0]["sp"] == 1
    assert "synthetic builder failure" in prof.failures[0]["error"]
    assert "phase" not in prof.failures[0]
    assert any(p.sp == 2 and p.fits for p in prof.results.values())
    assert "_failures" in prof.dump()


def test_out_of_memory_is_a_non_fit_and_frees_its_frames():
    """A step that runs out of memory does not fit: the error is recorded
    with phase "execute", the policy escalates, the bs ladder keeps the
    last rung that ran, and nothing of the failed run stays alive."""
    held = []

    def build(thw, bs, sp, policy="full"):
        def run():
            acts = torch.ones(1024, 64)  # what a failed step's frames hold
            held.append(weakref.ref(acts))
            if policy == "none" or bs >= 32:
                raise torch.cuda.OutOfMemoryError(
                    f"CUDA out of memory (synthetic, bs {bs})")
        return run, ()

    prof = PD.Profiler(Bucket({"144p": {51: (1.0, 4)}}), build,
                       memory_budget_bytes=BUDGET,
                       remat_candidates=("none", "dots", "full"),
                       peak_bytes=lambda thw, bs, sp, policy: GiB)
    prof.profile_all()
    (p,) = prof.results.values()
    assert (p.bs, p.remat_policy, p.fits) == (16, "dots", True)
    assert p.time >= 0 and p.memory_bytes == GiB
    assert [(f["policy"], f["bs"], f["phase"]) for f in prof.failures] == \
        [("none", 4, "execute"), ("dots", 32, "execute")]
    assert all("OutOfMemoryError" in f["error"] for f in prof.failures)
    assert [(t.remat_policy, t.bs, t.fits) for t in prof.trials] == [
        ("none", 4, False), ("dots", 4, True), ("dots", 8, True),
        ("dots", 16, True), ("dots", 32, False)]
    assert all(r() is None for r in held), "a failed run's tensors are alive"


def test_profiler_needs_a_memory_reading():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="peak_bytes"):
        PD.Profiler(Bucket({"144p": {1: (1.0, 2)}}), port_builder())


def _tiny_config(**kw):
    base = dict(
        model=STDiT3Config(depth=1, hidden_size=32, num_heads=2,
                           caption_channels=16, model_max_length=8),
        bucket_config={"144p": {1: (1.0, 2), 34: (1.0, 2)}},
        mask_ratios={"identity": 0.5, "quarter_head": 0.5},
        lr=2e-3, warmup_steps=1, max_steps=4, log_every=1, dataset_size=48,
        seed=3, weight_decay=0.01)
    base.update(kw)
    return PTR.TrainConfig(**base)


def tiny_table(thw, bs, sp, policy="full"):
    """Images fit with no recompute up to bs 4; 34-frame clips need "dots"
    and stop at bs 2."""
    if thw[0] == 1:
        return (2 if bs <= 4 else 9) * GiB
    return {"none": 9, "dots": 2 if bs <= 2 else 9, "full": 1}[policy] * GiB


class RecordingProfiler(PD.Profiler):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, memory_budget_bytes=8 * GiB, peak_bytes=tiny_table,
                         alloc_memory_fraction=1.0, measure_wall_time=False,
                         **kw)
        self.made.append(self)


def test_dynamic_profile_leaves_no_trace(monkeypatch):
    """A run with the profile phase ends with the weights, AdamW moments,
    step count, EMA and losses bit-equal to the same run given the
    profile's planner: the profile ran whole steps on the run's model and
    left nothing behind."""
    RecordingProfiler.made = []
    monkeypatch.setattr(PTR, "Profiler", RecordingProfiler)
    cfg = _tiny_config(dynamic_profile=True, dynamic_recompute=True)
    state_a, ema_a, hist_a = PTR.run_training(cfg, device="cpu")
    (prof,) = RecordingProfiler.made
    decided = {bid[:2]: (p.bs, p.remat_policy) for bid, p in prof.results.items()}
    assert decided == {("144p", 1): (4, "none"), ("144p", 34): (2, "dots")}
    assert [(bid[1], t.remat_policy, t.bs) for bid, t in
            ((t.bucket_id, t) for t in prof.trials)] == [
        (34, "none", 2), (34, "dots", 2), (34, "dots", 4),
        (1, "none", 2), (1, "none", 4), (1, "none", 8)]
    planner = prof.make_planner()

    cfg_b = dataclasses.replace(cfg, dynamic_profile=False,
                                dynamic_recompute=False)
    state_b, ema_b, hist_b = PTR.run_training(cfg_b, device="cpu",
                                              planner=planner)
    assert [h["loss"] for h in hist_a] == [h["loss"] for h in hist_b]
    assert {(h["batch"], h["remat_policy"]) for h in hist_a} <= {
        (4, "none"), (2, "dots")}
    assert state_a.tx.count == state_b.tx.count == cfg.max_steps
    for (n, a), b in zip(state_a.model.named_parameters(),
                         state_b.model.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(ema_a[n], ema_b[n]), n
    sa, sb = state_a.tx.opt.state_dict(), state_b.tx.opt.state_dict()
    for i, s in sa["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[k], sb["state"][i][k]), (i, k)


def test_sp_balance_runs_the_packed_step_loop():
    """sp_balance on one device: every GlobalStep holds one plan, whose
    gradients (one per micro-batch) are summed and applied once; on one
    bucket the losses follow the plain loop's."""
    cfg = _tiny_config(bucket_config={"144p": {1: (1.0, 2)}}, max_steps=3,
                       mask_ratios=None)
    planner = PTR.DCPPlanner({("144p", 1, "0.38"): {"time": 1.0, "sp": 1}},
                             target_time=2.0)  # gas 2
    plain = PTR.run_training(cfg, device="cpu", planner=planner)[2]
    packed = PTR.run_training(dataclasses.replace(cfg, sp_balance=True),
                              device="cpu", planner=planner)[2]
    assert [h["gas"] for h in packed] == [2, 2, 2]
    assert [h["packed_plans"] for h in packed] == [1, 1, 1]
    assert packed[0]["loss"] == plain[0]["loss"]
    np.testing.assert_allclose([h["loss"] for h in packed],
                               [h["loss"] for h in plain], rtol=1e-5)


@pytest.mark.parametrize("fields,error", [
    (dict(dynamic_recompute=True), ValueError),
    (dict(zero3=True, sp_balance=True), ValueError),
])
def test_unported_and_conflicting_fields_raise(fields, error):
    with pytest.raises(error, match="dynamic_profile|sp_balance"):
        PTR.run_training(_tiny_config(**fields), device="cpu")


@pytest.fixture(scope="module")
def plain_runs():
    """The plain world-1 runs, with and without sp_balance."""
    cfg = _tiny_config(max_steps=3)
    return {False: PTR.run_training(cfg, device="cpu")[2],
            True: PTR.run_training(dataclasses.replace(cfg, sp_balance=True),
                                   device="cpu")[2]}


@pytest.mark.parametrize("fields", [
    dict(zero3=True), dict(dynamic_sp=True),
    dict(zero3=True, dynamic_sp=True), dict(dynamic_sp=True, sp_balance=True),
])
def test_zero3_and_dynamic_sp_at_world1_are_the_plain_run(fields, plain_runs):
    """At one rank ZeRO-3 shards nothing and the sp pool holds one layout
    (JAX's `_pin_params_zero3` returns the params unchanged there): the
    losses and grad norms are the plain run's."""
    got = PTR.run_training(_tiny_config(max_steps=3, **fields),
                           device="cpu")[2]
    want = plain_runs[fields.get("sp_balance", False)]
    assert [h["loss"] for h in got] == [h["loss"] for h in want]
    assert [h["grad_norm"] for h in got] == [h["grad_norm"] for h in want]
    assert {h["mesh"] for h in got} == {"sp_balance" if fields.get(
        "sp_balance") else None}


def test_train_config_fields_match_jax():
    """Every field of the JAX TrainConfig, with its default (the model's
    dtype aside)."""
    want = {f.name: f for f in dataclasses.fields(JTR.TrainConfig)}
    got = {f.name: f for f in dataclasses.fields(PTR.TrainConfig)}
    assert set(got) == set(want)
    jcfg, pcfg = JTR.TrainConfig(), PTR.TrainConfig()
    for name in want:
        if name == "model":
            assert pcfg.model.dtype == torch.bfloat16
            assert jcfg.model.dtype == jnp.bfloat16
            continue
        assert getattr(pcfg, name) == getattr(jcfg, name), name


def test_timer_and_memory_stats_on_the_cpu():
    with Timer("cpu", device="cpu") as t:
        sum(range(10000))
    assert t.elapsed > 0 and t.memory == {}
    assert device_memory_stats("cpu") == {}
    one = par.Axis(None, (0,), 0)
    groups = par.Groups(par.ParallelConfig(), 0,
                        {a: one for a in par.MESH_AXES}, None,
                        torch.device("cpu"))
    with GroupTimer("one rank", groups=groups) as g:  # no collective
        pass
    assert g.elapsed >= 0 and g.groups is None
    with GroupTimer("one device", device="cpu") as g:
        pass
    assert g.elapsed >= 0

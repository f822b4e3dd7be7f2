"""`run_training` over ranks (gloo on the CPU): ZeRO-1 checkpoints move
between world sizes, and the cli spawns the ranks. A run saved at dp=2
resumes at world 1, and the reverse, and continues with the losses and
grad norms of a straight world-1 run on the same global batch (1e-4). The
checkpoint is the one-rank layout: rank 0 writes it with the moment slices
gathered; loading it keeps each rank's slice.
"""

import os

import numpy as np
import pytest
import torch

from videosys_tpu_torch.models.transformers import stdit3 as P
from videosys_tpu_torch.training.train import TrainConfig, run_training

SIZES = dict(depth=1, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8)


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


def _run_config(tmp_path, bs, **kw):
    return TrainConfig(
        model=P.STDiT3Config(**SIZES),
        bucket_config={"144p": {34: (1.0, bs)}}, mask_ratios=None,
        lr=2e-3, warmup_steps=1, log_every=1, dataset_size=32, seed=0,
        ckpt_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("saved_at", ["dp2", "world1"])
def test_checkpoints_move_between_world_sizes(tmp_path, saved_at):
    """A run saved after 2 steps at dp=2 resumes at world 1 (and the
    reverse) and continues with the losses of a straight 4-step world-1
    run on the same global batch (world 1: batch 4; dp=2: 2 a rank)."""
    straight = run_training(_run_config(tmp_path / "a", 4, max_steps=4),
                            device="cpu")[2]
    dp2 = dict(bs=2, dp_size=2)
    first = dp2 if saved_at == "dp2" else dict(bs=4)
    then = dict(bs=4) if saved_at == "dp2" else dp2
    saved = run_training(_run_config(tmp_path / "b", max_steps=2,
                                     ckpt_every=2, **first),
                         device="cpu")[2]
    ckpt = tmp_path / "b" / "epoch0-global_step2"
    assert sorted(os.listdir(ckpt)) == ["running_states.json", "state.pt"]
    resumed = run_training(_run_config(tmp_path / "c", max_steps=4, **then),
                           device="cpu", resume=str(ckpt))[2]
    assert [h["step"] for h in resumed] == [3, 4]
    got = [h["loss"] for h in saved + resumed]
    np.testing.assert_allclose(got, [h["loss"] for h in straight], rtol=1e-4)
    np.testing.assert_allclose(
        [h["grad_norm"] for h in saved + resumed],
        [h["grad_norm"] for h in straight], rtol=1e-4)


def test_cli_spawns_training_ranks():
    """`--dp-size 2` on the CPU (gloo): two ranks, the tiny model, the
    same history as the run_training call it makes."""
    from videosys_tpu_torch.training import cli

    steps, history = cli.main(["--tiny", "--device", "cpu", "--backend",
                               "gloo", "--max-steps", "2", "--dp-size", "2",
                               "--warmup-steps", "1"])
    assert steps == 2 and len(history) == 0  # log_every 10: nothing logged
    cfg = TrainConfig(model=P.STDiT3Config(depth=1, hidden_size=32,
                                           num_heads=2, caption_channels=16,
                                           model_max_length=8),
                      bucket_config={"144p": {1: (1.0, 2), 34: (1.0, 2)}},
                      mask_ratios=None, max_steps=2, warmup_steps=1,
                      dp_size=2, log_every=1)
    state, _, logged = run_training(cfg, device="cpu", backend="gloo")
    assert state.step == 2 and state.tx.groups is not None
    assert [h["step"] for h in logged] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in logged)

"""The arithmetic of the yardstick against hand-worked shapes: an attention
op's operations and bytes, its roofline bound, and the model FLOPs a step
executes; and an attention op counts the same whichever kernel runs it."""

import pytest
import torch

from harness import roofline
from harness.attention import AttentionProbe
from reference import cogvideox_2b as cog
from reference import opensora_v1_2 as osr
from reference import pab

from conftest import _json


def test_attention_work_by_hand():
    # Open-Sora's spatial rows: [30, 16, 1590, 1590, 72] bf16
    flops, nbytes = roofline.attention_work(30, 16, 1590, 1590, 72, 2)
    assert flops == 4 * 30 * 16 * 1590 * 1590 * 72  # 2 products, 2 a MAC
    assert nbytes == (2 * 30 * 16 * 1590 * 72 + 2 * 16 * 30 * 1590 * 72) * 2
    assert roofline.bound_seconds(flops, nbytes) == pytest.approx(
        flops / 989e12)  # bound by compute
    # its cross rows, 40 live keys of a 64-key bucket in each of 30 rows
    flops, nbytes = roofline.attention_work(30, 16, 1590, 64, 72, 2,
                                            live=[40] * 30, masked=True)
    assert flops == 4 * 16 * 1590 * 72 * 40 * 30
    assert nbytes == (2 * 30 * 16 * 1590 * 72 + 2 * 16 * 1200 * 72) * 2 \
        + 30 * 64
    assert roofline.bound_seconds(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)  # bound by memory
    # the backward: 5 products; dO read and dq, dk, dv written besides
    flops, nbytes = roofline.attention_work(1, 2, 8, 8, 4, 2, backward=True)
    assert flops == 2 * 5 * 2 * 8 * 8 * 4
    assert nbytes == 2 * (2 * 2 * 8 * 4 + 2 * 2 * 8 * 4) * 2


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("shape", [(3, 2, 15, 15, 8), (1, 2, 40, 40, 8),
                                   (1, 1, 5, 4200, 8)])
def test_attention_count_is_the_same_whichever_path_runs(monkeypatch, force,
                                                         shape):
    """The plain attention and the kernels' plain versions (and on a card
    the short, narrow or long kernel) give the same count: it comes from
    the call's shapes and live keys alone."""
    from videosys_tpu_torch.models.modules import blocks
    monkeypatch.setenv("VIDEOSYS_FORCE_FLASH", "1" if force else "0")
    B, H, Nq, Nk, D = shape
    q = torch.randn(B, H, Nq, D)
    k = torch.randn(B, H, Nk, D)
    mask = torch.ones(B, Nk, dtype=torch.bool)
    mask[:, Nk // 2:] = False
    probe = AttentionProbe()
    probe.install()
    try:
        blocks.scaled_dot_product_attention(q, k, k, kv_mask=mask)
    finally:
        probe.remove()
    (call,) = probe.calls
    live = [int(n) for n in call["live"].tolist()]
    assert live == [Nk // 2] * B
    assert roofline.attention_work(call["B"], call["H"], call["Nq"],
                                   call["Nk"], call["D"], call["itemsize"],
                                   live=live, masked=True) == \
        roofline.attention_work(B, H, Nq, Nk, D, 4, live=live, masked=True)


def test_stdit3_step_flops_by_hand():
    cfg = _json("configs", "opensora-v1.2.json")
    C, T, S, L = 1152, 15, 1590, 53
    M = 2 * T * S
    per_pair = 2 * (28 * M * C * C) + 4 * 2 * T * S * S * C \
        + 4 * 2 * S * T * T * C + 2 * (4 * 2 * L * C * C + 4 * T * S * 2 * L * C)
    # per pair: both blocks' projections and MLP (28 M C^2 each), the
    # spatial and temporal products, and both cross-attentions' kv
    # projection and products over the live tokens; the rest once a step
    rest = 2 * 2 * L * (4096 * C + C * C) + 2 * M * C * 16 + 2 * M * C * 32 \
        + 2 * 2 * (2 * (256 * C + C * C) + 6 * C * C)
    got = osr.step_flops(cfg, 2, T, S, [L, L])
    assert got == pytest.approx(28 * per_pair + rest, rel=1e-12)
    assert 1.05e14 < got < 1.15e14


def test_pab_step_drops_what_it_reads():
    cfg = _json("configs", "opensora-v1.2.json")
    mix = _json("traffic", "t2v-480p-2s-pab.json")
    req = mix["request"]
    t, _ = osr.rflow_ladder(req["steps"], req["height"], req["width"],
                            req["num_frames"])
    plans = pab.plans(mix["pipeline"]["pab_config"], t, 28, torch.bfloat16)
    dense = osr.step_flops(cfg, 2, 15, 1590, [53, 53])
    counts = [osr.step_flops(cfg, 2, 15, 1590, [53, 53], p) for p in plans]
    reading = [i for i, p in enumerate(plans) if p.read]
    assert reading == [9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
                       23, 25]
    assert all(counts[i] < dense for i in reading)
    assert all(counts[i] == dense for i in range(30) if i not in reading)
    assert pab.closure(plans, 14) == [12, 13, 14]


def test_cogvideox_step_flops_by_hand():
    cfg = _json("configs", "cogvideox-2b.json")
    C, N, L = 1920, 13 * 30 * 45, 226
    M = 2 * (N + L)
    block = 8 * M * C * C + 4 * 2 * (N + L) ** 2 * C + 16 * M * C * C
    got = cog.step_flops(cfg, 2, 13, 60, 90, L)
    assert got > 30 * block
    assert got == pytest.approx(30 * block, rel=2e-3)
    assert 2.3e14 < got < 2.5e14

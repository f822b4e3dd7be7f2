"""Puts the benchmark's own modules and the program on the path, and gives
the tiny configurations the CPU tests run (the cells' shapes, small
widths)."""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _json(*parts):
    return json.loads(BENCH.joinpath(*parts).read_text())


def tiny_t5(cfg: dict, width: int) -> None:
    cfg["text_encoder"].update(vocab_size=97, d_model=width, d_kv=8,
                               d_ff=48, num_layers=2, num_heads=4)


def tiny_opensora(dtype: str = "fp32") -> dict:
    cfg = _json("configs", "opensora-v1.2.json")
    cfg.update(depth=2, hidden_size=64, num_heads=4, caption_channels=64,
               dtype=dtype)
    tiny_t5(cfg, 64)
    cfg["vae"]["spatial"] = {"block_out_channels": [32, 32, 32, 32],
                             "layers_per_block": 1}
    cfg["vae"]["temporal"] = {"filters": 32, "num_res_blocks": 1,
                              "channel_multipliers": [1, 1, 1, 1],
                              "temporal_downsample": [False, True, True]}
    return cfg


def tiny_opensora_mix(traffic: str, steps: int = 30) -> dict:
    mix = _json("traffic", f"{traffic}.json")
    mix["request"].update(resolution="144p", aspect_ratio="9:16", height=144,
                          width=256, steps=steps)
    mix["prompt_words"] = 12
    return mix


def tiny_cogvideox(dtype: str = "fp32") -> dict:
    cfg = _json("configs", "cogvideox-2b.json")
    cfg.update(num_layers=2, num_attention_heads=2, attention_head_dim=16,
               time_embed_dim=32, text_embed_dim=32, max_text_seq_length=16,
               dtype=dtype)
    tiny_t5(cfg, 32)
    cfg["vae"].update(block_out_channels=[32, 32, 32, 32], layers_per_block=1,
                      tile_latent_min_height=6, tile_latent_min_width=8)
    return cfg


def tiny_cogvideox_mix(steps: int = 4) -> dict:
    mix = _json("traffic", "t2v-49x480x720.json")
    mix["request"].update(height=80, width=96, num_frames=9, steps=steps)
    mix["prompt_words"] = 8
    return mix


TINY = {
    "os12-480p-dense": lambda dtype="fp32": (
        tiny_opensora(dtype), tiny_opensora_mix("t2v-480p-2s", 4)),
    "os12-480p-pab": lambda dtype="fp32": (
        tiny_opensora(dtype), tiny_opensora_mix("t2v-480p-2s-pab", 30)),
    "cogx2b-480p-dense": lambda dtype="fp32": (
        tiny_cogvideox(dtype), tiny_cogvideox_mix()),
}


@pytest.fixture
def tiny():
    """cell -> (configuration, mix) at tiny widths."""
    return lambda cell, dtype="fp32": copy.deepcopy(TINY[cell](dtype))

"""The port's spans (`utils.timing.span`) and the phase times of
`VideoSysPipeline._phase`, on tiny Open-Sora and CogVideoX pipelines on
the CPU: with no profiler a `generate` enters no `record_function`; under
`torch.profiler` the exported trace holds one `videosys.request` a
generate, one `videosys.step` a denoise step nested in `videosys.denoise`
nested in the request, STDiT3's 2 x depth block spans and CogVideoX's depth
a forward, and only declared names, every one of them used; `profile_trace`
writes them; `last_timings` keeps its keys and sums to no more than the
request's wall time, and on the card its phases are timed by CUDA events
read at the request's end, with no synchronize."""

import json
import os
import time
import types
import zlib

import numpy as np
import pytest
import torch

import videosys_tpu_torch
from videosys_tpu_torch.core import pipeline as core_pipeline
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as PA
from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import (
    CogVideoXVAEConfig,
)
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal
from videosys_tpu_torch.models.text_encoders.t5 import (
    T5Config,
    T5EncoderModel,
    T5TextEncoder,
)
from videosys_tpu_torch.models.transformers.cogvideox import CogVideoXConfig
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config
from videosys_tpu_torch.utils import timing
from videosys_tpu_torch.utils.timing import profile_trace

STEPS = 2
DEPTH = 2
T5_TINY = T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=2,
                   num_heads=4)
PAB = videosys_tpu_torch.OpenSoraPABConfig(
    spatial_threshold=(100, 950), temporal_threshold=(100, 950),
    cross_threshold=(100, 950), mlp_broadcast=False)
PHASES = {"text", "denoise", "vae", "postprocess"}


class WordTokenizer:
    """Words hash to ids 2..vocab-1, then eos (1), padding (0), called as
    an HF tokenizer is."""

    def __call__(self, texts, max_length, **_):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            words = text.split()[: max_length - 1]
            toks = [2 + zlib.crc32(w.encode()) % (T5_TINY.vocab_size - 2)
                    for w in words] + [1]
            ids[i, : len(toks)] = toks
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def t5_encoder():
    torch.manual_seed(0)
    return T5TextEncoder(max_length=8, device="cpu", tokenizer=WordTokenizer(),
                         model=T5EncoderModel(T5_TINY))


def open_sora(pab: bool):
    vae = PA.OpenSoraVAE(
        PA.OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
        spatial=AutoencoderKL2D(block_out_channels=(8, 8, 8, 16),
                                layers_per_block=1, num_groups=4),
        temporal=VAETemporal(filters=8, num_res_blocks=1, num_groups=4))
    config = videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None,
        num_sampling_steps=STEPS, dtype="fp32", enable_pab=pab,
        pab_config=PAB, transformer_config=STDiT3Config(
            depth=DEPTH, hidden_size=32, num_heads=2, caption_channels=16,
            model_max_length=8, patch_size=(1, 2, 2)))
    pipe = videosys_tpu_torch.VideoSysEngine(
        config, vae=vae, device="cpu", seed=5,
        text_encoder=t5_encoder()).pipeline
    return pipe, lambda: pipe.generate(
        "waves at dusk", resolution="144p", aspect_ratio="1:1",
        num_frames=18, seed=11)


def cogvideox(pab: bool):
    # tiles of 6 x 5 latents: the 8 x 10 latents decode as 2 x 3 tiles
    vae = CogVideoXVAEConfig(latent_channels=4,
                             block_out_channels=(8, 8, 16, 16),
                             layers_per_block=1, norm_num_groups=4,
                             tile_latent_min_height=6,
                             tile_latent_min_width=5)
    config = videosys_tpu_torch.CogVideoXConfig(
        model_path=None, dtype="fp32", vae_tiling=True, enable_pab=pab,
        transformer_config=CogVideoXConfig(
            num_layers=DEPTH, num_heads=2, head_dim=16, in_channels=4,
            out_channels=4, time_embed_dim=16, text_embed_dim=16,
            max_text_seq_length=8),
        vae_config=vae)
    pipe = videosys_tpu_torch.CogVideoXPipeline(
        config, device="cpu", seed=1, text_encoder=t5_encoder())
    return pipe, lambda: pipe.generate(
        "a cat", num_inference_steps=STEPS, num_frames=9, height=64,
        width=80, seed=2)


PIPELINES = {"open_sora": open_sora, "cogvideox": cogvideox}
CASES = [("open_sora", False), ("open_sora", True), ("cogvideox", False),
         ("cogvideox", True)]
# the block spans of one forward
BLOCKS = {"open_sora": {timing.BLOCK_SPATIAL: DEPTH,
                        timing.BLOCK_TEMPORAL: DEPTH},
          "cogvideox": {timing.BLOCK: DEPTH}}


@pytest.fixture(scope="module")
def built():
    made = {}

    def get(name, pab):
        if (name, pab) not in made:
            made[name, pab] = PIPELINES[name](pab)
        return made[name, pab]

    return get


def program_spans(path):
    """[(name, start, end)] of the trace file's `videosys.` ranges."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("videosys.")]


def traced(generate, tmp_path, requests=1):
    path = str(tmp_path / "trace.json")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(requests):
            generate()
    prof.export_chrome_trace(path)
    return program_spans(path)


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("name,pab", CASES)
def test_no_profiler_enters_no_record_function(built, monkeypatch, name,
                                               pab):
    _, generate = built(name, pab)
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*args):
        calls.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    generate()
    assert calls == []
    # the count sees a span opened under a profiler
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.span(timing.STEP):
            pass
    assert calls == [timing.STEP]


@pytest.mark.parametrize("name,pab", CASES)
def test_spans_nest_request_denoise_step(built, tmp_path, name, pab):
    _, generate = built(name, pab)
    spans = traced(generate, tmp_path, requests=2)
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    requests = by[timing.REQUEST]
    assert len(requests) == 2
    assert len(by[timing.DENOISE]) == 2
    assert len(by[timing.STEP]) == 2 * STEPS
    for step in by[timing.STEP]:
        denoise = [d for d in by[timing.DENOISE] if inside(step, d)]
        assert len(denoise) == 1
        assert any(inside(denoise[0], r) for r in requests)
    for phase in (timing.TEXT, timing.VAE, timing.POSTPROCESS):
        assert all(any(inside(p, r) for r in requests) for p in by[phase])
    # one forward a step; each forward's blocks
    assert len(by[timing.FORWARD]) == 2 * STEPS
    for block, n in BLOCKS[name].items():
        assert len(by[block]) == 2 * STEPS * n
        for f in by[timing.FORWARD]:
            assert sum(inside(b, f) for b in by[block]) == n
    assert set(by) <= set(timing.SPANS)


def test_every_declared_span_is_opened(built, tmp_path):
    """The union of the names both pipelines open, dense and under PAB, is
    the declared tuple: no name is declared and never used."""
    seen = set()
    for name, pab in CASES:
        seen |= {s[0] for s in traced(built(name, pab)[1], tmp_path)}
    assert seen == set(timing.SPANS)
    assert len(timing.SPANS) == len(set(timing.SPANS))
    assert all(n.startswith("videosys.") for n in timing.SPANS)


def test_profile_trace_holds_the_spans(built, tmp_path):
    _, generate = built("open_sora", False)
    logdir = str(tmp_path / "trace")
    with profile_trace(logdir):
        generate()
    (path,) = os.listdir(logdir)
    names = [s[0] for s in program_spans(os.path.join(logdir, path))]
    assert names.count(timing.REQUEST) == 1
    assert names.count(timing.STEP) == STEPS
    assert names.count(timing.T5) == 1


@pytest.mark.parametrize("name", list(PIPELINES))
def test_last_timings_within_the_request(built, name):
    pipe, generate = built(name, False)
    t0 = time.perf_counter()
    generate()
    wall = time.perf_counter() - t0
    assert set(pipe.last_timings) == PHASES
    assert all(v >= 0 for v in pipe.last_timings.values())
    assert 0 < sum(pipe.last_timings.values()) <= wall


class FakeEvent:
    """A CUDA event on the host clock: record() stamps it."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class Phases(core_pipeline.VideoSysPipeline):
    """A pipeline of three phases, the card stood in for."""

    def __init__(self, offload: bool):
        self.device = types.SimpleNamespace(type="cuda")
        self._config = types.SimpleNamespace(cpu_offload=offload)

    @core_pipeline.timed_request
    def generate(self, naps):
        self.last_timings = dict.fromkeys(sorted(PHASES), 0.0)
        for timer, nap in naps:
            with self._phase(timer):
                time.sleep(nap)
        self.before_read = dict(self.last_timings)
        return "video"


def test_phases_on_the_card_are_read_from_events(monkeypatch):
    """On the card `_phase` records two CUDA events on the current stream
    and never synchronizes; the request's end adds their times to
    `last_timings` (a phase opened twice adds both)."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    pipe = Phases(offload=False)
    assert pipe.generate([("text", 0.01), ("denoise", 0.03),
                          ("vae", 0.02), ("vae", 0.02)]) == "video"
    assert syncs == []
    assert set(pipe.before_read.values()) == {0.0}
    got = pipe.last_timings
    assert got["postprocess"] == 0.0
    assert 0.01 <= got["text"] < got["denoise"]
    assert got["vae"] >= 0.04
    # under cpu_offload the phase waits for the card at its end
    pipe = Phases(offload=True)
    pipe.generate([("text", 0.0)])
    assert len(syncs) == 1 and pipe.before_read["text"] > 0

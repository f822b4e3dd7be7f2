"""A whole run of each cell on the CPU at tiny widths, the harness's look
for cards skipped: the result line's keys, a correct run in float32, and
each fault a serving cell can have, planted in the timed path, turning
`correct` false; the control (the reference with float8 products in the
program's place) reads above the limits."""

import pytest
import torch

import run as bench
import readings
from harness import manifest as mf

CPU = torch.device("cpu")
SEED = 3141592653589
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(tiny, cell, dtype="fp32"):
    cfg, mix = tiny(cell, dtype)
    code, result = bench.run_cell(cell, SEED, 0.5, False, device=CPU,
                                  cfg=cfg, mix=mix)
    assert code == 0
    return result


@pytest.mark.parametrize("cell", ["os12-480p-dense", "os12-480p-pab",
                                  "cogx2b-480p-dense"])
def test_tiny_run_is_correct(tiny, cell):
    result = run_tiny(tiny, cell)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    man = mf.load(mf.ROOT)
    e2e = [m["name"] for m in mf.metrics(man, cell, False)]
    # the CPU has no device peak: peak_gib is left out there
    assert set(result["metrics"]) == set(e2e) - {"peak_gib"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}


def _fault_open_sora_unchanged(mp):
    from videosys_tpu_torch.pipelines.open_sora import pipeline_open_sora
    mp.setattr(pipeline_open_sora.OpenSoraPipeline, "_step",
               lambda self, z, *a, **k: z)


def _fault_open_sora_half_batch(mp):
    # the guidance takes the conditional half alone: the other half of the
    # CFG-doubled batch is left out
    from videosys_tpu_torch.schedulers import rflow
    mp.setattr(rflow.RFlowScheduler, "apply_cfg",
               staticmethod(lambda cond, uncond, g: cond))


def _fault_open_sora_answer(mp):
    from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora
    decode = autoencoder_open_sora.OpenSoraVAE.decode_chunks_u8
    mp.setattr(autoencoder_open_sora.OpenSoraVAE, "decode_chunks_u8",
               lambda self, z, n: [255 - c for c in decode(self, z, n)])


def _fault_cog_unchanged(mp):
    from videosys_tpu_torch.schedulers import ddim
    mp.setattr(ddim.DDIMScheduler, "step",
               lambda self, out, t, sample, *a, **k: sample)


def _fault_cog_answer(mp):
    from videosys_tpu_torch.models.autoencoders import autoencoder_cogvideox
    decode = autoencoder_cogvideox.AutoencoderKLCogVideoX.decode
    mp.setattr(autoencoder_cogvideox.AutoencoderKLCogVideoX, "decode",
               lambda self, z: -decode(self, z))


def _fault_text_answer(mp):
    # T5's features altered where they are produced
    from videosys_tpu_torch.models.text_encoders import t5
    encode = t5.T5TextEncoder.encode
    mp.setattr(t5.T5TextEncoder, "encode",
               lambda self, texts: (lambda h, m: (-h, m))(
                   *encode(self, texts)))


@pytest.mark.parametrize("cell,fault", [
    ("os12-480p-dense", _fault_text_answer),
    ("cogx2b-480p-dense", _fault_text_answer),
    ("os12-480p-dense", _fault_open_sora_unchanged),
    ("os12-480p-dense", _fault_open_sora_half_batch),
    ("os12-480p-dense", _fault_open_sora_answer),
    ("os12-480p-pab", _fault_open_sora_unchanged),
    ("cogx2b-480p-dense", _fault_cog_unchanged),
    ("cogx2b-480p-dense", _fault_cog_answer),
])
def test_fault_in_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run_tiny(tiny, cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", ["os12-480p-dense", "cogx2b-480p-dense"])
def test_control_fails_a_limit(tiny, cell):
    cfg, mix = tiny(cell)
    got = readings.readings(cell, SEED, True, CPU, cfg, mix)
    adapter = mf.module("models", mf.workload(mf.load(mf.ROOT), cell)[
        "config"])
    assert all(v <= adapter.LIMITS[k] for k, v in got["program"].items())
    assert any(v > adapter.LIMITS[k] for k, v in got["control"].items())


@pytest.mark.parametrize("cell", ["os12-480p-dense", "cogx2b-480p-dense"])
def test_text_readings_of_the_program_and_the_control(tiny, cell):
    """The text mode builds T5 from the run's weights and encodes the
    request's texts as the pipeline does: in bfloat16 the program reads
    under its limit, the float8 control several times higher."""
    cfg, mix = tiny(cell, "bf16")
    got = readings.text_readings(cell, SEED, True, CPU, cfg, mix)
    adapter = mf.module("models", mf.workload(mf.load(mf.ROOT), cell)[
        "config"])
    program, control = got["program"]["text_rel"], got["control"]["text_rel"]
    assert 0 < program <= adapter.LIMITS["text_rel"]
    assert control > 3 * program


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card (run with -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    code, result = bench.run_cell("os12-480p-dense", SEED, 1.0, False)
    assert code == 0 and result["correct"] is True

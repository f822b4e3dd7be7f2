"""`cpu_offload` in the port, the analog of the JAX package's
test_low_mem_cpu_offload_matches_dense: with the same weights the offloaded
video equals the resident one bit for bit (dense, PAB, a reference frame,
loop=2); a fetch hook shows that each fetch finds every other module on
its host tensors; every weight is back on the host after `generate`. Also
the engine options of `OpenSoraConfig`, `driver_worker`, `shutdown` and
`initialize`."""

import copy
import dataclasses
import random
import zlib

import numpy as np
import pytest
import torch

import videosys_tpu_torch
from videosys_tpu_torch.core import pipeline as core_pipeline
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as PA
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal
from videosys_tpu_torch.models.text_encoders.t5 import (
    T5Config,
    T5EncoderModel,
    T5TextEncoder,
)
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config

SIZES = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8, patch_size=(1, 2, 2))
T5_TINY = T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=2,
                   num_heads=4)
KW = dict(resolution="144p", aspect_ratio="1:1", num_frames=18, seed=11)
PAB = videosys_tpu_torch.OpenSoraPABConfig(
    spatial_threshold=(100, 950), temporal_threshold=(100, 950),
    cross_threshold=(100, 950), mlp_broadcast=False)
REFERENCE = np.random.default_rng(0).uniform(
    -1, 1, (3, 1, 192, 192)).astype(np.float32)
CASES = {
    "dense": ({}, ["transformer", "vae"]),
    "pab": ({}, ["transformer", "vae"]),
    "reference": ({"reference": REFERENCE}, ["vae", "transformer", "vae"]),
    "loop2": ({"loop": 2}, ["transformer", "vae", "vae", "transformer",
                            "vae"]),
}


class WordTokenizer:
    """Words hash to ids 2..vocab-1, then eos (1), padding (0), called as
    an HF tokenizer is."""

    def __call__(self, texts, max_length, padding, truncation,
                 return_attention_mask, add_special_tokens, return_tensors):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            words = text.split()[: max_length - 1]
            toks = [2 + zlib.crc32(w.encode()) % (T5_TINY.vocab_size - 2)
                    for w in words] + [1]
            ids[i, : len(toks)] = toks
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def tiny_vae():
    return PA.OpenSoraVAE(
        PA.OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
        spatial=AutoencoderKL2D(block_out_channels=(8, 8, 8, 16),
                                layers_per_block=1, num_groups=4),
        temporal=VAETemporal(filters=8, num_res_blocks=1, num_groups=4))


def tiny_config(**over):
    return videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None, num_sampling_steps=4,
        dtype="fp32", transformer_config=STDiT3Config(**SIZES), **over)


@pytest.fixture(scope="module")
def engines():
    torch.manual_seed(0)
    t5 = T5EncoderModel(T5_TINY)
    dense = videosys_tpu_torch.VideoSysEngine(
        tiny_config(), vae=tiny_vae(), device="cpu", seed=5,
        text_encoder=T5TextEncoder(max_length=8, device="cpu",
                                   tokenizer=WordTokenizer(), model=t5))
    pipe = dense.driver_worker
    params = {"transformer": pipe.transformer.state_dict(),
              "vae": pipe.vae.state_dict()}
    off_t5 = T5TextEncoder(max_length=8, device="cpu", offload=True,
                           tokenizer=WordTokenizer(), model=copy.deepcopy(t5))
    off = videosys_tpu_torch.VideoSysEngine(
        tiny_config(cpu_offload=True, tiling_size=1), vae=tiny_vae(),
        device="cpu", params=params, text_encoder=off_t5)
    opipe = off.driver_worker
    return dense, off, [off_t5.model, opipe.transformer, opipe.vae]


@pytest.mark.parametrize("case", list(CASES))
def test_offload_equals_dense(engines, case, monkeypatch):
    dense, off, modules = engines
    extra, phases = CASES[case]
    for eng in (dense, off):
        eng.config.enable_pab, eng.config.pab_config = case == "pab", PAB
    params = [p for m in modules for p in m.parameters()]
    host = {id(p): p.data_ptr() for p in params}
    fetched = []

    def hook(name, module, seconds, nbytes):
        mine = {id(p) for p in module.parameters()}
        elsewhere = [p for p in params if id(p) not in mine
                     and p.data_ptr() != host[id(p)]]
        assert not elsewhere, f"{name}: another module is still fetched"
        assert all(p.data_ptr() != host[id(p)] for p in module.parameters())
        assert nbytes == sum(p.numel() * p.element_size()
                             for p in module.parameters())
        fetched.append(name)

    monkeypatch.setattr(core_pipeline, "FETCH_HOOKS", [hook])
    want = dense.generate("a red fox in the snow", **KW, **extra).video
    assert not fetched  # the resident engine fetches nothing
    got = off.generate("a red fox in the snow", **KW, **extra).video
    np.testing.assert_array_equal(got, want)
    # text: the T5, then the transformer's null caption; then each phase
    assert fetched == ["text_encoder", "y_embedder"] + phases
    assert all(p.data_ptr() == host[id(p)] for p in params)
    assert all(p.device.type == "cpu" for p in params)


def test_config_fields():
    cfg = tiny_config(num_gpus=1, cpu_offload=True, enable_cp=True,
                      enable_flash_attn=False)
    # on the CPU the plain attention runs anyway, so the flag is accepted
    pipe = videosys_tpu_torch.OpenSoraPipeline(cfg, vae=tiny_vae(),
                                               device="cpu")
    assert all(p.device.type == "cpu" and not p.is_pinned()
               for p in pipe.transformer.parameters())
    # num_gpus > 1 builds its groups over the default process group: none
    # exists here (VideoSysEngine spawns the ranks)
    with pytest.raises(RuntimeError, match="initialize"):
        videosys_tpu_torch.OpenSoraPipeline(
            dataclasses.replace(cfg, num_gpus=2), vae=tiny_vae(), device="cpu")


@pytest.mark.cuda
def test_flash_attn_off_raises_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with pytest.raises(ValueError, match="enable_flash_attn"):
        videosys_tpu_torch.OpenSoraPipeline(
            tiny_config(enable_flash_attn=False), vae=tiny_vae())


def test_engine_api_and_initialize(monkeypatch):
    eng = videosys_tpu_torch.VideoSysEngine(tiny_config(), vae=tiny_vae(),
                                            device="cpu")
    assert eng.driver_worker is eng.pipeline
    assert isinstance(eng.driver_worker, videosys_tpu_torch.OpenSoraPipeline)
    eng.shutdown()
    videosys_tpu_torch.initialize(seed=3)
    a = (random.random(), np.random.rand(), torch.rand(1).item())
    videosys_tpu_torch.initialize(rank=0, world_size=1, seed=3)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item())
    # world_size > 1 joins a process group: at an address, on a device
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        videosys_tpu_torch.initialize(world_size=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            videosys_tpu_torch.initialize(world_size=2,
                                          coordinator_address="localhost:1")

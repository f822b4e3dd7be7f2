"""The port's checkpoint I/O against the `safetensors` package and the JAX
package: safetensors files both ways (F32, F16, BF16, I64, I32, BOOL),
sharded directories and pytorch_model.bin; a tiny STDiT3 written in the
reference layout and served by both packages' engines from that directory
(same VAE weights, same initial noise; latents at 2e-4, video one level);
a tiny diffusers-layout CogVideoX snapshot (a sharded `transformer/` and a
`vae/`) loaded and served; the `save_params` / `try_load_params` round
trip; the raises."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

import videosys_tpu
import videosys_tpu_torch
from videosys_tpu.models.autoencoders import autoencoder_open_sora as JA
from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JKL
from videosys_tpu.models.autoencoders.vae_temporal import VAETemporal as JT
from videosys_tpu.models.transformers.stdit3 import STDiT3Config as JCfg
from videosys_tpu_torch.models.autoencoders import autoencoder_open_sora as PA
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D as PKL
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal as PT
from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import (
    CogVideoXVAEConfig,
)
from videosys_tpu_torch.models.modules.embeddings import rope_freqs
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
from videosys_tpu_torch.models.transformers.cogvideox import (
    CogVideoXConfig as CogModelConfig,
)
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config as PCfg
from videosys_tpu_torch.utils import safetensors_io as io
from videosys_tpu_torch.utils.checkpoint import (
    load_torch_checkpoint,
    save_params,
    try_load_params,
)
from videosys_tpu_torch.utils.from_jax import open_sora_vae_from_jax

TOL = 2e-4
SIZES = dict(depth=2, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8, patch_size=(1, 2, 2))
SPATIAL = dict(mid_block_add_attention=False, block_out_channels=(8, 16),
               layers_per_block=1, num_groups=4)
TEMPORAL = dict(filters=8, num_res_blocks=1, num_groups=4)


def tensors() -> dict:
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i64": torch.randint(-2**40, 2**40, (6,), generator=g),
        "i32": torch.randint(-100, 100, (2, 2), generator=g, dtype=torch.int32),
        "bool": torch.rand(9, generator=g) > 0.5,
        "scalar": torch.tensor(1.5),
    }


def assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_safetensors_file_both_ways(tmp_path):
    ts = tensors()
    st_save(ts, str(tmp_path / "lib.safetensors"), metadata={"format": "pt"})
    assert_same(io.load_file(str(tmp_path / "lib.safetensors")), ts)
    io.save_file(ts, str(tmp_path / "port.safetensors"), {"format": "pt"})
    assert_same(st_load(str(tmp_path / "port.safetensors")), ts)
    header, _ = io.read_header(str(tmp_path / "port.safetensors"))
    assert header["__metadata__"] == {"format": "pt"}


def test_sharded_directories_both_ways(tmp_path):
    ts = tensors()
    # the port writes two shards and an index; the library reads each
    io.save_sharded(ts, str(tmp_path / "port"), shards=2)
    with open(tmp_path / "port" / "model.safetensors.index.json") as f:
        weight_map = json.load(f)["weight_map"]
    assert sorted(set(weight_map.values())) == [
        "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    read = {}
    for name in set(weight_map.values()):
        read.update(st_load(str(tmp_path / "port" / name)))
    assert_same(read, ts)
    assert_same(io.load_dir(str(tmp_path / "port")), ts)
    # the library's shards with an index, read by the port
    lib = tmp_path / "lib"
    lib.mkdir()
    names = sorted(ts)
    shards = {"a.safetensors": names[:3], "b.safetensors": names[3:]}
    for fname, keys in shards.items():
        st_save({k: ts[k] for k in keys}, str(lib / fname))
    with open(lib / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": {
            k: fname for fname, keys in shards.items() for k in keys}}, f)
    assert_same(io.load_dir(str(lib)), ts)


@pytest.mark.parametrize("indexed", [False, True])
def test_pytorch_bin_directories(tmp_path, indexed):
    ts = tensors()
    if indexed:
        torch.save({k: ts[k] for k in sorted(ts)[:4]},
                   tmp_path / "pytorch_model-00001-of-00002.bin")
        torch.save({k: ts[k] for k in sorted(ts)[4:]},
                   tmp_path / "pytorch_model-00002-of-00002.bin")
        with open(tmp_path / "pytorch_model.bin.index.json", "w") as f:
            json.dump({"weight_map": {
                k: f"pytorch_model-0000{1 + (i >= 4)}-of-00002.bin"
                for i, k in enumerate(sorted(ts))}}, f)
    else:
        torch.save(ts, tmp_path / "pytorch_model.bin")
    assert_same(io.load_dir(str(tmp_path)), ts)
    assert io.load_dir(str(tmp_path / "nothing")) is None


def test_rope_freqs_key_is_checked_and_dropped(tmp_path):
    sd = {"x.weight": torch.ones(2),
          "rope.freqs": torch.from_numpy(rope_freqs(72))}
    st_save(sd, str(tmp_path / "model.safetensors"))
    assert set(load_torch_checkpoint(str(tmp_path))) == {"x.weight"}
    sd["rope.freqs"] = sd["rope.freqs"] * 2
    st_save(sd, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="rope.freqs"):
        load_torch_checkpoint(str(tmp_path))
    # every family the JAX package loads is ported: a Vchitect snapshot
    # reads transformer/ only, which this directory lacks; a family the
    # JAX package has not raises
    assert load_torch_checkpoint(str(tmp_path), family="vchitect") is None
    with pytest.raises(NotImplementedError, match="wan"):
        load_torch_checkpoint(str(tmp_path), family="wan")


def reference_snapshot(path, seed: int = 0) -> dict:
    """A tiny STDiT3 in the reference layout: an fp32 state_dict with the
    reference's names (and its stored `rope.freqs`) in model.safetensors."""
    torch.manual_seed(seed)
    sd = STDiT3(PCfg(**SIZES)).state_dict()
    head_dim = SIZES["hidden_size"] // SIZES["num_heads"]
    sd["rope.freqs"] = torch.from_numpy(rope_freqs(head_dim))
    os.makedirs(path, exist_ok=True)
    st_save(sd, os.path.join(path, "model.safetensors"))
    return sd


def jax_draw(seed, shape):
    _, zk = jax.random.split(jax.random.key(seed))
    return np.array(jax.random.normal(zk, shape, jnp.float32))


def test_checkpoint_served_like_jax(tmp_path):
    ckpt = str(tmp_path / "stdit3")
    reference_snapshot(ckpt)
    jcfg = videosys_tpu.OpenSoraConfig(
        transformer=ckpt, vae=None, text_encoder=None, num_sampling_steps=4,
        dtype="fp32", transformer_config=JCfg(**SIZES))
    jvae = JA.OpenSoraVAE(JA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=4),
                          spatial=JKL(**SPATIAL), temporal=JT(**TEMPORAL))
    jpipe = videosys_tpu.OpenSoraPipeline(jcfg, vae=jvae)
    jpipe.keep_latents = True
    pcfg = videosys_tpu_torch.OpenSoraConfig(
        transformer=ckpt, vae=None, text_encoder=None, num_sampling_steps=4,
        dtype="fp32", transformer_config=PCfg(**SIZES))
    pvae = PA.OpenSoraVAE(PA.OpenSoraVAEConfig(micro_frame_size=17,
                                               micro_batch_size=4),
                          spatial=PKL(**SPATIAL), temporal=PT(**TEMPORAL))
    peng = videosys_tpu_torch.VideoSysEngine(
        pcfg, vae=pvae, device="cpu",
        params={"vae": open_sora_vae_from_jax(jpipe.params["vae"])})
    peng.pipeline.keep_latents = True
    kw = dict(resolution="144p", aspect_ratio="1:1", num_frames=18, seed=3)
    want = jpipe.generate("waves at dusk", **kw).video
    t_lat, h, w = peng.pipeline.vae.get_latent_size((18, 192, 192))
    z = jax_draw(3, (1, 4, t_lat, h, w))
    got = peng.generate("waves at dusk", latents=torch.from_numpy(z),
                        **kw).video
    np.testing.assert_allclose(peng.pipeline.last_latents, jpipe.last_latents,
                               atol=TOL, rtol=TOL)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_checkpoint_cast_to_pipeline_dtype_and_strict(tmp_path):
    ckpt = str(tmp_path / "stdit3")
    sd = reference_snapshot(ckpt)
    cfg = videosys_tpu_torch.OpenSoraConfig(
        transformer=ckpt, vae=None, text_encoder=None, dtype="bf16",
        transformer_config=PCfg(**SIZES, dtype=torch.bfloat16))
    vae = PA.OpenSoraVAE(spatial=PKL(**SPATIAL), temporal=PT(**TEMPORAL))
    pipe = videosys_tpu_torch.OpenSoraPipeline(cfg, vae=vae, device="cpu")
    for k, v in pipe.transformer.state_dict().items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, sd[k].bfloat16()), k
    # a missing and an unexpected key raise and are named
    sd["extra.weight"] = torch.ones(1)
    del sd["final_layer.linear.bias"]
    st_save(sd, os.path.join(ckpt, "model.safetensors"))
    with pytest.raises(RuntimeError, match="final_layer.linear.bias") as err:
        videosys_tpu_torch.OpenSoraPipeline(cfg, vae=vae, device="cpu")
    assert "extra.weight" in str(err.value)


def test_save_params_round_trip(tmp_path):
    cfg = videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None, dtype="fp32",
        transformer_config=PCfg(**SIZES))
    vae = PA.OpenSoraVAE(PA.OpenSoraVAEConfig(micro_batch_size=4),
                         spatial=PKL(**SPATIAL), temporal=PT(**TEMPORAL))
    pipe = videosys_tpu_torch.OpenSoraPipeline(cfg, vae=vae, device="cpu")
    params = {"transformer": pipe.transformer.state_dict(),
              "vae": pipe.vae.state_dict()}
    save_params(params, str(tmp_path))
    cfg2 = videosys_tpu_torch.OpenSoraConfig(
        transformer=str(tmp_path), vae="unused/when/saved", text_encoder=None,
        dtype="fp32", transformer_config=PCfg(**SIZES))
    loaded = try_load_params(cfg2)
    assert set(loaded) == {"transformer", "vae"}
    for name in params:
        assert_same(loaded[name], params[name])
    vae2 = PA.OpenSoraVAE(PA.OpenSoraVAEConfig(micro_batch_size=4),
                          spatial=PKL(**SPATIAL), temporal=PT(**TEMPORAL))
    pipe2 = videosys_tpu_torch.OpenSoraPipeline(cfg2, vae=vae2, device="cpu",
                                                seed=7)
    kw = dict(resolution="144p", aspect_ratio="1:1", num_frames=1, seed=2)
    np.testing.assert_array_equal(pipe.generate("fox", **kw).video,
                                  pipe2.generate("fox", **kw).video)
    # an orbax directory is the JAX package's format
    os.makedirs(tmp_path / "jax" / "orbax")
    cfg2.transformer = str(tmp_path / "jax")
    with pytest.raises(ValueError, match="JAX package"):
        try_load_params(cfg2)


def test_unresolvable_weights_raise():
    """The analog of the JAX package's test: a configured path that does not
    resolve raises with its messages."""
    cfg = videosys_tpu_torch.OpenSoraConfig(
        transformer="/nonexistent/OpenSora-STDiT-v3", vae=None,
        text_encoder=None, dtype="fp32")
    with pytest.raises(FileNotFoundError, match="transformer weights"):
        videosys_tpu_torch.VideoSysEngine(cfg, device="cpu")
    cfg2 = videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae="/nonexistent/OpenSora-VAE-v1.2",
        text_encoder=None, dtype="fp32", transformer_config=PCfg(**SIZES))
    with pytest.raises(FileNotFoundError, match="VAE weights"):
        videosys_tpu_torch.VideoSysEngine(cfg2, device="cpu")


COG_SIZES = dict(num_layers=2, num_heads=2, head_dim=16, in_channels=4,
                 out_channels=4, time_embed_dim=16, text_embed_dim=16,
                 max_text_seq_length=8)
COG_VAE = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
               layers_per_block=1, norm_num_groups=4)


def cogvideox_config(model_path, **kw):
    kw = {"transformer_config": CogModelConfig(**COG_SIZES),
          "vae_config": CogVideoXVAEConfig(**COG_VAE), **kw}
    return videosys_tpu_torch.CogVideoXConfig(
        model_path=model_path, dtype="fp32", vae_tiling=False, **kw)


def cogvideox_snapshot(path, seed: int = 0):
    """A tiny CogVideoX in the diffusers layout, written by the
    `safetensors` package: `transformer/` in two shards with an index,
    `vae/` in one file. Returns the pipeline the weights came from."""
    pipe = videosys_tpu_torch.CogVideoXPipeline(cogvideox_config(""),
                                                device="cpu", seed=seed)
    sd = pipe.transformer.state_dict()
    names = sorted(sd)
    shards = {f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors":
              names[i::2] for i in range(2)}
    os.makedirs(path / "transformer")
    for fname, keys in shards.items():
        st_save({k: sd[k] for k in keys}, str(path / "transformer" / fname))
    with open(path / "transformer" /
              "diffusion_pytorch_model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": {
            k: fname for fname, keys in shards.items() for k in keys}}, f)
    os.makedirs(path / "vae")
    st_save(dict(pipe.vae.state_dict()),
            str(path / "vae" / "diffusion_pytorch_model.safetensors"))
    return pipe


def test_cogvideox_snapshot_loaded_and_served(tmp_path):
    snap = tmp_path / "CogVideoX-tiny"
    pipe = cogvideox_snapshot(snap)
    loaded = load_torch_checkpoint(str(snap), family="cogvideox")
    assert set(loaded) == {"transformer", "vae"}
    assert_same(loaded["transformer"], pipe.transformer.state_dict())
    assert_same(loaded["vae"], pipe.vae.state_dict())
    # served from the snapshot (another init seed, so every weight must
    # come from the files) the video equals the original pipeline's
    stub = StubTextEncoder(16, 8, device="cpu")
    served = videosys_tpu_torch.VideoSysEngine(
        cogvideox_config(str(snap)), text_encoder=stub, device="cpu", seed=9)
    kw = dict(num_inference_steps=2, num_frames=9, height=32, width=32,
              seed=4)
    np.testing.assert_array_equal(served.generate("a cat", **kw).video,
                                  pipe.generate("a cat", **kw).video)
    # a snapshot without vae/ and no random-init hook for it raises
    os.rename(snap / "vae", tmp_path / "vae_elsewhere")
    assert set(load_torch_checkpoint(str(snap), family="cogvideox")) == {
        "transformer"}
    with pytest.raises(FileNotFoundError, match="VAE weights"):
        videosys_tpu_torch.CogVideoXPipeline(
            cogvideox_config(str(snap), vae_config=None), text_encoder=stub,
            device="cpu")
    assert load_torch_checkpoint(str(tmp_path / "none"), "cogvideox") is None

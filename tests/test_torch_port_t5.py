"""The port's T5 encoder against the JAX package's (HF Flax T5): the
relative-position buckets, the encoder on the same weights (t5_from_jax),
the whole `T5TextEncoder` (tokenizer included) on a snapshot directory the
test writes, and the key names against transformers' torch T5. fp32,
2e-4; the bucket table exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tokenizers import Tokenizer, models, pre_tokenizers, processors
from transformers import FlaxT5EncoderModel, PreTrainedTokenizerFast
from transformers import T5Config as HFConfig
from transformers import T5EncoderModel as HFEncoder
from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

import videosys_tpu_torch
from videosys_tpu.models.text_encoders.t5 import T5TextEncoder as JT5TextEncoder
from videosys_tpu_torch.models.text_encoders.t5 import (
    T5Config,
    T5EncoderModel,
    T5TextEncoder,
    relative_position_bucket,
)
from videosys_tpu_torch.utils.from_jax import t5_from_jax
from videosys_tpu_torch.utils.safetensors_io import save_file

TOL = 2e-4
TINY = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_heads=4)
WORDS = ("a red fox sitting in fresh snow waves breaking at dusk on rocky "
         "coast aesthetic score : 6.5 .").split()
TEXTS = ["a red fox sitting in fresh snow", "", "waves " * 30,
         "unknown words on a rocky coast aesthetic score: 6.5."]


def flax_model(ff: str, seed: int = 0) -> FlaxT5EncoderModel:
    return FlaxT5EncoderModel(HFConfig(**TINY, feed_forward_proj=ff,
                                       dropout_rate=0.0), seed=seed)


def port_model(params) -> T5EncoderModel:
    model = T5EncoderModel(T5Config(**TINY, feed_forward_proj=(
        "relu" if "wi" in params["encoder"]["block"]["0"]["layer"]["1"][
            "DenseReluDense"] else "gated-gelu")))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in t5_from_jax(params).items()})
    return model.eval()


def ragged_mask(rng, B: int, L: int) -> np.ndarray:
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    return (np.arange(L)[None] < lens[:, None]).astype(np.int32)


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64)])
def test_bucket_table_equals_flax(num_buckets, max_distance):
    rel = np.arange(-600, 601, dtype=np.int32)
    want = np.asarray(FlaxT5Attention._relative_position_bucket(
        jnp.asarray(rel), True, num_buckets, max_distance))
    got = relative_position_bucket(torch.from_numpy(rel), num_buckets,
                                   max_distance).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
def test_encoder_matches_flax(ff):
    fm = flax_model(ff)
    pm = port_model(fm.params)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY["vocab_size"], (3, 24)).astype(np.int32)
    mask = ragged_mask(rng, 3, 24)
    want = np.asarray(fm(input_ids=ids, attention_mask=mask).last_hidden_state)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A local T5 snapshot: WordLevel tokenizer (eos appended), config.json,
    flax_model.msgpack for JAX and model.safetensors (this package's
    writer) for the port, the same weights."""
    d = str(tmp_path_factory.mktemp("t5"))
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(dict.fromkeys(WORDS))})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>",
                            eos_token="</s>", unk_token="<unk>"
                            ).save_pretrained(d)
    fm = flax_model("gated-gelu", seed=1)
    fm.save_pretrained(d)
    save_file({k: torch.from_numpy(np.array(v))
               for k, v in t5_from_jax(fm.params).items()},
              os.path.join(d, "model.safetensors"), {"format": "pt"})
    return d


@pytest.mark.parametrize("max_length", [20, 300])
def test_text_encoder_matches_jax(snapshot, max_length):
    jenc = JT5TextEncoder(snapshot, max_length=max_length)
    penc = T5TextEncoder(snapshot, max_length=max_length, device="cpu")
    jh, jm = jenc.encode(TEXTS)
    ph, pm = penc.encode(TEXTS)
    assert ph.shape == (len(TEXTS), max_length, TINY["d_model"])
    assert pm.dtype == torch.bool
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    # eos appended, truncation keeps it
    assert pm.sum(1).tolist()[:3] == [8, 1, min(31, max_length)]


def test_offloaded_encoder_equals_resident(snapshot):
    resident = T5TextEncoder(snapshot, max_length=20, device="cpu")
    off = T5TextEncoder(snapshot, max_length=20, device="cpu", offload=True)
    host = [p.data_ptr() for p in off.model.parameters()]
    a, b = resident.encode(TEXTS), off.encode(TEXTS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the weights are back on their host tensors
    assert [p.data_ptr() for p in off.model.parameters()] == host


@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
def test_state_dict_loads_into_transformers(ff):
    torch.manual_seed(0)
    pm = T5EncoderModel(T5Config(**TINY, feed_forward_proj=ff)).eval()
    hf = HFEncoder(HFConfig(**TINY, feed_forward_proj=ff,
                            dropout_rate=0.0)).eval()
    hf.load_state_dict(pm.state_dict(), strict=True)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 64, (2, 20)))
    mask = torch.from_numpy(ragged_mask(rng, 2, 20))
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = pm(ids, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_configured_encoder_that_does_not_load_raises(tmp_path):
    cfg = videosys_tpu_torch.OpenSoraConfig(
        transformer=None, vae=None, text_encoder=str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="could not be loaded"):
        videosys_tpu_torch.OpenSoraPipeline(cfg, device="cpu")


def test_mt5_snapshot_loads(tmp_path):
    """An mT5 snapshot (Open-Sora-Plan v1.2's captions): its config.json
    (model_type "mt5", untied embeddings, gated-gelu) and weights written
    here from transformers' torch MT5EncoderModel load into the port's
    encoder, which gives the same hidden states; another model type
    raises."""
    from transformers import MT5Config, MT5EncoderModel

    torch.manual_seed(0)
    hf_cfg = MT5Config(**TINY, feed_forward_proj="gated-gelu",
                       tie_word_embeddings=False, dropout_rate=0.0)
    hf = MT5EncoderModel(hf_cfg).eval()
    hf_cfg.save_pretrained(str(tmp_path))
    save_file({k: v.clone() for k, v in hf.state_dict().items()},
              str(tmp_path / "model.safetensors"), {"format": "pt"})
    cfg = T5Config.from_json(str(tmp_path / "config.json"))
    assert (cfg.model_type, cfg.vocab_size, cfg.feed_forward_proj) == (
        "mt5", TINY["vocab_size"], "gated-gelu")
    assert T5Config(vocab_size=250112, model_type="mt5").vocab_size == 250112
    pm = T5EncoderModel.from_pretrained(str(tmp_path)).eval()
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, TINY["vocab_size"], (2, 12)))
    mask = torch.from_numpy(ragged_mask(rng, 2, 12))
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = pm(ids, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="model_type 'umt5'"):
        T5Config(model_type="umt5")

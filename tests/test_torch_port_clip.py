"""The port's CLIP text encoder and Vchitect's CLIP-L + CLIP-G + T5 trio
against the JAX package (HF's Flax CLIP) on the CPU, fp32, 2e-4: the model
on the same weights (`clip_from_jax`) with both activations, its
state_dict loaded into transformers' torch CLIP, the SD3 packing, and the
whole triple encoder (tokenizers included) on a snapshot directory the test
writes."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tokenizers import Tokenizer, models, pre_tokenizers, processors
from transformers import CLIPTextConfig as HFCLIPConfig
from transformers import CLIPTextModelWithProjection as HFCLIP
from transformers import FlaxCLIPTextModelWithProjection, FlaxT5EncoderModel
from transformers import PreTrainedTokenizerFast
from transformers import T5Config as HFT5Config

from videosys_tpu.models.text_encoders import clip as JC
from videosys_tpu_torch.models.text_encoders.clip import (
    CLIPTextConfig,
    CLIPTextModelWithProjection,
    ClipTextEncoder,
    VchitectTripleTextEncoder,
    pack_sd3_embeds,
)
from videosys_tpu_torch.utils.from_jax import clip_from_jax, t5_from_jax
from videosys_tpu_torch.utils.safetensors_io import save_file

TOL = 2e-4
WORDS = "a ship sailing at dawn waves on rocky coast , .".split()
VOCAB = 3 + len(WORDS)  # pad / unk / bos, the words, then eos (the largest)
TINY = dict(vocab_size=VOCAB + 1, hidden_size=16, intermediate_size=32,
            projection_dim=12, num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=77)
TEXTS = ["a ship sailing at dawn", "", "waves " * 90,
         "unknown words on a rocky coast ."]


def hf_config(act: str, **kw) -> HFCLIPConfig:
    return HFCLIPConfig(**{**TINY, **kw}, hidden_act=act, eos_token_id=VOCAB,
                        bos_token_id=2, pad_token_id=VOCAB)


def port_model(params, act: str) -> CLIPTextModelWithProjection:
    model = CLIPTextModelWithProjection(CLIPTextConfig(**TINY, hidden_act=act))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in clip_from_jax(params).items()})
    return model.eval()


def token_ids(rng, B: int = 3, L: int = 77) -> np.ndarray:
    """bos, words, eos, then eos padding (CLIP-L's tokenizer pads with its
    eos), each row its own length."""
    ids = np.full((B, L), VOCAB, np.int32)
    for b, n in enumerate(rng.integers(0, L - 1, B)):
        ids[b, 0] = 2
        ids[b, 1:n + 1] = rng.integers(3, VOCAB, n)
    return ids


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_model_matches_flax(act):
    fm = FlaxCLIPTextModelWithProjection(hf_config(act), seed=0)
    pm = port_model(fm.params, act)
    ids = token_ids(np.random.default_rng(0))
    out = fm(input_ids=ids, output_hidden_states=True)
    with torch.no_grad():
        hidden, pooled = pm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(hidden.numpy(), np.asarray(out.hidden_states[-2]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(out.text_embeds),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_state_dict_loads_into_transformers(act):
    torch.manual_seed(0)
    pm = CLIPTextModelWithProjection(CLIPTextConfig(**TINY, hidden_act=act)).eval()
    hf = HFCLIP(hf_config(act)).eval()
    hf.load_state_dict(pm.state_dict(), strict=True)
    ids = torch.from_numpy(token_ids(np.random.default_rng(1))).long()
    with torch.no_grad():
        want = hf(input_ids=ids, output_hidden_states=True)
        hidden, pooled = pm(ids)
    np.testing.assert_allclose(hidden.numpy(), want.hidden_states[-2].numpy(),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), want.text_embeds.numpy(),
                               atol=TOL, rtol=TOL)


def test_pack_sd3_embeds_like_jax():
    rng = np.random.default_rng(2)
    parts = [rng.standard_normal(s).astype(np.float32) for s in
             ((2, 77, 8), (2, 8), (2, 77, 12), (2, 12), (2, 30, 48))]
    want = JC.pack_sd3_embeds(*(jnp.asarray(p) for p in parts))
    got = pack_sd3_embeds(*(torch.from_numpy(p) for p in parts))
    assert got[0].shape == (2, 77 + 30, 48) and got[1].shape == (2, 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def save_tokenizer(path: str, pad: str, template: str) -> None:
    """A WordLevel tokenizer over WORDS: ids pad 0, unk 1, bos 2, the
    words, eos last; `template` adds the special tokens."""
    vocab = {"<pad>": 0, "<unk>": 1, "<bos>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(WORDS)})
    vocab["<eos>"] = VOCAB
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single=template, special_tokens=[("<bos>", 2), ("<eos>", VOCAB)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token=pad,
                            bos_token="<bos>", eos_token="<eos>",
                            unk_token="<unk>").save_pretrained(path)


def save_model(fm, path: str, sd) -> None:
    """Flax weights for JAX and model.safetensors for the port, the same
    weights."""
    fm.save_pretrained(path)
    save_file({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
              os.path.join(path, "model.safetensors"), {"format": "pt"})


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny Vchitect snapshot's text side: CLIP-L (quick_gelu, padded
    with eos), CLIP-G (gelu, padded with id 0; wider), and a T5 whose width
    holds both CLIPs, its tokenizer in `text_encoder_3/` (where the JAX
    package reads it) and `tokenizer_3/`."""
    d = str(tmp_path_factory.mktemp("vchitect"))
    for i, (sub, act, pad, kw) in enumerate((
            ("", "quick_gelu", "<eos>", {}),
            ("_2", "gelu", "<pad>", dict(hidden_size=24, projection_dim=20)))):
        save_tokenizer(os.path.join(d, f"tokenizer{sub}"), pad,
                       "<bos> $A <eos>")
        fm = FlaxCLIPTextModelWithProjection(hf_config(act, **kw), seed=i)
        save_model(fm, os.path.join(d, f"text_encoder{sub}"),
                   clip_from_jax(fm.params))
    t5 = FlaxT5EncoderModel(HFT5Config(vocab_size=VOCAB + 1, d_model=48,
                                       d_kv=8, d_ff=64, num_layers=2,
                                       num_heads=4, dropout_rate=0.0,
                                       feed_forward_proj="gated-gelu"), seed=3)
    for sub in ("text_encoder_3", "tokenizer_3"):
        save_tokenizer(os.path.join(d, sub), "<pad>", "$A <eos>")
    save_model(t5, os.path.join(d, "text_encoder_3"), t5_from_jax(t5.params))
    with open(os.path.join(d, "text_encoder", "config.json")) as f:
        assert json.load(f)["hidden_act"] == "quick_gelu"
    return d


def test_clip_encoder_matches_jax(snapshot):
    jenc = JC.ClipTextEncoder(snapshot, "tokenizer_2", "text_encoder_2")
    penc = ClipTextEncoder(snapshot, "tokenizer_2", "text_encoder_2",
                           device="cpu")
    assert (penc.hidden_dim, penc.pooled_dim) == (24, 20)
    for got, want in zip(penc.encode(TEXTS), jenc.encode(TEXTS)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_triple_encoder_matches_jax(snapshot):
    jenc = JC.VchitectTripleTextEncoder(snapshot, t5_max_length=40)
    penc = VchitectTripleTextEncoder(snapshot, t5_max_length=40, device="cpu")
    want = jenc.encode_dual(TEXTS)
    got = penc.encode_dual(TEXTS)
    assert got[0].shape == (len(TEXTS), 77 + 40, 48)
    assert got[1].shape == (len(TEXTS), 12 + 20)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    # the CLIP rows are [L | G | zeros to the T5 width]
    assert not got[0][:, :77, 40:].any()
    # under cpu_offload each encoder is fetched for its encode only
    off = VchitectTripleTextEncoder(snapshot, t5_max_length=40, device="cpu",
                                    offload=True)
    for g, o in zip(got, off.encode_dual(TEXTS)):
        assert torch.equal(g, o)


def test_missing_snapshot_raises(tmp_path):
    with pytest.raises(Exception):
        ClipTextEncoder(str(tmp_path / "Vchitect-2.0-2B"), device="cpu")


def test_pipeline_with_triple_encoder_like_jax(snapshot, monkeypatch):
    """A snapshot with `text_encoder/` makes both pipelines build the trio:
    a tiny generate on the same transformer and VAE weights and latents
    gives the same video (within one level)."""
    import jax

    import videosys_tpu.pipelines.vchitect.pipeline_vchitect as JP
    import videosys_tpu_torch
    from videosys_tpu.models.autoencoders.vae2d import AutoencoderKL2D as JVAE
    from videosys_tpu.models.transformers import vchitect as J
    from videosys_tpu.utils.convert import convert_vae2d, convert_vchitect
    from videosys_tpu_torch.models.transformers import vchitect as P
    from videosys_tpu_torch.utils.from_jax import vae2d_from_jax, vchitect_from_jax

    sizes = dict(num_layers=2, num_heads=2, head_dim=16, joint_attention_dim=48,
                 pooled_projection_dim=32, sample_size=8, pos_embed_max_size=12)
    vae = dict(mid_block_add_attention=False, latent_channels=16,
               block_out_channels=(8, 16), layers_per_block=1, num_groups=4)
    req = dict(num_inference_steps=3, width=32, height=32, frames=2, seed=4)
    pipe = videosys_tpu_torch.VchitectXLPipeline(
        videosys_tpu_torch.VchitectConfig(
            model_path=snapshot, dtype="fp32",
            transformer_config=P.VchitectModelConfig(**sizes), vae_config=vae),
        device="cpu")
    assert isinstance(pipe.text_encoder, VchitectTripleTextEncoder)
    # the port's seeded weights, given to JAX by the JAX package's
    # converters and carried back unchanged by from_jax (no init program)
    sd = {name: {k: v.numpy() for k, v in m.state_dict().items()}
          for name, m in (("transformer", pipe.transformer), ("vae", pipe.vae))}
    params = {"transformer": convert_vchitect(sd["transformer"],
                                              depth=sizes["num_layers"]),
              "vae": convert_vae2d(sd["vae"], len(vae["block_out_channels"]))}
    for name, back in (("transformer", vchitect_from_jax(params["transformer"])),
                       ("vae", vae2d_from_jax(params["vae"]))):
        assert back.keys() == sd[name].keys()
        for k, v in back.items():
            np.testing.assert_array_equal(v, sd[name][k])
    jpipe = JP.VchitectXLPipeline(JP.VchitectConfig(
        model_path=snapshot, dtype="fp32",
        transformer_config=J.VchitectModelConfig(**sizes), vae=JVAE(**vae)),
        params=params)
    assert isinstance(jpipe.text_encoder, JC.VchitectTripleTextEncoder)
    want = jpipe.generate("a ship sailing at dawn", **req).video
    _, zkey = jax.random.split(jax.random.key(4))
    z = np.array(jax.random.normal(zkey, pipe.latent_shape(2, 32, 32)))
    got = pipe.generate("a ship sailing at dawn", latents=torch.from_numpy(z),
                        **req).video
    assert got.shape == want.shape == (1, 2, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

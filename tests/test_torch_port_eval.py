"""The port's eval helpers (`videosys_tpu_torch/eval`) against the JAX
package's on the CPU: PSNR, SSIM and `evaluate_pair` equal on seeded
videos (the metrics module is a byte copy); `eval_pab`, `summarize`,
`attention_ablation`, `components_ablation` and `generate_batch` on tiny
port engines (Vchitect, shared weights); `eval_dirs` equal to JAX's on two
directories of clips written here; the prompt loaders."""

import csv
import json
from pathlib import Path

import imageio
import numpy as np
import pytest

import videosys_tpu.eval.batch_eval as JB
import videosys_tpu.eval.metrics as JM
import videosys_tpu_torch
import videosys_tpu_torch.eval.batch_eval as PB
import videosys_tpu_torch.eval.metrics as PM
import videosys_tpu_torch.eval.pab_eval as PE
from videosys_tpu_torch.models.transformers.vchitect import VchitectModelConfig

SIZES = dict(num_layers=2, num_heads=2, head_dim=16, joint_attention_dim=32,
             pooled_projection_dim=24, sample_size=8, pos_embed_max_size=12)
VAE = dict(mid_block_add_attention=False, block_out_channels=(8, 16),
           layers_per_block=1, num_groups=4)
REQ = dict(num_inference_steps=6, width=32, height=32, frames=4)


def test_metrics_copy_equals_original():
    assert Path(PM.__file__).read_bytes() == Path(JM.__file__).read_bytes()


def seeded_videos(seed: int, shape=(2, 3, 24, 20, 3)):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 21, shape), 0, 255)
    return a, b.astype(np.uint8)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_metrics_equal_jax(kind):
    a, b = seeded_videos(0)
    if kind == "float":
        a, b = a / 255.0, b / 255.0
    for name in ("calculate_psnr", "calculate_ssim", "evaluate_pair"):
        assert getattr(PM, name)(a, b) == getattr(JM, name)(a, b), name
    assert PM.img_psnr(a[0, 0], a[0, 0]) == 100.0
    assert PM.frame_ssim(a[0, 0], a[0, 0]) == pytest.approx(1.0)


@pytest.fixture(scope="module")
def params():
    """One tiny Vchitect's weights, shared by every engine of a test."""
    pipe = videosys_tpu_torch.VchitectXLPipeline(config(), device="cpu",
                                                 seed=5)
    return {name: getattr(pipe, name).state_dict()
            for name in ("transformer", "vae")}


def config(**pab):
    return videosys_tpu_torch.VchitectConfig(
        model_path=None, dtype="fp32", enable_pab=bool(pab),
        pab_config=videosys_tpu_torch.VchitectPABConfig(**pab),
        transformer_config=VchitectModelConfig(**SIZES), vae_config=VAE)


def engine(params, **pab):
    return videosys_tpu_torch.VideoSysEngine(config(**pab), device="cpu",
                                             params=params)


def test_eval_pab_and_summarize(params):
    """Thresholds that never fire leave the PAB video bit-equal (PSNR 100,
    SSIM 1); Vchitect's ladder reads on 6 steps and moves it."""
    never = dict(spatial_threshold=(0, 1), temporal_threshold=(0, 1),
                 cross_threshold=(0, 1))
    res = PE.eval_pab(lambda pab: engine(params, **(never if pab else {})),
                      ["a ship sailing at dawn"], REQ, seed=1)
    assert res[0].psnr == 100.0 and res[0].ssim == pytest.approx(1.0)
    res = PE.eval_pab(lambda pab: engine(params, **({"spatial_range": 2}
                                                    if pab else {})),
                      ["a ship sailing at dawn", "waves"], REQ, seed=1)
    s = PE.summarize(res)
    assert s["n"] == 2 and s["psnr"] < 100.0 and 0 < s["ssim"] < 1.0
    assert s["psnr"] == pytest.approx(np.mean([r.psnr for r in res]))


def test_ablations(params):
    dense = engine(params)
    prompts = ["a ship sailing at dawn"]
    ref = dense.generate(prompts[0], seed=0, **REQ).video
    out = PE.attention_ablation(
        lambda over: engine(params, **over), dense, prompts, REQ,
        ranges={"spatial": (2,), "temporal": (3,), "cross": (2,)})
    assert set(out) == {"spatial", "temporal", "cross"}
    # each entry is the pair metric of that engine's video
    video = engine(params, spatial_broadcast=False, temporal_broadcast=False,
                   cross_broadcast=True, cross_range=2).generate(
        prompts[0], seed=0, **REQ).video
    m = PM.evaluate_pair(video, ref)
    assert out["cross"][2] == {"psnr": m["psnr"]["value"],
                               "ssim": m["ssim"]["value"]}
    comp = PE.components_ablation(lambda over: engine(params, **over), dense,
                                  prompts, REQ)
    assert set(comp) == {"wo_spatial", "wo_temporal", "wo_cross", "wo_mlp"}
    assert all(0 < v["ssim"] <= 1 for v in comp.values())


def test_generate_batch_and_prompt_loaders(params, tmp_path):
    rows = [{"id": "clip0", "text": "a ship"}, {"id": "clip1", "text": "waves"}]
    with open(tmp_path / "eval.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["id", "text"])
        w.writeheader()
        w.writerows(rows)
    prompts = PE.load_eval_prompts(str(tmp_path / "eval.csv"))
    assert prompts == {"clip0": "a ship", "clip1": "waves"}
    (tmp_path / "vbench.json").write_text(json.dumps(
        [{"prompt_en": "a ship"}, {"prompt_en": "waves"}]))
    assert PE.read_vbench_prompts(str(tmp_path / "vbench.json")) == [
        "a ship", "waves"]
    eng = engine(params)
    out = tmp_path / "videos"
    written = PE.generate_batch(eng, prompts, str(out), generate_kwargs=REQ)
    assert len(written) == 2 and all(Path(p).exists() for p in written)
    # existing clips are skipped
    assert PE.generate_batch(eng, prompts, str(out), generate_kwargs=REQ) == []
    listed = PE.generate_batch(eng, ["waves"], str(out), loop=2,
                               generate_kwargs=REQ)
    assert [Path(p).stem for p in listed] == ["waves-0", "waves-1"]


def test_run_vbench_needs_the_package():
    try:
        import vbench  # noqa: F401
        pytest.skip("vbench is installed")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="vbench"):
        PE.run_vbench("videos")


def write_clip(path: Path, video: np.ndarray) -> None:
    imageio.mimwrite(str(path), list(video), duration=100)


def test_eval_dirs_equal_jax(tmp_path):
    """Generated clips against ground truth that is longer (trimmed),
    larger (centre-cropped) and smaller (resized up), paired by name."""
    rng = np.random.default_rng(3)
    gen, gt = tmp_path / "gen", tmp_path / "gt"
    gen.mkdir()
    gt.mkdir()
    for i, gt_shape in enumerate(((6, 40, 48, 3), (5, 24, 32, 3),
                                  (4, 20, 24, 3))):
        video = rng.integers(0, 256, (4, 24, 32, 3)).astype(np.uint8)
        write_clip(gen / f"c{i}.gif", video)
        write_clip(gt / f"c{i}.gif",
                   rng.integers(0, 256, gt_shape).astype(np.uint8))
    assert PB.list_video_ids(str(gen), "gif") == ["c0", "c1", "c2"]
    loaded = PB.load_video(str(gen / "c0.gif"))
    assert loaded.shape[:3] == (4, 24, 32)
    got = PB.eval_dirs(str(gen), str(gt), "gif", batch_size=2)
    want = JB.eval_dirs(str(gen), str(gt), "gif", batch_size=2)
    assert got == want and got["n"] == 3
    with pytest.raises(ValueError, match="less than"):
        PB.preprocess_gt_video(loaded[:2], loaded.shape)
    with pytest.raises(ValueError, match="No videos"):
        PB.eval_dirs(str(tmp_path / "gt"), str(gen), "mp4")
    small = PB.resize_video(loaded, 12, 16)
    assert small.shape == (4, 12, 16, loaded.shape[-1])
    np.testing.assert_array_equal(small, JB.resize_video(loaded, 12, 16))

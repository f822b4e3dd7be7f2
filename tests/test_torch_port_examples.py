"""The port's entry points at tiny size on the CPU: the counterpart of
`tests/test_examples.py`. Every sample function of
`videosys_tpu_torch/examples/inference/*/sample.py` (one `run_multi_device`
on 2 gloo ranks), the PAB experiments' components ablation and quality
pair, and the CogVideoX demo's engines (the PAB engine on the dense
engine's modules) and its `launch`, which raises without `gradio`. Each
is asked for the CPU (`device="cpu"`); without it an entry point goes to
the card, and raises here."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

SAMPLES = "videosys_tpu_torch.examples.inference.{}.sample"


def sample(family):
    return importlib.import_module(SAMPLES.format(family))


@pytest.mark.parametrize("family,funcs", [
    ("open_sora", ["run_base", "run_pab"]),
    ("latte", ["run_base", "run_pab"]),
    ("cogvideox", ["run_base", "run_pab"]),
    ("open_sora_plan", ["run_base", "run_v110", "run_pab"]),
    ("vchitect", ["run_base", "run_pab"]),
])
def test_inference_examples(family, funcs, tmp_path):
    mod = sample(family)
    for name in funcs:
        out = getattr(mod, name)(tiny=True, outdir=str(tmp_path), device="cpu")
        assert out and os.path.exists(out), name


def test_open_sora_multi_device_spawns_ranks(tmp_path):
    """`run_multi_device` on 2 CPU ranks (sp=2) writes the video rank 0
    gathers, and stops its worker."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # read by the spawned worker
    try:
        out = sample("open_sora").run_multi_device(
            tiny=True, outdir=str(tmp_path), num_devices=2, device="cpu")
    finally:
        torch.set_num_threads(threads)
        if env is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = env
    assert out.endswith("-sp.png") and os.path.exists(out)
    assert not torch.distributed.is_initialized()


def test_entry_points_go_to_the_card_unless_asked(tmp_path):
    """Without `device` an entry point asks for the card (and raises
    here, where there is none)."""
    if torch.cuda.is_available():
        pytest.skip("a card is there: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample("latte").run_base(tiny=True, outdir=str(tmp_path))


def test_pab_experiments(tmp_path):
    """The components ablation (leave-one-out over the PAB scope) and the
    dense-vs-PAB quality pair on a tiny shared-weights engine set."""
    from videosys_tpu_torch.examples.eval import pab_experiments as E

    out = E.run_components_ablation(tiny=True, outdir=str(tmp_path),
                                    device="cpu")
    assert set(out) == {"wo_spatial", "wo_temporal", "wo_cross", "wo_mlp"}
    assert os.path.exists(tmp_path / "components_ablation.json")
    q = E.run_pab_quality(tiny=True, device="cpu")
    assert q["n"] == 1 and np.isfinite(q["psnr"])


def test_gradio_engines_share_modules(tmp_path):
    """`build_engines(tiny=True)`: the PAB engine runs the dense engine's
    modules; `generate_pair` writes both videos with their seconds."""
    from videosys_tpu_torch.examples.gradio import cogvideox as G

    dense, pab = G.build_engines(tiny=True, device="cpu")
    for name in G.SHARED:
        assert getattr(pab.pipeline, name) is getattr(dense.pipeline, name)
    assert pab.pipeline._config.enable_pab
    assert not dense.pipeline._config.enable_pab
    res = G.generate_pair(dense, pab, "Sunset over the sea.", steps=2,
                          outdir=str(tmp_path), num_frames=5, height=32,
                          width=32)
    for name in ("dense", "pab"):
        path, seconds = res[name]
        assert os.path.exists(path) and seconds > 0


def test_gradio_launch_needs_gradio(monkeypatch):
    """`launch` raises a clear error where `gradio` is not installed (an
    `import gradio` that fails, or finds the repo's gradio/ directory)."""
    from videosys_tpu_torch.examples.gradio import cogvideox as G

    with pytest.raises(RuntimeError, match="needs the `gradio` package"):
        G.launch(tiny=True, device="cpu")
    monkeypatch.setitem(sys.modules, "gradio", None)  # import fails
    with pytest.raises(RuntimeError, match="needs the `gradio` package"):
        G.launch(tiny=True, device="cpu")

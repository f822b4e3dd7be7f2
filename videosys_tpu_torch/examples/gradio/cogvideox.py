"""Gradio demo: CogVideoX with and without PAB side by side.

Counterpart of `gradio/cogvideox.py`: two engines on the same weights (the
PAB engine shares the dense engine's modules), a prompt box and each run's
latency. `launch` needs the `gradio` package and raises a clear error
without it; the rest of the module does not, and `build_engines(tiny=True,
device="cpu")` builds a random-init offline pair for tests.

    python -m videosys_tpu_torch.examples.gradio.cogvideox
"""

from __future__ import annotations

import os
import time

from videosys_tpu_torch import VideoSysEngine
from videosys_tpu_torch.examples.inference.cogvideox.sample import (
    _config,
    _kwargs,
)

SHARED = ("transformer", "vae", "text_encoder")


def build_engines(model_path: str = "THUDM/CogVideoX-2b", tiny: bool = False,
                  device=None):
    """(dense, pab) engines; the PAB engine's pipeline runs the dense
    engine's transformer, VAE and text encoder."""
    path = {} if tiny else {"model_path": model_path}
    dense = VideoSysEngine(_config(tiny, **path), device=device)
    params = {name: getattr(dense.pipeline, name).state_dict()
              for name in ("transformer", "vae")}
    pab = VideoSysEngine(_config(tiny, enable_pab=True, **path),
                         device=device, params=params,
                         text_encoder=dense.pipeline.text_encoder)
    for name in SHARED:
        setattr(pab.pipeline, name, getattr(dense.pipeline, name))
    return dense, pab


def generate_pair(dense, pab, prompt: str, steps: int = 50, seed: int = 0,
                  outdir: str = "./outputs", **generate_kwargs):
    """{"dense" | "pab": (saved path, seconds)} for one prompt; the
    remaining keywords go to `generate` (a tiny pair's sizes)."""
    results = {}
    for name, engine in (("dense", dense), ("pab", pab)):
        t0 = time.perf_counter()
        video = engine.generate(prompt, num_inference_steps=steps, seed=seed,
                                **generate_kwargs).video[0]
        dt = time.perf_counter() - t0
        path = engine.save_video(video, os.path.join(outdir, f"{name}-{seed}"))
        results[name] = (path, dt)
    return results


def launch(model_path: str = "THUDM/CogVideoX-2b", tiny: bool = False,
           device=None):
    """Serve the side-by-side demo (needs the `gradio` package)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "the CogVideoX demo needs the `gradio` package, which is not "
            "installed") from e
    if not hasattr(gr, "Blocks"):  # a directory named gradio, not the package
        raise RuntimeError(
            f"the CogVideoX demo needs the `gradio` package; `import gradio` "
            f"found {list(getattr(gr, '__path__', []))} instead")

    dense, pab = build_engines(model_path, tiny, device)
    request = _kwargs(tiny)
    request.pop("num_inference_steps")

    def run(prompt, steps, seed):
        res = generate_pair(dense, pab, prompt, int(steps), int(seed),
                            **request)
        (p_dense, t_dense), (p_pab, t_pab) = res["dense"], res["pab"]
        return (p_dense, f"{t_dense:.1f}s", p_pab,
                f"{t_pab:.1f}s ({t_dense / t_pab:.2f}x)")

    with gr.Blocks(title="VideoSys (PyTorch): CogVideoX +/- PAB") as demo:
        prompt = gr.Textbox(label="Prompt", value="Sunset over the sea.")
        steps = gr.Slider(10, 100, value=50, step=1, label="Steps")
        seed = gr.Number(value=0, label="Seed")
        btn = gr.Button("Generate")
        with gr.Row():
            v1 = gr.Video(label="Dense")
            t1 = gr.Textbox(label="Dense latency")
            v2 = gr.Video(label="PAB")
            t2 = gr.Textbox(label="PAB latency")
        btn.click(run, [prompt, steps, seed], [v1, t1, v2, t2])
    demo.launch()


if __name__ == "__main__":
    launch()

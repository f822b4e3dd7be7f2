"""PAB quality evaluation: accelerated vs dense output of the same model.

Port of `videosys_tpu/eval/pab_eval.py` (numpy and the engines it is
given; no JAX): the same functions on this package's engines.

Behavioral reference: `eval/pab/common_metrics/eval.py` + `batch_eval.py`
(pairwise PSNR/SSIM/LPIPS over generated video dirs), `eval/pab/experiments/
*.py` (ablation sweeps over spatial/temporal/cross ranges), and
`eval/pab/vbench/` (VBench prompt list + runner).

The reference compares videos re-read from disk; here the pair is generated
in-process with SHARED parameters (same seed, same weights), which removes
codec noise from the comparison — strictly tighter than the reference
protocol.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from videosys_tpu_torch.eval.metrics import evaluate_pair


@dataclasses.dataclass
class PABEvalResult:
    prompt: str
    metrics: Dict[str, dict]

    @property
    def psnr(self) -> float:
        return self.metrics["psnr"]["value"]

    @property
    def ssim(self) -> float:
        return self.metrics["ssim"]["value"]


def eval_pab(
    make_engine: Callable[[bool], Any],
    prompts: Sequence[str],
    generate_kwargs: Optional[dict] = None,
    seed: int = 0,
) -> List[PABEvalResult]:
    """`make_engine(enable_pab) -> engine`; both engines must share weights
    (pass the same `params=` to the pipeline). Runs every prompt through the
    dense and PAB engines with the same seed and scores the pair."""
    generate_kwargs = generate_kwargs or {}
    dense = make_engine(False)
    accel = make_engine(True)
    results = []
    for prompt in prompts:
        v_ref = dense.generate(prompt, seed=seed, **generate_kwargs).video
        v_pab = accel.generate(prompt, seed=seed, **generate_kwargs).video
        results.append(PABEvalResult(prompt, evaluate_pair(v_pab, v_ref)))
    return results


def summarize(results: Sequence[PABEvalResult]) -> Dict[str, float]:
    return {
        "psnr": float(np.mean([r.psnr for r in results])),
        "ssim": float(np.mean([r.ssim for r in results])),
        "n": len(results),
    }


def attention_ablation(
    make_engine: Callable[[dict], Any],
    dense_engine: Any,
    prompts: Sequence[str],
    generate_kwargs: Optional[dict] = None,
    ranges: Optional[Dict[str, Sequence[int]]] = None,
    seed: int = 0,
) -> Dict[str, Dict[int, Dict[str, float]]]:
    """PAB range sweep (experiments/attention_ablation.py:16-55): for each
    attention type, sweep the broadcast range with the other types off.
    `make_engine(pab_overrides) -> engine`."""
    generate_kwargs = generate_kwargs or {}
    ranges = ranges or {"spatial": (2, 3, 4, 5), "temporal": (3, 4, 5, 6),
                        "cross": (5, 6, 7, 8)}
    refs = {p: dense_engine.generate(p, seed=seed, **generate_kwargs).video
            for p in prompts}
    out: Dict[str, Dict[int, Dict[str, float]]] = {}
    for attn_type, gaps in ranges.items():
        out[attn_type] = {}
        for gap in gaps:
            overrides = {
                "spatial_broadcast": attn_type == "spatial",
                "temporal_broadcast": attn_type == "temporal",
                "cross_broadcast": attn_type == "cross",
                f"{attn_type}_range": gap,
            }
            engine = make_engine(overrides)
            scores = []
            for p in prompts:
                v = engine.generate(p, seed=seed, **generate_kwargs).video
                m = evaluate_pair(v, refs[p])
                scores.append((m["psnr"]["value"], m["ssim"]["value"]))
            arr = np.asarray(scores)
            out[attn_type][gap] = {"psnr": float(arr[:, 0].mean()),
                                   "ssim": float(arr[:, 1].mean())}
    return out


def components_ablation(
    make_engine: Callable[[dict], Any],
    dense_engine: Any,
    prompts: Sequence[str],
    generate_kwargs: Optional[dict] = None,
    seed: int = 0,
) -> Dict[str, Dict[str, float]]:
    """Leave-one-out PAB component ablation (experiments/
    components_ablation.py wo_spatial/wo_temporal/wo_cross/wo_mlp :7-40):
    for each component, disable ONLY it and keep the model's default PAB
    config for the rest. `make_engine(pab_overrides) -> engine` with PAB
    enabled and the overrides applied on top of the pipeline defaults."""
    generate_kwargs = generate_kwargs or {}
    refs = {p: dense_engine.generate(p, seed=seed, **generate_kwargs).video
            for p in prompts}
    out: Dict[str, Dict[str, float]] = {}
    for component in ("spatial", "temporal", "cross", "mlp"):
        engine = make_engine({f"{component}_broadcast": False})
        scores = []
        for p in prompts:
            v = engine.generate(p, seed=seed, **generate_kwargs).video
            m = evaluate_pair(v, refs[p])
            scores.append((m["psnr"]["value"], m["ssim"]["value"]))
        arr = np.asarray(scores)
        out[f"wo_{component}"] = {"psnr": float(arr[:, 0].mean()),
                                  "ssim": float(arr[:, 1].mean())}
    return out


def load_eval_prompts(csv_file_path: str) -> Dict[str, str]:
    """WebVid eval prompt loader (eval/pab/webvid/utils.py load_eval_prompts:
    CSV with `id` and `text` columns -> {id: prompt})."""
    import csv

    prompts = {}
    with open(csv_file_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            prompts[row["id"]] = row["text"]
    return prompts


def generate_batch(
    engine: Any,
    prompts,
    output_dir: str,
    loop: int = 1,
    generate_kwargs: Optional[dict] = None,
    skip_existing: bool = True,
) -> List[str]:
    """Batch generation to disk for directory-pair eval (experiments/utils.py
    generate_func :10-16 and webvid/utils.py :17-25). `prompts` is either a
    {id: prompt} dict (webvid style, seed 0, one clip per id) or a list of
    prompts (ablation style, `loop` seeds per prompt, filename
    `{prompt}-{l}`). Returns the written paths."""
    import os

    from videosys_tpu_torch.utils.video import save_video

    generate_kwargs = dict(generate_kwargs or {})
    if isinstance(prompts, dict):
        items = [(idx, prompt, 0) for idx, prompt in prompts.items()]
    else:
        items = [(f"{prompt}-{l}", prompt, l)
                 for prompt in prompts for l in range(loop)]
    written = []
    for name, prompt, seed in items:
        path = os.path.join(output_dir, f"{name}.mp4")
        # save_video falls back to .gif when no mp4 encoder exists
        if skip_existing and (os.path.exists(path)
                              or os.path.exists(path[:-4] + ".gif")):
            continue
        video = engine.generate(prompt, seed=seed, **generate_kwargs).video
        written.append(save_video(video, path))
    return written


def read_vbench_prompts(path: str) -> List[str]:
    """VBench prompt list loader (eval/pab/experiments/utils.py
    read_prompt_list: the full-info JSON's `prompt_en` fields)."""
    with open(path) as f:
        data = json.load(f)
    return [row["prompt_en"] for row in data]


def run_vbench(videos_path: str, dimensions: Optional[Sequence[str]] = None):
    """VBench hook (eval/pab/vbench/run_vbench.py) on the card. Requires
    the `vbench` wheel + its pretrained evaluators; raises a clear error
    offline."""
    try:
        from vbench import VBench  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "VBench evaluation needs the `vbench` package and its pretrained "
            "weights; unavailable in this offline image. Generate videos with "
            "eval_pab / attention_ablation and run VBench where it is "
            "installed.") from e
    import torch

    bench = VBench(torch.device("cuda"), "VBench_full_info.json", "vbench_out")
    return bench.evaluate(videos_path=videos_path, name="videosys_tpu_torch",
                          dimension_list=list(dimensions or []))

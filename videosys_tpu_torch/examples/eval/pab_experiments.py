"""PAB evaluation experiment entry points (Open-Sora).

Counterpart of `examples/eval/pab_experiments.py` (the reference's
`eval/pab/experiments/` scripts attention_ablation.py,
components_ablation.py, opensora.py and the `eval/pab/webvid/` generation)
as one CLI over `videosys_tpu_torch.eval`. Each function runs as a test
with `tiny=True` (a random-init offline config; the dense and PAB engines
share their weights, the protocol's requirement) and on the CPU with
`device="cpu"` (the card otherwise).

    python -m videosys_tpu_torch.examples.eval.pab_experiments attention_ablation --outdir samples/
    python -m videosys_tpu_torch.examples.eval.pab_experiments components_ablation --outdir samples/
    python -m videosys_tpu_torch.examples.eval.pab_experiments pab_quality
    python -m videosys_tpu_torch.examples.eval.pab_experiments webvid --csv prompts.csv --outdir out/
"""

import argparse
import json
import os

from videosys_tpu_torch import OpenSoraConfig, OpenSoraPABConfig, VideoSysEngine
from videosys_tpu_torch.examples.inference.open_sora.sample import _tiny_vae


def _engine_factory(tiny: bool, device=None):
    """make_engine(pab_overrides | None) with shared weights: the dense
    engine and every PAB variant run the same parameters, the eval
    protocol's requirement (eval/pab/README.md)."""
    shared = {}

    def make_engine(pab_overrides=None):
        pab = dict(enable_pab=pab_overrides is not None,
                   pab_config=OpenSoraPABConfig(**pab_overrides)
                   if pab_overrides else None)
        if tiny:
            from videosys_tpu_torch.models.transformers.stdit3 import (
                STDiT3Config,
            )

            cfg = OpenSoraConfig(
                transformer=None, vae=None, text_encoder=None,
                num_sampling_steps=4, dtype="fp32",
                transformer_config=STDiT3Config(
                    depth=2, hidden_size=32, num_heads=2, caption_channels=16,
                    model_max_length=8, patch_size=(1, 2, 2)), **pab)
            eng = VideoSysEngine(cfg, vae=_tiny_vae(), device=device,
                                 params=shared.get("params"))
        else:
            eng = VideoSysEngine(OpenSoraConfig(**pab), device=device,
                                 params=shared.get("params"))
        shared.setdefault("params", {
            name: getattr(eng.pipeline, name).state_dict()
            for name in ("transformer", "vae")})
        return eng

    return make_engine


def _gen_kwargs(tiny: bool):
    if tiny:
        return dict(resolution="144p", aspect_ratio="1:1", num_frames=1)
    return dict(resolution="480p", aspect_ratio="9:16", num_frames="2s")


def _write(out, outdir, name):
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, name), "w") as f:
            json.dump(out, f, indent=1)
    return out


def run_attention_ablation(tiny: bool = False, outdir: str = None,
                           prompts=("a breathtaking sunrise",), device=None):
    """experiments/attention_ablation.py: per-type broadcast-range sweep."""
    from videosys_tpu_torch.eval.pab_eval import attention_ablation

    make = _engine_factory(tiny, device)
    ranges = ({"spatial": (2,), "temporal": (2,), "cross": (2,)} if tiny
              else None)
    out = attention_ablation(
        lambda ov: make(ov), make(None), list(prompts),
        generate_kwargs=_gen_kwargs(tiny), ranges=ranges)
    return _write(out, outdir, "attention_ablation.json")


def run_components_ablation(tiny: bool = False, outdir: str = None,
                            prompts=("a breathtaking sunrise",), device=None):
    """experiments/components_ablation.py: leave-one-out over the default
    PAB scope."""
    from videosys_tpu_torch.eval.pab_eval import components_ablation

    make = _engine_factory(tiny, device)
    out = components_ablation(
        lambda ov: make(ov), make(None), list(prompts),
        generate_kwargs=_gen_kwargs(tiny))
    return _write(out, outdir, "components_ablation.json")


def run_pab_quality(tiny: bool = False, prompts=("a breathtaking sunrise",),
                    device=None):
    """experiments/opensora.py + common_metrics: dense-vs-PAB pair metrics."""
    from videosys_tpu_torch.eval.pab_eval import eval_pab, summarize

    make = _engine_factory(tiny, device)
    results = eval_pab(lambda pab: make({} if pab else None), list(prompts),
                       generate_kwargs=_gen_kwargs(tiny))
    return summarize(results)


def run_webvid(csv_path: str, outdir: str, tiny: bool = False,
               gt_dir: str = None, device=None):
    """webvid/open_sora.py: batch generation over an (id, text) CSV, then
    the directory-pair eval against ground-truth clips when given."""
    from videosys_tpu_torch.eval.batch_eval import eval_dirs
    from videosys_tpu_torch.eval.pab_eval import generate_batch, load_eval_prompts

    engine = _engine_factory(tiny, device)(None)
    written = generate_batch(engine, load_eval_prompts(csv_path), outdir,
                             generate_kwargs=_gen_kwargs(tiny))
    if gt_dir:
        ext = "mp4" if any(w.endswith(".mp4") for w in written) else "gif"
        return eval_dirs(outdir, gt_dir, file_extension=ext)
    return {"written": len(written)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["attention_ablation",
                                     "components_ablation", "pab_quality",
                                     "webvid"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--outdir", default="samples/pab_experiments")
    ap.add_argument("--csv")
    ap.add_argument("--gt-dir")
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu to run on the CPU")
    args = ap.parse_args(argv)
    if args.mode == "attention_ablation":
        out = run_attention_ablation(args.tiny, args.outdir, device=args.device)
    elif args.mode == "components_ablation":
        out = run_components_ablation(args.tiny, args.outdir,
                                      device=args.device)
    elif args.mode == "pab_quality":
        out = run_pab_quality(args.tiny, device=args.device)
    else:
        out = run_webvid(args.csv, args.outdir, args.tiny, args.gt_dir,
                         device=args.device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

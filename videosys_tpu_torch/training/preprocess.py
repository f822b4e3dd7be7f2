"""Latent pre-extraction: every dataset row's clip through the VAE encoder
and its caption through the text encoder, written as files that
`PreprocessedLatentDataset` reads, so that training skips both encoders.

Port of `examples/training/open_sora/preprocess.py` (reference:
examples/training/open_sora/preprocess.py). The layout is the JAX
example's: `latent_{i}.npy` (float16 [C, t, h, w]), `text_{i}.npz` (`y`
float16 [L, D], `mask` bool [L]) and `preprocessed.csv` (path, latent_path,
text_path, text, num_frames, height, width).

    python -m videosys_tpu_torch.training.preprocess --csv videos.csv \\
        --outdir latents/ --text-encoder /path/to/t5-v1_1-xxl
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Optional, Sequence

import numpy as np
import torch

from videosys_tpu_torch.core.pipeline import resolve_device

COLUMNS = ("path", "latent_path", "text_path", "text", "num_frames", "height",
           "width")


@torch.no_grad()
def preprocess(dataset, vae, text_encoder, thw, outdir: str, seed: int = 0,
               device=None) -> str:
    """Encode every row of `dataset` (a `VariableVideoTextDataset`) at the
    bucket shape `thw` = (frames, height, width): `load_video(i, thw,
    seed=seed)` through `vae.encode` (on `device`, in the VAE's dtype; row
    i's noise from `encode_noise(seed, i)`) and the row's text through
    `text_encoder.encode`. Returns the path of the CSV written."""
    from videosys_tpu_torch.training.train import encode_noise

    device = resolve_device(device)
    vae.to(device).eval()
    os.makedirs(outdir, exist_ok=True)
    rows = []
    for i in range(len(dataset)):
        sample = dataset[i]
        video = torch.from_numpy(dataset.load_video(i, thw, seed=seed))
        z = vae.encode(video[None].to(device), encode_noise(seed, i))
        y, mask = text_encoder.encode([sample.text])
        lat_path = os.path.join(outdir, f"latent_{i}.npy")
        txt_path = os.path.join(outdir, f"text_{i}.npz")
        np.save(lat_path, z[0].float().cpu().numpy().astype(np.float16))
        np.savez(txt_path, y=y[0].float().cpu().numpy().astype(np.float16),
                 mask=mask[0].cpu().numpy())
        rows.append({"path": sample.path, "latent_path": lat_path,
                     "text_path": txt_path, "text": sample.text,
                     "num_frames": sample.num_frames,
                     "height": sample.height, "width": sample.width})
    out_csv = os.path.join(outdir, "preprocessed.csv")
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    return out_csv


def merge_config(ap: argparse.ArgumentParser, args: argparse.Namespace,
                 path: Optional[str]) -> None:
    """Fill `args` from a YAML file: a flag given on the command line (one
    that differs from its default) wins (reference merge_args,
    utils/utils.py:62-78). PyYAML is imported only here."""
    if not path:
        return
    import yaml

    with open(path) as f:
        values = yaml.safe_load(f) or {}
    defaults = {a.dest: a.default for a in ap._actions}
    for k, v in values.items():
        k = k.replace("-", "_")
        if not hasattr(args, k):
            raise SystemExit(f"unknown config key: {k}")
        if getattr(args, k) == defaults.get(k):
            setattr(args, k, v)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csv", default=None, help="path,text,num_frames,height,width")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--bucket-frames", type=int, default=51)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=426)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="random-init tiny VAE and the stub text encoder")
    ap.add_argument("--text-encoder", default=None,
                    help="local T5 snapshot (weights and tokenizer); "
                         "required without --tiny")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--config", default=None,
                    help="YAML file; CLI flags override its values")
    args = ap.parse_args(argv)
    merge_config(ap, args, args.config)
    if not args.csv or not args.outdir:
        ap.error("--csv and --outdir are required (flag or config file)")
    if not args.tiny and not args.text_encoder:
        ap.error("--text-encoder PATH (a local T5 snapshot) is required "
                 "without --tiny")

    from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
        OpenSoraVAE,
        OpenSoraVAEConfig,
    )
    from videosys_tpu_torch.models.text_encoders.t5 import (
        StubTextEncoder,
        T5TextEncoder,
    )
    from videosys_tpu_torch.training.datasets import VariableVideoTextDataset

    device = resolve_device(args.device)
    cuda = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(args.seed)
        vae = tiny_vae() if args.tiny else OpenSoraVAE(OpenSoraVAEConfig())
    text = (StubTextEncoder(output_dim=16, max_length=8, device=device)
            if args.tiny else T5TextEncoder(args.text_encoder, device=device))
    return preprocess(VariableVideoTextDataset(args.csv), vae, text,
                      (args.bucket_frames, args.height, args.width),
                      args.outdir, seed=args.seed, device=device)


def tiny_vae():
    """The tiny Open-Sora VAE of the `--tiny` entry points (the JAX
    examples' widths: spatial (8, 16), no mid attention; temporal 8)."""
    from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
        OpenSoraVAE,
        OpenSoraVAEConfig,
    )
    from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
    from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal

    return OpenSoraVAE(
        OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
        spatial=AutoencoderKL2D(mid_block_add_attention=False,
                                block_out_channels=(8, 16),
                                layers_per_block=1, num_groups=4),
        temporal=VAETemporal(filters=8, num_res_blocks=1, num_groups=4))


if __name__ == "__main__":
    main()

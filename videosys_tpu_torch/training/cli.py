"""Open-Sora training entry point: flags -> `TrainConfig` -> `run_training`.

Port of `examples/training/open_sora/train.py` (reference:
examples/training/open_sora/train.py), with `--device` (default: the card).

    python -m videosys_tpu_torch.training.cli --dynamic-profile --max-steps 100
    python -m videosys_tpu_torch.training.cli --csv videos.csv   # raw video
    python -m videosys_tpu_torch.training.cli --tiny --device cpu --max-steps 2
    python -m videosys_tpu_torch.training.cli --dp-size 2 --sp-size 2  # 4 cards

`--dp-size` x `--sp-size` > 1 spawns that many ranks (rank 0 in this
process), rank r on `cuda:r`, or every rank on `--device` (with `--backend
gloo` where they share one card).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None):
    """Returns (optimizer steps taken, metrics history)."""
    from videosys_tpu_torch.core.pipeline import resolve_device
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config
    from videosys_tpu_torch.training.preprocess import merge_config
    from videosys_tpu_torch.training.train import TrainConfig, run_training

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--warmup-steps", type=int, default=1000)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--ema-decay", type=float, default=0.99)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dp-size", type=int, default=1)
    ap.add_argument("--sp-size", type=int, default=1)
    ap.add_argument("--dynamic-sp", action="store_true")
    ap.add_argument("--sp-balance", action="store_true",
                    help="pack plans of differing sp into GlobalSteps "
                         "(grads accumulate, one update per packed step)")
    ap.add_argument("--dynamic-profile", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "dots", "none"),
                    help="activation recompute policy for the depth pairs")
    ap.add_argument("--dynamic-recompute", action="store_true",
                    help="let the DCP profiler pick the least recompute "
                         "that fits memory, per bucket")
    ap.add_argument("--csv", default=None,
                    help="video CSV (path,text,num_frames,height,width); "
                         "trains from raw video through the VAE")
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="./checkpoints")
    ap.add_argument("--dataset-size", type=int, default=64)
    ap.add_argument("--tiny", action="store_true",
                    help="random-init tiny model (offline smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; over ranks, "
                         "cuda:r for rank r)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process group of the ranks (default: nccl on "
                         "cards, gloo on the CPU)")
    ap.add_argument("--config", default=None,
                    help="YAML file; CLI flags override its values "
                         "(reference merge_args, utils/utils.py:62-78)")
    args = ap.parse_args(argv)
    merge_config(ap, args, args.config)

    model = (STDiT3Config(depth=1, hidden_size=32, num_heads=2,
                          caption_channels=16, model_max_length=8)
             if args.tiny else STDiT3Config(dtype=torch.bfloat16))
    cfg = TrainConfig(
        model=model, lr=args.lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, grad_clip=args.grad_clip,
        ema_decay=args.ema_decay, epochs=args.epochs, max_steps=args.max_steps,
        seed=args.seed, dp_size=args.dp_size, sp_size=args.sp_size,
        dynamic_sp=args.dynamic_sp, sp_balance=args.sp_balance,
        dynamic_profile=args.dynamic_profile,
        remat_policy=args.remat_policy,
        dynamic_recompute=args.dynamic_recompute,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        dataset_size=args.dataset_size,
        bucket_config=({"144p": {1: (1.0, 2), 34: (1.0, 2)}} if args.tiny
                       else TrainConfig().bucket_config),
        mask_ratios=None if args.tiny else TrainConfig().mask_ratios,
    )
    ranks = args.dp_size * args.sp_size > 1
    device = torch.device(args.device or "cuda") if ranks \
        else resolve_device(args.device)
    dataset = vae = None
    if args.csv:
        from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
            OpenSoraVAE,
            OpenSoraVAEConfig,
        )
        from videosys_tpu_torch.training.datasets import VariableVideoTextDataset

        dataset = VariableVideoTextDataset(args.csv)
        # random weights from seed + 7, as the JAX loop initializes its VAE
        cuda = [device] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda):
            torch.manual_seed(args.seed + 7)
            vae = OpenSoraVAE(OpenSoraVAEConfig())
    if ranks:  # every rank on `--device`, or rank r on cuda:r
        extra = dict(device=args.device, backend=args.backend)
    else:
        extra = dict(device=device)
    state, ema, history = run_training(cfg, dataset=dataset, vae=vae, **extra)
    return int(state.step), history


if __name__ == "__main__":
    main()

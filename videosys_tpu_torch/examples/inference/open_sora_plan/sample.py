"""Open-Sora-Plan inference examples: the counterpart of
`examples/inference/open_sora_plan/sample.py` (v1.1 65 x 512 x 512 and
v1.2 29 x 480p, base and pab). `tiny=True` runs a random-init offline
config; `device="cpu"` runs on the CPU (the card otherwise).

    python -m videosys_tpu_torch.examples.inference.open_sora_plan.sample
"""

from videosys_tpu_torch import OpenSoraPlanConfig, VideoSysEngine


def _config(tiny: bool, version: str = "v120", **kw):
    ttype = "29x480p" if version == "v120" else "65x512x512"
    if not tiny:
        return OpenSoraPlanConfig(version=version, transformer_type=ttype, **kw)
    from videosys_tpu_torch.models.autoencoders.autoencoder_causal_vae import (
        CausalVAEConfig,
    )

    vae = CausalVAEConfig(
        hidden_size=8, hidden_size_mult=(1, 2), num_res_blocks=1,
        encoder_resnet_blocks=("ResnetBlock3D",) * 2,
        encoder_spatial_downsample=("SpatialDownsample2x", ""),
        encoder_temporal_downsample=("TimeDownsample2x", ""),
        decoder_resnet_blocks=("ResnetBlock3D",) * 2,
        decoder_spatial_upsample=("", "SpatialUpsample2x"),
        decoder_temporal_upsample=("", "TimeUpsample2x"))
    if version == "v120":
        from videosys_tpu_torch.models.transformers.open_sora_plan_v120 import (
            OpenSoraPlanV120Config,
        )

        tcfg = OpenSoraPlanV120Config(num_layers=1, num_heads=2, head_dim=24,
                                      caption_channels=16, sample_size=(8, 8),
                                      sample_size_t=2)
    else:
        from videosys_tpu_torch.models.transformers.open_sora_plan_v110 import (
            OpenSoraPlanV110Config,
        )

        tcfg = OpenSoraPlanV110Config(num_layers=1, num_heads=2, head_dim=24,
                                      caption_channels=16, sample_size=8,
                                      video_length=2)
    return OpenSoraPlanConfig(version=version, transformer_type=ttype,
                              dtype="fp32", enable_tiling=False,
                              transformer_config=tcfg, vae_config=vae, **kw)


def _generate(config, steps: int, path: str, device=None) -> str:
    engine = VideoSysEngine(config, device=device)
    video = engine.generate("Sunset over the sea.", seed=0,
                            num_inference_steps=steps).video[0]
    return engine.save_video(video, path)


def run_base(tiny: bool = False, version: str = "v120",
             outdir: str = "./outputs", device=None):
    steps = 8 if tiny else 100  # PNDM needs >= pndm_order steps
    return _generate(_config(tiny, version), steps,
                     f"{outdir}/Sunset over the sea.-osp-{version}", device)


def run_v110(tiny: bool = False, outdir: str = "./outputs", device=None):
    return run_base(tiny, version="v110", outdir=outdir, device=device)


def run_pab(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny, "v120", enable_pab=True), 4 if tiny else 100,
                     f"{outdir}/Sunset over the sea.-osp-pab", device)


if __name__ == "__main__":
    run_base()

"""CogVideoX inference examples: the counterpart of
`examples/inference/cogvideox/sample.py` (run_base on the 2b with DDIM,
run_pab). `tiny=True` runs a random-init offline config; `device="cpu"`
runs on the CPU (the card otherwise).

    python -m videosys_tpu_torch.examples.inference.cogvideox.sample
"""

from videosys_tpu_torch import CogVideoXConfig, VideoSysEngine


def _config(tiny: bool, **kw):
    if not tiny:
        return CogVideoXConfig(**kw)
    from videosys_tpu_torch.models.autoencoders.autoencoder_cogvideox import (
        CogVideoXVAEConfig,
    )
    from videosys_tpu_torch.models.transformers.cogvideox import (
        CogVideoXConfig as CogModelConfig,
    )

    kw.setdefault("model_path", None)
    return CogVideoXConfig(
        dtype="fp32",
        transformer_config=CogModelConfig(
            num_layers=1, num_heads=2, head_dim=16, in_channels=4,
            out_channels=4, text_embed_dim=16, max_text_seq_length=8),
        vae_config=CogVideoXVAEConfig(
            latent_channels=4, block_out_channels=(8, 8, 16, 16),
            layers_per_block=1, norm_num_groups=4), **kw)


def _kwargs(tiny: bool):
    return (dict(num_frames=5, height=32, width=32, num_inference_steps=2)
            if tiny else dict(num_frames=49, height=480, width=720,
                              num_inference_steps=50))


def _generate(config, tiny: bool, path: str, device=None) -> str:
    engine = VideoSysEngine(config, device=device)
    video = engine.generate("Sunset over the sea.", seed=0,
                            **_kwargs(tiny)).video[0]
    return engine.save_video(video, path)


def run_base(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny), tiny,
                     f"{outdir}/Sunset over the sea.-cog", device)


def run_pab(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny, enable_pab=True), tiny,
                     f"{outdir}/Sunset over the sea.-cog-pab", device)


if __name__ == "__main__":
    run_base()

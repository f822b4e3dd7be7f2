"""Latte inference examples: the counterpart of
`examples/inference/latte/sample.py` (base and pab). `tiny=True` runs a
random-init offline config; `device="cpu"` runs on the CPU (the card
otherwise).

    python -m videosys_tpu_torch.examples.inference.latte.sample
"""

from videosys_tpu_torch import LatteConfig, VideoSysEngine


def _config(tiny: bool, **kw):
    if not tiny:
        return LatteConfig(**kw)
    from videosys_tpu_torch.models.transformers.latte import (
        LatteConfig as LatteModelConfig,
    )

    return LatteConfig(
        model_path=None, dtype="fp32",
        transformer_config=LatteModelConfig(
            num_layers=1, num_heads=2, head_dim=16, caption_channels=16,
            sample_size=16, video_length=2),
        vae_config=dict(mid_block_add_attention=False,
                        block_out_channels=(8, 16), layers_per_block=1,
                        num_groups=4), **kw)


def _kwargs(tiny: bool):
    return (dict(video_length=2, height=32, width=32, num_inference_steps=2)
            if tiny else dict(video_length=16, height=512, width=512,
                              num_inference_steps=50))


def _generate(config, tiny: bool, path: str, device=None) -> str:
    engine = VideoSysEngine(config, device=device)
    video = engine.generate("Sunset over the sea.", seed=0,
                            **_kwargs(tiny)).video[0]
    return engine.save_video(video, path)


def run_base(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny), tiny,
                     f"{outdir}/Sunset over the sea.-latte", device)


def run_pab(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny, enable_pab=True), tiny,
                     f"{outdir}/Sunset over the sea.-latte-pab", device)


if __name__ == "__main__":
    run_base()

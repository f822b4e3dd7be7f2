"""Vchitect-2.0 inference examples: the counterpart of
`examples/inference/vchitect/sample.py` (base and pab at 480 x 288, 40
frames). `tiny=True` runs a random-init offline config; `device="cpu"`
runs on the CPU (the card otherwise).

    python -m videosys_tpu_torch.examples.inference.vchitect.sample
"""

from videosys_tpu_torch import VchitectConfig, VideoSysEngine


def _config(tiny: bool, **kw):
    if not tiny:
        return VchitectConfig(**kw)
    from videosys_tpu_torch.models.transformers.vchitect import VchitectModelConfig

    return VchitectConfig(
        model_path=None, dtype="fp32",
        transformer_config=VchitectModelConfig(
            num_layers=2, num_heads=2, head_dim=16, joint_attention_dim=32,
            pooled_projection_dim=24, sample_size=8, pos_embed_max_size=12),
        vae_config=dict(mid_block_add_attention=False, latent_channels=16,
                        block_out_channels=(8, 16), layers_per_block=1,
                        num_groups=4), **kw)


def _kwargs(tiny: bool):
    return (dict(width=32, height=32, frames=2, num_inference_steps=2)
            if tiny else dict(width=480, height=288, frames=40,
                              num_inference_steps=100))


def _generate(config, tiny: bool, path: str, device=None) -> str:
    engine = VideoSysEngine(config, device=device)
    video = engine.generate("Sunset over the sea.", seed=0,
                            **_kwargs(tiny)).video[0]
    return engine.save_video(video, path)


def run_base(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny), tiny,
                     f"{outdir}/Sunset over the sea.-vchitect", device)


def run_pab(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny, enable_pab=True), tiny,
                     f"{outdir}/Sunset over the sea.-vchitect-pab", device)


if __name__ == "__main__":
    run_base()

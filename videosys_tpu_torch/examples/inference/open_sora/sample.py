"""Open-Sora v1.2 inference examples.

Counterpart of `examples/inference/open_sora/sample.py`: one function per
mode (base / pab / multi-device); each builds a config, an engine,
generates and saves. `tiny=True` swaps in a random-init offline config so
the functions run as tests; `device="cpu"` runs them on the CPU (the card
otherwise).

    python -m videosys_tpu_torch.examples.inference.open_sora.sample
"""

from videosys_tpu_torch import OpenSoraConfig, VideoSysEngine


def _config(tiny: bool, **kw):
    if not tiny:
        return OpenSoraConfig(num_sampling_steps=30, cfg_scale=7.0, **kw)
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config

    return OpenSoraConfig(
        transformer=None, vae=None, text_encoder=None,
        num_sampling_steps=2, dtype="fp32",
        transformer_config=STDiT3Config(depth=1, hidden_size=32, num_heads=2,
                                        caption_channels=16,
                                        model_max_length=8), **kw)


def _tiny_vae():
    from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
        OpenSoraVAE,
        OpenSoraVAEConfig,
    )
    from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
    from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal

    return OpenSoraVAE(
        OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
        spatial=AutoencoderKL2D(mid_block_add_attention=False,
                                block_out_channels=(8, 16), layers_per_block=1,
                                num_groups=4),
        temporal=VAETemporal(filters=8, num_res_blocks=1, num_groups=4))


def _request(tiny: bool) -> dict:
    return (dict(resolution="144p", aspect_ratio="1:1", num_frames=1)
            if tiny else dict(resolution="480p", aspect_ratio="9:16",
                              num_frames="2s"))


def _generate(config, tiny: bool, path: str, device=None) -> str:
    engine = VideoSysEngine(config, device=device,
                            **({"vae": _tiny_vae()} if tiny else {}))
    try:
        prompt = "Sunset over the sea."
        video = engine.generate(prompt=prompt, seed=0,
                                **_request(tiny)).video[0]
        return engine.save_video(video, path.format(prompt=prompt))
    finally:
        engine.shutdown()


def run_base(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny), tiny, f"{outdir}/{{prompt}}", device)


def run_pab(tiny: bool = False, outdir: str = "./outputs", device=None):
    return _generate(_config(tiny, enable_pab=True), tiny,
                     f"{outdir}/{{prompt}}-pab", device)


def run_multi_device(tiny: bool = False, outdir: str = "./outputs",
                     num_devices: int = 2, device=None):
    """DSP sequence parallelism over `num_devices` ranks (the reference's
    num_gpus > 1 path), spawned by `VideoSysEngine`."""
    return _generate(_config(tiny, num_gpus=num_devices), tiny,
                     f"{outdir}/{{prompt}}-sp", device)


if __name__ == "__main__":
    run_base()
    run_pab()

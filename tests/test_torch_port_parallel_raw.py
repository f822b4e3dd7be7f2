"""Raw-video training over ranks (gloo on the CPU): `run_training` reads
clips and encodes each micro-batch through the Open-Sora VAE split over
the sp ranks (frames, then latent rows); each dp index encodes its own
clips, every draw of the encode made for the global batch and the index's
share kept. The losses equal world 1's on the same global batch (1e-4).
"""

import os

import numpy as np
import pytest
import torch

from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
    OpenSoraVAE,
    OpenSoraVAEConfig,
)
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal
from videosys_tpu_torch.models.transformers import stdit3 as P
from videosys_tpu_torch.training.datasets import VariableVideoTextDataset
from videosys_tpu_torch.training.train import TrainConfig, run_training

SIZES = dict(depth=1, hidden_size=32, num_heads=2, caption_channels=16,
             model_max_length=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every rank computes on one CPU thread (the ranks share this CPU)."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"  # read by the spawned workers
    yield
    torch.set_num_threads(threads)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


class MemoryClips(VariableVideoTextDataset):
    """Seeded uint8 clips in memory behind a CSV; only the decode is
    replaced (it pickles: the ranks get their own copy)."""

    def __init__(self, csv_path, clips):
        super().__init__(csv_path)
        self.clips = clips

    def read_frames(self, i, keep):
        return self.clips[i][keep]


def memory_clips(tmp_path, frames, hw=(150, 270)):
    rng = np.random.default_rng(3)
    clips = [rng.integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)
             for n in frames]
    path = tmp_path / "clips.csv"
    path.write_text("path,text,num_frames,height,width\n" + "".join(
        f"mem{i},a clip,{n},{hw[0]},{hw[1]}\n" for i, n in enumerate(frames)))
    return MemoryClips(str(path), clips)


def small_vae():
    torch.manual_seed(0)
    return OpenSoraVAE(
        OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
        spatial=AutoencoderKL2D(block_out_channels=(4, 8, 8, 8),
                                layers_per_block=1, num_groups=4),
        temporal=VAETemporal(filters=8, num_res_blocks=1, num_groups=4)).eval()


@pytest.mark.parametrize("world", ["sp2", "dp2"])
def test_raw_video_training_over_ranks(tmp_path, world):
    """Raw clips encoded inside `run_training` through the VAE split over
    the sp ranks (dp: each dp index its own clips, each draw the global
    batch's share): the losses of world 1 on the same global batch."""
    clips = memory_clips(tmp_path, (20, 1, 1, 20, 1, 1, 20, 20))
    dp = 2 if world == "dp2" else 1

    def config(dp, sp):
        return TrainConfig(
            model=P.STDiT3Config(**SIZES),
            bucket_config={"144p": {1: (1.0, 2 // dp), 17: (1.0, 2 // dp)}},
            mask_ratios=None, lr=2e-3, warmup_steps=1, max_steps=3,
            log_every=1, seed=5, dp_size=dp, sp_size=2 // dp)

    want = run_training(config(1, 1), dataset=clips, vae=small_vae(),
                        device="cpu")[2]
    got = run_training(config(dp, 2 // dp), dataset=clips, vae=small_vae(),
                       device="cpu")[2]
    assert {tuple(h["thw"]) for h in want} == {(1, 144, 256), (17, 144, 256)}
    assert [h["thw"] for h in got] == [h["thw"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-4)

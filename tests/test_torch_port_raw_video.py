"""Raw-video training, the data path and the entry points of the PyTorch
port against the JAX package, on the CPU: the video transforms (resize
byte-equal to OpenCV's INTER_LINEAR), the csv-read datasets against the
pandas-read ones, `load_video` on a small video file, the threaded latent
reads, `preprocess` against the JAX example's layout, raw-video
`run_training` against training on the latents its encode gives, and
`cli.main`. No module of the port may need pandas, OpenCV or PyYAML to
import."""

import csv
import dataclasses
import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from videosys_tpu.training import datasets as JD
from videosys_tpu.training import video_transforms as JV
from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import (
    OpenSoraVAE,
    OpenSoraVAEConfig,
)
from videosys_tpu_torch.models.autoencoders.vae2d import AutoencoderKL2D
from videosys_tpu_torch.models.autoencoders.vae_temporal import VAETemporal
from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder
from videosys_tpu_torch.models.transformers.stdit3 import STDiT3Config
from videosys_tpu_torch.training import cli
from videosys_tpu_torch.training import datasets as PD
from videosys_tpu_torch.training import train as PTR
from videosys_tpu_torch.training import video_transforms as PV

# the package exports the function `preprocess` under its module's name
PP = importlib.import_module("videosys_tpu_torch.training.preprocess")
ROOT = Path(__file__).resolve().parents[1]
CLIP = (7, 37, 53, 3)  # [T, H, W, C]: odd sizes, so every resize rounds


def _clip(seed=0, shape=CLIP):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# (name, the transform built in a module `m`): random ones get equal seeds
TRANSFORMS = {
    "resize_down": lambda m: lambda c: m.resize(c, (20, 31)),
    "resize_up": lambda m: lambda c: m.resize(c, (61, 100)),
    "resize_grey": lambda m: lambda c: m.resize(c[..., 0], (23, 90)),
    "crop": lambda m: lambda c: m.crop(c, 3, 5, 20, 30),
    "center_crop": lambda m: lambda c: m.center_crop(c, (21, 40)),
    "center_crop_using_short_edge": lambda m: m.center_crop_using_short_edge,
    "resize_crop_to_fill": lambda m: lambda c: m.resize_crop_to_fill(c, (24, 24)),
    "hflip": lambda m: m.hflip,
    "ResizeCrop": lambda m: m.ResizeCrop((30, 50)),
    "RandomCropVideo": lambda m: m.RandomCropVideo(
        (20, 20), rng=np.random.default_rng(3)),
    "CenterCropResizeVideo": lambda m: m.CenterCropResizeVideo((16, 24)),
    "UCFCenterCropVideo": lambda m: m.UCFCenterCropVideo(32),
    "RandomHorizontalFlipVideo": lambda m: m.RandomHorizontalFlipVideo(
        rng=np.random.default_rng(1)),
    "ToTensorNormalize": lambda m: m.ToTensorNormalize(),
    "Compose": lambda m: m.Compose([m.hflip, m.ResizeCrop(24),
                                    m.ToTensorNormalize()]),
    "get_transforms_video_center": lambda m: m.get_transforms_video(
        "center", (24, 24)),
    "get_transforms_video_resize_crop": lambda m: m.get_transforms_video(
        "resize_crop", (144, 256)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    """Every transform equal, byte for byte, to the JAX package's (which
    resizes with OpenCV); random ones from equal generators, three calls."""
    pytest.importorskip("cv2")
    want_t, got_t = TRANSFORMS[name](JV), TRANSFORMS[name](PV)
    for seed in range(3):
        clip = _clip(seed)
        want, got = want_t(clip), got_t(clip)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_temporal_random_crop_matches_jax():
    want = JV.TemporalRandomCrop(8, rng=np.random.default_rng(5))
    got = PV.TemporalRandomCrop(8, rng=np.random.default_rng(5))
    assert [got(n) for n in (3, 8, 30, 30)] == [want(n) for n in (3, 8, 30, 30)]


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path)


def _video_rows(paths, frames, hw):
    return [{"path": p, "text": f"clip {i}, with a comma and \"quotes\"",
             "num_frames": frames, "height": hw[0], "width": hw[1]}
            for i, p in enumerate(paths)]


def test_csv_datasets_match_pandas(tmp_path):
    rows = _video_rows([f"v{i}.mp4" for i in range(5)], 60, (270, 480))
    rows[2].update(num_frames=17, height=144, width=256)
    path = _write_csv(tmp_path / "videos.csv", rows)
    want, got = JD.VariableVideoTextDataset(path), PD.VariableVideoTextDataset(path)
    assert len(got) == len(want) == 5 and got.shapes() == want.shapes()
    for i in range(5):
        assert dataclasses.astuple(got[i]) == dataclasses.astuple(want[i])

    lat_rows = [dict(r, latent_path=f"latent_{i}.npy", text_path=f"text_{i}.npz")
                for i, r in enumerate(rows)]
    path = _write_csv(tmp_path / "preprocessed.csv", lat_rows)
    want = JD.PreprocessedLatentDataset(path, native_threads=0)
    got = PD.PreprocessedLatentDataset(path)
    assert got.shapes() == want.shapes()
    for i in range(5):
        assert dataclasses.astuple(got[i]) == dataclasses.astuple(want[i])
    got.close()


def test_load_video_matches_jax(tmp_path):
    """A video file written with OpenCV, read by both packages: the same
    temporal window, decode and resize-crop, byte for byte."""
    cv2 = pytest.importorskip("cv2")
    paths = []
    for v in range(2):
        path = str(tmp_path / f"v{v}.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 8,
                                 (48, 40))
        for frame in _clip(v, (20, 40, 48, 3)):
            writer.write(frame)
        writer.release()
        paths.append(path)
    csv_path = _write_csv(tmp_path / "videos.csv", _video_rows(paths, 20, (40, 48)))
    want, got = JD.VariableVideoTextDataset(csv_path), PD.VariableVideoTextDataset(csv_path)
    for i, thw, interval, seed in ((0, (8, 32, 32), 1, 0), (1, (5, 30, 64), 3, 4),
                                   (1, (30, 24, 24), 1, 1)):
        w = want.load_video(i, thw, frame_interval=interval, seed=seed)
        g = got.load_video(i, thw, frame_interval=interval, seed=seed)
        assert g.shape == (3,) + thw and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


class MemoryClips(PD.VariableVideoTextDataset):
    """Seeded uint8 clips in memory; only the decode is replaced."""

    def __init__(self, csv_path, clips):
        super().__init__(csv_path)
        self.clips = clips

    def read_frames(self, i, keep):
        return self.clips[i][keep]


def memory_clips(tmp_path, frames, hw=(150, 270)):
    """Clips of 150 x 270 (the 144p bucket, resize-cropped to 144 x 256)."""
    clips = [_clip(10 + i, (n,) + hw + (3,)) for i, n in enumerate(frames)]
    rows = [dict(r, num_frames=n) for r, n in
            zip(_video_rows([f"mem{i}" for i in range(len(frames))], 0, hw),
                frames)]
    return MemoryClips(_write_csv(tmp_path / "clips.csv", rows), clips)


def small_vae(seed=0):
    """An Open-Sora VAE with the real 8x spatial and 4x temporal factors at
    small widths, the mid attention included."""
    torch.manual_seed(seed)
    return OpenSoraVAE(
        OpenSoraVAEConfig(micro_frame_size=17, micro_batch_size=4),
        spatial=AutoencoderKL2D(block_out_channels=(4, 8, 8, 8),
                                layers_per_block=1, num_groups=4),
        temporal=VAETemporal(filters=8, num_res_blocks=1, num_groups=4)).eval()


def _train_config(**kw):
    base = dict(
        model=STDiT3Config(depth=1, hidden_size=32, num_heads=2,
                           caption_channels=16, model_max_length=8),
        bucket_config={"144p": {1: (1.0, 2), 17: (1.0, 1)}},
        mask_ratios={"identity": 0.5, "quarter_head": 0.5},
        lr=2e-3, warmup_steps=1, max_steps=3, log_every=1, seed=5)
    base.update(kw)
    return PTR.TrainConfig(**base)


class EncodedLatents:
    """The latents `run_training`'s raw-video mode would make: the same
    clips and the same encode noise, handed over as a latent dataset."""

    def __init__(self, clips, vae, seed):
        self.clips, self.vae, self.seed = clips, vae, seed

    def shapes(self):
        return self.clips.shapes()

    def load_latents(self, indices, latent_thw, rng_seed=0):
        t, h, w = latent_thw
        thw = ({1: 1, 5: 17}[t], h * 8, w * 8)
        x = np.stack([self.clips.load_video(int(i), thw, seed=rng_seed)
                      for i in indices])
        z = self.vae.encode(torch.from_numpy(x),
                            PTR.encode_noise(self.seed, rng_seed))
        return z.float().numpy()


def test_raw_video_training_equals_training_on_its_latents(tmp_path):
    clips = memory_clips(tmp_path, frames=(20, 1, 1, 20, 1, 1))
    vae = small_vae()
    cfg = _train_config(max_steps=4)  # the epoch: two plans of each bucket
    raw = PTR.run_training(cfg, dataset=clips, vae=vae, device="cpu")[2]
    assert {tuple(h["thw"]) for h in raw} == {(1, 144, 256), (17, 144, 256)}
    lat = PTR.run_training(cfg, dataset=EncodedLatents(clips, vae, cfg.seed),
                           vae=vae, device="cpu")[2]
    assert [h["loss"] for h in raw] == [h["loss"] for h in lat]
    assert all(h["data_seconds"] > 0 for h in raw)


def test_threaded_latent_reads_equal_np_load(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        lat, txt = tmp_path / f"latent_{i}.npy", tmp_path / f"text_{i}.npz"
        np.save(lat, rng.standard_normal((4, 2, 3, 5)).astype(np.float16))
        np.savez(txt, y=rng.standard_normal((8, 16)).astype(np.float16),
                 mask=np.arange(8) < i % 8 + 1)
        rows.append({"latent_path": str(lat), "text_path": str(txt),
                     "num_frames": 17, "height": 144, "width": 256})
    ds = PD.PreprocessedLatentDataset(_write_csv(tmp_path / "p.csv", rows),
                                      num_workers=3)
    ds.prefetch(range(12))
    ds.prefetch([3, 1, 7])  # already in flight
    for idx in ([3, 1, 7], [0], list(range(12)), [11, 11]):
        got = ds.load_latents(idx, (2, 3, 5))
        want = np.stack([np.load(rows[i]["latent_path"]) for i in idx])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.astype(np.float32))
    assert not ds._pending
    with pytest.raises(ValueError, match="bucket wants"):
        ds.load_latents([2], (2, 3, 6))
    y, mask = ds.text_embeds([5, 0])
    with np.load(rows[5]["text_path"]) as z:
        np.testing.assert_array_equal(y[0], z["y"].astype(np.float32))
        np.testing.assert_array_equal(mask[0], z["mask"])
    ds.close()


def _load_example(relpath):
    spec = importlib.util.spec_from_file_location(
        relpath.replace("/", "_")[:-3], ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_preprocess_layout_equals_the_jax_example(tmp_path):
    """`--tiny` preprocess of one video CSV by the JAX example and by the
    port: the same files, CSV, dtypes and shapes, and (the stub text
    encoder being the same) the same text embeddings."""
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("pandas")
    path = str(tmp_path / "v.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 8, (48, 40))
    for frame in _clip(0, (9, 40, 48, 3)):
        writer.write(frame)
    writer.release()
    csv_path = _write_csv(tmp_path / "videos.csv",
                          _video_rows([path, path], 9, (40, 48)))
    flags = ["--csv", csv_path, "--tiny", "--bucket-frames", "5",
             "--height", "16", "--width", "24"]
    want_csv = _load_example("examples/training/open_sora/preprocess.py").main(
        flags + ["--outdir", str(tmp_path / "jax")])
    got_csv = PP.main(flags + ["--outdir", str(tmp_path / "port"),
                               "--device", "cpu"])
    want, got = PD.read_csv(want_csv), PD.read_csv(got_csv)
    assert list(got[0]) == list(want[0])
    for w, g in zip(want, got):
        for key in ("path", "text", "num_frames", "height", "width"):
            assert g[key] == w[key]
        for key in ("latent_path", "text_path"):
            assert os.path.basename(g[key]) == os.path.basename(w[key])
        wl, gl = np.load(w["latent_path"]), np.load(g["latent_path"])
        assert (gl.dtype, gl.shape) == (wl.dtype, wl.shape) == \
            (np.float16, (4, 2, 8, 12))
        with np.load(w["text_path"]) as wz, np.load(g["text_path"]) as gz:
            assert sorted(gz.files) == sorted(wz.files) == ["mask", "y"]
            for k in ("y", "mask"):
                assert gz[k].dtype == wz[k].dtype
                np.testing.assert_array_equal(gz[k], wz[k])


def test_preprocess_round_trip_into_training(tmp_path):
    """Latents written by `preprocess` read back bit for bit, and train."""
    clips, vae = memory_clips(tmp_path, frames=(1,) * 4), small_vae()
    out_csv = PP.preprocess(clips, vae, StubTextEncoder(16, 8, device="cpu"),
                            (1, 144, 256), str(tmp_path / "lat"), seed=2,
                            device="cpu")
    ds = PD.PreprocessedLatentDataset(out_csv, num_workers=2)
    assert ds.shapes() == clips.shapes()
    for i in range(4):
        with torch.no_grad():
            z = vae.encode(torch.from_numpy(clips.load_video(i, (1, 144, 256),
                                                             seed=2))[None],
                           PTR.encode_noise(2, i))
        np.testing.assert_array_equal(
            ds.load_latents([i], (1, 18, 32))[0],
            z[0].numpy().astype(np.float16).astype(np.float32))
    cfg = _train_config(bucket_config={"144p": {1: (1.0, 2)}}, max_steps=2)
    state, _, history = PTR.run_training(cfg, dataset=ds, vae=vae, device="cpu",
                                         text_embed_fn=ds.text_embeds)
    ds.close()
    assert state.step == 2 and np.isfinite([h["loss"] for h in history]).all()


def test_cli_trains_the_tiny_config(tmp_path):
    flags = ["--tiny", "--device", "cpu", "--warmup-steps", "1",
             "--dataset-size", "8", "--ckpt-dir", str(tmp_path)]
    step, history = cli.main(flags + ["--max-steps", "2"])
    assert step == 2 and len(history) == 0  # logged every 10 steps
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump({"max-steps": 1, "lr": 5e-4}))
    assert cli.main(flags + ["--config", str(path)])[0] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--tiny", "--max-steps", "1"])


def test_port_imports_without_pandas_opencv_or_yaml():
    """Every module of the port imports with pandas, cv2 and yaml made
    unimportable, and pulls in neither JAX nor the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('pandas', 'cv2', 'yaml'): sys.modules[name] = None\n"
        "import videosys_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "videosys_tpu_torch.__path__, 'videosys_tpu_torch.')]\n"
        "assert 'videosys_tpu_torch.training.cli' in mods, mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'flax', 'optax', 'videosys_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)

"""Training datasets (numpy only; a copy of
`videosys_tpu/training/datasets.py` without the raw-video transforms and
the native read pool, which are not ported yet).

Behavioral reference: `videosys/training/datasets/open_sora/datasets.py`
(VariableVideoTextDataset :131-228, DummyVariableVideoTextDataset :229-448
with zipf/uniform synthetic size distributions, preprocessed-latents mode)
and `utils.py:239-336` (MaskGenerator).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Sample:
    index: int
    num_frames: int
    height: int
    width: int
    text: str
    path: Optional[str] = None


class VariableVideoTextDataset:
    """CSV-driven dataset: columns (path, text, num_frames, height, width)
    (datasets.py:131-228). Video pixels are loaded lazily per item; when only
    shapes are needed (bucketing/profiling) no IO happens."""

    def __init__(self, csv_path: str, transform=None):
        import pandas as pd

        self.df = pd.read_csv(csv_path)
        self.transform = transform

    def __len__(self):
        return len(self.df)

    def shape_of(self, i: int) -> Tuple[int, int, int]:
        row = self.df.iloc[i]
        return int(row["num_frames"]), int(row["height"]), int(row["width"])

    def shapes(self) -> List[Tuple[int, int, int]]:
        return [self.shape_of(i) for i in range(len(self))]

    def __getitem__(self, i: int) -> Sample:
        row = self.df.iloc[i]
        return Sample(i, int(row["num_frames"]), int(row["height"]),
                      int(row["width"]), str(row.get("text", "")),
                      row.get("path"))

    def load_video(self, i: int, target_thw: Tuple[int, int, int],
                   frame_interval: int = 1, seed: int = 0) -> np.ndarray:
        """Read + transform to the bucket shape -> [C, T, H, W] in [-1, 1]."""
        raise NotImplementedError(
            "raw-video loading (the video transforms) is not ported yet; "
            "train from pre-encoded latents (PreprocessedLatentDataset)")


def temporal_random_crop(total: int, num_frames: int, frame_interval: int,
                         seed: int = 0) -> np.ndarray:
    """Frame indices of a random temporal window (reference
    training/datasets/open_sora/utils.py:76-86)."""
    span = min(num_frames * frame_interval, total)
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, max(total - span, 0) + 1))
    idx = np.arange(start, start + span, frame_interval)[:num_frames]
    if len(idx) == 0:
        idx = np.zeros((1,), np.int64)
    return idx


class DummyVariableVideoTextDataset:
    """Synthetic dataset with zipf/uniform size distributions
    (datasets.py:229-448, _build_dummy_dataset :268). Used by the scheduler
    dry-run test (tests/test_sampler.py in the reference)."""

    def __init__(
        self,
        size: int = 1000,
        distribution: str = "zipf",  # zipf | uniform
        seed: int = 0,
        frames_choices: Tuple[int, ...] = (1, 34, 51, 102),
        resolution_choices: Tuple[Tuple[int, int], ...] = (
            (144, 256), (240, 426), (360, 640), (480, 854), (720, 1280)),
        in_channels: int = 4,
    ):
        rng = np.random.default_rng(seed)
        self.in_channels = in_channels
        if distribution == "zipf":
            f_w = 1.0 / np.arange(1, len(frames_choices) + 1) ** 1.5
            r_w = 1.0 / np.arange(1, len(resolution_choices) + 1) ** 1.5
        else:
            f_w = np.ones(len(frames_choices))
            r_w = np.ones(len(resolution_choices))
        f_w, r_w = f_w / f_w.sum(), r_w / r_w.sum()
        fi = rng.choice(len(frames_choices), size=size, p=f_w)
        ri = rng.choice(len(resolution_choices), size=size, p=r_w)
        self._shapes = [
            (frames_choices[a], *resolution_choices[b]) for a, b in zip(fi, ri)
        ]

    def __len__(self):
        return len(self._shapes)

    def shapes(self) -> List[Tuple[int, int, int]]:
        return list(self._shapes)

    def shape_of(self, i: int) -> Tuple[int, int, int]:
        return self._shapes[i]

    def load_latents(self, indices, latent_thw, rng_seed: int = 0) -> np.ndarray:
        """Synthetic pre-encoded latents [B, C, T', h, w] (ProfileDataIter
        semantics, profiler.py:121-149)."""
        rng = np.random.default_rng(rng_seed)
        t, h, w = latent_thw
        return rng.standard_normal(
            (len(indices), self.in_channels, t, h, w)).astype(np.float32)


class MaskGenerator:
    """Frame-conditioning mask sampler (utils.py:239-336): mixes mask types
    by ratio; returns bool [B, T] (True = denoise this frame)."""

    TYPES = ("identity", "random", "mask_head", "mask_tail", "mask_head_tail",
             "quarter_head", "quarter_tail", "quarter_head_tail",
             "interpolate", "image")

    def __init__(self, mask_ratios: dict):
        assert abs(sum(mask_ratios.values()) - 1.0) < 1e-6
        for k in mask_ratios:
            assert k in self.TYPES, f"unknown mask type {k}"
        self.types = list(mask_ratios.keys())
        self.probs = np.array([mask_ratios[k] for k in self.types])

    def _single(self, T: int, rng) -> np.ndarray:
        kind = rng.choice(self.types, p=self.probs)
        mask = np.ones(T, dtype=bool)
        if T == 1 or kind == "identity":
            return mask
        if kind == "image":
            return mask  # single-frame handled upstream
        edit = max(1, int(rng.integers(1, max(2, T // 4))))
        quarter = max(1, T // 4)
        if kind == "random":
            mask[rng.choice(T, size=edit, replace=False)] = False
        elif kind == "mask_head":
            mask[:edit] = False
        elif kind == "mask_tail":
            mask[-edit:] = False
        elif kind == "mask_head_tail":
            mask[:edit] = False
            mask[-edit:] = False
        elif kind == "quarter_head":
            mask[:quarter] = False
        elif kind == "quarter_tail":
            mask[-quarter:] = False
        elif kind == "quarter_head_tail":
            mask[:quarter] = False
            mask[-quarter:] = False
        elif kind == "interpolate":
            mask[::2] = False
        return mask

    def __call__(self, batch: int, T: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return np.stack([self._single(T, rng) for _ in range(batch)])


def prepare_dataloader(dataset, bucket_config: dict, batch_multiplier: int = 1,
                       seed: int = 0, planner=None, frame_interval: int = 1,
                       drop_last: bool = True):
    """API-parity shim for the reference's `prepare_dataloader`
    (training/datasets/open_sora/dataloader.py:25-103): builds the bucket +
    sampler pair; iteration yields `BatchPlan`s whose `micro_batches()` are
    the collated gas groups (batches are assembled on the host by the train
    loop)."""
    from videosys_tpu_torch.training.buckets import Bucket
    from videosys_tpu_torch.training.sampler import VariableVideoBatchSampler

    bucket = Bucket(bucket_config)
    sampler = VariableVideoBatchSampler(
        bucket, dataset.shapes(), batch_multiplier=batch_multiplier,
        seed=seed, planner=planner, frame_interval=frame_interval,
        drop_last=drop_last)
    return sampler, bucket


class PreprocessedLatentDataset:
    """Pre-encoded training data: latent_{i}.npy + text_{i}.npz files and a
    preprocessed.csv with the original pixel shapes for bucketing (columns
    num_frames, height, width, latent_path, text_path). Files are read with
    numpy; the JAX package's native read pool is not ported."""

    def __init__(self, csv_path: str):
        import pandas as pd

        self.df = pd.read_csv(csv_path)

    def __len__(self):
        return len(self.df)

    def shape_of(self, i: int) -> Tuple[int, int, int]:
        row = self.df.iloc[i]
        return int(row["num_frames"]), int(row["height"]), int(row["width"])

    def shapes(self) -> List[Tuple[int, int, int]]:
        return [self.shape_of(i) for i in range(len(self))]

    def __getitem__(self, i: int) -> Sample:
        row = self.df.iloc[i]
        return Sample(i, int(row["num_frames"]), int(row["height"]),
                      int(row["width"]), str(row.get("text", "")),
                      row.get("latent_path"))

    def load_latents(self, indices, latent_thw, rng_seed: int = 0) -> np.ndarray:
        """[B, C, t, h, w] float32."""
        lat = np.stack([np.load(str(self.df.iloc[int(i)]["latent_path"]))
                        for i in indices])
        if tuple(lat.shape[2:]) != tuple(latent_thw):
            raise ValueError(
                f"preprocessed latents are {lat.shape[2:]}, bucket wants "
                f"{tuple(latent_thw)}: encode them at the bucket's "
                f"(frames, height, width)")
        return lat.astype(np.float32)

    def text_embeds(self, indices):
        """(y [B, L, D] float32, kv_mask [B, L] bool) from the stored npz:
        the `text_embed_fn` of `run_training`."""
        ys, masks = [], []
        for i in indices:
            with np.load(str(self.df.iloc[int(i)]["text_path"])) as z:
                ys.append(np.asarray(z["y"], np.float32))
                masks.append(np.asarray(z["mask"], bool))
        return np.stack(ys), np.stack(masks)

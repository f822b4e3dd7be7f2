"""Training datasets (numpy; CSVs read with the standard `csv` module).

Port of `videosys_tpu/training/datasets.py`. Behavioral reference:
`videosys/training/datasets/open_sora/datasets.py` (VariableVideoTextDataset
:131-228, DummyVariableVideoTextDataset :229-448 with zipf/uniform synthetic
size distributions, preprocessed-latents mode) and `utils.py:239-336`
(MaskGenerator). The JAX package reads its CSVs with pandas and its
preprocessed latents on a native read pool; here the rows are dicts of
strings from `csv.DictReader` and the reads run on a thread pool.
"""

from __future__ import annotations

import csv
import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from videosys_tpu_torch.training.video_transforms import get_transforms_video


@dataclasses.dataclass
class Sample:
    index: int
    num_frames: int
    height: int
    width: int
    text: str
    path: Optional[str] = None


def read_csv(path: str) -> List[Dict[str, str]]:
    """The rows of a CSV file with a header line, as dicts of strings."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class _CsvRows:
    """Rows of a CSV with the pixel shape columns num_frames, height,
    width; `path_column` names the file a `Sample` points at."""

    path_column = "path"

    def __init__(self, csv_path: str):
        self.rows = read_csv(csv_path)

    def __len__(self):
        return len(self.rows)

    def shape_of(self, i: int) -> Tuple[int, int, int]:
        row = self.rows[i]
        return int(row["num_frames"]), int(row["height"]), int(row["width"])

    def shapes(self) -> List[Tuple[int, int, int]]:
        return [self.shape_of(i) for i in range(len(self))]

    def __getitem__(self, i: int) -> Sample:
        row = self.rows[i]
        return Sample(i, *self.shape_of(i), row.get("text", ""),
                      row.get(self.path_column))


class VariableVideoTextDataset(_CsvRows):
    """CSV-driven dataset: columns (path, text, num_frames, height, width)
    (datasets.py:131-228). Video pixels are loaded lazily per item; when only
    shapes are needed (bucketing/profiling) no IO happens."""

    def __init__(self, csv_path: str, transform=None):
        super().__init__(csv_path)
        self.transform = transform

    def read_frames(self, i: int, keep: np.ndarray) -> np.ndarray:
        """Decode frames `keep` (ascending indices) of row i's video ->
        uint8 [len(keep), H, W, 3] RGB, read with OpenCV as the JAX package
        does (read_video.py read_video_cv2 :213-248); a video shorter than
        `keep` repeats its last frame. A dataset whose frames come from
        elsewhere overrides this method only."""
        try:
            import cv2
        except ImportError as e:
            raise ImportError("decoding video files needs OpenCV (cv2), as "
                              "in the JAX package; it is not installed") from e
        path = self[i].path
        cap = cv2.VideoCapture(path)
        want = set(keep.tolist())
        frames, idx = [], 0
        while idx <= int(keep[-1]) and len(frames) < len(keep):
            ok, frame = cap.read()
            if not ok:
                break
            if idx in want:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            idx += 1
        cap.release()
        if not frames:
            raise IOError(f"cannot read {path}")
        frames += frames[-1:] * (len(keep) - len(frames))
        return np.stack(frames)

    def load_video(self, i: int, target_thw: Tuple[int, int, int],
                   frame_interval: int = 1, seed: int = 0) -> np.ndarray:
        """Read + transform to the bucket shape -> [C, T, H, W] in [-1, 1]
        (datasets.py:54-88): a random window of T frames strided by
        `frame_interval` (temporal_random_crop, utils.py:76-86, seeded by
        seed + i) over the row's num_frames, its decode, then the transform
        (default "resize_crop" to (H, W)). The JAX package takes the clip
        length from the video container and falls back to num_frames; here
        num_frames is the clip length, so the decode can be replaced."""
        T, H, W = target_thw
        keep = temporal_random_crop(self.shape_of(i)[0], T, frame_interval,
                                    seed + i)
        clip = self.read_frames(i, keep)
        if len(clip) < T:  # a clip shorter than T repeats its last frame
            clip = np.concatenate([clip, np.repeat(clip[-1:], T - len(clip), 0)])
        tfm = self.transform or get_transforms_video("resize_crop", (H, W))
        return np.ascontiguousarray(np.transpose(tfm(clip), (3, 0, 1, 2)))


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


class PreprocessedLatentDataset(_CsvRows):
    """Pre-encoded training data, as `training/preprocess.py` writes it:
    latent_{i}.npy + text_{i}.npz files and a preprocessed.csv with the
    original pixel shapes for bucketing (columns num_frames, height, width,
    latent_path, text_path).

    The counterpart of the JAX package's native read pool
    (`videosys_tpu/native`): the latent files are read by a pool of
    `num_workers` threads (numpy's file reads release the interpreter
    lock). `load_latents` submits every file of a micro-batch before it
    waits on any, and `prefetch` lets the training loop queue a whole
    plan's reads behind the current step. `close()` stops the pool."""

    path_column = "latent_path"

    def __init__(self, csv_path: str, num_workers: int = 4):
        super().__init__(csv_path)
        if num_workers < 1:
            raise ValueError("num_workers must be at least 1")
        self._pool = ThreadPoolExecutor(num_workers,
                                        thread_name_prefix="latent-read")
        self._pending: Dict[int, Future] = {}

    def _submit(self, i: int) -> None:
        if i not in self._pending:
            self._pending[i] = self._pool.submit(
                np.load, self.rows[i]["latent_path"])

    def _read(self, i: int) -> np.ndarray:
        self._submit(i)  # a row asked for twice is read twice
        return self._pending.pop(i).result()

    def prefetch(self, indices) -> None:
        """Queue the latent reads of `indices`; indices already in flight
        are left as they are."""
        for i in indices:
            self._submit(int(i))

    def load_latents(self, indices, latent_thw, rng_seed: int = 0) -> np.ndarray:
        """[B, C, t, h, w] float32. Submits all of `indices` before waiting on
        any, so a micro-batch's files stream concurrently."""
        self.prefetch(indices)
        lat = np.stack([self._read(int(i)) for i in indices])
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
            with np.load(self.rows[int(i)]["text_path"]) as z:
                ys.append(np.asarray(z["y"], np.float32))
                masks.append(np.asarray(z["mask"], bool))
        return np.stack(ys), np.stack(masks)

    def close(self) -> None:
        """Stop the read pool; reads not yet waited on are dropped."""
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._pending.clear()

"""Bucket system for variable-length/resolution video training (numpy only;
a copy of `videosys_tpu/training/buckets.py`).

Behavioral reference: `videosys/training/datasets/open_sora/bucket.py:31-151`
(+ aspect tables `aspect.py:446-477`, shared here with the inference-side
resolution data). A bucket is (resolution_name, num_frames, aspect_name) with
per-bucket keep-probability and batch size, matched by: resolution >= 0.8x
bucket pixels, frames >= bucket frames x interval, closest aspect ratio.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Optional, Tuple

import numpy as np

from videosys_tpu_torch.pipelines.open_sora.data_process import RESOLUTIONS

BucketId = Tuple[str, int, str]


def get_closest_ratio(height: float, width: float, ratios: dict) -> str:
    aspect = height / width
    return min(ratios.keys(), key=lambda r: abs(float(r) - aspect))


class Bucket:
    """bucket_config: {resolution_name: {num_frames: (prob, batch_size)}}
    (bucket.py:31-80). prob may be (prob_hw, prob_t) for 2-level sampling."""

    def __init__(self, bucket_config: dict):
        for key in bucket_config:
            assert key in RESOLUTIONS, f"unknown resolution bucket {key}"
        names = sorted(bucket_config.keys(),
                       key=lambda x: RESOLUTIONS[x]["pixels"], reverse=True)
        self.bucket_probs = OrderedDict()
        self.bucket_bs = OrderedDict()
        self.bucket_index = OrderedDict()
        idx = 0
        for k in names:
            t_names = sorted(bucket_config[k].keys(), reverse=True)
            self.bucket_probs[k] = OrderedDict(
                (t, bucket_config[k][t][0]) for t in t_names)
            self.bucket_bs[k] = OrderedDict(
                (t, bucket_config[k][t][1]) for t in t_names)
            self.bucket_index[k] = {}
            for t in t_names:
                self.bucket_index[k][t] = idx
                idx += 1
        self.hw_criteria = {k: RESOLUTIONS[k]["pixels"] for k in names}
        self.ar_criteria = {k: RESOLUTIONS[k]["table"] for k in names}
        self.num_bucket = sum(
            len(self.ar_criteria[k]) * len(v) for k, v in self.bucket_probs.items())

    def get_bucket_id(
        self, T: int, H: int, W: int, frame_interval: int = 1,
        seed: Optional[int] = None,
    ) -> Optional[BucketId]:
        """Probabilistic bucket assignment (bucket.py:82-126)."""
        resolution = H * W
        approx = 0.8
        fail = True
        for hw_id, t_criteria in self.bucket_probs.items():
            if resolution < self.hw_criteria[hw_id] * approx:
                continue
            if T == 1:  # image
                if 1 not in t_criteria:
                    continue
                rng = np.random.default_rng(
                    (seed or 0) + self.bucket_index[hw_id][1])
                if rng.random() < t_criteria[1]:
                    fail, t_id = False, 1
                    break
                continue
            t_fail = True
            for t_id, prob in t_criteria.items():
                rng = np.random.default_rng(
                    (seed or 0) + self.bucket_index[hw_id][t_id])
                if isinstance(prob, Iterable) and not isinstance(prob, str):
                    if rng.random() > prob[1]:
                        continue
                if T >= t_id * frame_interval and t_id != 1:
                    t_fail = False
                    break
            if t_fail:
                continue
            if isinstance(prob, Iterable) and not isinstance(prob, str):
                prob = prob[0]
            if prob >= 1 or rng.random() < prob:
                fail = False
                break
        if fail:
            return None
        ar_id = get_closest_ratio(H, W, self.ar_criteria[hw_id])
        return hw_id, t_id, ar_id

    def get_thw(self, bucket_id: BucketId) -> Tuple[int, int, int]:
        hw_id, t_id, ar_id = bucket_id
        h, w = self.ar_criteria[hw_id][ar_id]
        return t_id, int(h), int(w)

    def get_batch_size(self, bucket_id: BucketId) -> int:
        return self.bucket_bs[bucket_id[0]][bucket_id[1]]

    def __len__(self):
        return self.num_bucket

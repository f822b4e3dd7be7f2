"""Training of the port: `run_training(TrainConfig(...))`, the DCP profiler,
pre-extraction of latents (`preprocess`) and the datasets."""

from videosys_tpu_torch.core.dcp import BucketProfile, Profiler
from videosys_tpu_torch.training.datasets import PreprocessedLatentDataset
from videosys_tpu_torch.training.preprocess import preprocess
from videosys_tpu_torch.training.train import TrainConfig, run_training

__all__ = ["BucketProfile", "PreprocessedLatentDataset", "Profiler",
           "TrainConfig", "preprocess", "run_training"]

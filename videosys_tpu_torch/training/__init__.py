"""Training of the port: `run_training(TrainConfig(...))`."""

from videosys_tpu_torch.training.train import TrainConfig, run_training

__all__ = ["TrainConfig", "run_training"]

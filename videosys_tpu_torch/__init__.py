"""videosys_tpu_torch: the PyTorch/CUDA port of videosys_tpu.

Same public surface, `VideoSysEngine(config).generate(prompt)` and
`run_training(TrainConfig(...))`, on one NVIDIA card (or the CPU with
`device="cpu"`). Imports torch only; the CUDA kernels build at first use.
"""

from videosys_tpu_torch.core.engine import VideoSysEngine
from videosys_tpu_torch.pipelines.open_sora.pipeline_open_sora import (
    OpenSoraConfig,
    OpenSoraPipeline,
)

from videosys_tpu_torch.training.train import TrainConfig, run_training

__all__ = ["VideoSysEngine", "OpenSoraConfig", "OpenSoraPipeline",
           "TrainConfig", "run_training"]

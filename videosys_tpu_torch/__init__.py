"""videosys_tpu_torch: the PyTorch/CUDA port of videosys_tpu.

Same public surface, `initialize`, `VideoSysEngine(config).generate(prompt)`
(Open-Sora v1.2, CogVideoX, Latte, Open-Sora-Plan v1.1 / v1.2 and
Vchitect-2.0 configs),
`run_training(TrainConfig(...))`
with the DCP `Profiler`, and `preprocess`,
on one NVIDIA card (or the CPU with `device="cpu"`). Imports torch only;
the CUDA kernels build at first use.
"""

from videosys_tpu_torch.core.dcp import BucketProfile, Profiler
from videosys_tpu_torch.core.engine import VideoSysEngine, initialize
from videosys_tpu_torch.core.pab import PABConfig
from videosys_tpu_torch.pipelines.cogvideox.pipeline_cogvideox import (
    CogVideoXConfig,
    CogVideoXPABConfig,
    CogVideoXPipeline,
)
from videosys_tpu_torch.pipelines.latte.pipeline_latte import (
    LatteConfig,
    LattePABConfig,
    LattePipeline,
)
from videosys_tpu_torch.pipelines.open_sora.pipeline_open_sora import (
    OpenSoraConfig,
    OpenSoraPABConfig,
    OpenSoraPipeline,
)
from videosys_tpu_torch.pipelines.open_sora_plan.pipeline_open_sora_plan import (
    OpenSoraPlanConfig,
    OpenSoraPlanPipeline,
    OpenSoraPlanV110PABConfig,
    OpenSoraPlanV120PABConfig,
)
from videosys_tpu_torch.pipelines.vchitect.pipeline_vchitect import (
    VchitectConfig,
    VchitectPABConfig,
    VchitectXLPipeline,
)
from videosys_tpu_torch.training.datasets import PreprocessedLatentDataset
from videosys_tpu_torch.training.preprocess import preprocess
from videosys_tpu_torch.training.train import TrainConfig, run_training

__all__ = ["VideoSysEngine", "initialize", "BucketProfile", "CogVideoXConfig",
           "CogVideoXPABConfig", "CogVideoXPipeline", "LatteConfig",
           "LattePABConfig", "LattePipeline", "OpenSoraConfig",
           "OpenSoraPABConfig", "OpenSoraPipeline", "OpenSoraPlanConfig",
           "OpenSoraPlanPipeline", "OpenSoraPlanV110PABConfig",
           "OpenSoraPlanV120PABConfig", "PABConfig",
           "PreprocessedLatentDataset", "Profiler", "TrainConfig",
           "VchitectConfig", "VchitectPABConfig", "VchitectXLPipeline",
           "preprocess", "run_training"]

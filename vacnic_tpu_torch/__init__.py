"""vacnic_tpu_torch — the PyTorch/CUDA port of vacnic_tpu for NVIDIA Hopper.

The package mirrors vacnic_tpu's layout (core/ models/ kernels/ infer/ data/
train/ eval/ runtime/) module for module, so each port module has one JAX counterpart that
the tests hold it against. It imports torch and numpy only: never jax and
never vacnic_tpu. The hot path's TPU kernels are hand-written CUDA C++ for
sm_90a under kernels/csrc/, each with a plain-PyTorch twin that CPU tensors
take.
"""

__version__ = "0.1.0"

from vacnic_tpu_torch.core.config import (  # noqa: F401
    BartConfig,
    ClipVisionConfig,
    DecodeConfig,
    FusionConfig,
    TrainConfig,
    VacnicConfig,
)

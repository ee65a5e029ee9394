"""PyTorch + CUDA port of gsdf_slam_tpu for one NVIDIA H100.

The JAX package `gsdf_slam_tpu` is the reference this port is held
against. This package never imports jax. Its hand-written Hopper kernels
(csrc/) are built at first use by `kernels.py`; on CPU tensors every
kernel wrapper takes its plain PyTorch version instead.
"""

from .config import ModelParams, OptimizationParams, PipelineParams

__all__ = ["ModelParams", "OptimizationParams", "PipelineParams"]

"""Configuration dataclasses mirroring include/gaussian_parameters.h.

Same fields and defaults as the JAX package's `gsdf_slam_tpu/config.py`
(the reference's compiled-in defaults, gaussian_parameters.h:25-103).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """GaussianModelParams (gaussian_parameters.h:22-45)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    resolution: float = -1.0
    white_background: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    """GaussianPipelineParams (gaussian_parameters.h:48-60)."""

    convert_SHs: bool = False
    compute_cov3D: bool = False
    separate_sh: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    """GaussianOptimizationParams (gaussian_parameters.h:63-103)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002

"""Live-tunable training hyperparameters (the viewer's slider channel).

Port of `gsdf_slam_tpu/engine/variable_params.py`, VariableParameters +
get/setVaribleParameters (include/gaussian_mapper.h:79-97,
src/gaussian_mapper.cpp:941-982): a snapshot struct the viewer reads,
edits, and writes back while training runs. The port's `train_step` takes
its hyperparameters as plain floats, so an edit takes effect at the next
step.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class VariableParameters:
    position_lr_init: float
    feature_lr: float
    opacity_lr: float
    scaling_lr: float
    rotation_lr: float
    percent_dense: float
    lambda_dssim: float
    opacity_reset_interval: int
    densify_grad_th: float
    densify_interval: int
    new_kf_times_of_use: int
    stable_num_iter_existence: int = 0
    keep_training: bool = True
    do_gaus_pyramid_training: bool = False
    do_inactive_geo_densify: bool = False

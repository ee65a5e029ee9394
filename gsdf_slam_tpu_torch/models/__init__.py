from .gaussian_model import (
    DensifyCounts, GaussianModel, densify_and_prune, increase_pcd, prune_young, reset_opacity, voxel_hash,
)
from .optimizer import AdamState, adam_step, expon_lr, group_lrs

__all__ = [
    "AdamState", "DensifyCounts", "GaussianModel", "adam_step", "densify_and_prune", "expon_lr", "group_lrs",
    "increase_pcd", "prune_young", "reset_opacity", "voxel_hash",
]

from .gaussian_model import GaussianModel
from .optimizer import AdamState, adam_step, expon_lr, group_lrs

__all__ = ["AdamState", "GaussianModel", "adam_step", "expon_lr", "group_lrs"]

"""Host utilities: SE(3) algebra, the Lie groups and coordinate conversions,
numpy only (copies of the JAX package's `utils/`, which the port does not
import)."""

from .coordinates import change_world_system, convert_points, convert_pose
from .lie import SE3, SO3, RxSO3, Sim3, interpolate
from .se3 import rotation_angle, se3_exp, se3_inverse, se3_log, so3_exp, so3_log

__all__ = [
    "SE3", "SO3", "RxSO3", "Sim3", "change_world_system", "convert_points", "convert_pose", "interpolate",
    "rotation_angle", "se3_exp", "se3_inverse", "se3_log", "so3_exp", "so3_log",
]

from .keyframe import Camera, Keyframe
from .mapper import GaussianMapper
from .scene import Scene
from .settings import MapperSettings
from .train import StepMetrics, render_depth_state, render_state, train_step

__all__ = ["Camera", "GaussianMapper", "Keyframe", "MapperSettings", "Scene", "StepMetrics", "render_depth_state",
           "render_state", "train_step"]

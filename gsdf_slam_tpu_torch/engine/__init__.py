from .keyframe import Camera, Keyframe
from .scene import Scene
from .settings import MapperSettings
from .train import StepMetrics, render_depth_state, render_state, train_step

__all__ = ["Camera", "Keyframe", "MapperSettings", "Scene", "StepMetrics", "render_depth_state", "render_state",
           "train_step"]

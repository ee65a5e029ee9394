from .train import StepMetrics, render_state, train_step

__all__ = ["StepMetrics", "render_state", "train_step"]

from .projection import Preprocessed, preprocess, tile_grid
from .rasterize import RasterizeConfig, RenderOutput, render, render_preprocessed
from .transforms import CameraMatrices

__all__ = [
    "CameraMatrices", "Preprocessed", "RasterizeConfig", "RenderOutput",
    "preprocess", "render", "render_preprocessed", "tile_grid",
]

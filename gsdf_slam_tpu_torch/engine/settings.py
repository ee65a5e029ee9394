"""Mapper settings: the cv::FileStorage-style YAML of the reference.

Port of `gsdf_slam_tpu/engine/settings.py`. readConfigFromFile
(gaussian_mapper.cpp:69-146) reads flat dotted keys from OpenCV YAML.
Those files start with the OpenCV-only `%YAML:1.0` directive, so the flat
`Key.name: value` lines are parsed directly instead of with a YAML library.

Parity quirk kept: the reference looks up "Optimization.densify_from_iter_"
(trailing underscore) while every config writes "densify_from_iter", so it
always reads 0. That is replicated (and the correctly spelled key is read
when the misspelled one is absent, which matches the observed behaviour,
since cv::FileStorage returns 0 for missing keys).

The JAX package's `presize_capacity`, `presize_max_pairs` and
`auto_size_pairs_setting` (keys Mapper.presize_capacity,
Mapper.presize_max_pairs, Mapper.auto_size_pairs) size its fixed
capacities; the port sizes the map and the pairs exactly, so it has none.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from ..config import ModelParams, OptimizationParams, PipelineParams


def parse_opencv_yaml(path: str | Path) -> dict[str, float | int | str]:
    out: dict[str, float | int | str] = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or line.startswith("%") or ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip(), val.strip()
        if not val:
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val.strip('"')
    return out


@dataclasses.dataclass
class MapperSettings:
    model: ModelParams = ModelParams()
    pipe: PipelineParams = PipelineParams()
    opt: OptimizationParams = OptimizationParams()
    z_near: float = 0.01
    z_far: float = 100.0
    new_keyframe_times_of_use: int = 1
    do_gaus_pyramid_training: bool = False
    num_gaus_pyramid_sub_levels: int = 0
    gaus_pyramid_sub_level_times_of_use: int = 0
    keyframe_record_interval: int = 0
    training_report_interval: int = 0
    prune_big_point_after_iter: int = 30_000
    densify_min_opacity: float = 0.005
    viewer_image_scale: float = 1.0
    skyseg_onnx_path: str = ""  # optional; reference hardcodes skyseg.onnx
    # SLAM-era machinery (include/gaussian_mapper.h:252-275 members; the
    # fork keeps the knobs and the Photo-SLAM configs set them).
    do_inactive_geo_densify: bool = True  # inactive_geo_densify_ = true (:258)
    max_depth_cached: int = 1  # max_depth_cached_ = 1 (:260)
    inactive_geo_densify_max_pixel_dist: float = 20.0  # (:252)
    monocular_init_depth: float = 2.0  # bootstrap prior when no geometry yet
    stable_num_iter_existence: int = 0  # 0 = disabled (:275)
    large_rotation_threshold: float = 0.1  # ctor default (gaussian_mapper.cpp:17)
    large_translation_threshold: float = 0.01  # (:18)
    # cached binning: each (keyframe, pyramid level)'s pair permutation is
    # reused for up to rebin_interval - 1 renders before a fresh binning;
    # 1 = the reference's semantics (rebin every iteration,
    # rasterizer_impl.cu:456-500). Caches are dropped on every surgery.
    rebin_interval: int = 1
    # the same after opt.densify_until_iter, when the map no longer changes
    # size; 0 = rebin_interval everywhere (PARITY.md D8)
    rebin_interval_after_densify: int = 8
    # train steps kept in flight before their metrics are read; 0 =
    # synchronous, the reference's semantics (it reads loss.item() every
    # iteration, gaussian_mapper.cpp:437)
    metrics_pipeline_depth: int = 0
    # device-resident ground-truth and mask image cache budget in bytes;
    # 0 disables the bound
    gt_cache_bytes: int = 4 << 30

    @staticmethod
    def from_yaml(path: str | Path) -> "MapperSettings":
        kv = parse_opencv_yaml(path)

        def g(key, default):
            return kv.get(key, default)

        model = ModelParams(
            sh_degree=int(g("Model.sh_degree", 3)),
            resolution=float(g("Model.resolution", -1.0)),
            white_background=bool(g("Model.white_background", 0)),
        )
        pipe = PipelineParams(
            convert_SHs=bool(g("Pipeline.convert_SHs", 0)),
            compute_cov3D=bool(g("Pipeline.compute_cov3D", 0)),
        )
        densify_from = int(
            g("Optimization.densify_from_iter_", g("Optimization.densify_from_iter", 0))
        )
        opt = OptimizationParams(
            iterations=int(g("Optimization.max_num_iterations", 30_000)),
            position_lr_init=float(g("Optimization.position_lr_init", 0.00016)),
            position_lr_final=float(g("Optimization.position_lr_final", 0.0000016)),
            position_lr_delay_mult=float(g("Optimization.position_lr_delay_mult", 0.01)),
            position_lr_max_steps=int(g("Optimization.position_lr_max_steps", 30_000)),
            feature_lr=float(g("Optimization.feature_lr", 0.0025)),
            opacity_lr=float(g("Optimization.opacity_lr", 0.05)),
            scaling_lr=float(g("Optimization.scaling_lr", 0.005)),
            rotation_lr=float(g("Optimization.rotation_lr", 0.001)),
            percent_dense=float(g("Optimization.percent_dense", 0.01)),
            lambda_dssim=float(g("Optimization.lambda_dssim", 0.2)),
            densification_interval=int(g("Optimization.densification_interval", 100)),
            opacity_reset_interval=int(g("Optimization.opacity_reset_interval", 3000)),
            densify_from_iter=densify_from,
            densify_until_iter=int(g("Optimization.densify_until_iter", 15_000)),
            densify_grad_threshold=float(g("Optimization.densify_grad_threshold", 0.0002)),
        )
        return MapperSettings(
            model=model,
            pipe=pipe,
            opt=opt,
            z_near=float(g("Camera.z_near", 0.01)),
            z_far=float(g("Camera.z_far", 100.0)),
            new_keyframe_times_of_use=int(g("Mapper.new_keyframe_times_of_use", 1)),
            do_gaus_pyramid_training=bool(g("GausPyramid.do", 0)),
            num_gaus_pyramid_sub_levels=int(g("GausPyramid.num_sub_levels", 0)),
            gaus_pyramid_sub_level_times_of_use=int(g("GausPyramid.sub_level_times_of_use", 0)),
            keyframe_record_interval=int(g("Record.keyframe_record_interval", 0)),
            training_report_interval=int(g("Record.training_report_interval", 0)),
            prune_big_point_after_iter=int(g("Optimization.prune_big_point_after_iter", 30_000)),
            densify_min_opacity=float(g("Optimization.densify_min_opacity", 0.005)),
            viewer_image_scale=float(g("GaussianViewer.image_scale", 1.0)),
            # The reference hardcodes /home/.../skyseg.onnx
            # (gaussian_mapper.cpp:65); a config key is the sane surface.
            skyseg_onnx_path=str(g("Mapper.skyseg_onnx_path", "")),
            do_inactive_geo_densify=bool(g("Mapper.inactive_geo_densify", 1)),
            max_depth_cached=int(g("Mapper.depth_cache", 1)),
            inactive_geo_densify_max_pixel_dist=float(
                g("Monocular.inactive_geo_densify_max_pixel_dist", 20.0)
            ),
            monocular_init_depth=float(g("Monocular.init_depth", 2.0)),
            stable_num_iter_existence=int(g("Mapper.stable_num_iter_existence", 0)),
            large_rotation_threshold=float(g("Mapper.large_rotation_threshold", 0.1)),
            large_translation_threshold=float(
                g("Mapper.large_translation_threshold", 0.01)
            ),
            rebin_interval=int(g("Mapper.rebin_interval", 1)),
            rebin_interval_after_densify=int(
                g("Mapper.rebin_interval_after_densify", 8)
            ),
            metrics_pipeline_depth=int(g("Mapper.metrics_pipeline_depth", 0)),
            gt_cache_bytes=int(g("Mapper.gt_cache_bytes", 4 << 30)),
        )

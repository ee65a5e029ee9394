"""The monocular SLAM mode on the synthetic room: a stand-in tracker, pose
corrections and a short mono stream, for chip_smoke.py phase 10 and the
tests.

ORB-SLAM3 hands Photo-SLAM a keyframe's pose, its image and the map points
it observes; `tracker_points` stands in for those map points with seeded
pixels of the frame's raycast depth (`synthetic_room.make_sequence`),
lifted into the world. The mapper's settings are the port's
cfg/tum_mono.yaml with the Gaussian pyramid off (it needs cv2).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..data import CameraIntrinsics
from ..engine import GaussianMapper, MapperSettings
from ..utils import so3_exp
from .synthetic_room import make_sequence

TUM_MONO_YAML = Path(__file__).resolve().parent.parent / "cfg" / "tum_mono.yaml"
# the short stream: frames at size x size, tracker points a keyframe and
# their reach in pixels (the yaml's 20 at a tenth of TUM's 640 columns), the
# depth cache, train steps a keyframe, the small correction (after the steps
# of keyframe, of keyframe), the large one (at and of keyframe), rebin_interval
SHORT = dict(frames=8, size=64, points=100, pixel_dist=2.0, depth_cache=2, steps=2, small=(4, 2), large=(6, 6),
             rebin=4)
SMALL_CORRECTION = (0.5, 0.01)  # degrees, metres
LARGE_CORRECTION = (35.0, 0.0)


def room_intrinsics(width: int, height: int, fov: float = np.pi / 2) -> CameraIntrinsics:
    """make_sequence's pinhole camera."""
    fx = 0.5 * width / np.tan(fov / 2)
    return CameraIntrinsics(fx=fx, fy=fx, cx=(width - 1) / 2.0, cy=(height - 1) / 2.0, width=width, height=height)


def tracker_points(t_wc, rgb, depth, n: int, seed: int, fov: float = np.pi / 2):
    """`n` seeded pixels with depth of a raycast frame, lifted into the
    world: (points [n, 3], colours [n, 3]) float32."""
    h, w = depth.shape
    intr = room_intrinsics(w, h, fov)
    ys, xs = np.nonzero(depth > 0)
    pick = np.random.default_rng(seed).choice(len(ys), size=min(n, len(ys)), replace=False)
    y, x = ys[pick], xs[pick]
    z = depth[y, x].astype(np.float64)
    pc = np.stack([(x - intr.cx) / intr.fx * z, (y - intr.cy) / intr.fy * z, z], -1)
    t = np.asarray(t_wc, np.float64)
    return (pc @ t[:3, :3].T + t[:3, 3]).astype(np.float32), rgb[y, x].astype(np.float32)


def corrected_pose(t_wc, degrees: float, metres: float, axis=(0.0, 1.0, 0.0)) -> np.ndarray:
    """A tracker's correction of camera pose `t_wc`: turned by `degrees`
    about the camera's `axis` and moved `metres` along the world x axis."""
    out = np.asarray(t_wc, np.float64).copy()
    a = np.asarray(axis, np.float64)
    out[:3, :3] = out[:3, :3] @ so3_exp(np.radians(degrees) * a / np.linalg.norm(a))
    out[0, 3] += metres
    return out.astype(np.float32)


def mono_settings(**kw) -> MapperSettings:
    """cfg/tum_mono.yaml's settings, the pyramid off, no report; `kw`
    replaces fields."""
    s = MapperSettings.from_yaml(TUM_MONO_YAML)
    return dataclasses.replace(s, do_gaus_pyramid_training=False, training_report_interval=0, **kw)


def view_z_max(model, t_cw) -> float:
    """Max |z| of the map's Gaussians in the view of camera `t_cw`."""
    t = np.asarray(t_cw, np.float64)
    xyz = model.xyz.detach().cpu().numpy().astype(np.float64)
    return float(np.abs(xyz @ t[2, :3] + t[2, 3]).max()) if len(xyz) else 1.0


def short_mono_run(device, pipeline: int = 0, frames=None) -> dict:
    """SHORT's stream on `device` with `pipeline` steps in flight: each
    keyframe fed image only with its tracker points, then its train
    steps; the large correction after its keyframe's feed, the small one
    after its keyframe's steps (an ingest drops every binning cache).
    Returns the mapper, each keyframe's samples (last_mono_samples and the
    view's z_max), the counts after each feed, the binning caches before
    and after the small correction, the counts around the large one and the
    step log. `frames` (make_sequence at SHORT's size) may be passed in."""
    c = SHORT
    size = c["size"]
    if frames is None:
        frames = make_sequence(c["frames"], size, size)
    settings = mono_settings(max_depth_cached=c["depth_cache"], inactive_geo_densify_max_pixel_dist=c["pixel_dist"],
                             rebin_interval=c["rebin"], metrics_pipeline_depth=pipeline)
    m = GaussianMapper(settings=settings, device=device)
    m.step_log = []
    intr = room_intrinsics(size, size)
    out = {"mapper": m, "samples": [], "counts": []}
    for i, (pose, rgb, depth) in enumerate(frames):
        pts, cols = tracker_points(pose, rgb, depth, c["points"], seed=i)
        m.feed_keyframe(i, pose, rgb, points=pts, colors=cols, intrinsics=intr)
        out["samples"].append({**m.last_mono_samples, "z_max": view_z_max(m.model, m.scene.keyframes[i].t_cw)})
        out["counts"].append(m.model.count)
        if i == c["large"][0]:  # before the steps: this keyframe's points are the young ones
            n0 = m.model.count
            m.update_keyframe_pose(c["large"][1], corrected_pose(pose, *LARGE_CORRECTION))
            out["large"] = (n0, m.model.count)
            out["stable"] = bool((m.model.exist_since_iter <= m.iteration - settings.stable_num_iter_existence).all())
        for _ in range(c["steps"]):
            m.train_for_one_iteration()
        if i == c["small"][0]:  # after the steps: the binning caches they left
            fid = c["small"][1]
            out["caches_before"] = sorted(m._bin_cache)
            m.update_keyframe_pose(fid, corrected_pose(np.linalg.inv(m.scene.keyframes[fid].t_cw), *SMALL_CORRECTION))
            out["caches_after"], out["small_fid"] = sorted(m._bin_cache), fid
            out["small_pruned"] = out["counts"][-1] - m.model.count
    m.flush_metrics()
    out["log"] = m.step_log
    return out


def image_only_run(device, settings: MapperSettings, frames) -> dict:
    """Keyframes fed with an image and nothing else, one step each: at the
    default settings (max_depth_cached 1) the prior's samples are the first
    Gaussians; at cfg/tum_mono.yaml's depth cache of 10 the steps before the
    first flush train an empty map. Returns the mapper, the counts after
    each feed and the step log."""
    h, w = frames[0][2].shape
    m = GaussianMapper(settings=settings, device=device)
    m.step_log = []
    counts = []
    for i, (pose, rgb, _) in enumerate(frames):
        m.feed_keyframe(i, pose, rgb, intrinsics=room_intrinsics(w, h))
        counts.append(m.model.count)
        m.train_for_one_iteration()
    return {"mapper": m, "counts": counts, "log": m.step_log}

"""The one traffic generator: a traffic file's parameters, a configuration's
sensors and a seed make the stream of keyframes a cell feeds the mapper.

Every frame is raycast on the device (`traffic/scenes.py`) in set-up and
handed over as host arrays, as a sensor's driver hands them over: the
upload is the program's.

Scenes:

* "street": the seeded periodic street; frame k is taken `step_m` metres
  down the road from frame k - 1 with a sinusoidal sway, and frames k and
  k mod N (N frames to a period) share their image and scan, the pose
  moved on by (k div N) periods. A camera image and a LiDAR scan a frame.
* "room": the box room; the warm lap is `make_sequence`'s two rings, the
  later keyframes poses inside it (yaw anywhere, a pitch and an offset from
  the centre within the traffic's limits), drawn once from the traffic's
  `pool_seed`: every seed feeds the same poses, in an order of its own. A
  camera image and a depth image a frame; or, where the sensors hold
  `"tracker": {"points_per_keyframe": N}`, a monocular stream: the camera
  image and the N map points a tracker hands over with it (`tracker_points`),
  and no depth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import scenes


@dataclass
class Frame:
    t_wc: np.ndarray  # [4, 4] float32 camera pose T_world_cam
    image: np.ndarray  # [H, W, 3] float32 RGB in [0, 1]
    depth: np.ndarray | None = None  # [H, W] float32 z-depth (RGB-D)
    scan: np.ndarray | None = None  # [N, 3] float32 points in the LiDAR frame
    lidar_pose: np.ndarray | None = None  # [4, 4] float32 T_world_lidar
    points: np.ndarray | None = None  # [N, 3] float32 tracker map points in the world (monocular)
    colors: np.ndarray | None = None  # [N, 3] float32 their colours


class Stream:
    """The cell's keyframes: `warm` of them for set-up, then those of the
    window, then those the check feeds (`harness.Cell.setup`)."""

    def __init__(self, frames: list[Frame], warm: int, calib: dict, period_frames: int = 0,
                 period_shift: np.ndarray | None = None):
        self._frames = frames
        self.warm = warm
        self.calib = calib  # fx, fy, cx, cy, width, height; proj, tr for LiDAR
        self._period = period_frames
        self._shift = period_shift

    def frame(self, k: int) -> Frame:
        if not self._period:
            return self._frames[k]
        base = self._frames[k % self._period]
        laps = k // self._period
        if laps == 0:
            return base
        shift = np.eye(4, dtype=np.float64)
        shift[:3, 3] = laps * self._shift
        move = lambda t: (shift @ t.astype(np.float64)).astype(np.float32)
        lidar = None if base.lidar_pose is None else move(base.lidar_pose)
        return Frame(move(base.t_wc), base.image, base.depth, base.scan, lidar)


def calibration(sensors: dict) -> dict:
    cam = sensors["camera"]
    w, h, fx = int(cam["width"]), int(cam["height"]), float(cam["fx"])
    fy = float(cam.get("fy", fx))
    out = {"width": w, "height": h, "fx": fx, "fy": fy, "cx": (w - 1) / 2.0, "cy": (h - 1) / 2.0}
    if "lidar" in sensors:
        out["proj"] = np.array([[fx, 0, out["cx"], 0], [0, fy, out["cy"], 0], [0, 0, 1, 0]], np.float32)
        out["tr"] = np.array(scenes.TR_VELO_TO_CAM, np.float32)
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def tracker_points(t_wc: np.ndarray, image: np.ndarray, depth: np.ndarray, calib: dict, n: int,
                   rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """A tracker's map points in a raycast frame: `n` pixels drawn by `rng`
    among those with depth > 0, lifted into the world in float64 by the
    frame's float64 pose `t_wc`; (points [n, 3], their pixels' colours
    [n, 3]), float32. The benchmark's copy of
    `probes/mono.py::tracker_points`, on the stream's camera."""
    ys, xs = np.nonzero(depth > 0)
    pick = rng.choice(len(ys), size=min(n, len(ys)), replace=False)
    y, x = ys[pick], xs[pick]
    z = depth[y, x].astype(np.float64)
    pc = np.stack([(x - calib["cx"]) / calib["fx"] * z, (y - calib["cy"]) / calib["fy"] * z, z], -1)
    t = np.asarray(t_wc, np.float64)
    return (pc @ t[:3, :3].T + t[:3, 3]).astype(np.float32), image[y, x].astype(np.float32)


def make_stream(config: dict, traffic: dict, seed: int, n_keyframes: int, device) -> Stream:
    """The first `n_keyframes` keyframes of the cell's stream (the warm
    ones included) from `seed`."""
    sensors = config["sensors"]
    calib = calibration(sensors)
    gen_host = torch.Generator().manual_seed(seed)
    scene = traffic["scene"]
    w, h, fx = calib["width"], calib["height"], calib["fx"]
    if scene == "street":
        street = scenes.periodic_street(gen_host, float(traffic["period_m"]), traffic["boxes"],
                                        float(traffic["ground_y_m"]), device)
        step, sway, n_sway = float(traffic["step_m"]), float(traffic["sway_m"]), int(traffic["sway_cycles"])
        per = int(round(street.period / step))
        gen_dev = torch.Generator(device=device).manual_seed(seed)
        n_points = int(sensors["lidar"]["points_per_scan"])
        tr = torch.tensor(scenes.TR_VELO_TO_CAM, dtype=torch.float64)
        frames = []
        for k in range(min(per, n_keyframes)):
            pose = scenes.drive_pose(k * step, sway * math.sin(2 * math.pi * n_sway * k / per))
            pose_d = pose.to(device)
            rgb, _ = scenes.raycast_street(street, pose_d, w, h, fx)
            scan = scenes.lidar_scan(street, pose_d, n_points, gen_dev)
            frames.append(Frame(pose.numpy().astype(np.float32), _host(rgb), scan=_host(scan),
                                lidar_pose=(pose @ tr).numpy().astype(np.float32)))
        return Stream(frames, int(traffic["warm_keyframes"]), calib, per, np.array([0.0, 0.0, street.period]))
    if scene == "room":
        warm = int(traffic["warm_keyframes"])
        poses = scenes.room_lap_poses(warm)
        lim = traffic["poses"]
        # every seed gets the same set of poses, in an order of its own
        n_new = max(0, n_keyframes - warm)
        pool = torch.rand((n_new, 5), generator=torch.Generator().manual_seed(int(lim["pool_seed"])),
                          dtype=torch.float64)
        u = pool[torch.randperm(n_new, generator=gen_host)]
        for r in u:
            yaw = 2 * math.pi * float(r[0])
            pitch = float(lim["pitch_rad"]) * (2 * float(r[1]) - 1)
            # a point drawn uniformly in the ball of radius offset_m
            z = 2 * float(r[2]) - 1
            phi = 2 * math.pi * float(r[3])
            rad = float(lim["offset_m"]) * float(r[4]) ** (1 / 3)
            off = torch.tensor([math.sqrt(1 - z * z) * math.cos(phi), math.sqrt(1 - z * z) * math.sin(phi), z],
                               dtype=torch.float64) * rad
            poses.append(scenes.room_pose(yaw, pitch, offset=off))
        tracker = sensors.get("tracker")
        frames = []
        for k, pose in enumerate(poses[:n_keyframes]):
            rgb, depth = scenes.raycast_room(pose.to(device), w, h, fx, traffic["room_min_m"], traffic["room_max_m"],
                                             fy=calib["fy"])
            t_wc, image, depth = pose.numpy().astype(np.float32), _host(rgb), _host(depth)
            if tracker is None:
                frames.append(Frame(t_wc, image, depth=depth))
                continue
            # the frame's own draw, so that the room's frames are the same
            # with and without the tracker
            pts, cols = tracker_points(pose.numpy(), image, depth, calib, int(tracker["points_per_keyframe"]),
                                       np.random.default_rng([seed, k]))
            frames.append(Frame(t_wc, image, points=pts, colors=cols))
        return Stream(frames, warm, calib)
    raise ValueError(f"unknown scene {scene!r}")

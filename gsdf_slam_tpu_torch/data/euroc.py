"""EuRoC MAV stereo dataset parser + host-side stereo depth.

Supports BASELINE config #4 (EuRoC MH_01 stereo SLAM mapping). The
reference's EuRoC mode rode ORB-SLAM3 stereo (scripts/euroc_stereo.sh) and
the mapper's cv::cuda SGM members (gaussian_mapper.h:255-256); here stereo
depth is computed host-side with OpenCV SGBM on rectified pairs and fed to
the mapper as a colorized cloud — the same division of labor (tracking and
stereo on host, mapping on accelerator).

Layout: <seq>/mav0/cam{0,1}/data/*.png + sensor.yaml (K, radtan distortion,
T_BS), state_groundtruth_estimate0/data.csv (T_WB).

A copy of `gsdf_slam_tpu/data/euroc.py`, which imports no jax: the port keeps its own.
`cv2` and `yaml` are imported inside the functions that use them.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from .base_parser import CameraIntrinsics, FrameSet, list_files

# ASL default calibration (EuRoC sensor.yaml cam0/cam1), used when the
# sequence ships without sensor.yaml files.
_DEFAULT_CAM = {
    "cam0": dict(
        K=[458.654, 457.296, 367.215, 248.375],
        D=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
        T_BS=np.array(
            [
                [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
                [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
                [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
                [0.0, 0.0, 0.0, 1.0],
            ]
        ),
    ),
    "cam1": dict(
        K=[457.587, 456.134, 379.999, 255.238],
        D=[-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05],
        T_BS=np.array(
            [
                [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
                [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
                [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
                [0.0, 0.0, 0.0, 1.0],
            ]
        ),
    ),
}


def _load_sensor_yaml(path: Path):
    import yaml

    d = yaml.safe_load(path.read_text().replace("%YAML:1.0", ""))
    intr = d["intrinsics"]
    t_bs = np.array(d["T_BS"]["data"], dtype=np.float64).reshape(4, 4)
    return dict(K=intr, D=d["distortion_coefficients"], T_BS=t_bs)


def _read_gt_csv(path: Path):
    stamps, poses = [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            t = float(row[0]) * 1e-9
            px, py, pz, qw, qx, qy, qz = (float(v) for v in row[1:8])
            m = np.eye(4)
            n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
            qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
            m[:3, :3] = [
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
                [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
                [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
            ]
            m[:3, 3] = [px, py, pz]
            stamps.append(t)
            poses.append(m)
    return np.array(stamps), np.stack(poses)


class EurocParser:
    def __init__(self, sequence_path: str | Path):
        base = Path(sequence_path)
        mav = base / "mav0" if (base / "mav0").is_dir() else base
        self.base = mav
        cams = {}
        for c in ("cam0", "cam1"):
            sensor = mav / c / "sensor.yaml"
            cams[c] = _load_sensor_yaml(sensor) if sensor.exists() else _DEFAULT_CAM[c]
        self.cams = cams
        k = cams["cam0"]["K"]
        self.intrinsics = CameraIntrinsics(k[0], k[1], k[2], k[3], 752, 480)
        # stereo extrinsics: T_cam1_cam0 = inv(T_BS1) @ T_BS0
        self.T_c1_c0 = np.linalg.inv(cams["cam1"]["T_BS"]) @ cams["cam0"]["T_BS"]

        gt = mav / "state_groundtruth_estimate0" / "data.csv"
        self.gt_stamps, self.gt_poses = _read_gt_csv(gt)  # T_WB

        self.left_files = list_files(mav / "cam0" / "data", ".png")
        self.right_files = list_files(mav / "cam1" / "data", ".png")
        self._associate()
        self._rect = None

    def _associate(self, max_diff: float = 0.01):
        lf, rf, poses = [], [], []
        right_stamps = np.array([float(f.stem) * 1e-9 for f in self.right_files])
        for f in self.left_files:
            t = float(f.stem) * 1e-9
            j = int(np.argmin(np.abs(right_stamps - t)))
            k = int(np.argmin(np.abs(self.gt_stamps - t)))
            if abs(right_stamps[j] - t) < max_diff and abs(self.gt_stamps[k] - t) < 0.05:
                lf.append(f)
                rf.append(self.right_files[j])
                # camera pose: T_WC0 = T_WB @ T_BS0
                poses.append(self.gt_poses[k] @ self.cams["cam0"]["T_BS"])
        self.color_files, self.depth_files = lf, rf
        self.poses = (
            np.stack(poses).astype(np.float32) if poses else np.zeros((0, 4, 4), np.float32)
        )

    def rectification(self):
        """Cached stereo rectification maps + the rectified projection."""
        if self._rect is not None:
            return self._rect
        import cv2

        c0, c1 = self.cams["cam0"], self.cams["cam1"]
        k0 = np.array([[c0["K"][0], 0, c0["K"][2]], [0, c0["K"][1], c0["K"][3]], [0, 0, 1]])
        k1 = np.array([[c1["K"][0], 0, c1["K"][2]], [0, c1["K"][1], c1["K"][3]], [0, 0, 1]])
        d0 = np.array(c0["D"])
        d1 = np.array(c1["D"])
        size = (752, 480)
        r = np.ascontiguousarray(self.T_c1_c0[:3, :3], dtype=np.float64)
        t = np.ascontiguousarray(self.T_c1_c0[:3, 3], dtype=np.float64).reshape(3, 1)
        r1, r2, p1, p2, q, _, _ = cv2.stereoRectify(
            k0, d0, k1, d1, size, r, t, flags=cv2.CALIB_ZERO_DISPARITY, alpha=0
        )
        m0 = cv2.initUndistortRectifyMap(k0, d0, r1, p1, size, cv2.CV_32FC1)
        m1 = cv2.initUndistortRectifyMap(k1, d1, r2, p2, size, cv2.CV_32FC1)
        self._rect = dict(maps0=m0, maps1=m1, P1=p1, R1=r1, Q=q, baseline=-p2[0, 3] / p2[0, 0])
        return self._rect

    def frames(self) -> FrameSet:
        n = len(self.color_files)
        # report the RECTIFIED intrinsics — keyframes train on the
        # rectified left image, so the mapper's camera must match
        rect = self.rectification()
        p1 = rect["P1"]
        intr = CameraIntrinsics(p1[0, 0], p1[1, 1], p1[0, 2], p1[1, 2], 752, 480)
        return FrameSet(
            color_files=self.color_files,
            depth_files=self.depth_files,  # right images; depth via SGBM
            color_poses=self.poses[:n],
            depth_poses=self.poses[:n],
            intrinsics=intr,
        )


def stereo_depth(left_gray: np.ndarray, right_gray: np.ndarray, rect: dict) -> np.ndarray:
    """Rectified SGBM disparity -> metric depth (z in the rectified cam0).

    The reference's stereo path used cv::cuda::StereoSGM
    (gaussian_mapper.h:255-256); OpenCV SGBM on the host is the equivalent.
    """
    import cv2

    l = cv2.remap(left_gray, *rect["maps0"], cv2.INTER_LINEAR)
    r = cv2.remap(right_gray, *rect["maps1"], cv2.INTER_LINEAR)
    sgbm = cv2.StereoSGBM_create(
        minDisparity=0,
        numDisparities=96,
        blockSize=7,
        P1=8 * 49,
        P2=32 * 49,
        uniquenessRatio=10,
        speckleWindowSize=100,
        speckleRange=2,
    )
    disp = sgbm.compute(l, r).astype(np.float32) / 16.0
    fx = rect["P1"][0, 0]
    depth = np.where(disp > 0.5, fx * rect["baseline"] / np.maximum(disp, 1e-6), 0.0)
    return depth.astype(np.float32)

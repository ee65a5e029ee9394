"""Camera undistortion maps + masks (pinhole radtan + fisheye).

Equivalent of Camera::initUndistortRectifyMapAndMask (include/camera.h:
72-105): builds cv2 remap maps for a distorted camera plus the white-image
undistortion mask whose black edges the training loss masks out
(gaussian_mapper.cpp:415-417). Pyramid-level masks are resized copies, like
the reference's gaus_pyramid_undistort_mask_.

The reference's Camera carries a PINHOLE/FISHEYE model id
(include/camera.h:52-54, CameraModelType) for the legacy Photo-SLAM
fisheye-calibrated rigs (TUM-VI/EuRoC-style KANNALA_BRANDT sensors in
cfg/ORB_SLAM3/**), though its own map construction only ever calls the radtan
cv::initUndistortRectifyMap. Here the model id selects the correct OpenCV
backend: `model="fisheye"` uses cv2.fisheye (Kannala-Brandt k1..k4),
`model="pinhole"` the radtan path.

A copy of `gsdf_slam_tpu/engine/camera_undistort.py`, which imports no jax: the port keeps its own.
`cv2` and `yaml` are imported inside the functions that use them.
"""

from __future__ import annotations

import numpy as np

# reference model ids (include/camera.h:52-54)
MODEL_INVALID, MODEL_PINHOLE, MODEL_FISHEYE = 0, 1, 2
_MODEL_NAMES = {MODEL_PINHOLE: "pinhole", MODEL_FISHEYE: "fisheye"}


def model_name(model) -> str:
    """Accept a reference model id (1/2) or a string; return the string."""
    if isinstance(model, str):
        if model not in ("pinhole", "fisheye"):
            raise ValueError(f"unknown camera model {model!r}")
        return model
    try:
        return _MODEL_NAMES[int(model)]
    except (KeyError, ValueError):
        raise ValueError(f"unknown camera model id {model!r}") from None


class UndistortRectifier:
    def __init__(
        self,
        k: np.ndarray,  # [3,3] intrinsics
        dist: np.ndarray,  # distortion coefficients (radtan k1 k2 p1 p2 [k3] / fisheye k1..k4)
        width: int,
        height: int,
        new_k: np.ndarray | None = None,
        model: str | int = "pinhole",
    ):
        import cv2

        self.k = np.asarray(k, np.float64)
        self.dist = np.asarray(dist, np.float64)
        self.size = (width, height)
        self.model = model_name(model)
        self.new_k = self.k if new_k is None else np.asarray(new_k, np.float64)
        if self.model == "fisheye":
            # Kannala-Brandt: cv2.fisheye wants exactly 4 coefficients
            d = np.zeros(4, np.float64)
            d[: min(4, self.dist.size)] = self.dist.ravel()[:4]
            self.dist = d
            self.maps = cv2.fisheye.initUndistortRectifyMap(
                self.k, self.dist.reshape(4, 1), np.eye(3), self.new_k,
                self.size, cv2.CV_32FC1,
            )
        else:
            self.maps = cv2.initUndistortRectifyMap(
                self.k, self.dist, None, self.new_k, self.size, cv2.CV_32FC1
            )
        white = np.full((height, width), 255, np.uint8)
        self.mask = (
            cv2.remap(white, *self.maps, cv2.INTER_LINEAR) > 0
        ).astype(np.float32)

    def undistort(self, image: np.ndarray) -> np.ndarray:
        import cv2

        return cv2.remap(image, *self.maps, cv2.INTER_LINEAR)

    def backproject_depth(self, depth: np.ndarray, stride: int = 1) -> np.ndarray:
        """Raw (distorted) depth image -> camera-frame points [M, 3].

        The training target is the undistorted image (GaussianMapper trains
        on the remapped frame, gaussian_mapper.cpp:172-204), so seed points
        backprojected from raw RGB-D depth must go through the distortion
        model too — a plain pinhole backprojection of distorted pixels is
        off by tens of pixels at the borders of e.g. TUM fr1 (k1=0.26) and
        would keep re-seeding misplaced border geometry every keyframe.
        Mirrors how the reference's ORB-SLAM3 feed delivers undistortion-
        consistent map points. Invalid (<= 0) depth is dropped; the valid
        mask matches `depth[::stride, ::stride] > 0` row-major order, so
        callers can sample colors from the raw image at the same pixels."""
        import cv2

        h, w = depth.shape
        ys, xs = np.meshgrid(
            np.arange(0, h, stride), np.arange(0, w, stride), indexing="ij"
        )
        d = depth[ys, xs]
        valid = d > 0
        pix = np.stack([xs[valid], ys[valid]], -1).astype(np.float64)
        if len(pix) == 0:
            return np.zeros((0, 3), np.float32)
        if self.model == "fisheye":
            norm = cv2.fisheye.undistortPoints(
                pix[None], self.k, self.dist.reshape(4, 1)
            ).reshape(-1, 2)
        else:
            norm = cv2.undistortPoints(pix[None], self.k, self.dist).reshape(-1, 2)
        dv = d[valid].astype(np.float64)
        pts = np.stack([norm[:, 0] * dv, norm[:, 1] * dv, dv], -1)
        return pts.astype(np.float32)

    def pyramid_masks(self, factors) -> list[np.ndarray]:
        import cv2

        out = []
        for f in factors:
            w = int(self.size[0] * f)
            h = int(self.size[1] * f)
            out.append(cv2.resize(self.mask, (w, h), interpolation=cv2.INTER_NEAREST))
        return out

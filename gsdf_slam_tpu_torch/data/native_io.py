"""ctypes bindings to the native IO library (native/libgsdf_io.so).

Accelerated host IO for the hot byte-level readers; every entry point has a
pure-Python fallback in pointcloud_io/base_parser, so the .so is optional
(`make -C native` builds it).

A copy of `gsdf_slam_tpu/data/native_io.py`, which imports no jax: the port keeps its own.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB = None
_SEARCHED = False


def _lib():
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    so = Path(__file__).resolve().parent.parent.parent / "native" / "libgsdf_io.so"
    if not so.exists():
        # The .so is not committed (platform-specific binary); build it on
        # demand from the checked-in source. Falls back to pure Python.
        import subprocess

        try:
            subprocess.run(
                ["make", "-C", str(so.parent)],
                capture_output=True, timeout=60, check=False,
            )
        except (OSError, subprocess.TimeoutExpired):
            pass
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.gsdf_read_kitti_bin.restype = ctypes.c_int64
    lib.gsdf_read_kitti_bin.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.gsdf_load_poses.restype = ctypes.c_int64
    lib.gsdf_load_poses.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.gsdf_read_ply_xyz.restype = ctypes.c_int64
    lib.gsdf_read_ply_xyz.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def read_kitti_bin(path, max_points: int = 1 << 21) -> np.ndarray | None:
    lib = _lib()
    if lib is None:
        return None
    out = np.empty((max_points, 3), np.float32)
    n = lib.gsdf_read_kitti_bin(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_points
    )
    if n < 0:
        return None
    return out[:n].copy()


def read_ply_xyz(path, max_points: int = 1 << 22) -> np.ndarray | None:
    lib = _lib()
    if lib is None:
        return None
    out = np.empty((max_points, 3), np.float32)
    n = lib.gsdf_read_ply_xyz(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_points
    )
    if n < 0:
        return None
    return out[:n].copy()


def load_poses(path, pose_type: int, max_poses: int = 1 << 18):
    lib = _lib()
    if lib is None:
        return None
    mats = np.empty((max_poses, 4, 4), np.float32)
    stamps = np.empty((max_poses,), np.float64)
    n = lib.gsdf_load_poses(
        str(path).encode(),
        pose_type,
        mats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_poses,
    )
    if n < 0:
        return None
    return mats[:n].copy(), (stamps[:n].copy() if pose_type == 3 else None)

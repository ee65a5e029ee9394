"""Point-cloud file readers: KITTI .bin, .ply, .pcd.

Host-side NumPy equivalents of the readers in
submodules/data_loader/data_loader.cpp:141-170 (.bin as xyzi float32 stream,
.ply via tinyply, .pcd via PCL).

A copy of `gsdf_slam_tpu/data/pointcloud_io.py`, which imports no jax: the port keeps its own.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..io.ply import read_ply


def read_kitti_bin(path: str | Path) -> np.ndarray:
    """KITTI velodyne scan: packed float32 (x, y, z, intensity) records."""
    from . import native_io

    fast = native_io.read_kitti_bin(path)
    if fast is not None:
        return fast
    raw = np.fromfile(path, dtype=np.float32)
    return raw.reshape(-1, 4)[:, :3].copy()


def read_ply_points(path: str | Path) -> np.ndarray:
    from . import native_io

    fast = native_io.read_ply_xyz(path)
    if fast is not None:
        return fast
    p = read_ply(path)
    return np.stack([p["x"], p["y"], p["z"]], -1).astype(np.float32)


def read_pcd(path: str | Path) -> np.ndarray:
    """PCD v0.7 reader (ascii and binary), xyz fields only."""
    with open(path, "rb") as f:
        data = f.read()
    lines = []
    pos = 0
    while True:
        nl = data.find(b"\n", pos)
        line = data[pos:nl].decode("ascii", errors="replace")
        lines.append(line)
        pos = nl + 1
        if line.startswith("DATA"):
            break
    meta = {}
    for line in lines:
        parts = line.split()
        if parts:
            meta[parts[0]] = parts[1:]
    fields = meta["FIELDS"]
    sizes = [int(s) for s in meta["SIZE"]]
    types = meta["TYPE"]
    counts = [int(c) for c in meta.get("COUNT", ["1"] * len(fields))]
    n = int(meta["POINTS"][0])
    mode = meta["DATA"][0]

    np_types = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 1): "u1",
                ("U", 2): "<u2", ("U", 4): "<u4", ("I", 1): "i1",
                ("I", 2): "<i2", ("I", 4): "<i4"}
    dtype_fields = []
    for f_, s, t, c in zip(fields, sizes, types, counts):
        base = np_types[(t, s)]
        dtype_fields.append((f_, base, (c,)) if c > 1 else (f_, base))
    dtype = np.dtype(dtype_fields)

    if mode == "ascii":
        body = data[pos:].decode("ascii")
        arr = np.loadtxt(body.splitlines(), dtype=np.float64, max_rows=n, ndmin=2)
        col = {f_: i for i, f_ in enumerate(fields)}
        pts = arr[:, [col["x"], col["y"], col["z"]]]
        return pts.astype(np.float32)
    if mode == "binary":
        rec = np.frombuffer(data[pos : pos + dtype.itemsize * n], dtype=dtype)
        return np.stack(
            [rec["x"], rec["y"], rec["z"]], -1
        ).astype(np.float32)
    raise ValueError(f"unsupported PCD DATA mode {mode} in {path}")


def read_points(path: str | Path) -> np.ndarray:
    """Dispatch on extension like data_loader.cpp:141-170."""
    s = str(path)
    if s.endswith(".bin"):
        return read_kitti_bin(path)
    if s.endswith(".ply"):
        return read_ply_points(path)
    if s.endswith(".pcd"):
        return read_pcd(path)
    raise ValueError(f"unknown point-cloud format: {path}")

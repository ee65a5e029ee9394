"""PLY codec (tinyply replacement) + the 3DGS point-cloud checkpoint format.

Port of `gsdf_slam_tpu/io/ply.py`. The reference vendors tinyply for (a)
reading LiDAR clouds (ply_utils_torch.cpp) and (b) writing/reading the
3DGS-viewer-compatible model checkpoints (GaussianModel::savePly/loadPly,
gaussian_model.cpp:688-954: x y z, nx ny nz, f_dc_0..2, f_rest_0..44,
opacity, scale_0..2, rot_0..3 as binary_little_endian floats). The codec
is numpy; `gaussians_to_ply_dict` reads a `GaussianModel` and
`ply_dict_to_gaussians` builds one, on the card unless told otherwise.
"""

from __future__ import annotations

import io
import os
from pathlib import Path

import numpy as np
import torch

from ..models.gaussian_model import GaussianModel

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Read a PLY file's 'vertex' element into {property: 1-D array}.

    Supports ascii and binary_little_endian, list-free vertex properties
    (the formats the reference ever touches)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("__list__", parts[-1]))
            else:
                elements[-1][2].append((parts[2], parts[1]))

    out: dict[str, np.ndarray] = {}
    offset = 0
    for name, count, props in elements:
        if any(p[0] == "__list__" for p in props):
            if name == "vertex":
                raise ValueError("list properties on vertex element unsupported")
            break  # faces etc. after vertex: ignore
        dtype = np.dtype([(p, _PLY_DTYPES[t]) for p, t in props])
        if fmt == "ascii":
            text = body.decode("ascii")
            rows = np.loadtxt(io.StringIO(text), max_rows=count, ndmin=2)
            rec = np.rec.fromarrays(
                [rows[:, i].astype(dtype[i]) for i in range(len(props))],
                dtype=dtype,
            )
            body_used = None  # ascii multi-element unsupported; fine here
        elif fmt == "binary_little_endian":
            nbytes = dtype.itemsize * count
            rec = np.frombuffer(body[offset : offset + nbytes], dtype=dtype)
            offset += nbytes
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
        if name == "vertex":
            for p, _ in props:
                out[p] = np.ascontiguousarray(rec[p])
    return out


def write_ply(path: str | Path, props: dict[str, np.ndarray]) -> None:
    """Write vertex-only binary_little_endian PLY.

    Properties already typed uint8 stay uint8 (`property uchar`); everything
    else is written as float32, matching tinyply's typed-column behavior."""
    names = list(props)
    n = len(props[names[0]])
    cols = {}
    fields = []
    for k in names:
        a = np.asarray(props[k]).reshape(n)
        if a.dtype == np.uint8:
            cols[k] = a
            fields.append((k, "u1", "uchar"))
        else:
            cols[k] = a.astype(np.float32)
            fields.append((k, "<f4", "float"))
    dtype = np.dtype([(k, t) for k, t, _ in fields])
    rec = np.zeros(n, dtype=dtype)
    for k in names:
        rec[k] = cols[k]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {ply_t} {k}" for k, _, ply_t in fields]
    header += ["end_header", ""]
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def write_sparse_points_ply(
    path: str | Path, xyz: np.ndarray, colors: np.ndarray
) -> None:
    """Sparse tracker-point export (GaussianModel::saveSparsePointsPly,
    reference src/gaussian_model.cpp:955-996): x y z float32, zero normals,
    red green blue uint8 (colors in [0,1] scaled by 255)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    rgb = (np.asarray(colors, np.float32).reshape(-1, 3) * 255.0).astype(np.uint8)
    props: dict[str, np.ndarray] = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
    }
    write_ply(path, props)


def gaussians_to_ply_dict(model: GaussianModel) -> dict[str, np.ndarray]:
    """3DGS checkpoint layout (GaussianModel::savePly :861-954) of a model's
    parameters: f_dc [N, 1, 3] -> f_dc_0..2 and f_rest [N, 15, 3] ->
    f_rest_0..44, each transposed to channel-major like the reference."""
    p = {k: t.detach().cpu().numpy() for k, t in model.params().items()}
    xyz, scaling, rotation = p["xyz"], p["scaling"], p["rotation"]
    n = xyz.shape[0]
    out = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    dc = p["f_dc"].reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(dc.shape[1]):
        out[f"f_dc_{i}"] = dc[:, i]
    rest = p["f_rest"].reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest.shape[1]):
        out[f"f_rest_{i}"] = rest[:, i]
    out["opacity"] = p["opacity"].reshape(n)
    for i in range(scaling.shape[1]):
        out[f"scale_{i}"] = scaling[:, i]
    for i in range(rotation.shape[1]):
        out[f"rot_{i}"] = rotation[:, i]
    return out


def ply_dict_to_gaussians(props: dict[str, np.ndarray], device: torch.device | str = "cuda") -> GaussianModel:
    """Inverse of gaussians_to_ply_dict (GaussianModel::loadPly :688-859):
    a model on `device`, with zero densification statistics."""
    n = len(props["x"])
    xyz = np.stack([props["x"], props["y"], props["z"]], -1)
    n_dc = sum(1 for k in props if k.startswith("f_dc_"))
    dc = np.stack([props[f"f_dc_{i}"] for i in range(n_dc)], -1)
    dc = dc.reshape(n, 3, -1).transpose(0, 2, 1)  # [N, 1, 3]
    n_rest = sum(1 for k in props if k.startswith("f_rest_"))
    if n_rest:
        rest = np.stack([props[f"f_rest_{i}"] for i in range(n_rest)], -1)
        rest = rest.reshape(n, 3, -1).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, 15, 3), np.float32)
    n_s = sum(1 for k in props if k.startswith("scale_"))
    n_r = sum(1 for k in props if k.startswith("rot_"))
    arrays = {
        "xyz": xyz,
        "f_dc": dc,
        "f_rest": rest,
        "opacity": np.asarray(props["opacity"]).reshape(n, 1),
        "scaling": np.stack([props[f"scale_{i}"] for i in range(n_s)], -1),
        "rotation": np.stack([props[f"rot_{i}"] for i in range(n_r)], -1),
    }
    return GaussianModel(
        {k: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device) for k, a in arrays.items()}
    )

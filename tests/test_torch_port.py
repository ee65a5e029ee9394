"""The port stands alone: it imports no jax, a CUDA tensor never falls
back to a plain version, and its entry points run on the card unless told
otherwise."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_helpers import claims_cuda

from gsdf_slam_tpu_torch import convert, kernels
from gsdf_slam_tpu_torch.data import DataLoader
from gsdf_slam_tpu_torch.engine import Camera, GaussianMapper, Keyframe
from gsdf_slam_tpu_torch.io import ply_dict_to_gaussians
from gsdf_slam_tpu_torch.models import GaussianModel
from gsdf_slam_tpu_torch.models import optimizer
from gsdf_slam_tpu_torch.ops import CameraMatrices, binning, blend_probe, pair_table, projection, tile_blend
from gsdf_slam_tpu_torch.ops.colorize import colorize_pointcloud

REPO = Path(__file__).resolve().parent.parent

_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib", "gsdf_slam_tpu.")) or name == "gsdf_slam_tpu":
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, _Block())
import gsdf_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gsdf_slam_tpu_torch.__path__, "gsdf_slam_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert "jax" not in sys.modules
print(len(names))
"""


def test_port_imports_no_jax():
    """Every module of the package imports in a process where importing
    jax (or the JAX package) raises."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], capture_output=True, text=True, cwd=REPO, env=env, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 55


_NO_CV2_AT_IMPORT = r"""
import importlib, pkgutil, sys
import gsdf_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gsdf_slam_tpu_torch.__path__, "gsdf_slam_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(sorted(m for m in ("cv2", "yaml") if m in sys.modules))
"""


def test_port_imports_no_cv2_at_import_time():
    """The card's machine has no cv2: every module of the port imports
    without it; cv2 (and yaml) are imported inside the functions that use
    them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", _NO_CV2_AT_IMPORT], capture_output=True, text=True, cwd=REPO, env=env, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert "cv2" not in res.stdout.strip(), res.stdout


@pytest.fixture
def no_kernel_library(monkeypatch, tmp_path):
    """A machine without nvcc and without a built library."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_lib", None)
    kernels.reset_launch_counts()


@pytest.mark.parametrize("wrapper", [
    "tile_ranges_pack", "blend_fwd", "blend_bwd", "blend_fwd_export",
    "blend_probe_fwd", "blend_probe_fwd_pair2", "blend_probe_bwd", "expand_gather",
    "realign_copy", "window_gather_rows", "window_gather_cols", "xpose_cumsum", "preprocess_fwd", "preprocess_bwd",
    "bin_count", "bin_write", "adam_step",
])
def test_cuda_tensor_raises_without_library(no_kernel_library, monkeypatch, wrapper):
    def plain_called(*a, **k):
        raise AssertionError("fell back to the plain version")

    for name in ("tile_ranges_pack_plain", "bin_count_plain", "bin_write_plain"):
        monkeypatch.setattr(binning, name, plain_called)
    monkeypatch.setattr(tile_blend, "blend_fwd_plain", plain_called)
    monkeypatch.setattr(tile_blend, "blend_bwd_plain", plain_called)
    for name in ("blend_probe_fwd_plain", "blend_probe_fwd_pair2_plain", "blend_probe_bwd_plain",
                 "expand_gather_plain"):
        monkeypatch.setattr(blend_probe, name, plain_called)
    for name in ("realign_copy_plain", "window_gather_rows_plain", "window_gather_cols_plain",
                 "xpose_cumsum_plain"):
        monkeypatch.setattr(pair_table, name, plain_called)
    monkeypatch.setattr(projection, "preprocess_plain", plain_called)
    monkeypatch.setattr(optimizer, "adam_step_plain", plain_called)
    z = lambda *s, dt=torch.float32: claims_cuda(torch.zeros(s, dtype=dt))
    cam = CameraMatrices(z(4, 4), z(4, 4), z(3), z(), z())
    st = projection.PreprocessSettings(64, 64, 3, 1.0, None)
    gauss = (z(5, dt=torch.int64), z(5, dt=torch.int32), z(5, 2, dt=torch.int32), z(5, 2, dt=torch.int32), z(5, 2),
             z(5, 3), z(5))
    calls = {
        "tile_ranges_pack": lambda: binning.tile_ranges_pack(
            z(4, dt=torch.int32), z(4, dt=torch.int64), z(4, dt=torch.int32), z(3, 9), 16),
        "bin_count": lambda: binning.bin_count(*gauss, grid_w=4),
        "bin_write": lambda: binning.bin_write(*gauss, z(1, dt=torch.int64), 3, grid_w=4),
        "blend_fwd": lambda: tile_blend.blend_fwd(z(16, 2, dt=torch.int32), z(9, 4), 4, 4),
        "blend_fwd_export": lambda: tile_blend.blend_fwd_export(z(16, 2, dt=torch.int32), z(9, 4), 4, 4, 10.0),
        "blend_bwd": lambda: tile_blend.blend_bwd(
            z(16, 2, dt=torch.int32), z(9, 4), z(4, dt=torch.int32), z(16, 256, 3),
            z(16, 256, dt=torch.int32), z(16, 256, 4), z(16, 256, 3), z(16, 256), 3, 4, 4),
        "blend_probe_fwd": lambda: blend_probe.blend_probe_fwd(
            z(16, 2, dt=torch.int32), z(9, 4), 4, 4, "chunk_exit", 16),
        "blend_probe_fwd_pair2": lambda: blend_probe.blend_probe_fwd_pair2(
            z(16, 2, dt=torch.int32), z(9, 4), 4, 4, 16),
        "blend_probe_bwd": lambda: blend_probe.blend_probe_bwd(
            z(16, 2, dt=torch.int32), z(9, 4), z(16, dt=torch.int32), z(16, 256), z(16, 256, 3),
            z(16, 256), 4, 4, 16),
        "expand_gather": lambda: blend_probe.expand_gather(
            z(16, 1024), z(1, dt=torch.int32), z(512, dt=torch.int32)),
        "realign_copy": lambda: pair_table.realign_copy(z(3, 2, dt=torch.int32), z(16, 300), 384),
        "window_gather_rows": lambda: pair_table.window_gather_rows(
            z(1, dt=torch.int32), z(16, 2200), z(1024, dt=torch.int32)),
        "window_gather_cols": lambda: pair_table.window_gather_cols(
            z(1, dt=torch.int32), z(16, 2200), z(2048, dt=torch.int32)),
        "xpose_cumsum": lambda: pair_table.xpose_cumsum(z(1024, 16, dt=torch.int32)),
        "preprocess_fwd": lambda: projection.preprocess(
            z(5, 3), z(5, 3), z(5, 4), z(5), z(5, 1, 3), z(5, 15, 3), cam, width=64, height=64, sh_degree=3),
        "preprocess_bwd": lambda: projection.preprocess_bwd(
            z(5, 3), z(5, 3), z(5, 4), z(5, 1, 3), z(5, 15, 3), cam, st, z(5, 9)[:, 0:2], None, z(5, 9)[:, 2:5],
            z(5, 9)[:, 6:9]),
        "adam_step": lambda: optimizer.adam_step(
            {k: z(5, 3) for k in ("xyz", "scaling")}, {k: z(5, 3) for k in ("xyz", "scaling")},
            optimizer.AdamState({k: z(5, 3) for k in ("xyz", "scaling")}, {k: z(5, 3) for k in ("xyz", "scaling")}),
            {"xyz": 1e-3, "scaling": 5e-3}),
    }
    with pytest.raises(RuntimeError, match="nvcc not found"):
        calls[wrapper]()
    assert kernels.LAUNCHES[wrapper] == 0


_PCD = np.random.default_rng(0).uniform(-1, 1, (20, 3)).astype(np.float32)
_POSE = (np.array([1.0, 0, 0, 0]), np.zeros(3), 1.0, 1.0)
_KEYFRAME = Keyframe(fid=0, camera=Camera(0, 50.0, 50.0, 32.0, 32.0, 64, 64), t_cw=np.eye(4, dtype=np.float32),
                     image=np.zeros((64, 64, 3), np.float32))
_PLY = {**{c: _PCD[:, i] for i, c in enumerate("xyz")}, **{f"f_dc_{i}": _PCD[:, i] for i in range(3)},
        "opacity": _PCD[:, 0], **{f"scale_{i}": _PCD[:, i] for i in range(3)},
        **{f"rot_{i}": _PCD[:, i % 3] for i in range(4)}}
_SCAN = (np.random.default_rng(1).uniform(-5, 5, (50, 3)).astype(np.float32), np.zeros((8, 8, 3), np.float32),
         np.eye(4, dtype=np.float32)[:3], np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))


def _loader_get_item():
    """A one-frame KITTI directory, read by a DataLoader given no device:
    get_item colourises its scan on the loader's device."""
    import tempfile

    cv2 = pytest.importorskip("cv2")
    with tempfile.TemporaryDirectory() as tmp:
        return _read_one_kitti_frame(cv2, Path(tmp))


def _read_one_kitti_frame(cv2, base):
    (base / "image_2").mkdir()
    (base / "velodyne").mkdir()
    (base / "calib.txt").write_text("P2: 50 0 32 0 0 50 16 0 0 0 1 0\nTr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    (base / "poses.txt").write_text("1 0 0 0 0 1 0 0 0 0 1 0\n")
    cv2.imwrite(str(base / "image_2" / "000000.png"), np.zeros((32, 64, 3), np.uint8))
    np.array([[0.0, 0.0, 5.0, 0.0]], np.float32).tofile(base / "velodyne" / "000000.bin")
    loader = DataLoader(base, "kitti")
    loader.get_item(0)
    return torch.empty(0, device=loader.device)


# each entry point called without a device
_DEFAULT_DEVICE_CALLS = {
    "create_from_pcd": lambda: GaussianModel.create_from_pcd(_PCD, _PCD).xyz,
    "from_pose": lambda: CameraMatrices.from_pose(*_POSE).view,
    "from_arrays": lambda: CameraMatrices.from_arrays(np.eye(4), np.eye(4), np.zeros(3), 1.0, 1.0).view,
    "from_jax_state": lambda: convert.from_jax_state(
        {k: np.zeros((2,) + s, np.float32) for k, s in (("xyz", (3,)), ("f_dc", (1, 3)), ("f_rest", (15, 3)),
                                                        ("opacity", (1,)), ("scaling", (3,)), ("rotation", (4,)))},
        2).xyz,
    "from_jax_pairs": lambda: convert.from_jax_pairs(np.zeros((2, 1), np.int32), np.zeros((16, 128), np.float32))[1],
    "camera_matrices": lambda: _KEYFRAME.camera_matrices().view,
    "ply_dict_to_gaussians": lambda: ply_dict_to_gaussians(_PLY).xyz,
    "GaussianMapper": lambda: GaussianMapper()._bg[False],
    "colorize_pointcloud": lambda: colorize_pointcloud(*_SCAN).points_world,
    "DataLoader.get_item": _loader_get_item,
}


@pytest.mark.parametrize("entry", list(_DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(entry):
    """Without a device argument an entry point allocates on CUDA: on a
    machine without a card it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        assert _DEFAULT_DEVICE_CALLS[entry]().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            _DEFAULT_DEVICE_CALLS[entry]()


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tile_blend.blend_fwd(torch.zeros((16, 2), dtype=torch.int32, device="meta"),
                             torch.zeros((9, 4), device="meta"), 4, 4)


def test_check_rejects_bad_inputs():
    dev = torch.device("cpu")
    kernels.check("x", torch.zeros(3, 9), torch.float32, (-1, 9), dev)
    with pytest.raises(TypeError):
        kernels.check("x", torch.zeros(3, 9, dtype=torch.float64), torch.float32, (3, 9), dev)
    with pytest.raises(ValueError, match="shape"):
        kernels.check("x", torch.zeros(3, 8), torch.float32, (3, 9), dev)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.check("x", torch.zeros(9, 3).t(), torch.float32, (3, 9), dev)
    kernels.check("x", torch.zeros(9, 3).t(), torch.float32, (3, 9), dev, contiguous=False)
    with pytest.raises(ValueError, match="device"):
        kernels.check("x", torch.zeros(3, 9, device="meta"), torch.float32, (3, 9), dev)

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

from gsdf_slam_tpu_torch import convert, kernels
from gsdf_slam_tpu_torch.config import OptimizationParams
from gsdf_slam_tpu_torch.models import GaussianModel
from gsdf_slam_tpu_torch.models.optimizer import expon_lr, group_lrs
from gsdf_slam_tpu_torch.ops import CameraMatrices, binning, blend_probe, pair_table, tile_blend

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
    assert int(res.stdout.strip()) >= 15


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _claims_cuda(t):
    return torch.Tensor._make_subclass(_ClaimsCuda, t)


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
    "realign_copy", "window_gather_rows", "window_gather_cols", "xpose_cumsum",
])
def test_cuda_tensor_raises_without_library(no_kernel_library, monkeypatch, wrapper):
    def plain_called(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(binning, "tile_ranges_pack_plain", plain_called)
    monkeypatch.setattr(tile_blend, "blend_fwd_plain", plain_called)
    monkeypatch.setattr(tile_blend, "blend_bwd_plain", plain_called)
    for name in ("blend_probe_fwd_plain", "blend_probe_fwd_pair2_plain", "blend_probe_bwd_plain",
                 "expand_gather_plain"):
        monkeypatch.setattr(blend_probe, name, plain_called)
    for name in ("realign_copy_plain", "window_gather_rows_plain", "window_gather_cols_plain",
                 "xpose_cumsum_plain"):
        monkeypatch.setattr(pair_table, name, plain_called)
    z = lambda *s, dt=torch.float32: _claims_cuda(torch.zeros(s, dtype=dt))
    calls = {
        "tile_ranges_pack": lambda: binning.tile_ranges_pack(
            z(4, dt=torch.int64), z(4, dt=torch.int64), z(4, dt=torch.int32), z(3, 9), 16),
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
    }
    with pytest.raises(RuntimeError, match="nvcc not found"):
        calls[wrapper]()
    assert kernels.LAUNCHES[wrapper] == 0


_PCD = np.random.default_rng(0).uniform(-1, 1, (20, 3)).astype(np.float32)
_POSE = (np.array([1.0, 0, 0, 0]), np.zeros(3), 1.0, 1.0)
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
    "expon_lr": lambda: expon_lr(10, 1e-3, 1e-5),
    "group_lrs": lambda: group_lrs(OptimizationParams(), 1.0, 10)["f_dc"],
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
    with pytest.raises(ValueError, match="device"):
        kernels.check("x", torch.zeros(3, 9, device="meta"), torch.float32, (3, 9), dev)

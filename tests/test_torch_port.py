"""The port stands alone: it imports no jax, and a CUDA tensor never falls
back to a plain version."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gsdf_slam_tpu_torch import kernels
from gsdf_slam_tpu_torch.ops import binning, tile_blend

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


@pytest.mark.parametrize("wrapper", ["tile_ranges_pack", "blend_fwd", "blend_bwd", "blend_fwd_export"])
def test_cuda_tensor_raises_without_library(no_kernel_library, monkeypatch, wrapper):
    def plain_called(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(binning, "tile_ranges_pack_plain", plain_called)
    monkeypatch.setattr(tile_blend, "blend_fwd_plain", plain_called)
    monkeypatch.setattr(tile_blend, "blend_bwd_plain", plain_called)
    z = lambda *s, dt=torch.float32: _claims_cuda(torch.zeros(s, dtype=dt))
    calls = {
        "tile_ranges_pack": lambda: binning.tile_ranges_pack(
            z(4, dt=torch.int64), z(4, dt=torch.int64), z(4, dt=torch.int32), z(3, 9), 16),
        "blend_fwd": lambda: tile_blend.blend_fwd(z(16, 2, dt=torch.int32), z(9, 4), 4, 4),
        "blend_fwd_export": lambda: tile_blend.blend_fwd_export(z(16, 2, dt=torch.int32), z(9, 4), 4, 4, 10.0),
        "blend_bwd": lambda: tile_blend.blend_bwd(
            z(16, 2, dt=torch.int32), z(9, 4), z(4, dt=torch.int32), z(16, 256),
            z(16, 256, dt=torch.int32), z(16, 256, 3), z(16, 256), 3, 4, 4),
    }
    with pytest.raises(RuntimeError, match="nvcc not found"):
        calls[wrapper]()
    assert kernels.LAUNCHES[wrapper] == 0


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

"""The check that decides `correct`, at a size the CPU runs: a sound run
of each cell comes out correct; the same run with the timed path broken
underneath (a step that leaves the state unchanged, half of the image left
out of the loss, an answer altered where it is made) and the control (the
reference in bfloat16 in the program's place) come out not correct; in the
monocular cell also the samples' sources swapped, and its checked keyframe
flushes the depth cache. Also: no file of the benchmark imports the JAX
package, a run names the JAX it finds loaded, and a run without a card
prints no result."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gsdf_slam_tpu_torch.engine import mapper as mapper_mod
from gsdf_slam_tpu_torch.engine import train as train_mod
from gsdf_slam_tpu_torch.data import loader
from torch_bench import check, harness, run
from torch_bench.reference import mono

from .tiny import MONO, tiny_spec

CELLS = ["kitti_lidar.drive", "replica_rgbd.room", "kitti_lidar.polish", MONO]
SEED = 2**31 + 11


def _run(workload: str) -> dict:
    res = run.run_cell(tiny_spec(workload), SEED, 1.5, False, torch.device("cpu"), time.perf_counter())
    res.pop("_lines")
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"


def _no_adam(*_a, **_k):
    return None


def _half_loss(rendered, gt, mask, lambda_dssim=0.2):
    h = rendered.shape[0] // 2
    return check_loss(rendered[:h], gt[:h], None if mask is None else mask[:h], lambda_dssim)


check_loss = train_mod.mapper_loss


def _swap_colours(*a, **k):
    out = _colorize(*a, **k)
    return out._replace(colors=out.colors.flip(-1))


_colorize = loader.colorize_pointcloud


def _swap_backprojected(self, *a, **k):
    pts, cols = _backproject(self, *a, **k)
    return pts, cols[:, ::-1].copy()


_backproject = mapper_mod.GaussianMapper._backproject


def _swap_render(*a, **k):
    out = _render(*a, **k)
    return out._replace(image=out.image.flip(-1))


_render = train_mod.render_state


def _deeper_render(*a, **k):
    depth, coverage = _render_depth(*a, **k)
    return depth * 1.05, coverage


_render_depth = mapper_mod.render_depth_state

FAULTS = {
    "state_unchanged": [(train_mod, "adam_step", _no_adam)],
    "half_batch": [(train_mod, "mapper_loss", _half_loss)],
    "altered": [(loader, "colorize_pointcloud", _swap_colours),
                (mapper_mod.GaussianMapper, "_backproject", _swap_backprojected)],
    "altered_render": [(train_mod, "render_state", _swap_render)],
    "altered_depth": [(mapper_mod, "render_depth_state", _deeper_render)],
}


# every fault a cell can have: the polish ingests nothing, so its answer is
# altered in the render only; the monocular cell neither colourises nor
# backprojects, and only it renders depths
UNREACHED = {("kitti_lidar.polish", "altered"), (MONO, "altered")} | {(w, "altered_depth") for w in CELLS if w != MONO}
CASES = [(w, f) for w in CELLS for f in sorted(FAULTS) if (w, f) not in UNREACHED]


@pytest.mark.parametrize("workload,fault", CASES)
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    for obj, name, fn in FAULTS[fault]:
        monkeypatch.setattr(obj, name, fn)
    res = _run(workload)
    assert not res["correct"], res["check"]


def _segments(workload: str):
    """(spec, cell, the program's check segments, the reference's)."""
    spec = tiny_spec(workload)
    cell = harness.Cell(spec, SEED, 1.5, "cpu")
    cell.setup()
    cell.window()
    seg = check.program_segment(cell)
    cell.release()
    return spec, cell, seg, check.reference_segment(cell, seg)


@pytest.fixture(scope="module")
def mono_segments():
    return _segments(MONO)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, request):
    spec, cell, seg, ref = request.getfixturevalue("mono_segments") if workload == MONO else _segments(workload)
    sound, _ = check.verdict(check.compare(seg, ref), spec["limits"])
    control, _ = check.verdict(check.compare(check.reference_segment(cell, seg, "control"), ref), spec["limits"])
    assert sound and not control


def test_swapped_sources_are_not_correct(mono_segments):
    """The samples taking the render's depth before the tracker's fail."""
    spec, cell, seg, ref = mono_segments
    numbers = check.compare(check.reference_segment(cell, seg, "sources_swapped"), ref)
    assert not check.verdict(numbers, spec["limits"])[0]
    assert numbers["mono_source_gap"] > spec["limits"]["mono_source_gap"], numbers


def test_checked_keyframe_flushes_the_depth_cache(mono_segments):
    """The check brings the cache to one short of its flush, so the checked
    keyframe grows the map by the cache's points and its tracker points,
    and both sides count every source."""
    spec, cell, seg, ref = mono_segments
    assert seg["cache0"]["cached"] == check.depth_cache(spec["config"]) - 1 and seg["cached"] == 0
    assert seg["kept"] == ref["kept"] > 100
    assert set(ref["mono"]["source"].tolist()) >= {-1, 0, 1}


def test_reference_sources_are_the_mappers():
    assert mono.SOURCES == mapper_mod.MONO_SOURCES


def test_no_cuda_prints_no_result():
    root = Path(harness.ROOT)
    p = subprocess.run([sys.executable, "-m", "torch_bench.run", "--workload", "kitti_lidar.drive", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_names_the_jax_it_finds():
    names = ["torch", "gsdf_slam_tpu_torch.engine", "torch_bench.run", "jaxtyping"]
    assert run.jax_loaded(names) == []
    assert run.jax_loaded(names + ["jax.numpy", "flax", "gsdf_slam_tpu.ops"]) == ["flax", "gsdf_slam_tpu", "jax"]


def test_benchmark_imports_no_jax():
    banned = ("jax", "gsdf_slam_tpu", "benchmarks")
    for path in Path(harness.HERE).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, f"{path} imports {n}"


def test_skipped_densify_is_not_correct(monkeypatch):
    """The surgery segment's densify, planted with no effect, fails."""
    def no_densify(model, adam, **kw):
        return mapper_mod.DensifyCounts(0, 0, 0) if hasattr(mapper_mod, "DensifyCounts") else None

    monkeypatch.setattr(mapper_mod, "densify_and_prune", no_densify)
    res = _run("replica_rgbd.room")
    assert "surgery_count_gap" in res["check"]
    assert not res["correct"], res["check"]


def test_room_check_covers_surgery():
    res = _run("replica_rgbd.room")
    assert res["correct"] and res["check"]["surgery_count_gap"]["value"] is not None, res["check"]



def test_segment_line_names_each_step_and_leaf():
    leaves = {k: float(i + 1) for i, k in enumerate(check.LEAVES)}
    seg = {"fids": [4, 9, 2], "binnings": ["export", "cached", "export"], "losses": [0.5, 0.25, 0.125],
           "grad_norms": leaves}
    ref = {"losses": [0.5, 0.25, 0.2], "grad_norms": {k: 2 * v for k, v in leaves.items()}}
    line = check.segment_line(seg, ref)
    assert line.startswith("segment: keyframes [4, 9, 2] binnings ['export', 'cached', 'export'] losses ")
    assert "0.125/0.2 " in line and "\n" not in line
    for k, v in leaves.items():
        assert f"{k} {v:.7g}/{2 * v:.7g}" in line

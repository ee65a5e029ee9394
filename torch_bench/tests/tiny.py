"""Cells at a size the CPU runs in seconds, for the benchmark's own tests:
the cell's files as committed, with the camera cut to 96 pixels across,
the scans to 3,000 points, the warm segment to 6 keyframes, and a
densifying schedule brought forward to iteration 10, every 20; and a
monocular cell built in code (`mono_spec`), which no file lists yet."""

from __future__ import annotations

import copy
import json

from torch_bench import harness

MONO = "tum_mono.keyframes"
TUM_MONO_YAML = harness.ROOT / "gsdf_slam_tpu_torch" / "cfg" / "tum_mono.yaml"
# the tiny monocular cell's limits: the room's, the samples' gaps, and a
# densify's count over its ~2,500 Gaussians, of which one that sits at the
# threshold and goes the other way reads 4e-4 (the room's 0.4M: 2.5e-6)
MONO_LIMITS = {"mono_source_gap": 0.02, "mono_depth_gap": 1e-3, "surgery_count_gap": 2e-3}


def cell_spec(workload: str) -> dict:
    """The cell's spec; for a cell whose files are kept but that
    BENCHMARK.json does not list (the room, PERF.md's Open questions), the
    same from its files."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    if any(w["name"] == workload for w in bench["workloads"]):
        return harness.load_spec(workload)
    config, traffic = workload.split(".")
    read = lambda *p: json.loads(harness.HERE.joinpath(*p).read_text())
    return {"workload": workload, "cell": {"name": workload, "config": config, "traffic": traffic, "chips": 1},
            "config": read("configs", f"{config}.json"), "traffic": read("traffic", f"{traffic}.json"),
            "limits": read("limits", f"{workload}.json"), "end_to_end": bench["end_to_end"],
            "per_layer": bench["per_layer"]}


def tiny_spec(workload: str, rate_hz: float | None = 3.0) -> dict:
    if workload == MONO:
        return mono_spec(rate_hz)
    return tiny_spec_of(copy.deepcopy(cell_spec(workload)), rate_hz)


def tiny_spec_of(spec: dict, rate_hz: float | None = 3.0) -> dict:
    """`spec` cut to the tiny size, in place."""
    cam = spec["config"]["sensors"]["camera"]
    f = 96 / cam["width"]
    cam["width"], cam["height"] = 96, max(16, int(round(cam["height"] * f)))
    cam["fx"], cam["fy"] = cam["fx"] * f, cam["fy"] * f
    if "lidar" in spec["config"]["sensors"]:
        spec["config"]["sensors"]["lidar"]["points_per_scan"] = 3000
    spec["traffic"]["warm_keyframes"] = min(spec["traffic"]["warm_keyframes"], 6)
    mapper = spec["config"]["mapper"]
    if mapper.get("Optimization.densify_until_iter", 0) > 1000:
        # densify within the few iterations a tiny run trains, so that the
        # check's surgery segment runs
        mapper["Optimization.densify_from_iter"] = 10
        mapper["Optimization.densification_interval"] = 20
    if rate_hz and "rate_hz" in spec["traffic"]["window"]:
        spec["traffic"]["window"]["rate_hz"] = rate_hz
    return spec


def mono_spec(rate_hz: float | None = 3.0) -> dict:
    """A monocular cell on the room's traffic, built in code and cut as
    `tiny_spec` cuts a cell: the mapper's settings of the program's
    cfg/tum_mono.yaml (the pyramid off, no report), TUM fr1's camera
    (640x480, fx 517.3, fy 516.5) cut to 96x72, 100 tracker points a
    keyframe, their reach the yaml's 20 pixels scaled to 3, and a depth
    cache of 2 keyframes."""
    mapper = {}
    for line in TUM_MONO_YAML.read_text().splitlines():
        key, sep, val = line.partition(":")
        if sep and not line.startswith(("%", "#")):
            mapper[key.strip()] = float(val) if "." in val else int(val)
    mapper.update({"GausPyramid.do": 0, "Record.training_report_interval": 0, "Mapper.depth_cache": 2,
                   "Monocular.inactive_geo_densify_max_pixel_dist": 3.0})
    room = cell_spec("replica_rgbd.room")
    spec = copy.deepcopy(room)
    spec["workload"] = spec["cell"]["name"] = MONO
    spec["cell"]["config"] = "tum_mono"
    spec["config"] = {"mapper": mapper, "precision": "float32",
                      "sensors": {"camera": {"width": 640, "height": 480, "fx": 517.3, "fy": 516.5},
                                  "tracker": {"points_per_keyframe": 100}}}
    spec["limits"] = {**room["limits"], **MONO_LIMITS}
    return tiny_spec_of(spec, rate_hz)

"""Cells at a size the CPU runs in seconds, for the benchmark's own tests:
the cell's files as committed, with the camera cut to 96 pixels across,
the scans to 3,000 points, the warm segment to 6 keyframes, and a
densifying schedule brought forward to iteration 10, every 20."""

from __future__ import annotations

import copy
import json

from torch_bench import harness


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
    spec = copy.deepcopy(cell_spec(workload))
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

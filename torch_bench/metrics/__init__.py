"""The benchmark's metrics, one reader a metric: `metrics/<name>.py`
defines `read(rec)`, which takes the window's record (`harness.Cell.window`)
and returns the metric's value, or None where the record holds nothing for
it to read (the harness then leaves the metric out of the result)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_readers: dict = {}


def reader(name: str):
    """The `read` function of metrics/<name>.py."""
    if name not in _readers:
        path = HERE / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"torch_bench.metrics._{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[name] = mod.read
    return _readers[name]


def read(name: str, rec):
    return reader(name)(rec)


def quarter_rates(iter_ends_s: list[float], window_s: float) -> tuple[float, float]:
    """Iterations per second in the window's first and last quarter."""
    q = window_s / 4
    first = sum(1 for t in iter_ends_s if t <= q)
    last = sum(1 for t in iter_ends_s if t > window_s - q)
    return first / q, last / q


def window_summary(rec) -> dict:
    """What the record says of the map's growth and the loop, for PERF.md."""
    first, last = quarter_rates(rec.iter_ends_s, rec.window_s)
    return {
        "window_s": rec.window_s,
        "iterations": rec.iterations,
        "keyframes_due": rec.keyframes_due,
        "keyframes_fed": rec.keyframes_fed,
        "gaussians_start": rec.gaussians_start,
        "gaussians_end": rec.gaussians_end,
        "iters_per_s_first_quarter": first,
        "iters_per_s_last_quarter": last,
        "binning": rec.binning,
        "phases_s": rec.phases_s,
        "spans_s": rec.spans_s,
        **({"trace_blend_launches": rec.trace.kernel_launches(("blend_fwd_kernel", "blend_fwd_export_kernel",
                                                                "blend_bwd_kernel")),
            "blend_calls": rec.blend["fwd_calls"] + rec.blend["bwd_calls"],
            "clock_offset_ns": rec.trace.clock_offset_ns, "clock_drift_s": rec.trace.clock_drift_s}
           if rec.trace is not None and rec.blend is not None else {}),
    }

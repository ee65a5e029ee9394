"""The traced window of one cell, given to the program's spans.

    python3 -m torch_bench.span_table --workload kitti_lidar.drive --seed 1 --seconds 30

From the root of a checkout on a machine with an NVIDIA card. Runs the
cell's set-up and traced window as `torch_bench.run --trace 1` does, with
the mapper's tracer recording its spans (and current around
`colorize_frame`, which is no entry point of the mapper), keeps the
window's profile, and gives each device operation, blocking call and idle
gap to the innermost span open when it was launched, made or opened
(`attribution.py`). Prints one JSON line: per span the host and self
seconds, calls, device seconds, launches, blocking calls and idle
seconds; the step's device ms (the union of the operations launched inside
`train_step`), host ms in blocking calls and launches per iteration; the
pairs a step's blend walks; the attribution's coverage; the set-up spans;
and what a span costs the host, off and on. Skips the check. Exits 1
without a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import run  # noqa: E402  (sets the run's environment, as the benchmark's command does)

SPANS_TIMED = 100_000


def span_cost(n: int = SPANS_TIMED) -> dict:
    """Host microseconds a span costs: with no tracer current, with one
    keeping totals, and with one recording intervals."""
    from gsdf_slam_tpu_torch.utils.observability import PhaseTimer, span, using

    def loop() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("x"):
                pass
        return (time.perf_counter_ns() - t0) / n / 1e3

    out = {"off_us": loop()}
    with using(PhaseTimer()):
        out["totals_us"] = loop()
    with using(PhaseTimer(record=True)):
        out["record_us"] = loop()
    return out


@contextlib.contextmanager
def capture(trace):
    """Keep the profile and the marker times of the harness's traced
    window (`trace.profiled`, `trace.mark`), passing both through."""
    got = SimpleNamespace(prof=None, marks=[])
    profiled, mark = trace.profiled, trace.mark

    @contextlib.contextmanager
    def keep_profile():
        with profiled() as prof:
            got.prof = prof
            yield prof

    def keep_mark(device):
        t = mark(device)
        got.marks.append(t)
        return t

    trace.profiled, trace.mark = keep_profile, keep_mark
    try:
        yield got
    finally:
        trace.profiled, trace.mark = profiled, mark


@contextlib.contextmanager
def colourise_under(timer):
    """`colorize_frame` with `timer` current, for the harness's feed."""
    import gsdf_slam_tpu_torch.data as data
    from gsdf_slam_tpu_torch.utils.observability import using

    orig = data.colorize_frame

    def colorize_frame(*args, **kwargs):
        with using(timer):
            return orig(*args, **kwargs)

    data.colorize_frame = colorize_frame
    try:
        yield
    finally:
        data.colorize_frame = orig


def card() -> dict:
    import torch

    out = {"kind": torch.cuda.get_device_name(0)}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["power_limit"] = q.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = None
    return out


def table(spec: dict, seed: int, seconds: float, device) -> dict:
    from gsdf_slam_tpu_torch.utils.observability import PhaseTimer, using

    from . import attribution, harness, trace

    cell = harness.Cell(spec, seed, seconds, device, traced=True)
    setup_tracer = PhaseTimer()
    with using(setup_tracer):
        cell.setup()
    setup_s = time.perf_counter() - T_START
    timer = cell.mapper.timer
    totals0, self0 = dict(timer.totals), dict(timer.self_totals)
    counts0, counters0 = dict(timer.counts), dict(timer.counters)
    timer.intervals.clear()
    timer.record = True
    try:
        with capture(trace) as got, colourise_under(timer):
            rec = cell.window()
    finally:
        timer.record = False
    t0 = time.perf_counter()
    host_t0, host_t1 = got.marks
    spans = [(n, a, b) for n, _, a, b in timer.intervals] + list(cell.spans.intervals)
    att = attribution.Attribution(got.prof.profiler.kineto_results.events(), host_t0, host_t1, spans)
    iters = rec.iterations
    step = att.inside("train_step")
    rows = att.by_span()
    for name in set(rows) | {k for k in timer.totals if timer.totals[k] != totals0.get(k, 0.0)}:
        row = rows.setdefault(name, {"device_s": 0.0, "launches": 0, "syncs": 0, "sync_s": 0.0, "idle_s": 0.0})
        if name in timer.totals:
            row.update(host_s=timer.totals[name] - totals0.get(name, 0.0),
                       self_s=timer.self_totals[name] - self0.get(name, 0.0),
                       calls=timer.counts[name] - counts0.get(name, 0))
        elif name in rec.spans_s:
            row.update(host_s=rec.spans_s[name], calls=rec.span_counts[name])
    pairs = timer.counters.get("blend.pairs", 0) - counters0.get("blend.pairs", 0)
    return {
        "workload": spec["workload"], "seed": seed, "device": card(),
        "window_s": rec.window_s, "iterations": iters, "iters_per_s": iters / rec.window_s,
        "keyframes_fed": rec.keyframes_fed, "gaussians": [rec.gaussians_start, rec.gaussians_end],
        "busy_s": att.busy_s, "busy_s_harness": rec.trace.busy_s, "idle_share": 100 * (1 - att.busy_s / att.window_s),
        "syncs_per_iter_harness": rec.syncs / iters if iters else None,
        "step": {"host_ms": 1e3 * rec.phases_s.get("train_step", 0.0) / iters,
                 "device_ms": 1e3 * step["device_s"] / iters, "sync_wait_ms": 1e3 * step["sync_s"] / iters,
                 "syncs_per_iter": step["syncs"] / iters, "launches_per_iter": step["launches"] / iters,
                 "spans": step["spans"]},
        "blend.pairs_per_iter": pairs / iters if iters else None,
        "attribution": att.summary(),
        "idle_gaps": dict(sorted(att.idle_by_span.items(), key=lambda kv: -kv[1])),
        "spans": dict(sorted(rows.items(), key=lambda kv: -kv[1].get("host_s", 0.0))),
        "setup": {"setup_s": setup_s, "harness": cell.setup_phases, "kernels.library_s":
                  setup_tracer.totals.get("kernels.library"), "mapper.first_step_s": timer.totals.get("mapper.first_step")},
        "reading_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One cell's traced window, given to the program's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if not torch.cuda.is_available():
        print("torch_bench.span_table: no CUDA card", file=sys.stderr)
        return 1
    from . import harness

    cost = span_cost()
    out = table(harness.load_spec(args.workload), args.seed, args.seconds, torch.device("cuda", 0))
    out["span_cost_us"] = cost
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

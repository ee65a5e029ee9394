"""One cell of the port's benchmark: set-up, the measured window and the
check, driven by the data in BENCHMARK.json and the cell's files.

A cell is a configuration (`configs/<config>.json`: the mapper's settings
as the port's YAML keys, the sensors) under a traffic mix
(`traffic/<traffic>.json`: the scene, the warm segment, the window's loop
and rate). Each metric is read by `metrics/<name>.py`, each limit of the
check is in `limits/<workload>.json`.

The window drives the port's public entry points (gsdf_slam_tpu_torch):
`data/loader.py::colorize_frame` for a LiDAR frame,
`GaussianMapper.feed_keyframe` (a monocular keyframe with its tracker
points and no depth), `GaussianMapper.train_for_one_iteration` and
`flush_metrics`. Two loops:

* "paced": keyframes fall due at a fixed rate from the window's start (an
  open loop); the loop ingests every due keyframe in order, then trains
  one iteration, and repeats. A keyframe's lag runs from its due time to
  the end of its feed; one still waiting at the close counts with its lag
  at the close.
* "train": iterations back to back, no ingest.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import check, trace
from .traffic.generator import make_stream

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    applies = lambda m: workload in m.get("workloads", [workload])
    return {
        "workload": workload,
        "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def mapper_settings(config: dict):
    """MapperSettings from the configuration's flat YAML keys, through the
    port's own parser."""
    from gsdf_slam_tpu_torch.engine import MapperSettings

    text = "%YAML:1.0\n" + "".join(f"{k}: {json.dumps(v) if isinstance(v, str) else v}\n"
                                   for k, v in config["mapper"].items())
    fd, path = tempfile.mkstemp(suffix=".yaml")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        return MapperSettings.from_yaml(path)
    finally:
        os.unlink(path)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """One run of one cell on `device`; `traced` adds the instruments of a
    `--trace 1` run."""

    def __init__(self, spec: dict, seed: int, seconds: float, device, traced: bool = False):
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.traced = traced
        self.traffic = spec["traffic"]
        self.config = spec["config"]
        self.loop = self.traffic["window"]["loop"]
        self.rate = float(self.traffic["window"].get("rate_hz", 0.0))
        self.spans = trace.Spans(keep=traced)

    # ------------------------------------------------------------- set-up
    def n_window_keyframes(self) -> int:
        return int(math.ceil(self.rate * self.seconds)) if self.loop == "paced" else 0

    def setup(self) -> None:
        from gsdf_slam_tpu_torch import kernels
        from gsdf_slam_tpu_torch.data import CameraIntrinsics
        from gsdf_slam_tpu_torch.engine import GaussianMapper

        t0 = time.perf_counter()
        if self.device.type == "cuda":
            kernels.library()  # from the checkout's build directory, or built there once
        self.check_feeds = self.loop == "paced"
        # the check feeds up to two keyframes past the window's, and in a
        # monocular cell first those that bring the depth cache to its flush
        n_check = 2 + check.flush_feeds(self.config) if self.check_feeds else 0
        n = self.traffic["warm_keyframes"] + self.n_window_keyframes() + n_check
        t1 = time.perf_counter()
        self.stream = make_stream(self.config, self.traffic, self.seed, n, self.device)
        t2 = time.perf_counter()
        c = self.stream.calib
        self.intr = CameraIntrinsics(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                                     height=c["height"])
        self.mapper = GaussianMapper(settings=mapper_settings(self.config),
                                     ingest_capacity=int(self.config.get("ingest_capacity", 1 << 16)),
                                     seed=self.seed, device=self.device)
        for k in range(self.stream.warm):
            self.feed(k)
            self.mapper.train_for_one_iteration()
        self.mapper.flush_metrics()
        if self.traced and self.device.type == "cuda":
            # the profiler's first start (CUPTI) is set-up, not window
            with trace.profiled():
                self.mapper.train_for_one_iteration()
        _sync(self.device)
        self.next_kf = self.stream.warm
        self.setup_phases = (f"kernels {t1 - t0:.3f}, frames {t2 - t1:.3f}, warm segment "
                             f"{time.perf_counter() - t2:.3f}")

    def feed(self, k: int):
        """Keyframe k through the program's entry points; a LiDAR frame is
        colourised first, a monocular one goes with its tracker points and
        no depth. Returns the colourised frame, if any."""
        from gsdf_slam_tpu_torch.data import colorize_frame

        f = self.stream.frame(k)
        if f.scan is not None:
            c = self.stream.calib
            with self.spans("colourise"):
                fd = colorize_frame(f.image, f.scan, c["proj"], c["tr"], f.t_wc, f.lidar_pose, device=self.device)
            with self.spans("ingest"):
                self.mapper.feed_keyframe(k, f.t_wc, f.image, points=fd.points, colors=fd.colors,
                                          intrinsics=self.intr)
            return fd
        with self.spans("ingest"):
            if f.depth is None:
                self.mapper.feed_keyframe(k, f.t_wc, f.image, points=f.points, colors=f.colors, intrinsics=self.intr)
            else:
                self.mapper.feed_keyframe(k, f.t_wc, f.image, depth=f.depth, intrinsics=self.intr)
        return None

    # ------------------------------------------------------------- window
    def window(self) -> SimpleNamespace:
        """Run the measured window; returns its record. In a traced run the
        profiler, the sync counter and the blend counters are on around the
        loop, and marker kernels on the device's timeline bracket it."""
        m = self.mapper
        dev = self.device
        cuda = dev.type == "cuda"
        instrument = self.traced and cuda
        rec = SimpleNamespace(seconds=self.seconds, loop=self.loop, rate_hz=self.rate, traced=self.traced)
        rec.gaussians_start = m.model.count
        rec.pixels = self.stream.calib["width"] * self.stream.calib["height"]
        phases0 = dict(m.timer.totals)
        binning0 = dict(m.binning_counts)
        spans0 = (dict(self.spans.totals), dict(self.spans.counts))
        self.spans.intervals.clear()
        blend = trace.BlendWork(dev) if instrument else None
        if cuda:
            rec.setup_peak_bytes = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        iters, losses_bad, lags, counts_per_iter, iter_ends = 0, 0, [], [], []
        k0 = self.next_kf
        n_due = self.n_window_keyframes()
        k = 0
        with contextlib.ExitStack() as outer, contextlib.ExitStack() as counters:
            prof = outer.enter_context(trace.profiled()) if instrument else None
            host_t0 = trace.mark(dev) if instrument else None
            if instrument:
                blend.install()
                counters.callback(blend.uninstall)
            t0 = time.perf_counter()
            end = t0 + self.seconds
            while True:
                now = time.perf_counter()
                if now >= end:
                    break
                if self.loop == "paced":
                    while k < n_due and t0 + k / self.rate <= now:
                        self.feed(k0 + k)
                        now = time.perf_counter()
                        lags.append(now - (t0 + k / self.rate))
                        k += 1
                        if now >= end:
                            break
                    if now >= end:
                        break
                with self.spans("train"):
                    out = m.train_for_one_iteration()
                iters += 1
                iter_ends.append(time.perf_counter() - t0)
                counts_per_iter.append(m.model.count)
                if out is None or not math.isfinite(out["loss"]):
                    losses_bad += 1
            m.flush_metrics()
            counters.close()
            loop_end = time.perf_counter_ns()  # the window's own closing sync is not the loop's
            _sync(dev)
            t_close = time.perf_counter()
            host_t1 = trace.mark(dev) if instrument else None
            if instrument:
                _sync(dev)
        rec.window_s = t_close - t0
        # keyframes due in the window but not fed by its close
        for j in range(k, n_due):
            lags.append(t_close - (t0 + j / self.rate))
        self.next_kf = k0 + k
        rec.iterations = iters
        rec.bad_losses = losses_bad
        rec.keyframes_due = n_due
        rec.keyframes_fed = k
        rec.lags_s = lags
        rec.iter_ends_s = iter_ends
        rec.gaussians_per_iter = counts_per_iter
        rec.gaussians_end = m.model.count
        rec.peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
        rec.phases_s = {k_: v - phases0.get(k_, 0.0) for k_, v in m.timer.totals.items()}
        rec.binning = {k_: v - binning0.get(k_, 0) for k_, v in m.binning_counts.items()}
        rec.spans_s = {k_: v - spans0[0].get(k_, 0.0) for k_, v in self.spans.totals.items()}
        rec.span_counts = {k_: v - spans0[1].get(k_, 0) for k_, v in self.spans.counts.items()}
        rec.blend = blend.read() if blend else None
        rec.trace = trace.DeviceTrace(prof, host_t0, host_t1, self.spans.intervals, loop_end) if prof else None
        rec.syncs = rec.trace.syncs if prof else None
        return rec

    # -------------------------------------------------------------- check
    def check(self) -> dict:
        """The program's check segment on this mapper (after the window),
        then the reference on the snapshots, with the program freed.
        Returns the compared numbers."""
        seg = check.program_segment(self)
        self.release()
        t0 = time.perf_counter()
        ref = check.reference_segment(self, seg)
        self.reference_s = time.perf_counter() - t0
        self.reference_stats = ref["stats"]
        self.segment_line = check.segment_line(seg, ref)
        return check.compare(seg, ref)

    def release(self) -> None:
        """Free the program's state on the device."""
        self.mapper = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


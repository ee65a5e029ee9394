"""The traced run's instruments: the harness's spans, the device trace, the
blend launches' work and the host syncs.

* `Spans` times the harness's calls into each layer (colourise, ingest,
  train) on the host clock, and in the traced run keeps each interval, so
  that each idle gap of the device is named by the span the host was in.
* `DeviceTrace` reduces a torch.profiler trace of the window: the busy
  seconds (the union of the device's kernel, copy and set intervals inside
  the window), the window's length, time by kernel name, and the idle gaps
  by host span.
* `BlendWork` wraps the blend kernels' wrappers of the program
  (`ops/tile_blend.py`) in the traced run only, and sums on the device,
  from each launch's own inputs and outputs, the pixel-pairs its pixels
  walked (n_contrib), the checkpoint words, the pairs K2 reads and each
  launch's bound; it reads them back once, after the window.
* the host syncs are the CUDA runtime's blocking calls in the trace
  (`SYNC_CALLS`); they count the calls that
  `torch.cuda.set_sync_debug_mode("warn")` reports (`chip_smoke.py::
  count_syncs`) without its warnings' cost in every step.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict

import torch

from .metrics import counts

# the CUDA runtime calls that block the host until the device catches up:
# torch's item(), cpu(), nonzero() and synchronize() end in one of them
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
FWD_KERNELS = ("blend_fwd_kernel", "blend_fwd_export_kernel")
BWD_KERNELS = ("blend_bwd_kernel",)


class Spans:
    """Host-clock totals and counts of named spans; with `keep`, also each
    span's interval (perf_counter_ns), for naming the device's idle gaps."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.intervals: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self.totals[name] += (t1 - t0) / 1e9
            self.counts[name] += 1
            if self.keep:
                self.intervals.append((name, t0, t1))


def mark(device) -> int:
    """Put a marker on the device's timeline: synchronise, read the host
    clock, launch torch.cuda._sleep's spin kernel. Returns the host ns at
    the launch; the kernel starts a launch latency (~10 us) after it."""
    torch.cuda.synchronize(device)
    t = time.perf_counter_ns()
    torch.cuda._sleep(1)
    return t


def _short(name: str) -> str:
    """A kernel's name without its namespaces' anonymous markers, argument
    list and template arguments."""
    base = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    while True:
        cut = re.sub(r"<[^<>]*>", "", base)
        if cut == base:
            break
        base = cut
    base = base.strip()
    return (base[5:] if base.startswith("void ") else base)[:120] or name[:120]


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _event_fields(e):
    """(name, on device, start ns, end ns) of a kineto event, across the
    torch versions' accessors."""
    name = e.name()
    dev = e.device_type() == torch.autograd.DeviceType.CUDA
    if hasattr(e, "start_ns"):
        start, dur = e.start_ns(), e.duration_ns()
    else:
        start, dur = 1000 * e.start_us(), 1000 * e.duration_us()
    return name, dev, int(start), int(start + dur)


class DeviceTrace:
    """The reduction of one profiled window: the device's events of the
    profile and the CUDA runtime's blocking calls (CUDA activity only:
    recording every host operation as well slows a step by a third), put
    on the host's clock by the marker kernels launched at the window's
    start and close (`mark`)."""

    def __init__(self, prof, host_t0: int, host_t1: int, spans: list[tuple[str, int, int]],
                 loop_end: int | None = None):
        res = prof.profiler.kineto_results
        dev, markers, syncs = [], [], []
        for e in res.events():
            name, on_dev, a, b = _event_fields(e)
            if not on_dev:
                if name in SYNC_CALLS:
                    syncs.append(a)
                continue
            if "spin_kernel" in name:
                markers.append(a)
            else:
                dev.append((name, a, b))
        if not markers:
            raise RuntimeError("the trace holds neither of its marker kernels")
        markers.sort()
        # device time = host time + offset, from the start marker (the
        # first kernel launched); the close marker's offset, where the
        # trace kept it, says how far the two clocks drift apart
        offset = markers[0] - host_t0
        self.clock_offset_ns = offset
        self.clock_drift_s = (markers[-1] - host_t1 - offset) / 1e9 if len(markers) > 1 else None
        w0, w1 = host_t0 + offset, host_t1 + offset
        self.window_s = (w1 - w0) / 1e9
        # the host's blocking calls inside the loop, to `loop_end` (the
        # runtime's records share the kernels' clock)
        s1 = w1 if loop_end is None else loop_end + offset
        self.syncs = sum(1 for a in syncs if w0 <= a < s1)
        clipped = [(max(a, w0), min(b, w1)) for _, a, b in dev if b > w0 and a < w1]
        busy = _union(clipped)
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        self.device_events = len(dev)
        self.by_kernel: dict[str, float] = defaultdict(float)
        self.launches: dict[str, int] = defaultdict(int)
        short: dict[str, str] = {}
        for name, a, b in dev:
            if b > w0 and a < w1:
                k = short.get(name) or short.setdefault(name, _short(name))
                self.by_kernel[k] += (b - a) / 1e9
                self.launches[k] += 1
        # idle gaps inside the window, each named by the harness span the
        # host was in at the gap's middle (the spans inside the window do
        # not overlap)
        gaps: dict[str, float] = defaultdict(float)
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        on_dev = sorted((n, a + offset, b + offset) for n, a, b in spans)
        on_dev.sort(key=lambda s: s[1])
        starts = [s[1] for s in on_dev]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = on_dev[i][0] if i >= 0 and mid < on_dev[i][2] else "the loop, outside any span"
            gaps[label] += (b - a) / 1e9
        self.idle_by_span = dict(gaps)

    def kernel_seconds(self, names: tuple[str, ...]) -> float:
        return sum(s for k, s in self.by_kernel.items() if k.split("::")[-1] in names)

    def kernel_launches(self, names: tuple[str, ...]) -> int:
        return sum(n for k, n in self.launches.items() if k.split("::")[-1] in names)

    def breakdown(self) -> dict:
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


@contextlib.contextmanager
def profiled():
    """A torch.profiler of the device's activity over the block."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA], record_shapes=False, profile_memory=False,
                   with_stack=False)
    with prof:
        yield prof


class BlendWork:
    """Device-side sums over the blend launches of the traced window."""

    def __init__(self, device):
        z = lambda dt: torch.zeros((), dtype=dt, device=device)
        self.fwd = {"walked": z(torch.int64), "bound_s": z(torch.float64)}
        self.bwd = {"walked": z(torch.int64), "bound_s": z(torch.float64)}
        self.calls = {"fwd": 0, "bwd": 0}
        self._restore = None

    @staticmethod
    def _bound(bytes_moved: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
        return torch.maximum(bytes_moved.double() / counts.HBM_BYTES_PER_S, ops.double() / counts.FP32_OPS_PER_S)

    def _add_fwd(self, ranges, payload, n_contrib, export: bool):
        t, m = ranges.shape[0], payload.shape[1]
        nc = n_contrib.to(torch.int64)
        walked = nc.sum()
        words = ((nc + counts.BUCKET - 1) // counts.BUCKET).sum()
        bytes_moved = counts.fwd_bytes(t, m, words, export)
        self.fwd["walked"] += walked
        self.fwd["bound_s"] += self._bound(bytes_moved, counts.FWD_WALK_OPS * walked)
        self.calls["fwd"] += 1

    def _add_bwd(self, ranges, n_contrib, num_gaussians: int):
        t = ranges.shape[0]
        nc = n_contrib.to(torch.int64)
        walked = nc.sum()
        words = ((nc + counts.BUCKET - 1) // counts.BUCKET).sum()
        lens = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
        live = counts.BUCKET * ((nc.amax(1) + counts.BUCKET - 1) // counts.BUCKET)
        pairs_read = torch.minimum(lens, live).sum()
        bytes_moved = counts.bwd_bytes(t, pairs_read, words, num_gaussians)
        self.bwd["walked"] += walked
        self.bwd["bound_s"] += self._bound(bytes_moved, counts.FWD_WALK_OPS * walked)
        self.calls["bwd"] += 1

    def install(self):
        from gsdf_slam_tpu_torch.ops import tile_blend

        orig = {n: getattr(tile_blend, n) for n in ("blend_fwd", "blend_fwd_export", "blend_bwd")}

        def blend_fwd(ranges, payload, grid_w, grid_h):
            out = orig["blend_fwd"](ranges, payload, grid_w, grid_h)
            self._add_fwd(ranges, payload, out[2], False)
            return out

        def blend_fwd_export(ranges, payload, grid_w, grid_h, margin):
            out = orig["blend_fwd_export"](ranges, payload, grid_w, grid_h, margin)
            self._add_fwd(ranges, payload, out[2], True)
            return out

        def blend_bwd(ranges, payload, gid, accum, n_contrib, ckpt, ct_accum, ct_log_t_eff, num_gaussians,
                      grid_w, grid_h):
            out = orig["blend_bwd"](ranges, payload, gid, accum, n_contrib, ckpt, ct_accum, ct_log_t_eff,
                                    num_gaussians, grid_w, grid_h)
            self._add_bwd(ranges, n_contrib, num_gaussians)
            return out

        for n, f in (("blend_fwd", blend_fwd), ("blend_fwd_export", blend_fwd_export), ("blend_bwd", blend_bwd)):
            setattr(tile_blend, n, f)
        self._restore = orig

    def uninstall(self):
        if self._restore:
            from gsdf_slam_tpu_torch.ops import tile_blend

            for n, f in self._restore.items():
                setattr(tile_blend, n, f)
            self._restore = None

    def read(self) -> dict:
        """The sums, read back to the host once."""
        vals = torch.stack([self.fwd["walked"].double(), self.fwd["bound_s"], self.bwd["walked"].double(),
                            self.bwd["bound_s"]]).tolist()
        return {"fwd_walked": int(vals[0]), "fwd_bound_s": vals[1], "bwd_walked": int(vals[2]),
                "bwd_bound_s": vals[3], **{f"{k}_calls": v for k, v in self.calls.items()}}

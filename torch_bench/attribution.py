"""Attribution of a profiled window to the program's spans.

The program's tracer (`gsdf_slam_tpu_torch/utils/observability.py::
PhaseTimer` with `record`) keeps each span's interval on the host clock
that the harness's `Spans` and marker kernels use (`trace.mark`). This
module puts those intervals, with the harness's, on the device clock by
the window's markers, as `trace.DeviceTrace` does, with two differences,
since a span may last a few microseconds: each marker is read at its
launch record where the trace has one (its kernel starts a launch latency,
tens of microseconds, after the host read its clock), and the offset runs
linearly from the start marker's to the close marker's (the two clocks
drift apart by tenths of a millisecond over a window). Each event of the
window then goes to a span:

* a device operation (kernel, copy or set) to the innermost span open when
  the host launched it: the CUDA runtime record with the operation's
  correlation id (its `correlation_id()`, else its
  `linked_correlation_id()`); where the trace has no such record, to the
  innermost span open at the operation's start (counted as a fallback);
* a blocking runtime call (`trace.SYNC_CALLS`), with its duration, to the
  innermost span open at its start;
* an idle gap of the device to the innermost span open at its middle.

Spans nest as the host's calls do (one thread opens them), so the
innermost open span is the one that started last among those still open.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .trace import SYNC_CALLS, _event_fields, _union

OUTSIDE = "the loop, outside any span"


class Timeline:
    """The innermost open span at each instant, from nested intervals
    (name, start, end) of one clock."""

    def __init__(self, intervals):
        intervals = list(intervals)
        self.names = [iv[0] for iv in intervals]
        # at equal times a span closes before the next opens
        marks = sorted([(a, 1, i) for i, (_, a, _) in enumerate(intervals)]
                       + [(b, 0, i) for i, (_, _, b) in enumerate(intervals)])
        bounds, labels, open_ = [], [], []
        for t, opens, i in marks:
            if opens:
                open_.append(i)
            elif open_ and open_[-1] == i:
                open_.pop()
            else:
                open_.remove(i)
            top = open_[-1] if open_ else -1
            if bounds and bounds[-1] == t:
                labels[-1] = top
            else:
                bounds.append(t)
                labels.append(top)
        self.bounds = np.asarray(bounds, dtype=np.int64)
        self.labels = np.asarray(labels, dtype=np.int64)

    def at(self, t) -> np.ndarray:
        """Index into `names` of the innermost span open at each time of
        `t` (an interval holds its start, not its end); -1 where none."""
        t = np.asarray(t, dtype=np.int64)
        i = np.searchsorted(self.bounds, t, side="right") - 1
        return np.where(i >= 0, self.labels[np.maximum(i, 0)], -1)

    def name(self, label: int) -> str:
        return self.names[label] if label >= 0 else OUTSIDE


def _inside(intervals, t) -> np.ndarray:
    """Whether each time of `t` falls in one of `intervals` [(start, end)],
    which do not overlap."""
    iv = sorted(intervals)
    starts = np.asarray([a for a, _ in iv], dtype=np.int64)
    ends = np.asarray([b for _, b in iv], dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    i = np.searchsorted(starts, t, side="right") - 1
    return (i >= 0) & (t < ends[np.maximum(i, 0)]) if len(iv) else np.zeros(t.shape, bool)


def _corr(e, what: str) -> int:
    fn = getattr(e, what, None)
    return int(fn()) if fn is not None else 0


class Attribution:
    """One profiled window given to the spans: `events` are the profile's
    kineto events, `host_t0` / `host_t1` the marker times of the window's
    start and close (`trace.mark`), `spans` the harness's and the
    program's intervals (name, start ns, end ns) on the host clock."""

    def __init__(self, events, host_t0: int, host_t1: int, spans):
        launched: dict[int, int] = {}
        syncs, ops, markers = [], [], []
        for e in events:
            name, on_dev, a, b = _event_fields(e)
            if not on_dev:
                c = _corr(e, "correlation_id")
                if c:
                    launched[c] = a
                if name in SYNC_CALLS:
                    syncs.append((a, b))
            elif "spin_kernel" in name:
                markers.append((a, _corr(e, "correlation_id")))
            else:
                ops.append((a, b, _corr(e, "correlation_id"), _corr(e, "linked_correlation_id")))
        if not markers:
            raise RuntimeError("the trace holds neither of its marker kernels")
        markers.sort()
        (first, c0), (last, c1) = markers[0], markers[-1]
        launch0 = launched.get(c0, first)
        self.marker_latency_ns = first - launch0
        off0 = launch0 - host_t0
        off1 = launched.get(c1, last) - host_t1 if len(markers) > 1 else off0
        self.clock_drift_ns = off1 - off0
        rate = (off1 - off0) / (host_t1 - host_t0) if host_t1 > host_t0 else 0.0

        def on_device(t: int) -> int:
            return t + off0 + round(rate * (t - host_t0))

        w0, w1 = on_device(host_t0), on_device(host_t1)
        self.window_s = (w1 - w0) / 1e9
        spans = [(n, on_device(a), on_device(b)) for n, a, b in spans]
        self.timeline = tl = Timeline(spans)
        self._spans = spans

        ops = [op for op in ops if op[1] > w0 and op[0] < w1]
        start = np.asarray([op[0] for op in ops], dtype=np.int64)
        end = np.asarray([op[1] for op in ops], dtype=np.int64)
        launch = [launched.get(c) or launched.get(linked) for _, _, c, linked in ops]
        self.by_launch = np.asarray([t is not None for t in launch], dtype=bool)
        self.launch_t = np.asarray([t if t is not None else a for t, a in zip(launch, start)], dtype=np.int64)
        self.clipped = (np.maximum(start, w0), np.minimum(end, w1))
        self.op_label = tl.at(self.launch_t)
        self.ops = len(ops)
        self.fallback = int((~self.by_launch).sum())
        self.in_span_by_launch = int((self.by_launch & (self.op_label >= 0)).sum())

        syncs = [(a, b) for a, b in syncs if w0 <= a < w1]
        self.sync_start = np.asarray([a for a, _ in syncs], dtype=np.int64)
        self.sync_s = np.asarray([(b - a) / 1e9 for a, b in syncs], dtype=np.float64)
        self.sync_label = tl.at(self.sync_start)

        busy = _union(list(zip(self.clipped[0].tolist(), self.clipped[1].tolist())))
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        gap_label = tl.at([(a + b) // 2 for a, b in gaps])
        self.idle_by_span: dict[str, float] = defaultdict(float)
        for (a, b), lab in zip(gaps, gap_label.tolist()):
            self.idle_by_span[tl.name(lab)] += (b - a) / 1e9

    def by_span(self) -> dict[str, dict]:
        """Per span name: the device seconds, launches and blocking calls
        (count, host seconds) given to it as the innermost span, and the
        idle seconds of the gaps at whose middle it was the innermost."""
        out: dict[str, dict] = defaultdict(lambda: {"device_s": 0.0, "launches": 0, "syncs": 0, "sync_s": 0.0,
                                                    "idle_s": 0.0})
        dur = (self.clipped[1] - self.clipped[0]) / 1e9
        for lab, d in zip(self.op_label.tolist(), dur.tolist()):
            row = out[self.timeline.name(lab)]
            row["device_s"] += d
            row["launches"] += 1
        for lab, s in zip(self.sync_label.tolist(), self.sync_s.tolist()):
            row = out[self.timeline.name(lab)]
            row["syncs"] += 1
            row["sync_s"] += s
        for name, s in self.idle_by_span.items():
            out[name]["idle_s"] += s
        return dict(out)

    def inside(self, name: str) -> dict:
        """What the host launched and waited for inside the spans named
        `name`, their children's included: the union of those operations'
        device intervals (s), their count, and the blocking calls (count,
        host s)."""
        iv = [(a, b) for n, a, b in self._spans if n == name]
        mine = _inside(iv, self.launch_t)
        sel = list(zip(self.clipped[0][mine].tolist(), self.clipped[1][mine].tolist()))
        sync_in = _inside(iv, self.sync_start)
        return {"spans": len(iv), "device_s": sum(b - a for a, b in _union(sel)) / 1e9,
                "launches": int(mine.sum()), "syncs": int(sync_in.sum()),
                "sync_s": float(self.sync_s[sync_in].sum())}

    def summary(self) -> dict:
        return {"ops": self.ops, "by_launch": int(self.by_launch.sum()), "fallback": self.fallback,
                "marker_latency_ns": self.marker_latency_ns, "clock_drift_ns": self.clock_drift_ns,
                "in_span_by_launch": self.in_span_by_launch,
                "share_in_span_by_launch": self.in_span_by_launch / self.ops if self.ops else None}

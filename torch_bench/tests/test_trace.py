"""The attribution of a profiled window to the program's spans
(`torch_bench/attribution.py`) on a synthetic kineto-like event list, and
the readers of the step's parts (CPU)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_bench import attribution, metrics

OFF = 1_000_000  # device clock = host clock + OFF


class _Event:
    """A kineto event: a device operation, or (`dev` False) a runtime call,
    with its correlation ids; `corr=None` leaves the accessors out, as on
    a record that has none."""

    def __init__(self, name, a, b, dev=True, corr=0, linked=0):
        self._n, self._a, self._b, self._dev = name, a + OFF, b + OFF, dev
        if corr is not None:
            self.correlation_id = lambda: corr
            self.linked_correlation_id = lambda: linked

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def test_timeline_gives_the_innermost_open_span():
    tl = attribution.Timeline([("train", 0, 100), ("train_step", 10, 90), ("render.blend", 20, 50),
                               ("render.binning", 20, 30), ("step.adam", 60, 70)])
    got = [tl.name(i) for i in tl.at([-1, 0, 10, 20, 29, 30, 50, 65, 70, 95, 100])]
    assert got == [attribution.OUTSIDE, "train", "train_step", "render.binning", "render.binning", "render.blend",
                   "train_step", "step.adam", "train_step", "train", attribution.OUTSIDE]


def _window():
    """A window of 1,000 ns: a harness span "train" holding the program's
    train_step, which holds render.binning (a sync inside) and
    step.backward; "ingest" outside it. Launches and their kernels are
    matched by correlation id, one kernel by its linked id only, one has
    no launch record (a fallback) and one has no accessors at all."""
    spans = [("ingest", 0, 200), ("train", 200, 1000), ("train_step", 210, 990), ("render.binning", 220, 400),
             ("step.backward", 500, 900)]
    ev = [
        _Event("spin_kernel", 0, 5), _Event("spin_kernel", 1000, 1005),
        # ingest: launched at 50, runs 60-120
        _Event("cudaLaunchKernel", 50, 52, dev=False, corr=1), _Event("k_ingest", 60, 120, corr=1),
        # binning: launched at 230, runs 240-260; then a sync 270-390
        _Event("cudaLaunchKernel", 230, 232, dev=False, corr=2), _Event("k_sort", 240, 260, corr=2),
        _Event("cudaStreamSynchronize", 270, 390, dev=False, corr=3),
        # launched inside render.binning (390) but run after it closed
        _Event("cudaMemcpyAsync", 390, 392, dev=False, corr=4), _Event("Memcpy HtoD", 420, 430, corr=9, linked=4),
        # backward: two kernels launched at 510 and 520 run 600-700
        _Event("cudaLaunchKernel", 510, 511, dev=False, corr=5), _Event("k_bwd", 600, 650, corr=5),
        _Event("cudaLaunchKernel", 520, 521, dev=False, corr=6), _Event("k_bwd2", 650, 700, corr=6),
        # no launch record: given to the span open at its start (step.backward)
        _Event("k_orphan", 800, 810, corr=77),
        _Event("k_bare", 820, 830, corr=None),
        # a sync in train_step's own time, after step.backward
        _Event("cudaStreamSynchronize", 905, 985, dev=False, corr=8),
    ]
    return attribution.Attribution(ev, 0, 1000, spans)


def test_attribution_by_correlation_id_and_fallback():
    att = _window()
    assert att.window_s == pytest.approx(1e-6)
    assert att.ops == 7 and att.fallback == 2 and att.in_span_by_launch == 5
    assert att.summary()["share_in_span_by_launch"] == pytest.approx(5 / 7)
    rows = att.by_span()
    assert rows["ingest"]["launches"] == 1 and rows["ingest"]["device_s"] == pytest.approx(60e-9)
    # the memcpy ran at 420-430, outside render.binning, but was launched in it
    assert rows["render.binning"]["launches"] == 2
    assert rows["render.binning"]["device_s"] == pytest.approx(30e-9)
    assert rows["render.binning"]["syncs"] == 1 and rows["render.binning"]["sync_s"] == pytest.approx(120e-9)
    assert rows["step.backward"]["launches"] == 4  # two launched, two by their start
    assert rows["train_step"]["syncs"] == 1 and rows["train_step"]["launches"] == 0
    step = att.inside("train_step")
    assert step == {"spans": 1, "device_s": pytest.approx(150e-9), "launches": 6, "syncs": 2,
                    "sync_s": pytest.approx(200e-9)}
    assert att.inside("ingest")["launches"] == 1 and att.inside("nothing")["launches"] == 0


def test_idle_gaps_are_named_by_the_innermost_program_span():
    att = _window()
    # busy: 60-120, 240-260, 420-430, 600-700, 800-810, 820-830 (210 ns)
    assert att.busy_s == pytest.approx(210e-9)
    gaps = dict(att.idle_by_span)
    # 0-60 and 120-240 (middles 30, 180: ingest); 260-420 (middle 340:
    # render.binning); 430-600 (515: step.backward); 700-800, 810-820
    # (750, 815: step.backward); 830-1000 (915: train_step)
    assert gaps == pytest.approx({"ingest": 180e-9, "render.binning": 160e-9, "step.backward": 280e-9,
                                  "train_step": 170e-9})
    assert "train" not in gaps
    assert sum(gaps.values()) == pytest.approx(att.window_s - att.busy_s)
    rows = att.by_span()
    assert rows["render.binning"]["idle_s"] == pytest.approx(160e-9)


def test_the_clocks_meet_at_the_marker_launch():
    """The start marker's launch record, not its kernel (a launch latency
    later), sets the offset: a call 3 ns into span "b" stays in "b"."""
    ev = [_Event("cudaLaunchKernel", 0, 1, dev=False, corr=1), _Event("spin_kernel", 8, 10, corr=1),
          _Event("cudaLaunchKernel", 200, 201, dev=False, corr=3), _Event("spin_kernel", 208, 210, corr=3),
          _Event("cudaStreamSynchronize", 103, 150, dev=False, corr=2)]
    att = attribution.Attribution(ev, 0, 200, [("a", 0, 100), ("b", 100, 200)])
    assert att.marker_latency_ns == 8 and att.clock_drift_ns == 0
    assert att.by_span()["b"]["syncs"] == 1 and "a" not in att.by_span()
    # without the launch records the kernels' starts set it, 8 ns late
    att = attribution.Attribution([ev[1], ev[3], ev[4]], 0, 200, [("a", 0, 100), ("b", 100, 200)])
    assert att.marker_latency_ns == 0 and att.by_span()["a"]["syncs"] == 1


def test_the_offset_follows_the_clocks_drift():
    """The close marker's offset is 40 ns short of the start's: the offset
    runs from one to the other, so a call at device 880 is host 880 / 0.96
    = 916.7, in "late"; a constant offset would put it at 880, in "early"."""
    ev = [_Event("spin_kernel", 0, 5), _Event("spin_kernel", 960, 965),
          _Event("cudaStreamSynchronize", 880, 890, dev=False, corr=2)]
    spans = [("early", 0, 900), ("late", 900, 1000)]
    att = attribution.Attribution(ev, 0, 1000, spans)
    assert att.clock_drift_ns == -40 and att.window_s == pytest.approx(960e-9)
    assert att.by_span()["late"]["syncs"] == 1
    att = attribution.Attribution(ev[:1] + ev[2:], 0, 1000, spans)
    assert att.clock_drift_ns == 0 and att.by_span()["early"]["syncs"] == 1


def test_a_trace_without_markers_is_refused():
    with pytest.raises(RuntimeError):
        attribution.Attribution([_Event("k", 0, 1)], 0, 10, [])


STEP_PARTS = {"step.preprocess_ms": "render.preprocess", "step.blend_ms": "render.blend",
              "step.binning_ms": "render.binning", "step.loss_ms": "step.loss", "step.backward_ms": "step.backward",
              "step.adam_ms": "step.adam", "step.readback_ms": "step.readback"}


@pytest.mark.parametrize("name", sorted(STEP_PARTS))
def test_step_part_readers(name):
    # a program without such a span: nothing to read
    assert metrics.read(name, SimpleNamespace(phases_s={"train_step": 1.0}, iterations=10)) is None
    assert metrics.read(name, SimpleNamespace(phases_s={STEP_PARTS[name]: 0.5}, iterations=0)) is None
    assert metrics.read(name, SimpleNamespace(phases_s={STEP_PARTS[name]: 0.5}, iterations=10)) == pytest.approx(50.0)
    assert metrics.read(name, SimpleNamespace(phases_s={STEP_PARTS[name]: 0.0}, iterations=10)) == 0.0


def test_the_step_part_readers_are_listed():
    import json

    from torch_bench import harness

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in STEP_PARTS:
        m = listed[name]
        assert (m["source"], m["layer"], m["moves"], m["unit"]) == ("program_span", "step", "iters_per_s", "ms")
        assert "workloads" not in m
    assert np.all([list(listed).index(n) >= len(listed) - len(STEP_PARTS) for n in STEP_PARTS])

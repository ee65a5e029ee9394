"""The benchmark's arithmetic against the program's copies it was taken
from, the refusal of a share over 100%, the trace's reduction and the
readers' silence where there is nothing to read (CPU)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from gsdf_slam_tpu_torch.probes import timing
from torch_bench import metrics, trace
from torch_bench.metrics import counts

# the headline scene's work (PERF.md: 818,802 pairs, 3,225 tiles,
# 105,228,403 pixel-pairs up to n_contrib, 3,684,514 checkpoint words;
# P 400,000)
PAIRS, TILES, WALKED, WORDS, P = 818_802, 3_225, 105_228_403, 3_684_514, 400_000


def test_constants_match_chip_smoke():
    for name in ("FWD_WALK_OPS", "FWD_OPS", "EXPORT_LIVE_OPS", "BWD_OPS"):
        assert getattr(counts, name) == getattr(chip_smoke, name)
    assert counts.HBM_BYTES_PER_S == timing.HBM_BYTES_PER_S
    assert counts.FP32_OPS_PER_S == timing.FP32_OPS_PER_S


def test_counts_from_shapes_match_chip_smoke_at_the_headline():
    pix = 256 * TILES
    # chip_smoke.py phase 5's formulas, at the headline's counts
    fwd = 8 * TILES + 36 * PAIRS + 20 * pix + 16 * WORDS
    bwd = 8 * TILES + 40 * PAIRS + 32 * pix + 16 * WORDS + 36 * P
    assert counts.fwd_bytes(TILES, PAIRS, WORDS, export=False) == fwd
    assert counts.fwd_bytes(TILES, PAIRS, WORDS, export=True) == fwd + PAIRS
    assert counts.bwd_bytes(TILES, PAIRS, WORDS, P) == bwd
    ops = counts.FWD_WALK_OPS * WALKED
    assert counts.bound_s(fwd, ops) == pytest.approx(timing.bound_ms(fwd, ops)[0] / 1e3, rel=1e-12)
    assert counts.bound_s(bwd, ops) == pytest.approx(timing.bound_ms(bwd, ops)[0] / 1e3, rel=1e-12)


def test_blend_work_counts_from_a_launch():
    work = trace.BlendWork("cpu")
    ranges = torch.tensor([[0, 40], [40, 40], [40, 100]], dtype=torch.int32)
    payload = torch.zeros((9, 100))
    nc = torch.zeros((3, 256), dtype=torch.int32)
    nc[0, :10] = 33  # two buckets a pixel
    nc[2, 0] = 60
    work._add_fwd(ranges, payload, nc, export=False)
    work._add_bwd(ranges, nc, 7)
    got = work.read()
    walked = 10 * 33 + 60
    words = 10 * 2 + 2
    assert got["fwd_walked"] == got["bwd_walked"] == walked
    assert got["fwd_bound_s"] == pytest.approx(counts.bound_s(counts.fwd_bytes(3, 100, words, False),
                                                               counts.FWD_WALK_OPS * walked))
    # K2 reads tile 0's two live buckets (40 pairs), tile 2's two (60 pairs)
    assert got["bwd_bound_s"] == pytest.approx(counts.bound_s(counts.bwd_bytes(3, 100, words, 7),
                                                               counts.FWD_WALK_OPS * walked))


def test_share_is_refused_over_100():
    assert counts.share(1.0, 4.0) == 25.0
    assert counts.share(0.0, 4.0) is None and counts.share(1.0, 0.0) is None
    with pytest.raises(ValueError):
        counts.share(1.01, 1.0)


class _Event:
    def __init__(self, name, a, b):
        self._n, self._a, self._b = name, a, b

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def test_device_trace_reduction():
    off = 1_000_000  # device clock = host clock + off
    evs = [_Event("spin_kernel", off + 0, off + 10), _Event("void at::native::k<float>(float*)", off + 100, off + 300),
           _Event("(anonymous namespace)::blend_bwd_kernel(int const*)", off + 250, off + 400),
           _Event("blend_fwd_kernel(int const*)", off + 700, off + 800), _Event("spin_kernel", off + 1000, off + 1010)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: evs)))
    spans = [("ingest", 0, 500), ("train", 500, 1000)]
    t = trace.DeviceTrace(prof, 0, 1000, spans)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(400e-9)  # [100, 400] and [700, 800]
    assert t.kernel_seconds(trace.BWD_KERNELS) == pytest.approx(150e-9)
    assert t.kernel_seconds(trace.FWD_KERNELS) == pytest.approx(100e-9)
    assert t.idle_by_span == pytest.approx({"ingest": 100e-9, "train": 500e-9})
    assert t.clock_drift_s == 0


def _rec(**kw):
    base = dict(loop="train", lags_s=[], iterations=0, window_s=1.0, peak_bytes=0, gaussians_end=0, syncs=None,
                span_counts={}, spans_s={}, phases_s={}, keyframes_fed=0, binning={}, blend=None, trace=None,
                gaussians_per_iter=[], pixels=0, setup_s=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("name", ["stream.kf_lag_ms_p95", "bytes_per_gaussian", "mapper.syncs_per_iter", "colourise.ms_per_kf",
                                  "ingest.ms_per_kf", "step.host_ms", "binning.cached_share", "blend_fwd.roofline",
                                  "blend_bwd.roofline", "device.idle_share", "step.mfu"])
def test_reader_is_silent_with_nothing_to_read(name):
    assert metrics.read(name, _rec()) is None


def test_readers_of_a_record():
    rec = _rec(loop="paced", lags_s=[i / 1000 for i in range(1, 101)], iterations=50, window_s=2.0,
               peak_bytes=1000, gaussians_end=10, binning={"export": 3, "cached": 1})
    assert metrics.read("iters_per_s", rec) == 25.0
    assert metrics.read("stream.kf_lag_ms_p95", rec) == pytest.approx(95.05)
    assert metrics.read("bytes_per_gaussian", rec) == 100.0
    assert metrics.read("binning.cached_share", rec) == 25.0

"""Tracing, profiling and memory observability.

Port of `gsdf_slam_tpu/utils/observability.py`. The reference's telemetry
is ad hoc (commented std::chrono timers, a tensor memory printer at
gaussian_mapper.cpp:147-159, memory queries in submodules/utils/utils.h:
29-31). Here: a phase timer for the host loop, the bytes of a set of
tensors, the allocator's device memory statistics, and a torch.profiler
trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def tensor_memory_mb(tensors) -> float:
    """printTensorMemory's count for a tensor, or a dict, list or tuple of
    them (nested), in MiB."""
    if isinstance(tensors, torch.Tensor):
        return tensors.numel() * tensors.element_size() / 2**20
    if isinstance(tensors, dict):
        tensors = list(tensors.values())
    if isinstance(tensors, (list, tuple)):
        return sum(tensor_memory_mb(t) for t in tensors)
    return 0.0


def device_memory_stats(device: torch.device | str | int = 0) -> dict:
    """The CUDA caching allocator's bytes on `device`
    (utils::get_gpu_memory analog): in use now, the peak, and the card's
    total. Empty without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a torch.profiler trace of the host and the card into
    `logdir` (a Chrome trace, viewable in Perfetto or TensorBoard)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class PhaseTimer:
    """Host-side phase timer for the mapper loop: an EMA per phase, as in
    the JAX package, and each phase's call count and total seconds."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.means: dict[str, float] = defaultdict(float)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            old = self.means[name]
            self.means[name] = dt if old == 0 else self.ema * old + (1 - self.ema) * dt
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        return " ".join(f"{k}={v * 1000:.1f}ms" for k, v in sorted(self.means.items()))

    def summary(self) -> dict[str, dict[str, float]]:
        """Per phase: calls, total and mean host ms."""
        return {
            k: {"calls": self.counts[k], "total_ms": self.totals[k] * 1e3,
                "mean_ms": self.totals[k] * 1e3 / self.counts[k]}
            for k in sorted(self.totals)
        }

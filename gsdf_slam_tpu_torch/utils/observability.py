"""Tracing and device memory observability.

Port of `gsdf_slam_tpu/utils/observability.py`. The reference's telemetry
is ad hoc (commented std::chrono timers, a tensor memory printer at
gaussian_mapper.cpp:147-159, memory queries in submodules/utils/utils.h:
29-31). Here: the port's one tracer (`PhaseTimer`: nested host spans,
counters, and with `record` each span's interval), the module-level
`span` and `count` that deep ops call, which record into the tracer made
current by `using`, and the allocator's device memory statistics.

No span or counter reads the device: each is the host's clock
(`time.perf_counter_ns`, the clock a profiler's marker kernels put on the
device timeline) and host integers.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from collections import defaultdict

import torch

_CURRENT: contextvars.ContextVar[PhaseTimer | None] = contextvars.ContextVar("gsdf_tracer", default=None)


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


class PhaseTimer:
    """Host-side tracer for the mapper loop: per span name an EMA (as in
    the JAX package), the call count, total seconds and self seconds (the
    span less the spans opened inside it); host-integer counters; and,
    with `record`, each span's (name, parent name, start ns, end ns) on
    `time.perf_counter_ns` in `intervals`, in closing order."""

    def __init__(self, ema: float = 0.9, record: bool = False):
        self.ema = ema
        self.record = record
        self.means: dict[str, float] = defaultdict(float)
        self.totals: dict[str, float] = defaultdict(float)
        self.self_totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self.intervals: list[tuple[str, str | None, int, int]] = []
        # the open spans, innermost last: [name, ns covered by children]
        self._open: list[list] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        parent = self._open[-1][0] if self._open else None
        frame = [name, 0]
        self._open.append(frame)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self._open.pop()
            ns = t1 - t0
            if self._open:
                self._open[-1][1] += ns
            dt = ns / 1e9
            old = self.means[name]
            self.means[name] = dt if old == 0 else self.ema * old + (1 - self.ema) * dt
            self.totals[name] += dt
            self.self_totals[name] += (ns - frame[1]) / 1e9
            self.counts[name] += 1
            if self.record:
                self.intervals.append((name, parent, t0, t1))

    def count(self, name: str, n: int) -> None:
        self.counters[name] += int(n)

    def report(self) -> str:
        return " ".join(f"{k}={v * 1000:.1f}ms" for k, v in sorted(self.means.items()))

    def summary(self) -> dict[str, dict[str, float]]:
        """Per phase: calls, total, mean and self host ms."""
        return {
            k: {"calls": self.counts[k], "total_ms": self.totals[k] * 1e3,
                "mean_ms": self.totals[k] * 1e3 / self.counts[k], "self_ms": self.self_totals[k] * 1e3}
            for k in sorted(self.totals)
        }


@contextlib.contextmanager
def using(tracer: PhaseTimer | None):
    """Make `tracer` the one `span` and `count` record into, inside the
    block (a context variable: per thread and per asyncio task)."""
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)


def span(name: str):
    """A span of the current tracer (`using`); nothing without one."""
    tracer = _CURRENT.get()
    return contextlib.nullcontext() if tracer is None else tracer.phase(name)


def count(name: str, n: int) -> None:
    """Add `n` to the current tracer's counter `name`; nothing without one."""
    tracer = _CURRENT.get()
    if tracer is not None:
        tracer.count(name, n)

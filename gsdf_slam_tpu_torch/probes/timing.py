"""Device timing on CUDA events and the card's identity, shared by the
probes and chip_smoke.py."""

from __future__ import annotations

import subprocess

import torch

ITERS = 20
# NVIDIA H100 SXM, published dense peaks at the full 700 W limit (NVIDIA's
# data sheet): device memory bytes/s and float32 operations/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_ms(bytes_moved: float, ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take for work that moves
    `bytes_moved` bytes (each input read once, each output written once)
    and does `ops` float32 operations: (ms, "bytes" or "operations"),
    whichever bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require_cuda() -> str:
    """The card's `name, power limit` line from nvidia-smi; raises without
    a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the card: torch.cuda.is_available() is False")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device ms per call of fn over `iters` calls after one warm-up,
    on CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int = ITERS) -> float:
    """Mean device ms per call of fn: `iters` calls captured in a CUDA graph
    and replayed, timed on CUDA events. The host's cost per call (Python,
    argument checks, the launch) drops out; a wrapper counts the launches it
    captures."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters

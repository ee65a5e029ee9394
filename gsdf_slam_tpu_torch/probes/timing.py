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
# special functions (expf, logf, reciprocal) on the SFUs: 16 results a clock
# on each of the 132 SMs (the Hopper architecture white paper)
SFU_PER_CLOCK = 16 * 132


def bound_ms(bytes_moved: float, ops: float = 0.0, sfu: float = 0.0,
             sfu_per_s: float | None = None) -> tuple[float, str, str]:
    """The least time the card could take for work that moves
    `bytes_moved` bytes (each input read once, each output written once),
    does `ops` float32 operations and `sfu` special functions at
    `sfu_per_s`: (ms, "bytes" or "operations", the term that binds:
    "bytes", "float32" or "special functions")."""
    terms = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3, "float32": ops / FP32_OPS_PER_S * 1e3}
    if sfu:
        terms["special functions"] = sfu / sfu_per_s * 1e3
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def sfu_per_s() -> float:
    """Special functions per second at the card's top SM clock
    (nvidia-smi's clocks.max.sm)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return SFU_PER_CLOCK * float(mhz) * 1e6


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

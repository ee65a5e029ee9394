"""Monotone-window expansion gather on the card.

    python -m gsdf_slam_tpu_torch.probes.expand_probe [mp ...]

Port of benchmarks/expand_probe.py. The binning expansion `rows =
table[rank]` reads a table of per-Gaussian rows at a nondecreasing rank,
so each 512-lane output cell draws from a window of at most 640 table
lanes. For each mp (default 180,224 and 1,048,576 pair lanes, with p =
max(mp // 3, 1000) // 128 * 128 Gaussians) the probe times, with CUDA
events (mean of 20 launches after one warm-up):

- the plain row-gather plus transpose `tbl_rm[rank].T.contiguous()` from a
  row-major [lanes, 16] table, the counterpart of the JAX probe's `xla
  row-gather + transpose` line;
- the plain version of the kernel, the column gather `table[:, rank]`;
- the `expand_gather` kernel (csrc/expand_gather.cu), which stages each
  cell's [16, 640] window in shared memory and writes [16, mp] field-major;

each also replayed from a CUDA graph of the same 20 calls (the device's
time without the host's cost per call), and checks that the kernel is
bit-equal to `table[:, rank]`. It needs a CUDA device and fails without
one.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.blend_probe import EXPAND_CELL, EXPAND_WIN, expand_gather
from .checks import bit_equal
from .timing import cuda_ms, graph_ms, require_cuda

DEFAULT_TARGETS = (180_224, 1_048_576)


def build(mp: int, p: int):
    """Synthetic monotone expansion (benchmarks/expand_probe.py:110-136):
    p Gaussians with random tiles_touched summing to ~0.92 mp. Returns the
    padded table [16, p_lanes] float32, rank [mp], the window start of each
    512-lane cell in 128-lane blocks g0 [mp / 512], the in-window rank lr
    [mp] (all int32) and p_lanes."""
    rng = np.random.default_rng(0)
    t = rng.integers(0, 7, p).astype(np.int64)
    total = int(t.sum())
    scale = 0.92 * mp / total
    t = np.maximum((t * scale).astype(np.int64), 0)
    starts = np.cumsum(t) - t
    rank = np.zeros(mp, np.int32)
    live = t > 0
    np.maximum.at(rank, starts[live].clip(0, mp - 1), np.arange(1, p + 1)[live])
    rank = np.maximum.accumulate(rank) - 1
    rank = np.maximum(rank, 0).astype(np.int32)
    table = rng.standard_normal((16, p)).astype(np.float32)
    # int-valued rows (start/gid/rect) as exact f32 VALUES
    table[3] = np.arange(p, dtype=np.float32)
    table[4] = starts.astype(np.float32)
    p_lanes = (p + 127) // 128 * 128 + EXPAND_WIN
    table_pad = np.zeros((16, p_lanes), np.float32)
    table_pad[:, :p] = table
    g0 = (rank[::EXPAND_CELL] // 128 * 128).astype(np.int32)
    lr = (rank - np.repeat(g0, EXPAND_CELL)[: len(rank)]).astype(np.int32)
    return table_pad, rank, (g0 // 128).astype(np.int32), lr, p_lanes


def main(argv=None) -> dict:
    """Run the probe at each mp of `argv` (default DEFAULT_TARGETS); print
    one line per measurement and return {mp: {...}}."""
    targets = [int(t) for t in (argv or [])] or list(DEFAULT_TARGETS)
    smi = require_cuda()
    dev = torch.device("cuda", 0)
    results = {}
    for mp in targets:
        if mp % EXPAND_CELL:
            raise ValueError(f"mp must be a multiple of {EXPAND_CELL}, got {mp}")
        p = max(mp // 3, 1000) // 128 * 128
        table, rank, g0, lr = (torch.from_numpy(a).to(dev) for a in build(mp, p)[:4])
        tbl_rm = table.t().contiguous()  # [lanes, 16]: the row-major table the row-gather reads
        rank64 = rank.to(torch.int64)
        got = expand_gather(table, g0, lr)
        want = table[:, rank64]
        torch.cuda.synchronize()
        same = bit_equal(got, want)
        runs = {
            "gather": lambda: tbl_rm[rank64].t().contiguous(),
            "plain": lambda: table[:, rank64],
            "kernel": lambda: expand_gather(table, g0, lr),
        }
        res = dict(p=p, bit_equal=same)
        for key, fn in runs.items():
            res[f"{key}_ms"] = cuda_ms(fn)
            res[f"{key}_graph_ms"] = graph_ms(fn)
        print(f"--- mp={mp} p={p} on {smi}: ms/op on CUDA events, and replayed from a CUDA graph ---",
              flush=True)
        for key, label in (("gather", "row-gather + transpose (plain)"),
                           ("plain", "table[:, rank] (plain version)"),
                           ("kernel", "expand_gather kernel")):
            print(f"{label:40s} {res[key + '_ms']:10.4f} {res[key + '_graph_ms']:10.4f}", flush=True)
        print(f"  expand_gather bit-equal to table[:, rank]: {same}", flush=True)
        results[mp] = res
    return results


if __name__ == "__main__":
    res = main(sys.argv[1:])
    sys.exit(0 if all(r["bit_equal"] for r in res.values()) else 1)

"""The rate sweep of an open-loop cell, on the card: the cell's window at
each rate, for the highest rate whose keyframes' 95th-percentile lag stays
within one period.

    python3 -m torch_bench.sweep --workload kitti_lidar.drive --seconds 30 --seed 5 --rates 8 10 12 15

One set-up and one window a rate, in one process; no check. Prints one JSON
line a rate (the lag's 95th percentile against the period, iterations/s,
keyframes due and fed, Gaussians at the window's ends). The traffic file's
rate is 0.8 times the highest rate that keeps up, capped at the sensor's.
Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_bench.sweep: no CUDA card", file=sys.stderr)
        return 1
    from . import harness, metrics

    base = harness.load_spec(args.workload)
    for rate in args.rates:
        spec = copy.deepcopy(base)
        spec["traffic"]["window"]["rate_hz"] = rate
        cell = harness.Cell(spec, args.seed, args.seconds, torch.device("cuda", 0))
        cell.setup()
        rec = cell.window()
        lag = metrics.read("stream.kf_lag_ms_p95", rec)
        print(json.dumps({"rate_hz": rate, "period_ms": 1e3 / rate, "stream.kf_lag_ms_p95": lag,
                          "keeps_up": lag is not None and lag <= 1e3 / rate,
                          "iters_per_s": metrics.read("iters_per_s", rec),
                          **metrics.window_summary(rec)}), flush=True)
        cell.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The readings that the check's limits are set from, on the card.

    python3 -m torch_bench.readings --workload kitti_lidar.drive --seconds 5 \
        --seeds 11 12 13 --variants control half_batch altered

For each seed, one set-up, a window of `--seconds`, the program's check
segment, then the reference, and each variant put in the program's place
against the reference from the same snapshot (`check.reference_segment`):
"control", the reference in bfloat16; "half_batch", "altered",
"state_unchanged", "sources_swapped" (a monocular cell's), the planted
faults. Prints one JSON line a seed: the
seed, the program's numbers, each variant's numbers, and the seconds the
reference took. Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_bench.readings: no CUDA card", file=sys.stderr)
        return 1
    from . import harness

    spec = harness.load_spec(args.workload)
    for seed in args.seeds:
        print(json.dumps(read_seed(spec, seed, args.seconds, args.variants, torch.device("cuda", 0))), flush=True)
    return 0


def read_seed(spec: dict, seed: int, seconds: float, variants, device) -> dict:
    from . import check, harness

    cell = harness.Cell(spec, seed, seconds, device)
    cell.setup()
    cell.window()
    seg = check.program_segment(cell)
    cell.release()
    t0 = time.perf_counter()
    ref = check.reference_segment(cell, seg)
    out = {"seed": seed, "reference_s": time.perf_counter() - t0, "program": check.compare(seg, ref)}
    for v in variants:
        out[v] = check.compare(check.reference_segment(cell, seg, v), ref)
    return out


if __name__ == "__main__":
    raise SystemExit(main())

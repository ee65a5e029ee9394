"""The port's benchmark: one run of one cell.

    python3 -m torch_bench.run --workload kitti_lidar.drive --seed 1 --seconds 30 --trace 0

From the root of a checkout on a machine with an NVIDIA card. Set-up (the
kernel library from `build/torch_kernels/`, the cell's frames made on the
card from the seed, the warm segment) runs from the process's start to the
window's; the window drives the port's mapper; then the check compares the
program's own segment with the plain reference. Prints the checked
segment's steps (keyframes, binnings, losses, each leaf's first gradient)
and then the compared numbers with their limits as the last lines of
standard error, and one
JSON object as the last line of standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and `check` last. Exits 1, printing no result, without a CUDA
card, and where the process has loaded JAX or the JAX package by the time
the window and the check are over (it names them on standard error).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the run inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(var, str(ROOT / "build" / "torch_bench_cache" / sub))
# one host thread for the CPU math libraries: the step is host-bound, and
# idle worker threads spinning beside the loop make runs spread
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")


# top-level modules that no run may load: the port is measured without JAX
JAX_MODULES = ("jax", "jaxlib", "flax", "gsdf_slam_tpu")


def jax_loaded(module_names) -> list[str]:
    """The JAX_MODULES among `module_names`, by whole top-level names."""
    return sorted({name.split(".")[0] for name in module_names} & set(JAX_MODULES))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """Set up, measure and check one cell; the result line's fields."""
    import torch

    from . import check, harness, metrics

    cell = harness.Cell(spec, seed, seconds, device, traced=traced)
    cell.setup()
    setup_s = time.perf_counter() - t_start
    rec = cell.window()
    rec.setup_s = setup_s
    t_window = time.perf_counter()
    dev = cell.device
    cuda = dev.type == "cuda"
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(rec.peak_bytes, getattr(rec, "setup_peak_bytes", 0))),
    }
    wanted = spec["per_layer"] if traced else spec["end_to_end"]
    values = {}
    for m in wanted:
        v = metrics.read(m["name"], rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": False,
        "attempted": rec.keyframes_due if rec.loop == "paced" else rec.iterations,
        "failed": rec.bad_losses,
        "metrics": values,
        "device": device_info,
    }
    if traced and rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    # the record's extras, for PERF.md's growth of the map (not read by the driver)
    result["window"] = metrics.window_summary(rec)
    t_read = time.perf_counter()
    numbers = cell.check()
    t_check = time.perf_counter()
    ok, lines = check.verdict(numbers, spec["limits"])
    lines.insert(0, f"seconds: set-up {setup_s:.3f} ({cell.setup_phases}), window {rec.window_s:.3f}, "
                    f"reading it {t_read - t_window:.3f}, check {t_check - t_read:.3f} "
                    f"(reference {cell.reference_s:.3f}, {cell.reference_stats})")
    lines.insert(1, cell.segment_line)
    result["correct"] = bool(ok and rec.bad_losses == 0)
    result["check"] = {k: {"value": numbers.get(k), "limit": spec["limits"].get(k)}
                       for k in sorted(set(numbers) | set(spec["limits"]))}
    result["_lines"] = lines
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if not torch.cuda.is_available():
        print("torch_bench: torch.cuda.is_available() is False; the benchmark measures the card", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < 1:
        print("torch_bench: no CUDA device", file=sys.stderr)
        return 1
    from . import harness

    spec = harness.load_spec(args.workload)
    if torch.cuda.device_count() < int(spec["cell"]["chips"]):
        print(f"torch_bench: {args.workload} needs {spec['cell']['chips']} cards", file=sys.stderr)
        return 1
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    loaded = jax_loaded(list(sys.modules))
    if loaded:
        print(f"torch_bench: the run loaded {', '.join(loaded)}; it measures the port without JAX", file=sys.stderr)
        return 1
    lines = result.pop("_lines")
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

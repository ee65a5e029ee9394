"""Measurement probes of the port's kernels, run on the card:

    python -m gsdf_slam_tpu_torch.probes.kernel_probe [name ...]
    python -m gsdf_slam_tpu_torch.probes.expand_probe [mp ...]
    python -m gsdf_slam_tpu_torch.probes.microbench [--p P] [--mp MP] [name ...]

Ports of `benchmarks/kernel_probe.py`, `benchmarks/expand_probe.py` and
`benchmarks/microbench.py`.
"""

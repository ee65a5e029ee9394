"""Measurement probes of the port's kernels, run on the card:

    python -m gsdf_slam_tpu_torch.probes.kernel_probe [name ...]
    python -m gsdf_slam_tpu_torch.probes.expand_probe [mp ...]

Ports of `benchmarks/kernel_probe.py` and `benchmarks/expand_probe.py`.
"""

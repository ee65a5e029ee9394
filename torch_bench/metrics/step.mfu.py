"""The float32 operations the window's steps need (metrics/counts.py:
per Gaussian, per pixel and the blend's walk, a lower count) over the
traced window's seconds times the card's 67 TFLOP/s, in percent."""

from torch_bench.metrics import counts


def read(rec):
    if rec.blend is None or rec.trace is None or not rec.iterations:
        return None
    ops = counts.steps_ops(sum(rec.gaussians_per_iter), rec.pixels * rec.iterations, rec.blend["fwd_walked"],
                           rec.blend["bwd_walked"])
    return counts.share(ops / counts.FP32_OPS_PER_S, rec.trace.window_s)

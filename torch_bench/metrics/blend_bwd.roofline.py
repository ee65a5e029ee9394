"""K2's (blend_bwd) summed bound over its summed device time in the traced
window, in percent; the bound as for blend_fwd.roofline, with the pairs of
the live buckets that K2 reads and the per-Gaussian gradients it writes."""

from torch_bench.metrics import counts
from torch_bench.trace import BWD_KERNELS


def read(rec):
    if rec.blend is None or rec.trace is None or not rec.blend["bwd_calls"]:
        return None
    return counts.share(rec.blend["bwd_bound_s"], rec.trace.kernel_seconds(BWD_KERNELS))

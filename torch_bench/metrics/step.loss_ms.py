"""Host milliseconds of the program's span "step.loss" per iteration of the
window: the L1 and D-SSIM loss's forward. Inside the mapper's train_step
phase (step.host_ms). Nothing where the program has no such span."""


def read(rec):
    total = rec.phases_s.get("step.loss")
    return 1e3 * total / rec.iterations if total is not None and rec.iterations else None

"""Host milliseconds of the program's span "step.readback" per iteration of the
window: the loss and PSNR's read-back (.tolist()), where the host waits for
the step's device tail. Inside the mapper's train_step phase (step.host_ms).
Nothing where the program has no such span."""


def read(rec):
    total = rec.phases_s.get("step.readback")
    return 1e3 * total / rec.iterations if total is not None and rec.iterations else None

"""Host milliseconds of the program's span "step.adam" per iteration of the
window: the learning rates' upload and Adam over the six groups. Inside the
mapper's train_step phase (step.host_ms). Nothing where the program has no
such span."""


def read(rec):
    total = rec.phases_s.get("step.adam")
    return 1e3 * total / rec.iterations if total is not None and rec.iterations else None

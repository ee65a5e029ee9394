"""Host milliseconds of the program's span "step.backward" per iteration of the
window: the autograd backward (K2, the loss's and the preprocess's
backward). Inside the mapper's train_step phase (step.host_ms). Nothing
where the program has no such span."""


def read(rec):
    total = rec.phases_s.get("step.backward")
    return 1e3 * total / rec.iterations if total is not None and rec.iterations else None

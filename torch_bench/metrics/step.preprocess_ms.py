"""Host milliseconds of the program's span "render.preprocess" per iteration of
the window: the preprocess's forward (activations, projection, SH colours).
Inside the mapper's train_step phase (step.host_ms). Nothing where the
program has no such span."""


def read(rec):
    total = rec.phases_s.get("render.preprocess")
    return 1e3 * total / rec.iterations if total is not None and rec.iterations else None

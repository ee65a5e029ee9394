"""Host milliseconds of the program's span "render.blend" per iteration of the
window: the blend's forward: the binning, K1 or K4 (or the cached gather and
K1) and the composite. Inside the mapper's train_step phase (step.host_ms).
Nothing where the program has no such span."""


def read(rec):
    total = rec.phases_s.get("render.blend")
    return 1e3 * total / rec.iterations if total is not None and rec.iterations else None

"""Host milliseconds of the mapper's PhaseTimer train_step phase per
iteration of the window (a synchronous step: to its loss's read-back)."""


def read(rec):
    total = rec.phases_s.get("train_step", 0.0)
    return 1e3 * total / rec.iterations if rec.iterations and total > 0 else None

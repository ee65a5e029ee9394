"""Host milliseconds of the program's span "render.binning" per iteration of
the window: the binning (expand, cull, sort, K3, with the pair count's read-
back and the cull's nonzero) and an export step's cache compaction (its
nonzero). Inside the mapper's train_step phase (step.host_ms). Nothing where
the program has no such span."""


def read(rec):
    total = rec.phases_s.get("render.binning")
    return 1e3 * total / rec.iterations if total is not None and rec.iterations else None

"""Host milliseconds of the mapper's PhaseTimer ingest phases (ingest.*,
without ingest.knn, which ingest.increase_pcd holds) per keyframe fed in
the window."""


def read(rec):
    total = sum(v for k, v in rec.phases_s.items() if k.startswith("ingest.") and k != "ingest.knn")
    return 1e3 * total / rec.keyframes_fed if rec.keyframes_fed and total > 0 else None

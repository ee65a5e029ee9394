"""Steps of the window that blended through a cached binning, in percent of
its steps (GaussianMapper.binning_counts)."""


def read(rec):
    total = sum(rec.binning.values())
    return 100.0 * rec.binning.get("cached", 0) / total if total else None

"""torch.cuda.max_memory_allocated() over the window (reset at its start)
over the Gaussians at its end: the map a card can hold."""


def read(rec):
    if not rec.peak_bytes or not rec.gaussians_end:
        return None
    return rec.peak_bytes / rec.gaussians_end

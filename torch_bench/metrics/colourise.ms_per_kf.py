"""Host milliseconds of the harness's span around colorize_frame, per
keyframe colourised in the window (the call syncs, so its device work is
inside)."""


def read(rec):
    n = rec.span_counts.get("colourise", 0)
    return 1e3 * rec.spans_s["colourise"] / n if n else None

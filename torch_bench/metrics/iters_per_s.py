"""Training iterations completed in the window over its seconds (a
synchronise ends the window)."""


def read(rec):
    return rec.iterations / rec.window_s if rec.window_s > 0 else None

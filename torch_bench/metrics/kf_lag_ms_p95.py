"""The 95th percentile, over every keyframe due in the window, of the
milliseconds from its due time to the end of its feed_keyframe; a keyframe
still waiting at the close counts with its lag at the close."""

import numpy as np


def read(rec):
    if rec.loop != "paced" or not rec.lags_s:
        return None
    return float(np.percentile(np.asarray(rec.lags_s, dtype=np.float64) * 1e3, 95))

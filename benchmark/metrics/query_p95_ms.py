"""The 95th percentile, in ms, of every case query completed in the window,
each timed from its issue to its returned hits (numpy's linear
interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = [r["latency_s"] for r in run.records if not r["failed"]]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None

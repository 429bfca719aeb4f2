"""The 95th percentile of every request's latency in the window, from its
call to the synchronize that returns its features (host clock)."""

import numpy as np


def read(run):
    lat = run.get("latencies")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None

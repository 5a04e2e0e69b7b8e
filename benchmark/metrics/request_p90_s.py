"""90th percentile latency of the requests completed in the window (linear
interpolation between order statistics)."""

import numpy as np


def read(ctx):
    lat = [s for _, s, _ in getattr(ctx.run, "records", ())]
    return float(np.percentile(lat, 90)) if lat else None

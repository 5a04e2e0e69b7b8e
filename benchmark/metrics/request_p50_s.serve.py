"""Median latency of the requests completed in the measured window, each
from its send to its image on the host.  A per-layer reading: it swings
with the host's speed from run to run more than ``request_p90_s`` does.  In
a ``--trace 1`` run the measured window times the sampler's calls, each
ending in a device synchronize, so it reads a little higher there."""

import statistics


def read(ctx):
    lat = [s for _, s, _ in getattr(ctx.run, "records", ())]
    return statistics.median(lat) if lat else None

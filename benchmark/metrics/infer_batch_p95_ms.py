"""The 95th percentile over every batch completed in the window of its
time from the call to its masks on the host (host clock)."""

import statistics


def read(ctx):
    lat = ctx.latencies
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3

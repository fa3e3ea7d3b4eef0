"""The 95th percentile, over every request completed in the window, of the
seconds from `generate` being called to its return."""

import statistics


def read(run):
    lat = [r.done - r.sent for r in run.done]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]

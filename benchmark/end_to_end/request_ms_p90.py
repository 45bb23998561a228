"""The 90th percentile of every request's latency in the window, call to
frames on the host, in ms."""

import statistics


def read(window):
    if len(window.latencies) < 2:
        return None
    return 1e3 * statistics.quantiles(window.latencies, n=10, method="inclusive")[8]

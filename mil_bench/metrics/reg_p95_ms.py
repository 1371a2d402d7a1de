"""The 95th percentile of every pair's latency in the window, ms."""
from milbench.stats import percentile


def read(run):
    lat = run.latencies_s()
    return None if not lat else 1e3 * percentile(lat, 95)

"""serve_latency_p95_ms: the 95th percentile of every volume's latency in the
window (normalisation start to labels on the host), interpolated between
order statistics as ``statistics.quantiles(method="inclusive")``."""
import statistics


def read(record):
    if record["kind"] != "serve" or len(record["latencies_s"]) < 2:
        return None
    return 1e3 * statistics.quantiles(record["latencies_s"], n=100, method="inclusive")[94]

"""device_idle_pct.serve: the share of the traced window in which no operation
ran on the device (one less the union of their intervals over the window)."""


def read(record):
    trace = record["trace"]
    if record["kind"] != "serve" or not trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])

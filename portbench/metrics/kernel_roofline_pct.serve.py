"""kernel_roofline_pct.serve: the least time of the window's work for the
system's hand-written kernels (portbench.roofline, from the configuration's
shapes) over their device time in the traced window."""


def read(record):
    trace, bound = record["trace"], record["kernel_bound_s"]
    if record["kind"] != "serve" or not trace or not trace["kernel_s"] or not bound:
        return None
    return 100.0 * bound / trace["kernel_s"]

"""serve_volumes_per_s: volumes whose labels reached the host, over the
whole window."""


def read(record):
    if record["kind"] != "serve":
        return None
    return record["units"] / record["window_s"]

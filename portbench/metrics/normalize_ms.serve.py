"""normalize_ms.serve: the mean time of the harness's span around the
system's ``PETandCTNormalize`` of a volume."""


def read(record):
    if record["kind"] != "serve" or not record["normalize_s"]:
        return None
    return 1e3 * sum(record["normalize_s"]) / len(record["normalize_s"])

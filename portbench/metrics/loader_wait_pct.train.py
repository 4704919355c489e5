"""loader_wait_pct.train: the seconds ``SemanticSeg._run_epoch`` counted
waiting on its loader (its ``loader_wait_seconds``), over the window."""


def read(record):
    if record["kind"] != "train":
        return None
    return 100.0 * record["loader_wait_s"] / record["window_s"]

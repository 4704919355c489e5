"""peak_mem_gib.train: the caching allocator's peak of reserved
bytes over the window, reset at its start (a captured graph's pool counts
while the graph lives)."""


def read(record):
    if record["kind"] != "train" or record["window_peak_bytes"] is None:
        return None
    return record["window_peak_bytes"] / 2 ** 30

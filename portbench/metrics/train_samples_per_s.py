"""train_samples_per_s: training samples of every step of the window's
epochs, over the whole window."""


def read(record):
    if record["kind"] != "train":
        return None
    return record["samples"] / record["window_s"]

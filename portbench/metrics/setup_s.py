"""setup_s: process start to the first timed step or volume (imports, the
CUDA context, the kernel library, weights, inputs, warm-up and capture)."""


def read(record):
    return record["setup_s"]

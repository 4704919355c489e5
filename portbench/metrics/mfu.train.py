"""mfu.train: the fine-grid model FLOPs of the window's work (portbench.flops)
over the window times the H100's dense bf16 peak, 989 TFLOP/s."""
from portbench.roofline import PEAK_BF16_FLOPS


def read(record):
    if record["kind"] != "train":
        return None
    return 100.0 * record["flops"] / (record["window_s"] * PEAK_BF16_FLOPS)

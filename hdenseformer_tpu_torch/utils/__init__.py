"""Utilities of the port (``profiling.py``), re-exported as JAX's are."""
from hdenseformer_tpu_torch.utils.profiling import (
    Timer,
    count_flops,
    count_params,
    profiler_trace,
    set_process_title,
)

__all__ = ["Timer", "count_flops", "count_params", "profiler_trace", "set_process_title"]

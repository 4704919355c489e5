"""Experiment configuration of the port (``config.py``)."""
from hdenseformer_tpu_torch.configs.config import DATASET_PRESETS, ExperimentConfig, get_config

__all__ = ["DATASET_PRESETS", "ExperimentConfig", "get_config"]

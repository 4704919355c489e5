"""Losses of the port (``losses.py``)."""
from hdenseformer_tpu_torch.losses.losses import (
    LOSS_REGISTRY,
    cross_entropy_loss,
    deep_supervision_loss,
    focal_loss,
    get_loss,
)

__all__ = [
    "LOSS_REGISTRY",
    "cross_entropy_loss",
    "deep_supervision_loss",
    "focal_loss",
    "get_loss",
]

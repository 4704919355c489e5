"""Losses of the port (``losses.py``)."""
from hdenseformer_tpu_torch.losses.losses import (
    LOSS_REGISTRY,
    binary_dice_loss,
    ce_plus_dice,
    cross_entropy_loss,
    deep_supervision_loss,
    dice_loss,
    fl_loss,
    fl_plus_dice,
    focal_loss,
    get_loss,
    topk_loss,
)

__all__ = [
    "LOSS_REGISTRY",
    "binary_dice_loss",
    "ce_plus_dice",
    "cross_entropy_loss",
    "deep_supervision_loss",
    "dice_loss",
    "fl_loss",
    "fl_plus_dice",
    "focal_loss",
    "get_loss",
    "topk_loss",
]

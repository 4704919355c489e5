"""Metrics of the port: in-step dice and confusion matrix on the device,
running dice, mIoU and averages on the host, offline eval3d metrics."""

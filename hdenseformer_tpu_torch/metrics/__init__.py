"""Metrics of the port: in-step dice and confusion matrix on the device,
running dice and averages on the host."""

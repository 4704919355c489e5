"""Whole-volume inference of the port."""

"""Numpy and device helpers."""

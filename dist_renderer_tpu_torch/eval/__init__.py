"""Evaluation: mesh extraction, chamfer distance, the native mesh kernels."""

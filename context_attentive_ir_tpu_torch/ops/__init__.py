"""Layers, recurrences, attention and the hand-written CUDA kernels."""

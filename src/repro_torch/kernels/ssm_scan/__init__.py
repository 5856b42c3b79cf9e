"""Diagonal linear scan: plain version, CUDA binding, dispatching wrapper."""

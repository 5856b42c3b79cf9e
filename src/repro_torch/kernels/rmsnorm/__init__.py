"""Fused RMSNorm: plain version, CUDA binding, dispatching wrapper."""

"""Fused selective scan of a Mamba head (inference): plain version, CPU
emulation of the kernel's loop, CUDA binding, dispatching wrapper."""

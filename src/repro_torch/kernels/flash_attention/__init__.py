"""Flash attention: plain version, CUDA binding, dispatching wrapper."""

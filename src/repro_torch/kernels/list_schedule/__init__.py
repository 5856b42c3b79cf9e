"""List schedule of a task graph under many hardware-parameter vectors:
plain version, CUDA binding, dispatching wrapper."""

"""Hardware models of the simulated NPU (copies of ``repro.hw``)."""

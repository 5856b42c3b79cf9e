"""Power-EM: joint performance/power analysis (paper §5)."""
from .characterization import DEFAULT_CHARS, LeakageLUT, PowerChar, VFCurve
from .dvfs import DvfsPoint, choose_operating_point, sweep
from .powerem import PowerEM, PowerNode, PowerReport, build_power_tree

__all__ = [
    "DEFAULT_CHARS",
    "DvfsPoint",
    "LeakageLUT",
    "PowerChar",
    "PowerEM",
    "PowerNode",
    "PowerReport",
    "VFCurve",
    "build_power_tree",
    "choose_operating_point",
    "sweep",
]

"""Model zoo: shared layers + block library + segment-based assembly."""
from .model import Model, Segment, build_model, plan_segments

__all__ = ["Model", "Segment", "build_model", "plan_segments"]

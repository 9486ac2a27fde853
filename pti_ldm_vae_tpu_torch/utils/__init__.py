from .determinism import set_determinism
from .visualization import normalize_batch_for_display

__all__ = ["normalize_batch_for_display", "set_determinism"]

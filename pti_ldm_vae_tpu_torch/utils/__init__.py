from .determinism import set_determinism
from .visualization import (
    normalize_batch_for_display,
    normalize_image_to_uint8,
    visualize_2d_image,
    visualize_one_slice_in_3d_image,
)

__all__ = [
    "normalize_batch_for_display",
    "normalize_image_to_uint8",
    "set_determinism",
    "visualize_2d_image",
    "visualize_one_slice_in_3d_image",
]

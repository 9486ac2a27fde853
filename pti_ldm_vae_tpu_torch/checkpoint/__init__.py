from .manager import CheckpointManager
from .torch_convert import (
    lpips_params_from_jax,
    lpips_params_from_npz,
    monai_layout,
    monai_state_dict,
    state_dict_from_flax,
)

__all__ = [
    "CheckpointManager",
    "lpips_params_from_jax",
    "lpips_params_from_npz",
    "monai_layout",
    "monai_state_dict",
    "state_dict_from_flax",
]

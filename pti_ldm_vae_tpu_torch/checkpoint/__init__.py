from .manager import CheckpointManager
from .paths import resolve_checkpoint
from .reference_resume import load_reference_checkpoint
from .torch_convert import (
    disc_monai_layout,
    disc_state_dict_from_flax,
    lpips_params_from_jax,
    lpips_params_from_npz,
    monai_layout,
    monai_state_dict,
    state_dict_from_flax,
)

__all__ = [
    "CheckpointManager",
    "disc_monai_layout",
    "disc_state_dict_from_flax",
    "load_reference_checkpoint",
    "lpips_params_from_jax",
    "lpips_params_from_npz",
    "monai_layout",
    "monai_state_dict",
    "resolve_checkpoint",
    "state_dict_from_flax",
]

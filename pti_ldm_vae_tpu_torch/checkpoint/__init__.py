from .torch_convert import monai_layout, monai_state_dict, state_dict_from_flax

__all__ = ["monai_layout", "monai_state_dict", "state_dict_from_flax"]

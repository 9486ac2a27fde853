from .datasets import list_tif_paths, split_dataset
from .factory import (
    RegressionLoader,
    create_regression_dataloaders,
    create_regression_eval_dataloader,
    create_regression_inference_dataloader,
    create_vae_dataloaders,
    create_vae_inference_dataloader,
)
from .io import TifReader, read_image, write_png, write_tif
from .loader import ShardedDataLoader, shard_indices
from .transforms import (
    local_normalize_by_mask,
    local_normalize_by_mask_np,
    preprocess_batch_device,
    preprocess_image_np,
    resize_area_np,
)

__all__ = [
    "RegressionLoader",
    "ShardedDataLoader",
    "TifReader",
    "create_regression_dataloaders",
    "create_regression_eval_dataloader",
    "create_regression_inference_dataloader",
    "create_vae_dataloaders",
    "create_vae_inference_dataloader",
    "list_tif_paths",
    "local_normalize_by_mask",
    "local_normalize_by_mask_np",
    "preprocess_batch_device",
    "preprocess_image_np",
    "read_image",
    "resize_area_np",
    "shard_indices",
    "split_dataset",
    "write_png",
    "write_tif",
]

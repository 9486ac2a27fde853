"""Shared CLI plumbing for inference (counterpart of the inference subset of
``pti_ldm_vae_tpu/utils/cli_common.py``), plus device selection.

Entry points run on CUDA unless ``--device cpu`` is passed; with no CUDA
device and no explicit ``cpu`` they raise rather than run on the CPU.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch

from ..config import resolve_bool
from ..data.factory import create_vae_inference_dataloader
from ..models.autoencoder_kl import AutoencoderKL
from ..models.unet import ConditionProjector, DiffusionUNet, diffusion_unet_from_config
from ..ops.norm import DEFAULT_NORM_STATS
from ..train.diffusion import NoiseSchedule
from .determinism import set_determinism
from .vae_loader import load_vae_config, load_vae_model

__all__ = [
    "add_shared_io_args",
    "resolve_device",
    "init_device_and_seed",
    "enable_parity_numerics",
    "load_config_and_model",
    "LdmModels",
    "load_ldm_models",
    "build_inference_dataloader",
    "resolve_inference_output_dirs",
    "resolve_eval_output_dir",
    "load_json_config",
    "resolve_run_dir",
    "serialize_args",
]


def add_shared_io_args(parser: argparse.ArgumentParser, output_help: str) -> None:
    """Common IO arguments (reference ``cli_common.py:16-37``) and ``--device``."""
    parser.add_argument("-c", "--config-file", required=True, help="Config json file")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Checkpoint path (torch .pth, MONAI keys)")
    parser.add_argument("--input-dir", type=str, required=True,
                        help="Directory containing input TIF images")
    parser.add_argument("--output-dir", type=str, default=None, help=output_help)
    parser.add_argument("--num-samples", type=int, default=None,
                        help="Number of samples to process (default: all)")
    parser.add_argument("--batch-size", type=int, default=8, help="Batch size (default: 8)")
    parser.add_argument("--num-workers", type=int, default=4,
                        help="Number of loader workers (default: 4)")
    parser.add_argument("--seed", type=int, default=42,
                        help="Random seed for determinism (default: 42)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")


def resolve_device(name: str) -> torch.device:
    """``cuda[:i]`` or ``cpu``; raises when CUDA is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def init_device_and_seed(seed: int | None, device: torch.device) -> torch.Generator:
    """Report the device and seed the RNGs (reference ``cli_common.py:40-54``);
    returns a generator on ``device``."""
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"Using device: {device} ({where})")
    return set_determinism(seed, device)


def enable_parity_numerics() -> None:
    """True f32 numerics: cuDNN runs f32 convolutions in TF32 unless told not to."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_config_and_model(
    config_file: str, checkpoint_path: str, *, device: torch.device, exact: bool = False,
    conv_kernel: bool = False, s2d_stem: bool | str | None = None,
) -> tuple[Any, AutoencoderKL]:
    """Reference ``cli_common.py:57-70``: returns (config_namespace, model).

    Compute dtype: bf16 on CUDA, f32 on the CPU or with ``exact=True``, which
    also turns TF32 off and pins the standard (reference) formulation
    (``s2d_stem`` False). Otherwise ``s2d_stem`` overrides the config's key
    (``None``: the config's, default ``"auto"``). ``conv_kernel`` sends the 3x3
    convolutions through the hand-written kernels."""
    if exact:
        enable_parity_numerics()
    compute_dtype = torch.float32 if exact or device.type == "cpu" else torch.bfloat16
    config = load_vae_config(config_file)
    model = load_vae_model(
        config, checkpoint_path, device=device, compute_dtype=compute_dtype,
        s2d_stem=False if exact else s2d_stem, conv_kernel=conv_kernel,
    )
    return config, model


@dataclass
class LdmModels:
    """What both diffusion CLIs build from an LDM config: the frozen VAE, the
    UNet and (with conditioning) the projector on the device, the schedule
    (on the device) and the latent shape of one image."""

    vae_config: Any
    vae: AutoencoderKL
    unet: DiffusionUNet
    projector: ConditionProjector | None
    schedule: NoiseSchedule
    latent_shape: tuple[int, int, int]


def load_ldm_models(cfg: dict, *, device: torch.device, exact: bool = False,
                    remat: bool = False) -> LdmModels:
    """The frozen VAE of ``cfg["vae"]`` (``load_config_and_model``) and a
    freshly initialized UNet and projector of ``cfg["diffusion_def"]`` in the
    same compute dtype (bf16 on CUDA, f32 on the CPU or with ``exact``, which
    also turns TF32 off). Top-level ``remat`` / ``norm_stats`` keys win over
    the ``diffusion_def`` ones, as in the JAX package's CLIs; ``remat`` (or the
    keyword) checkpoints the UNet's blocks."""
    vae_config, vae = load_config_and_model(cfg["vae"]["config_file"], cfg["vae"]["checkpoint"],
                                            device=device, exact=exact)
    ae_def = vae_config.autoencoder_def
    if ae_def.get("spatial_dims", 2) != 2:
        raise NotImplementedError(
            f"the diffusion CLIs support spatial_dims=2 VAEs only (got {ae_def['spatial_dims']})")
    dd = cfg["diffusion_def"]
    remat = remat or resolve_bool(cfg.get("remat", dd.get("remat", False)))
    norm_stats = str(cfg.get("norm_stats", dd.get("norm_stats", DEFAULT_NORM_STATS)))
    unet = diffusion_unet_from_config(dd, compute_dtype=vae.compute_dtype, remat=remat,
                                      norm_stats=norm_stats)
    projector = None
    if dd.get("with_conditioning", True):
        projector = ConditionProjector(dd["in_channels"], dd.get("cross_attention_dim", 512))
        projector = projector.to(device)
    train_cfg = cfg["diffusion_train"]
    schedule = NoiseSchedule.linear_beta(
        int(train_cfg.get("num_train_timesteps", 1000)),
        float(train_cfg.get("beta_start", 1e-4)),
        float(train_cfg.get("beta_end", 2e-2)),
    ).to(device)
    # each of the VAE's downsamples, (0, 1) pad + 3x3 stride 2, halves a side (rounding down)
    h, w = vae_config.autoencoder_train["patch_size"]
    for _ in range(len(ae_def["channels"]) - 1):
        h, w = h // 2, w // 2
    return LdmModels(vae_config, vae, unet.to(device=device, memory_format=torch.channels_last),
                     projector, schedule, (h, w, int(ae_def["latent_channels"])))


def build_inference_dataloader(
    input_dir: str, config: Any, batch_size: int, num_samples: int | None, num_workers: int
):
    patch_size = tuple(config.autoencoder_train["patch_size"])
    return create_vae_inference_dataloader(
        input_dir=input_dir, patch_size=patch_size, batch_size=batch_size,
        num_samples=num_samples, num_workers=num_workers,
    )


def resolve_inference_output_dirs(
    checkpoint_path: str, output_dir: str | None
) -> tuple[Path, Path, Path]:
    """Reference ``cli_common.py:102-134``."""
    checkpoint_name = Path(checkpoint_path).stem or Path(checkpoint_path).name
    base = Path(f"inference_vae_{checkpoint_name}") if output_dir is None else Path(output_dir)
    out_tif = base / "results_tif"
    out_png = base / "results_png"
    out_tif.mkdir(parents=True, exist_ok=True)
    out_png.mkdir(parents=True, exist_ok=True)
    return base, out_tif, out_png


def resolve_eval_output_dir(config_file: str, output_dir: str | None) -> Path:
    """``evals/<config_stem>`` unless given (reference ``vae_loader.py:46-56``)."""
    out = Path(output_dir) if output_dir is not None else Path("evals") / Path(config_file).stem
    out.mkdir(parents=True, exist_ok=True)
    return out


def load_json_config(config_file: str) -> dict[str, Any]:
    """Plain JSON load, no @refs (regression configs, reference ``cli_common.py:137-147``)."""
    with open(config_file, encoding="utf-8") as fh:
        return json.load(fh)


def resolve_run_dir(config: dict[str, Any], config_file: str) -> Path:
    """``runs/<config_stem>`` unless ``run_dir`` is set (reference
    ``cli_common.py:150-166``); created."""
    if config.get("run_dir"):
        run_dir = Path(config["run_dir"])
    else:
        run_dir = Path("runs") / Path(config_file).stem
        config["run_dir"] = str(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def serialize_args(args: Any) -> dict[str, Any]:
    """CLI args -> JSON-serializable (reference ``eval_metrics.py:66-83``)."""
    out: dict[str, Any] = {}
    for key, value in vars(args).items():
        if hasattr(value, "__fspath__"):
            out[key] = str(value)
        elif isinstance(value, (list, tuple)):
            out[key] = [str(item) for item in value]
        else:
            out[key] = value
    return out

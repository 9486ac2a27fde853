"""VAE training CLI (counterpart of ``pti_ldm_vae_tpu/cli/train_vae.py``;
workload parity with ``vae_scripts/train_vae.py``). Runs on CUDA unless
``--device cpu`` is given.

    python -m pti_ldm_vae_tpu_torch.cli.train_vae -c config/vae_dente_no_adv.json \\
        [--no-wandb] [--f32] [--conv-kernel] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..config import load_config
from ..train.loop import VAETrainer
from ..utils.cli_common import enable_parity_numerics, resolve_device
from ..utils.logging import load_dotenv

__all__ = ["main"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train a VAE (PyTorch/CUDA)",
        epilog="Perceptual loss: converted LPIPS(squeeze) weights are loaded "
               "from $PTI_LPIPS_WEIGHTS or weights/lpips_squeeze.npz. Without "
               "them training uses deterministic RANDOM perceptual features — "
               "fine for smoke runs, NOT valid for parity with the torch "
               "reference; the run config records perceptual_pretrained "
               "accordingly.",
    )
    parser.add_argument("-c", "--config-file", required=True, help="Config json file")
    parser.add_argument("-g", "--gpus", type=int, default=1,
                        help="Accepted for reference CLI compatibility; one device is used")
    parser.add_argument("--batch-size", type=int, default=None, help="Override batch size")
    parser.add_argument("--max-epochs", type=int, default=None, help="Override max epochs")
    parser.add_argument("--lr", type=float, default=None, help="Override learning rate")
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--cache-rate", type=float, default=0.0,
                        help="Fraction of training data cached in RAM")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--subset-size", type=int, default=None,
                        help="Use only the first N images (smoke runs)")
    parser.add_argument("--no-wandb", action="store_true")
    parser.add_argument("--remat", action="store_true",
                        help="Activation checkpointing of the ResBlocks and attention blocks "
                             "(same as config \"remat\": true): their activations are "
                             "recomputed in the backward instead of kept")
    parser.add_argument("--s2d-stem", nargs="?", const="true", default=None,
                        choices=("true", "false", "auto", "encoder", "decoder"),
                        help="Space-to-depth full-resolution path (same as config "
                             "\"s2d_stem\"): the encoder's level 0 and/or the decoder's "
                             "full-resolution tail at half resolution with 4x the channels; "
                             "\"auto\" (the default) takes the standard path on the H100")
    parser.add_argument("--norm-stats", choices=("two_pass", "one_pass"), default=None,
                        help="GroupNorm statistics formulation (same as config "
                             "\"norm_stats\"): \"one_pass\" through the GroupNorm+SiLU "
                             "kernels, \"two_pass\" (centered variance) as plain tensor code")
    parser.add_argument("--f32", action="store_true",
                        help="f32 compute with TF32 off (parity runs)")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions of the autoencoder through the "
                             "hand-written convolution kernels (forward, input and filter "
                             "gradient) instead of cuDNN")
    parser.add_argument("--profile-port", type=int, default=None,
                        help="Profiler server port of the JAX CLI; raises here: torch has "
                             "no live profiler endpoint (use --trace-at-step)")
    parser.add_argument("--trace-at-step", type=int, default=None,
                        help="Capture one torch.profiler trace of this global step into "
                             "<run_dir>/traces (TensorBoard-readable)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    load_dotenv()  # WANDB_PROJECT/WANDB_ENTITY (reference ``train_vae.py:30``)
    cfg = load_config(args.config_file)

    # CLI overrides (reference ``train_vae.py:113-119``).
    if args.batch_size:
        cfg["autoencoder_train"]["batch_size"] = args.batch_size
    if args.max_epochs:
        cfg["autoencoder_train"]["max_epochs"] = args.max_epochs
    if args.lr:
        cfg["autoencoder_train"]["lr"] = args.lr
    if args.remat:
        cfg["remat"] = True
    if args.s2d_stem is not None:
        cfg["s2d_stem"] = {"true": True, "false": False}.get(args.s2d_stem, args.s2d_stem)
    if args.norm_stats:
        cfg["norm_stats"] = args.norm_stats
    if args.f32:
        enable_parity_numerics()

    trainer = VAETrainer(
        cfg,
        device=device,
        seed=args.seed,
        num_workers=args.num_workers,
        cache_rate=args.cache_rate,
        subset_size=args.subset_size,
        mixed_precision=False if args.f32 else None,
        use_wandb=False if args.no_wandb else None,
        profile_port=args.profile_port,
        trace_at_step=args.trace_at_step,
        conv_kernel=args.conv_kernel,
    )
    return trainer.train()


if __name__ == "__main__":
    main()

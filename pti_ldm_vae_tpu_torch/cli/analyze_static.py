"""Static latent-space projection CLI (t-SNE or UMAP -> PNG) (counterpart of
``pti_ldm_vae_tpu/cli/analyze_static.py``; reference
``vae_scripts/analyze_static.py``): cached group encoding with the frozen VAE
in f32 (TF32 off), PCA -> t-SNE on the device, fitted jointly on both groups
and split afterwards, or PCA -> UMAP on the edente group with dente aligned
through the fitted model's ``transform`` (needs ``umap-learn``); the plot as a
PNG and per-exam distance statistics. CUDA unless ``--device cpu``.

    python -m pti_ldm_vae_tpu_torch.cli.analyze_static --vae-weights vae.pth \\
        --config-file config/vae_dente_no_adv.json --folder-edente data/edente \\
        --folder-dente data/dente --method tsne --color-by-patient [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..analysis import LatentSpaceAnalyzer
from ..analysis.common import (
    compute_and_save_statistics,
    create_transforms,
    load_and_encode_group_with_cache,
    load_vae_model,
    save_visualization_and_legend,
    set_seed,
    setup_device_and_output,
)

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Static Latent Space Analysis (UMAP or t-SNE)")
    parser.add_argument("--vae-weights", type=str, required=True)
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--folder-edente", type=str, required=True)
    parser.add_argument("--folder-dente", type=str, default=None)
    parser.add_argument("--output-dir", type=str, default="projections")
    parser.add_argument("--max-images", type=int, default=1000)
    parser.add_argument("--patch-size", type=int, nargs=2, default=[256, 256])
    parser.add_argument("--color-by-patient", action="store_true")
    parser.add_argument("--method", type=str, choices=["umap", "tsne"], default="umap")
    parser.add_argument("--n-neighbors", type=int, default=40)
    parser.add_argument("--min-dist", type=float, default=0.5)
    parser.add_argument("--perplexity", type=int, default=30)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--subtitle", type=str, default=None)
    parser.add_argument("--dpi", type=int, default=300)
    parser.add_argument("--cache-dir", type=str, default="cache/latents")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions of the encoder through the "
                             "hand-written convolution kernels instead of cuDNN")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the projections by group, the ids and the plot's path."""
    args = parse_args(argv)
    set_seed(args.seed)
    print(f"Static Latent Space Analysis - {args.method.upper()}")

    device, output_dir = setup_device_and_output(args.output_dir, args.device)
    model = load_vae_model(args.config_file, args.vae_weights, device=device,
                           conv_kernel=args.conv_kernel)
    transform = create_transforms(tuple(args.patch_size))
    analyzer = LatentSpaceAnalyzer(model, transform, device=device)

    latent_edente, ids_edente, paths_edente = load_and_encode_group_with_cache(
        analyzer, args.folder_edente, args.vae_weights,
        args.max_images, tuple(args.patch_size), "edente", cache_dir=args.cache_dir,
    )
    latent_dente = ids_dente = paths_dente = None
    if args.folder_dente:
        latent_dente, ids_dente, paths_dente = load_and_encode_group_with_cache(
            analyzer, args.folder_dente, args.vae_weights,
            args.max_images, tuple(args.patch_size), "dente", cache_dir=args.cache_dir,
        )

    projections = []
    proj_dente = None
    if args.method == "umap":
        proj_edente, umap_model = analyzer.reduce_dimensionality_umap(
            latent_edente, n_neighbors=args.n_neighbors, min_dist=args.min_dist,
            random_state=args.seed, pca_components=min(len(latent_edente), 50),
        )
        projections.append((proj_edente, ids_edente, "o", "edente"))
        if args.folder_dente:
            # align dente through the fitted PCA -> UMAP (reference ``:249-257``)
            proj_dente = umap_model.transform(latent_dente)
            projections.append((proj_dente, ids_dente, "o_filled", "dente"))
        output_filename = "umap_projection.png"
        title = "UMAP"
    else:
        combined = (
            np.concatenate([latent_edente, latent_dente]) if args.folder_dente else latent_edente
        )
        # fit t-SNE jointly, then split (reference ``:263-279``)
        tsne_combined = analyzer.reduce_dimensionality_tsne(
            combined, perplexity=args.perplexity, random_state=args.seed,
            pca_components=min(len(combined), 50),
        )
        split = len(latent_edente)
        proj_edente = tsne_combined[:split]
        projections.append((proj_edente, ids_edente, "o", "edente"))
        if args.folder_dente:
            proj_dente = tsne_combined[split:]
            projections.append((proj_dente, ids_dente, "o_filled", "dente"))
        output_filename = "tsne_projection.png"
        title = "t-SNE"

    if args.folder_dente:
        title = f"{title} (dente filled, edente open)"
    if args.subtitle:
        title = f"{title} — {args.subtitle}"

    plot = save_visualization_and_legend(
        analyzer, projections, output_dir, title, args.color_by_patient,
        ids_edente, ids_dente, output_filename,
        image_paths_list=[paths_edente] + ([paths_dente] if paths_dente else []),
    )

    if args.folder_dente:
        compute_and_save_statistics(
            analyzer, proj_edente, proj_dente, latent_edente, latent_dente,
            ids_edente, ids_dente, "edente", "dente", output_dir,
        )
    print("Analysis complete.")
    return {"plot": plot, "projections": {name: v for v, _, _, name in projections},
            "ids": {name: ids for _, ids, _, name in projections}}


if __name__ == "__main__":
    main()

"""Interactive latent-space explorer (Dash app; static export otherwise)
(counterpart of ``pti_ldm_vae_tpu/cli/analyze_interactive.py``; reference
``vae_scripts/analyze_interactive.py``): a scatter of the t-SNE / UMAP
projection with click-to-view images, live-recompute sliders and a 2-point
latent distance panel. ``dash`` is optional: without it (or with
``--export``) the same content is exported statically, the projection plot
(PNG) and ``projection_data.json`` with coordinates, ids and paths. Encoding
and projection run on the device (CUDA unless ``--device cpu``).

    python -m pti_ldm_vae_tpu_torch.cli.analyze_interactive --vae-weights vae.pth \\
        --config-file config/vae_dente_no_adv.json --folder-edente data/edente \\
        --folder-dente data/dente --method tsne --export [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..analysis import LatentSpaceAnalyzer
from ..analysis.common import (
    create_transforms,
    load_and_encode_group_with_cache,
    load_vae_model,
    set_seed,
    setup_device_and_output,
)

__all__ = ["main", "export_static", "recompute_projection", "slider_recompute_payload"]

try:
    import dash  # noqa: F401
    _HAS_DASH = True
except ImportError:  # pragma: no cover
    _HAS_DASH = False


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Interactive Latent Space Analysis")
    parser.add_argument("--vae-weights", type=str, required=True)
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--folder-edente", type=str, required=True)
    parser.add_argument("--folder-dente", type=str, default=None)
    parser.add_argument("--max-images", type=int, default=3000)
    parser.add_argument("--patch-size", type=int, nargs=2, default=[256, 256])
    parser.add_argument("--method", type=str, choices=["umap", "tsne"], default="umap")
    parser.add_argument("--n-neighbors", type=int, default=40)
    parser.add_argument("--min-dist", type=float, default=0.5)
    parser.add_argument("--perplexity", type=int, default=30)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--color-by-patient", action="store_true",
                        help="Color scatter points by patient id (reference flag)")
    parser.add_argument("--subtitle", type=str, default=None)
    parser.add_argument("--port", type=int, default=8050)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--output-dir", type=str, default="projections_interactive")
    parser.add_argument("--export", action="store_true",
                        help="Skip the server; export static artifacts only")
    parser.add_argument("--cache-dir", type=str, default="cache/latents")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions of the encoder through the "
                             "hand-written convolution kernels instead of cuDNN")
    return parser.parse_args(argv)


def _compute_groups(args):
    set_seed(args.seed)
    device, output_dir = setup_device_and_output(args.output_dir, args.device)
    model = load_vae_model(args.config_file, args.vae_weights, device=device,
                           conv_kernel=args.conv_kernel)
    analyzer = LatentSpaceAnalyzer(model, create_transforms(tuple(args.patch_size)), device=device)
    groups = []
    for folder, name, marker in (
        (args.folder_edente, "edente", "o"),
        (args.folder_dente, "dente", "o_filled"),
    ):
        if folder is None:
            continue
        latents, ids, paths = load_and_encode_group_with_cache(
            analyzer, folder, args.vae_weights, args.max_images,
            tuple(args.patch_size), name, cache_dir=args.cache_dir,
        )
        groups.append({"name": name, "marker": marker, "latents": latents,
                       "ids": ids, "paths": paths})
    return analyzer, output_dir, groups


def recompute_projection(
    analyzer,
    groups,
    method: str,
    *,
    n_neighbors: int = 40,
    min_dist: float = 0.5,
    perplexity: int = 30,
    seed: int = 42,
):
    """(Re)fit the 2-D projection with explicit hyperparameters, for the
    initial render and the live-recompute sliders (reference
    ``analyze_interactive.py:559-636``): UMAP fits on the first group's
    PCA-50 latents and aligns the others through the composed PCA -> UMAP
    ``transform``; t-SNE refits jointly and splits. Mutates and returns
    ``groups`` with fresh ``projection`` entries."""
    combined = np.concatenate([g["latents"] for g in groups])
    pca_components = min(len(combined), 50)
    if method == "umap":
        proj_first, model = analyzer.reduce_dimensionality_umap(
            groups[0]["latents"], n_neighbors=n_neighbors, min_dist=min_dist,
            random_state=seed, pca_components=min(len(groups[0]["latents"]), 50),
        )
        groups[0]["projection"] = proj_first
        for g in groups[1:]:
            g["projection"] = model.transform(g["latents"])
    else:
        joint = analyzer.reduce_dimensionality_tsne(
            combined, perplexity=perplexity, random_state=seed,
            pca_components=pca_components,
        )
        start = 0
        for g in groups:
            g["projection"] = joint[start : start + len(g["latents"])]
            start += len(g["latents"])
    return groups


def slider_recompute_payload(analyzer, groups, method: str, **hyper) -> dict:
    """The live-recompute callback body (dash-free, directly testable):
    refit with the slider values, return a JSON-able projection payload."""
    groups = recompute_projection(analyzer, groups, method, **hyper)
    return {
        "method": method,
        "hyper": dict(hyper),
        "groups": [
            {
                "name": g["name"],
                "projection": np.asarray(g["projection"]).tolist(),
                "paths": list(g["paths"]),
            }
            for g in groups
        ],
    }


def _project(analyzer, groups, args):
    return recompute_projection(
        analyzer, groups, args.method,
        n_neighbors=args.n_neighbors, min_dist=args.min_dist,
        perplexity=args.perplexity, seed=args.seed,
    )


def export_static(analyzer, output_dir: Path, groups, args) -> Path:
    """Static artifacts equivalent to the app's initial view and data panel."""
    projections = [(g["projection"], g["ids"], g["marker"], g["name"]) for g in groups]
    plot_path = analyzer.plot_projection_2d(
        projections, str(output_dir / f"{args.method}_projection.png"),
        title=f"{args.method.upper()} projection",
        # the flag is store_true: absent means False (reference analyze_interactive.py:44)
        color_by_patient=getattr(args, "color_by_patient", False),
        image_paths_list=[g["paths"] for g in groups],
    )
    data_path = output_dir / "projection_data.json"
    payload = {
        "method": args.method,
        "groups": [
            {
                "name": g["name"],
                "ids": list(g["ids"]),
                "paths": list(g["paths"]),
                "projection": np.asarray(g["projection"]).tolist(),
            }
            for g in groups
        ],
    }
    data_path.write_text(json.dumps(payload), encoding="utf-8")
    print(f"Exported {plot_path} and {data_path}")
    return data_path


def _build_dash_app(analyzer, groups, args):  # pragma: no cover - needs dash
    import base64
    import io

    import dash
    import plotly.graph_objects as go
    from dash import dcc, html
    from PIL import Image

    from ..analysis.latent_distance import latent_distance
    from ..data.io import read_image

    app = dash.Dash(__name__)

    def build_figure(gs):
        fig = go.Figure()
        for g in gs:
            proj = np.asarray(g["projection"])
            fig.add_trace(go.Scatter(
                x=proj[:, 0], y=proj[:, 1], mode="markers",
                name=g["name"], customdata=g["paths"],
                marker={"symbol": "circle" if g["name"] == "dente" else "circle-open", "size": 9},
            ))
        fig.update_layout(title=f"{args.method.upper()} projection", height=700)
        return fig

    # live-recompute sliders (reference ``analyze_interactive.py:559-636``)
    if args.method == "umap":
        sliders = html.Div([
            html.Label("n_neighbors"),
            dcc.Slider(id="n-neighbors-slider", min=5, max=100, step=5, value=args.n_neighbors),
            html.Label("min_dist"),
            dcc.Slider(id="min-dist-slider", min=0.0, max=1.0, step=0.05, value=args.min_dist),
        ])
    else:
        sliders = html.Div([
            html.Label("perplexity"),
            dcc.Slider(id="perplexity-slider", min=5, max=50, step=5, value=args.perplexity),
        ])

    app.layout = html.Div([
        sliders,
        dcc.Graph(id="scatter", figure=build_figure(groups)),
        html.Div(id="image-panel"),
        html.Div(id="distance-panel"),
        dcc.Store(id="selected", data=[]),
    ])

    if args.method == "umap":
        @app.callback(
            dash.Output("scatter", "figure"),
            dash.Input("n-neighbors-slider", "value"),
            dash.Input("min-dist-slider", "value"),
        )
        def on_umap_sliders(n_neighbors, min_dist):
            print(f"Recalculating UMAP: n_neighbors={n_neighbors} min_dist={min_dist}")
            payload = slider_recompute_payload(
                analyzer, groups, "umap",
                n_neighbors=int(n_neighbors), min_dist=float(min_dist), seed=args.seed,
            )
            return build_figure(payload["groups"])
    else:
        @app.callback(
            dash.Output("scatter", "figure"),
            dash.Input("perplexity-slider", "value"),
        )
        def on_perplexity_slider(perplexity):
            print(f"Recalculating t-SNE: perplexity={perplexity}")
            payload = slider_recompute_payload(
                analyzer, groups, "tsne", perplexity=int(perplexity), seed=args.seed,
            )
            return build_figure(payload["groups"])

    @app.callback(
        dash.Output("image-panel", "children"),
        dash.Output("selected", "data"),
        dash.Input("scatter", "clickData"),
        dash.State("selected", "data"),
    )
    def on_click(click_data, selected):
        if not click_data:
            return dash.no_update, dash.no_update
        path = click_data["points"][0]["customdata"]
        img = read_image(path)
        lo, hi = np.percentile(img[img != 0], [2, 98]) if np.any(img != 0) else (0, 1)
        disp = np.clip((img - lo) / (hi - lo + 1e-8), 0, 1)
        buf = io.BytesIO()
        Image.fromarray((disp * 255).astype(np.uint8)).save(buf, format="PNG")
        encoded = base64.b64encode(buf.getvalue()).decode()
        selected = (selected + [path])[-2:]
        children = [html.Img(src=f"data:image/png;base64,{encoded}", style={"height": "300px"})]
        if len(selected) == 2:
            flat = {p: g["latents"][g["paths"].index(p)]
                    for g in groups for p in selected if p in g["paths"]}
            if len(flat) == 2:
                a, b = list(flat.values())
                children.append(html.P(f"Latent distance: {latent_distance(a, b):.4f}"))
        return children, selected

    return app


def main(argv=None):
    args = parse_args(argv)
    analyzer, output_dir, groups = _compute_groups(args)
    groups = _project(analyzer, groups, args)
    if args.export or not _HAS_DASH:
        if not _HAS_DASH and not args.export:
            print("dash is not installed — exporting static artifacts instead "
                  "(install dash for the interactive app).")
        return export_static(analyzer, output_dir, groups, args)
    app = _build_dash_app(analyzer, groups, args)  # pragma: no cover
    app.run(debug=args.debug, port=args.port)  # pragma: no cover


if __name__ == "__main__":
    main()

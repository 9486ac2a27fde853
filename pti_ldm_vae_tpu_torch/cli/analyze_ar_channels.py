"""AR-VAE channel viewer (Dash app; static PNG grid otherwise) (counterpart
of ``pti_ldm_vae_tpu/cli/analyze_ar_channels.py``; reference
``vae_scripts/analyze_ar_channels.py``): for one input image, the original,
its deterministic reconstruction and one heatmap per latent channel (the
latent means), the AR-regularized channels named after their attributes.
Without ``dash`` (or with ``--export``) the grid is written as a PNG drawn
with numpy, the AR channels framed in red and their names printed. The
encode and decode run in f32 (TF32 off) on the device, CUDA unless
``--device cpu``.

    python -m pti_ldm_vae_tpu_torch.cli.analyze_ar_channels -c config/ar_vae_dente.json \\
        --checkpoint ar_vae.pth --image-path img.tif --export --output grid.png [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..analysis.common import create_transforms
from ..config import filter_comment_keys
from ..data.io import write_png
from ..utils.cli_common import load_config_and_model, resolve_device
from ..utils.visualization import draw_channel_grid
from ..utils.visualization import normalize_unit as _normalize_unit

__all__ = [
    "main",
    "encode_image",
    "extract_attr_channels",
    "export_static_grid",
    "select_channel_payload",
]

try:
    import dash  # noqa: F401
    _HAS_DASH = True
except ImportError:  # pragma: no cover
    _HAS_DASH = False


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="AR-VAE latent channel viewer")
    parser.add_argument("-c", "--config-file", required=True, help="Path to AR-VAE config JSON.")
    parser.add_argument("--checkpoint", required=True,
                        help="Path to the VAE checkpoint (torch .pth, MONAI keys).")
    parser.add_argument("--image-path", required=True, help="Path to the input .tif image.")
    parser.add_argument("--port", type=int, default=8052)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--export", action="store_true",
                        help="Write a static PNG grid instead of serving the app")
    parser.add_argument("--output", type=str, default="ar_channels.png")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions through the hand-written "
                             "convolution kernels instead of cuDNN")
    return parser.parse_args(argv)


def extract_attr_channels(config) -> dict[str, int]:
    """attribute name -> latent channel (reference ``analyze_ar_channels.py:
    build mapping``); comment keys filtered."""
    reg = getattr(config, "regularized_attributes", None)
    if not reg:
        raise ValueError("Config is missing regularized_attributes.")
    mapping = filter_comment_keys(reg.get("attribute_latent_mapping", {}))
    if not mapping:
        raise ValueError("attribute_latent_mapping is empty.")
    return {name: int(meta["latent_channel"]) for name, meta in mapping.items()}


def encode_image(image_path: str, model, transform):
    """(reconstruction [H, W], latents [C, h, w], original [H, W]) as host
    float32: ``encode_deterministic`` then ``decode_stage_2_outputs`` on the
    model's device."""
    img = np.asarray(transform(image_path), dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    device = next(model.parameters()).device
    with torch.inference_mode():
        z_mu = model.encode_deterministic(torch.from_numpy(img[None]).to(device))
        recon = model.decode_stage_2_outputs(z_mu)
        latents = z_mu[0].permute(2, 0, 1).float().cpu().numpy()  # NHWC -> CHW
        recon = recon[0, :, :, 0].float().cpu().numpy()
    return recon, latents, img[..., 0]


def export_static_grid(original, reconstruction, latents, attr_to_channel, output: str) -> None:
    """Original | reconstruction | per-channel latent heatmaps -> PNG."""
    channel_to_attr = {v: k for k, v in attr_to_channel.items()}
    write_png(output, draw_channel_grid(original, reconstruction, latents,
                                        frozenset(channel_to_attr)))
    for c in range(latents.shape[0]):
        label = f"z[{c}]" + (f" — {channel_to_attr[c]} (AR)" if c in channel_to_attr else "")
        print(f"  panel {c + 1}: {label}")
    print(f"Wrote {output}")


def select_channel_payload(latents: np.ndarray, attr_to_channel: dict[str, int],
                           selected_channel: int | None) -> dict:
    """Channel-dropdown callback body (dash-free, directly testable) —
    reference ``analyze_ar_channels.py:272-299`` ``update_channel_fig``:
    selected channel -> {title, unit-normalized heatmap data, valid flag}."""
    if selected_channel is None:
        return {"title": "No channel", "data": np.zeros_like(latents[0]), "valid": False}
    if not 0 <= selected_channel < latents.shape[0]:
        return {
            "title": f"{selected_channel} (out of range)",
            "data": np.zeros_like(latents[0]),
            "valid": False,
        }
    attr_name = next(
        (name for name, idx in attr_to_channel.items() if idx == selected_channel), None
    )
    title = (
        f"ch {selected_channel}: {attr_name} (regularized)"
        if attr_name else f"ch {selected_channel}: unmapped"
    )
    return {
        "title": title,
        "data": _normalize_unit(latents[selected_channel]),
        "valid": True,
    }


def _build_dash_app(original, reconstruction, latents, attr_to_channel):  # pragma: no cover
    import dash
    import plotly.graph_objects as go
    from dash import dcc, html

    def heatmap(data, title, colorscale="Viridis"):
        fig = go.Figure(data=go.Heatmap(z=np.squeeze(data), colorscale=colorscale))
        fig.update_layout(title=title, margin={"l": 0, "r": 0, "t": 30, "b": 0},
                          height=340, width=340)
        fig.update_xaxes(scaleanchor="y", scaleratio=1)
        fig.update_yaxes(autorange="reversed")
        return fig

    channel_to_attr = {v: k for k, v in attr_to_channel.items()}
    app = dash.Dash(__name__)
    default_channel = min(channel_to_attr) if channel_to_attr else 0
    channel_options = [
        {
            "label": f"z[{c}]" + (f" — {channel_to_attr[c]} (AR)" if c in channel_to_attr else ""),
            "value": c,
        }
        for c in range(latents.shape[0])
    ]
    app.layout = html.Div([
        html.Div([
            dcc.Graph(figure=heatmap(_normalize_unit(original), "Original", "Gray")),
            dcc.Graph(figure=heatmap(_normalize_unit(reconstruction), "Reconstruction", "Gray")),
        ], style={"display": "flex"}),
        html.Div([
            html.H4("Latent Channel"),
            dcc.Dropdown(id="channel-dropdown", options=channel_options,
                         value=default_channel, clearable=False),
            dcc.Graph(id="channel-fig"),
        ]),
    ])

    @app.callback(
        dash.Output("channel-fig", "figure"),
        dash.Input("channel-dropdown", "value"),
    )
    def update_channel_fig(selected_channel):
        payload = select_channel_payload(latents, attr_to_channel, selected_channel)
        return heatmap(payload["data"], payload["title"])

    return app


def main(argv=None):
    """Exports the grid and returns its path, or serves the Dash app."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    config, model = load_config_and_model(args.config_file, args.checkpoint, device=device,
                                          exact=True, conv_kernel=args.conv_kernel)
    attr_to_channel = extract_attr_channels(config)
    patch_size = tuple(config.autoencoder_train["patch_size"])
    transform = create_transforms(patch_size)
    reconstruction, latents, original = encode_image(args.image_path, model, transform)

    if args.export or not _HAS_DASH:
        if not _HAS_DASH and not args.export:
            print("dash is not installed — exporting a static grid instead.")
        export_static_grid(original, reconstruction, latents, attr_to_channel, args.output)
        return args.output
    app = _build_dash_app(original, reconstruction, latents, attr_to_channel)  # pragma: no cover
    app.run(host=args.host, port=args.port, debug=args.debug)  # pragma: no cover


if __name__ == "__main__":
    main()

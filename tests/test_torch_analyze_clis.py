"""The port's analysis CLIs with ``--device cpu`` beside the JAX package's, on
one shared MONAI-keyed ``.pth`` (the toy VAE of ``tests/test_analyze_clis.py``
with both non-local attention blocks on, JAX init, weights carried across)
and one shared latent cache, the JAX run first:

* ``analyze_static --method tsne``: the port reads the JAX package's latents
  ("0 newly encoded"), so the ``[Latent]`` lines of ``distance_metrics.txt``,
  all of ``exams_sorted_by_distance.txt`` and ``color_legend.txt`` are the
  same bytes; the plot is a PNG of the stated size;
* ``analyze_interactive --export``: ``projection_data.json`` has the same
  ids, paths and shape; the slider refit changes the projection;
* ``analyze_ar_channels --export``: reconstruction and latents within rtol
  1e-4 / atol 1e-5 of the JAX CLI's, ``select_channel_payload`` equal, the
  grid PNG of ``channel_grid_shape``;
* ``--conv-kernel`` (the convolution kernels' plain versions here) encodes
  the same latents within rtol 1e-4 / atol 1e-5; ``--method umap`` raises
  the JAX package's ``ImportError`` where umap-learn is absent; without
  ``--device cpu`` and without CUDA each CLI raises.
"""

import argparse
import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.cli import analyze_ar_channels as jax_ar
from pti_ldm_vae_tpu.cli import analyze_interactive as jax_interactive
from pti_ldm_vae_tpu.cli import analyze_static as jax_static
from pti_ldm_vae_tpu.data.io import write_tif
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.utils.cli_common import load_config_and_model as jax_load
from pti_ldm_vae_tpu_torch.analysis import latent_space
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax
from pti_ldm_vae_tpu_torch.cli import analyze_ar_channels, analyze_interactive, analyze_static
from pti_ldm_vae_tpu_torch.data.io import read_image
from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model
from pti_ldm_vae_tpu_torch.utils.visualization import SCATTER_SHAPE, channel_grid_shape

ARCH = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=2,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, False],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
N_PER_GROUP = 60
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_acli_ws")
    rng = np.random.default_rng(0)
    for sub in ("edente", "dente"):
        (root / sub).mkdir()
        for i in range(N_PER_GROUP):
            img = rng.uniform(0.1, 1.0, size=(16, 16)).astype(np.float32)
            write_tif(str(root / sub / f"20{i:02d}_HA_2021_02_{i % 6}.tif"), img)
    jax_vae = jax_from_config(ARCH, use_pallas_attention=False, s2d_stem=False)
    variables = jax.jit(jax_vae.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 1)),
                                      jax.random.key(1))
    state = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), ARCH)
    torch.save(state, root / "vae.pth")
    cfg = {
        "autoencoder_def": ARCH,
        "autoencoder_train": {"patch_size": [16, 16]},
        "regularized_attributes": {
            "enabled": True,
            "attribute_latent_mapping": {
                "_c": "comment",
                "height_0": {"latent_channel": 0, "delta": 1.0},
            },
        },
    }
    (root / "config.json").write_text(json.dumps(cfg))
    return root


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def _static_args(ws, out, *extra):
    return ["--vae-weights", str(ws / "vae.pth"), "--config-file", str(ws / "config.json"),
            "--folder-edente", str(ws / "edente"), "--folder-dente", str(ws / "dente"),
            "--output-dir", str(ws / out), "--method", "tsne", "--perplexity", "10",
            "--max-images", str(N_PER_GROUP), "--patch-size", "16", "16",
            "--color-by-patient", "--cache-dir", str(ws / "cache"), *extra]


@pytest.fixture(scope="module")
def static_runs(ws):
    """The JAX CLI first (it fills the shared cache), then the port's."""
    _run(jax_static.main, _static_args(ws, "jax_static"))
    result, stdout = _run(analyze_static.main, _static_args(ws, "port_static", "--device", "cpu"))
    return result, stdout


def test_static_reads_the_jax_cache(static_runs):
    _, stdout = static_runs
    hits = re.findall(r"(\d+) from cache, (\d+) newly encoded", stdout)
    assert hits == [(str(N_PER_GROUP), "0")] * 2


@pytest.mark.parametrize("name", ["exams_sorted_by_distance.txt", "color_legend.txt"])
def test_static_text_files_same_bytes(ws, static_runs, name):
    assert (ws / "port_static" / name).read_bytes() == (ws / "jax_static" / name).read_bytes()


def test_static_latent_statistics_same_bytes(ws, static_runs):
    lines = [[ln for ln in (ws / side / "distance_metrics.txt").read_text().splitlines()
              if "[Projection]" not in ln] for side in ("jax_static", "port_static")]
    assert lines[0] == lines[1] and sum("[Latent]" in ln for ln in lines[0]) == 6


def test_static_projection_and_plot(ws, static_runs):
    result, _ = static_runs
    assert result["plot"] == ws / "port_static" / "tsne_projection.png"
    assert read_image(str(result["plot"])).shape == (*SCATTER_SHAPE, 3)
    for group in ("edente", "dente"):
        proj = result["projections"][group]
        assert proj.shape == (N_PER_GROUP, 2) and np.isfinite(proj).all()
        assert result["ids"][group] == [str(i % 6) for i in range(N_PER_GROUP)]


def test_static_conv_kernel_encodes_the_same_latents(ws, static_runs):
    """A fresh cache through ``--conv-kernel``: the same latents as the JAX
    package's cache entries."""
    args = _static_args(ws, "port_static_conv", "--device", "cpu", "--conv-kernel")
    args[args.index("--cache-dir") + 1] = str(ws / "cache_conv")
    _, stdout = _run(analyze_static.main, args)
    assert re.findall(r"(\d+) newly encoded", stdout) == [str(N_PER_GROUP)] * 2
    for name in ("jax_static", "port_static_conv"):
        assert (ws / name / "exams_sorted_by_distance.txt").exists()
    (sig,) = [p.name for p in (ws / "cache").iterdir()]
    files = sorted((ws / "cache" / sig).glob("*.npz"))
    assert len(files) == 2 * N_PER_GROUP
    for f in files:
        np.testing.assert_allclose(np.load(ws / "cache_conv" / sig / f.name)["latent"],
                                   np.load(f)["latent"], **TOL)


def _interactive_args(ws, out, *extra):
    return ["--vae-weights", str(ws / "vae.pth"), "--config-file", str(ws / "config.json"),
            "--folder-edente", str(ws / "edente"), "--folder-dente", str(ws / "dente"),
            "--max-images", "55", "--patch-size", "16", "16", "--method", "tsne",
            "--perplexity", "8", "--output-dir", str(ws / out), "--export",
            "--cache-dir", str(ws / "cache"), *extra]


def test_interactive_export_matches_jax(ws, static_runs):
    want = json.loads(_run(jax_interactive.main, _interactive_args(ws, "jax_int"))[0].read_text())
    data_path, stdout = _run(analyze_interactive.main,
                             _interactive_args(ws, "port_int", "--device", "cpu"))
    got = json.loads(data_path.read_text())
    assert re.findall(r"(\d+) newly encoded", stdout) == ["0", "0"]
    assert got["method"] == want["method"] == "tsne"
    assert [g["name"] for g in got["groups"]] == [g["name"] for g in want["groups"]]
    for g, w in zip(got["groups"], want["groups"]):
        assert g["ids"] == w["ids"] and g["paths"] == w["paths"] and len(g["ids"]) == 55
        assert np.shape(g["projection"]) == np.shape(w["projection"]) == (55, 2)
        assert np.isfinite(g["projection"]).all()
    assert read_image(str(ws / "port_int" / "tsne_projection.png")).shape == (*SCATTER_SHAPE, 3)


def test_interactive_slider_recompute_changes_the_projection(ws, static_runs):
    args = argparse.Namespace(
        vae_weights=str(ws / "vae.pth"), config_file=str(ws / "config.json"),
        folder_edente=str(ws / "edente"), folder_dente=None, max_images=55,
        patch_size=[16, 16], seed=42, output_dir=str(ws / "slider_out"),
        cache_dir=str(ws / "cache"), device="cpu", conv_kernel=False,
    )
    analyzer, _, groups = analyze_interactive._compute_groups(args)
    groups = analyze_interactive.recompute_projection(analyzer, groups, "tsne", perplexity=8,
                                                      seed=42)
    base = np.asarray(groups[0]["projection"]).copy()
    assert base.shape == (55, 2)
    payload = analyze_interactive.slider_recompute_payload(analyzer, groups, "tsne",
                                                           perplexity=20, seed=42)
    assert payload["method"] == "tsne" and payload["hyper"] == {"perplexity": 20, "seed": 42}
    new = np.asarray(payload["groups"][0]["projection"])
    assert new.shape == base.shape and not np.allclose(new, base)
    assert payload["groups"][0]["paths"] == groups[0]["paths"]


def test_ar_channels_matches_jax(ws):
    img = str(sorted((ws / "edente").glob("*.tif"))[0])
    args = ["-c", str(ws / "config.json"), "--checkpoint", str(ws / "vae.pth"),
            "--image-path", img, "--export"]
    want_png, _ = _run(jax_ar.main, args + ["--output", str(ws / "jax_ar.png")])
    got_png, stdout = _run(analyze_ar_channels.main,
                           args + ["--output", str(ws / "port_ar.png"), "--device", "cpu"])
    assert got_png == str(ws / "port_ar.png") and "z[0] — height_0 (AR)" in stdout
    assert read_image(got_png).shape == (*channel_grid_shape(ARCH["latent_channels"]), 3)

    config, (jax_model, variables) = jax_load(str(ws / "config.json"), str(ws / "vae.pth"),
                                              exact=True)
    want = jax_ar.encode_image(img, jax_model, variables, jax_ar.create_transforms((16, 16)))
    _, model = load_config_and_model(str(ws / "config.json"), str(ws / "vae.pth"),
                                     device=torch.device("cpu"), exact=True)
    got = analyze_ar_channels.encode_image(img, model,
                                           analyze_ar_channels.create_transforms((16, 16)))
    assert got[1].shape == want[1].shape == (2, 8, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    mapping = analyze_ar_channels.extract_attr_channels(config)
    assert mapping == jax_ar.extract_attr_channels(config) == {"height_0": 0}
    for channel in (None, 0, 1, 2, -1):
        p, j = (m.select_channel_payload(w[1], mapping, channel)
                for m in (analyze_ar_channels, jax_ar))
        assert p["title"] == j["title"] and p["valid"] == j["valid"]
        np.testing.assert_array_equal(p["data"], j["data"])


def test_static_umap_raises_the_jax_import_error(ws, static_runs):
    if latent_space._umap is not None:
        pytest.skip("umap-learn is installed")
    args = _static_args(ws, "port_umap", "--device", "cpu")
    args[args.index("tsne")] = "umap"
    with pytest.raises(ImportError, match="^Please install umap-learn: pip install umap-learn$"):
        _run(analyze_static.main, args)


@pytest.mark.parametrize("cli", ["static", "interactive", "ar_channels"])
def test_cli_without_device_cpu_raises_without_cuda(ws, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    argv = {
        "static": (analyze_static.main, _static_args(ws, "no_cuda")),
        "interactive": (analyze_interactive.main, _interactive_args(ws, "no_cuda")),
        "ar_channels": (analyze_ar_channels.main,
                        ["-c", str(ws / "config.json"), "--checkpoint", str(ws / "vae.pth"),
                         "--image-path", "unused.tif", "--export"]),
    }[cli]
    with pytest.raises(RuntimeError, match="--device cpu"):
        argv[0](argv[1])

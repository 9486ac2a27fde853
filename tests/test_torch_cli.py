"""Both inference CLIs on the same synthetic TIFs and the same MONAI-keyed
``.pth``: the port (``--device cpu``, f32) against the JAX package (``--f32``:
f32, standard path, XLA attention). Output TIFs agree within 1e-3."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.torch_convert import to_torch_state_dict
from pti_ldm_vae_tpu.cli.inference_vae import main as jax_main
from pti_ldm_vae_tpu.config import resolve_refs
from pti_ldm_vae_tpu.data.io import read_image as jax_read_image
from pti_ldm_vae_tpu.data.io import write_tif as jax_write_tif
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.cli.inference_vae import main
from pti_ldm_vae_tpu_torch.data.io import read_image


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    data = root / "data" / "dente"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(5):
        img = rng.uniform(0.1, 1.0, size=(40, 36)).astype(np.float32)
        img[:4] = 0.0
        jax_write_tif(str(data / f"dente_{i:03d}.tif"), img)
    cfg = {
        "spatial_dims": 2, "image_channels": 1, "latent_channels": 3,
        "autoencoder_def": {
            "spatial_dims": "@spatial_dims", "in_channels": "@image_channels",
            "out_channels": "@image_channels", "latent_channels": "@latent_channels",
            "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4,
            "norm_eps": 1e-6, "attention_levels": [False, False],
            "with_encoder_nonlocal_attn": True, "with_decoder_nonlocal_attn": True,
        },
        "autoencoder_train": {"batch_size": 2, "patch_size": [32, 32]},
    }
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    ae_def = resolve_refs(cfg)["autoencoder_def"]
    model = autoencoder_from_config(ae_def)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 1)), jax.random.key(1))
    sd = to_torch_state_dict(jax.tree_util.tree_map(np.asarray, variables), ae_def)
    ckpt = root / "vae.pth"
    torch.save({"autoencoder_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               ckpt)
    return root, cfg_path, ckpt


def _run_both(workspace):
    root, cfg_path, ckpt = workspace
    common = ["-c", str(cfg_path), "--checkpoint", str(ckpt),
              "--input-dir", str(root / "data"), "--batch-size", "2", "--num-workers", "2"]
    if not (root / "port" / "results_tif").exists():
        assert main(common + ["--output-dir", str(root / "port"), "--device", "cpu"]) == 5
        jax_main(common + ["--output-dir", str(root / "jax"), "--f32"])
    return root


def test_cli_outputs_match_jax(workspace):
    root = _run_both(workspace)
    for kind in ("results_tif", "results_png"):
        assert sorted(os.listdir(root / "port" / kind)) == sorted(os.listdir(root / "jax" / kind))
        assert len(os.listdir(root / "port" / kind)) == 5
    for name in sorted(os.listdir(root / "jax" / "results_tif")):
        ours = read_image(str(root / "port" / "results_tif" / name))
        theirs = jax_read_image(str(root / "jax" / "results_tif" / name))
        assert ours.shape == theirs.shape == (32, 64)
        # the preprocessed input: both CLIs decode with the native fused path
        np.testing.assert_array_equal(ours[:, :32], theirs[:, :32])
        assert np.abs(ours - theirs).max() <= 1e-3


def test_cli_pngs_match_jax(workspace):
    root = _run_both(workspace)
    for name in sorted(os.listdir(root / "jax" / "results_png")):
        ours = read_image(str(root / "port" / "results_png" / name))
        theirs = jax_read_image(str(root / "jax" / "results_png" / name))
        assert ours.shape == theirs.shape == (32, 64)
        assert np.abs(ours - theirs).max() <= 1.0  # one uint8 level of display rounding


def test_cli_refuses_orbax_directories(workspace, tmp_path):
    root, cfg_path, _ = workspace
    with pytest.raises(ValueError, match="orbax"):
        main(["-c", str(cfg_path), "--checkpoint", str(tmp_path), "--input-dir",
              str(root / "data"), "--output-dir", str(tmp_path / "o"), "--device", "cpu"])

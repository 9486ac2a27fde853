"""One training epoch of the port's ``VAETrainer`` against the JAX package's,
on the same files with the same initial weights, f32, ``perceptual_weight 0``.

The two trainers draw their posterior noise from different generators, so the
shared initial weights pin the log-variance head near -20 (sigma ~ 4.5e-5):
the noise then moves the losses by less than the bar. Split, epoch order,
batches, masks, loss terms and the Adam updates are each package's own.
Bar: every train step's and the validation's reconstruction loss within 1e-3
relative.
"""

import json

import jax
import numpy as np
import pytest

from pti_ldm_vae_tpu.config import resolve_refs
from pti_ldm_vae_tpu.data.io import write_tif
from pti_ldm_vae_tpu.train.loop import VAETrainer as JaxTrainer
from pti_ldm_vae_tpu.train.state import create_train_state as jax_create_state
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax
from pti_ldm_vae_tpu_torch.train.loop import VAETrainer


def _rows(run_dir):
    with open(run_dir / "metrics.jsonl", encoding="utf-8") as fh:
        return [json.loads(line) for line in fh]


def test_one_epoch_matches_jax_trainer(tmp_path):
    data = tmp_path / "data" / "dente"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(12):
        img = rng.uniform(0.1, 1.0, size=(40, 40)).astype(np.float32)
        img[:4] = 0.0
        write_tif(str(data / f"dente_{i:03d}.tif"), img)
    cfg = resolve_refs({
        "spatial_dims": 2, "image_channels": 1, "latent_channels": 3,
        "data_base_dir": str(tmp_path / "data"), "data_source": "dente", "train_split": 0.75,
        "s2d_stem": False,
        "autoencoder_def": {
            "spatial_dims": "@spatial_dims", "in_channels": "@image_channels",
            "out_channels": "@image_channels", "latent_channels": "@latent_channels",
            "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4, "norm_eps": 1e-6,
            "attention_levels": [False, False],
            "with_encoder_nonlocal_attn": True, "with_decoder_nonlocal_attn": True,
        },
        "autoencoder_train": {"batch_size": 4, "patch_size": [32, 32], "lr": 1e-3,
                              "perceptual_weight": 0.0, "kl_weight": 1e-3, "recon_loss": "l1",
                              "adv_enabled": False, "max_epochs": 1},
        "wandb": {"enabled": False},
    })
    common = dict(seed=42, num_workers=2, use_wandb=False, mixed_precision=False)

    theirs = JaxTrainer({**cfg, "run_dir": str(tmp_path / "jax")}, use_pallas_attention=False,
                        **common)
    params = jax.tree_util.tree_map(np.array, theirs.state.params_g)
    head = params["params"]["quant_conv_log_sigma"]
    head["kernel"][:] = 0.0
    head["bias"][:] = -20.0
    theirs.state = jax_create_state(params, lr=1e-3)
    theirs.train_epoch(0)
    want_val = theirs.validate(0)
    theirs.logger.finish()

    ours = VAETrainer({**cfg, "run_dir": str(tmp_path / "port")}, device="cpu", **common)
    ours.model.load_state_dict(state_dict_from_flax(params, cfg["autoencoder_def"]), strict=True)
    ours.train_epoch(0)
    got_val = ours.validate(0)
    ours.close()

    assert got_val == pytest.approx(want_val, rel=1e-3)
    want = [r for r in _rows(tmp_path / "jax") if "train/recon_loss" in r]
    got = [r for r in _rows(tmp_path / "port") if "train/recon_loss" in r]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a["train/step"] == b["train/step"]
        assert a["train/recon_loss"] == pytest.approx(b["train/recon_loss"], rel=1e-3)
    assert got[-1]["train/recon_loss"] < got[0]["train/recon_loss"]

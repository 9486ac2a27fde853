"""Checkpoint paths into the port (CPU, toy sizes).

* ``checkpoint/paths.py:resolve_checkpoint``: a file as it is, else
  ``path + ".pth"``, else a directory raises naming the export command, else
  ``FileNotFoundError``; the VAE loader also reads the MONAI-keyed ``.npz``
  of ``tools/convert_torch_checkpoint.py to-torch``.
* Weights trained by the JAX package: orbax directories written with its own
  ``orbax_io.save_pytree`` (VAE, UNet + projector, a regression head with its
  ``.json`` sidecar, all JAX-initialised) go through
  ``tools/export_jax_checkpoint.py``; then the port's CLIs, given the orbax
  directory's path, load the exported ``.pth`` beside it and agree with the
  JAX CLIs on the directory itself: ``inference_vae`` at
  ``tests/test_torch_cli.py``'s bars (inputs bit-equal, outputs 1e-3),
  ``inference_regression`` at ``tests/test_torch_regression_cli.py``'s
  (rtol 1e-4, atol 1e-4 of the predictions' scale), the UNet's epsilon at
  1e-3; ``sample_diffusion`` runs on the exported UNet and VAE.
* The shipped configs chain in the port: ``train_vae`` on a toy copy of
  ``config/vae_dente_no_adv.json`` (under ``./runs/vae_dente_no_adv``), then
  ``train_regression`` and ``train_diffusion`` on copies of
  ``config/reg_edente_from_dente.json`` and ``config/ldm_dente.json`` whose
  ``vae.checkpoint`` (``.../trained_weights/autoencoder_last``) is left as
  shipped.
"""

import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.orbax_io import save_pytree
from pti_ldm_vae_tpu.cli.inference_regression import main as jax_inference_regression
from pti_ldm_vae_tpu.cli.inference_vae import main as jax_inference_vae
from pti_ldm_vae_tpu.models import unet as jax_unet
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_autoencoder
from pti_ldm_vae_tpu.models.regressor import LatentRegressor as JaxRegressor
from pti_ldm_vae_tpu.utils.regression_utils import (
    save_regression_checkpoint as jax_save_regression_checkpoint,
)
from pti_ldm_vae_tpu_torch.checkpoint.paths import resolve_checkpoint
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax
from pti_ldm_vae_tpu_torch.checkpoint.unet_convert import load_diffusion_checkpoint
from pti_ldm_vae_tpu_torch.cli.inference_regression import main as inference_regression
from pti_ldm_vae_tpu_torch.cli.inference_vae import main as inference_vae
from pti_ldm_vae_tpu_torch.cli.sample_diffusion import main as sample_diffusion
from pti_ldm_vae_tpu_torch.cli.train_diffusion import main as train_diffusion
from pti_ldm_vae_tpu_torch.cli.train_regression import main as train_regression
from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_vae
from pti_ldm_vae_tpu_torch.data.io import read_image, write_tif
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.unet import (
    ConditionProjector,
    diffusion_unet_from_config,
    project_latent_condition,
)
from pti_ldm_vae_tpu_torch.utils.vae_loader import load_autoencoder_state_dict

ROOT = Path(__file__).resolve().parents[1]
PATCH = 16
AE_DEF = dict(spatial_dims=2, in_channels=1, out_channels=1, latent_channels=2,
              channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
              attention_levels=[False, False], with_encoder_nonlocal_attn=True,
              with_decoder_nonlocal_attn=True)
UNET_DEF = dict(spatial_dims=2, in_channels=2, out_channels=2, channels=[8, 16],
                attention_levels=[False, True], num_head_channels=[0, 8], num_res_blocks=1,
                with_conditioning=True, cross_attention_dim=16, norm_num_groups=4)
TARGETS = ["height_0", "width_0", "width_1", "width_2", "width_3", "width_4"]
HIDDEN = (256, 32)  # config/reg_edente_from_dente.json's head


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _images(folder: Path, n: int, seed: int = 0, shape=(40, 36)) -> None:
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.uniform(0.1, 1.0, size=shape).astype(np.float32)
        img[:4] = 0.0
        write_tif(str(folder / f"img_{i:03d}.tif"), img)


# ------------------------------------------------------------ the rule ----
@pytest.mark.parametrize("case", ["file", "pth_beside", "directory", "missing"])
def test_resolve_rule(case, tmp_path):
    path = tmp_path / "autoencoder_last"
    if case == "file":
        path.write_bytes(b"x")
        assert resolve_checkpoint(path, "vae") == str(path)
    elif case == "pth_beside":
        path.mkdir()  # an orbax directory with its export beside it: the export wins
        (tmp_path / "autoencoder_last.pth").write_bytes(b"x")
        assert resolve_checkpoint(path, "vae") == str(path) + ".pth"
    elif case == "directory":
        path.mkdir()
        for kind in ("vae", "diffusion", "head"):
            with pytest.raises(ValueError, match=f"orbax.*export_jax_checkpoint.py {kind} "):
                resolve_checkpoint(path, kind)
    else:
        with pytest.raises(FileNotFoundError, match="autoencoder_last.pth"):
            resolve_checkpoint(path, "head")


def test_resolve_rejects_an_unknown_kind(tmp_path):
    with pytest.raises(ValueError, match="kind"):
        resolve_checkpoint(tmp_path, "optimizer")


# ------------------------------------------- trees of the JAX package ----
@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """Orbax directories of JAX-initialised trees, as the JAX trainers lay
    them out, exported into ``.pth`` files beside them."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    _images(root / "data" / "dente", 5)
    vae_cfg = root / "vae.json"
    vae_cfg.write_text(json.dumps({"autoencoder_def": AE_DEF,
                                   "autoencoder_train": {"batch_size": 2,
                                                         "patch_size": [PATCH, PATCH]}}))
    weights = root / "runs" / "trained_weights"
    vae = jax_autoencoder(AE_DEF)
    vae_vars = jax.jit(vae.init)(jax.random.key(0), jnp.zeros((1, PATCH, PATCH, 1)),
                                 jax.random.key(1))
    save_pytree(str(weights / "autoencoder_last"), vae_vars)
    save_pytree(str(weights / "checkpoint_full"), {"params_g": vae_vars})

    unet = jax_unet.diffusion_unet_from_config(UNET_DEF)
    proj = jax_unet.ConditionProjector(cross_attention_dim=16)
    tokens = (PATCH // 2) ** 2
    unet_vars = jax.jit(unet.init)(jax.random.key(2), jnp.zeros((1, PATCH // 2, PATCH // 2, 2)),
                                   jnp.zeros((1,), jnp.int32), jnp.zeros((1, tokens, 16)))
    proj_vars = jax.jit(proj.init)(jax.random.key(3), jnp.zeros((1, tokens, 2)))
    save_pytree(str(weights / "diffusion_last"), {"unet": unet_vars, "projector": proj_vars})
    ldm_cfg = root / "ldm.json"
    ldm_cfg.write_text(json.dumps({
        "run_dir": str(root / "runs" / "ldm"),
        "vae": {"config_file": str(vae_cfg), "checkpoint": str(weights / "autoencoder_last")},
        "diffusion_def": UNET_DEF,
        "diffusion_train": {"batch_size": 3, "lr": 1e-4, "max_epochs": 1, "num_train_timesteps": 50},
        "sampling": {"num_inference_steps": 3, "eta": 0.0}, "wandb": {"enabled": False}}))

    latent_dim = AE_DEF["latent_channels"] * (PATCH // 2) ** 2
    head = JaxRegressor(hidden_dims=HIDDEN, output_dim=len(TARGETS), dropout=0.1)
    head_vars = head.init(jax.random.key(4), jnp.zeros((1, latent_dim)))
    jax_save_regression_checkpoint(weights / "head_best", head_vars, TARGETS, epoch=3,
                                   latent_dim=latent_dim)
    reg = json.loads((ROOT / "config" / "reg_edente_from_dente.json").read_text())
    reg["run_dir"] = str(root / "runs" / "reg")
    for block in ("data", "evaluation"):
        reg[block].update(data_base_dir=str(root / "data"), patch_size=[PATCH, PATCH], num_workers=2)
    reg["vae"].update(config_file=str(vae_cfg), checkpoint=str(weights / "autoencoder_last"))
    reg_cfg = root / "reg.json"
    reg_cfg.write_text(json.dumps(reg))

    export = _tool("export_jax_checkpoint")
    export.main(["vae", str(weights / "autoencoder_last"), str(vae_cfg)])
    export.main(["vae", str(weights / "checkpoint_full"), str(vae_cfg)])
    export.main(["diffusion", str(weights / "diffusion_last"), str(ldm_cfg)])
    export.main(["head", str(weights / "head_best"), str(reg_cfg)])
    numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return dict(root=root, weights=weights, vae_cfg=vae_cfg, ldm_cfg=ldm_cfg, reg_cfg=reg_cfg,
                vae_vars=numpy(vae_vars), unet=unet, proj=proj, unet_vars=unet_vars,
                proj_vars=proj_vars, latent_dim=latent_dim)


def test_export_writes_the_ports_payloads(jax_world):
    weights = jax_world["weights"]
    want = state_dict_from_flax(jax_world["vae_vars"], AE_DEF)
    for name in ("autoencoder_last", "checkpoint_full"):  # a train state's params_g too
        got = torch.load(weights / f"{name}.pth", weights_only=True)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    autoencoder_from_config(AE_DEF).load_state_dict(want, strict=True)
    payload = torch.load(weights / "diffusion_last.pth", weights_only=True)
    assert set(payload) == {"unet", "projector"} and set(payload["projector"]) == {"weight", "bias"}
    head = torch.load(weights / "head_best.pth", weights_only=True)
    assert (head["targets"], head["epoch"], head["latent_dim"]) == (TARGETS, 3,
                                                                   jax_world["latent_dim"])
    # dropout 0.1: Linear, activation, dropout per hidden layer
    assert sorted(head["regressor_state_dict"]) == sorted(
        f"mlp.{i}.{p}" for i in (0, 3, 6) for p in ("weight", "bias"))


def test_the_to_torch_npz_loads(jax_world, tmp_path, monkeypatch):
    """``tools/convert_torch_checkpoint.py to-torch`` writes a MONAI-keyed
    ``.npz``; the port's VAE loader reads it (no pickles) as the same state
    dict the ``.pth`` export holds."""
    out = tmp_path / "vae.npz"
    monkeypatch.setattr(sys, "argv", ["convert", "to-torch", str(jax_world["weights"] / "autoencoder_last"),
                                      str(jax_world["vae_cfg"]), str(out)])
    _tool("convert_torch_checkpoint").main()
    got = load_autoencoder_state_dict(str(out))
    want = state_dict_from_flax(jax_world["vae_vars"], AE_DEF)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_exported_vae_serves_inference_vae_like_the_jax_cli(jax_world):
    root, ckpt = jax_world["root"], str(jax_world["weights"] / "autoencoder_last")
    common = ["-c", str(jax_world["vae_cfg"]), "--checkpoint", ckpt, "--input-dir",
              str(root / "data"), "--batch-size", "2", "--num-workers", "2"]
    assert inference_vae(common + ["--output-dir", str(root / "vae_port"), "--device", "cpu"]) == 5
    jax_inference_vae(common + ["--output-dir", str(root / "vae_jax"), "--f32"])
    names = sorted(os.listdir(root / "vae_jax" / "results_tif"))
    assert sorted(os.listdir(root / "vae_port" / "results_tif")) == names and len(names) == 5
    for name in names:
        ours = read_image(str(root / "vae_port" / "results_tif" / name))
        theirs = read_image(str(root / "vae_jax" / "results_tif" / name))
        assert ours.shape == theirs.shape == (PATCH, 2 * PATCH)
        np.testing.assert_array_equal(ours[:, :PATCH], theirs[:, :PATCH])  # the native input
        assert np.abs(ours - theirs).max() <= 1e-3


def test_exported_unet_matches_the_jax_unet(jax_world):
    unet_sd, proj_sd = load_diffusion_checkpoint(str(jax_world["weights"] / "diffusion_last"))
    unet = diffusion_unet_from_config(UNET_DEF)
    unet.load_state_dict(unet_sd, strict=True)
    proj = ConditionProjector(latent_channels=2, cross_attention_dim=16)
    proj.load_state_dict(proj_sd, strict=True)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, PATCH // 2, PATCH // 2, 2)).astype(np.float32)
    cond = rng.normal(size=(2, PATCH // 2, PATCH // 2, 2)).astype(np.float32)
    t = np.array([3, 41], np.int32)
    ctx_jax = jax_world["proj"].apply(jax_world["proj_vars"], cond.reshape(2, -1, 2))
    want = np.asarray(jax.jit(jax_world["unet"].apply)(jax_world["unet_vars"], x, jnp.asarray(t),
                                                       ctx_jax))
    with torch.no_grad():
        ctx = project_latent_condition(proj, torch.from_numpy(cond))
        np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_jax), rtol=1e-4, atol=1e-5)
        got = unet(torch.from_numpy(x), torch.from_numpy(t).long(), ctx).numpy()
    assert np.abs(got - want).max() <= 1e-3


def test_exported_unet_and_vae_drive_sample_diffusion(jax_world):
    """The LDM config names the JAX run's orbax directories, VAE and UNet; the
    port's sampler loads the exports beside them."""
    root = jax_world["root"]
    out = sample_diffusion(["-c", str(jax_world["ldm_cfg"]), "--checkpoint",
                            str(jax_world["weights"] / "diffusion_last"), "--condition-dir",
                            str(root / "data"), "--num-images", "2", "--output-dir",
                            str(root / "samples"), "--num-workers", "1", "--device", "cpu"])
    tifs = sorted(Path(out).glob("sample_*.tif"))
    assert len(tifs) == 2 and all(np.isfinite(read_image(str(p))).all() for p in tifs)
    assert read_image(str(tifs[0])).shape == (PATCH, PATCH)


def _predictions(path: Path) -> np.ndarray:
    payload = json.loads(path.read_text())
    return np.array([[row[t] for t in payload["targets"]] for row in payload["predictions"]])


def test_exported_head_serves_inference_regression_like_the_jax_cli(jax_world):
    root = jax_world["root"]
    args = ["-c", str(jax_world["reg_cfg"]), "--checkpoint", str(jax_world["weights"] / "head_best"),
            "--input-dir", str(root / "data" / "dente"), "--batch-size", "2"]
    inference_regression(args + ["--output-dir", str(root / "reg_port"), "--device", "cpu"])
    jax_inference_regression(args + ["--output-dir", str(root / "reg_jax")])
    got = _predictions(root / "reg_port" / "predictions.json")
    want = _predictions(root / "reg_jax" / "predictions.json")
    assert got.shape == (5, len(TARGETS)) and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


# ------------------------------------------- the shipped configs chain ----
def test_shipped_configs_chain_in_the_port(tmp_path, monkeypatch):
    """``train_vae`` -> ``train_regression`` / ``train_diffusion`` with the
    shipped configs' relative paths, run from a working directory that holds
    ``config/`` and ``data/`` as the repository's README lays them out. Only
    the VAE's width (toy), the patch size (32², LPIPS needs 17) and the
    epochs and batches are cut;
    ``vae.checkpoint`` stays ``./runs/vae_dente_no_adv/trained_weights/autoencoder_last``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    (tmp_path / "config").mkdir()
    _images(tmp_path / "data" / "train_val" / "dente", 6, seed=1)
    rng = np.random.default_rng(2)
    attributes = {f"img_{i:03d}.tif": {t: float(rng.uniform(5, 50)) for t in TARGETS}
                  for i in range(6)}
    (tmp_path / "data" / "train_val" / "metrics").mkdir()
    (tmp_path / "data" / "train_val" / "metrics" / "attributes_edente.json").write_text(
        json.dumps(attributes))

    vae = json.loads((ROOT / "config" / "vae_dente_no_adv.json").read_text())
    vae["autoencoder_def"].update(channels=[8, 16], num_res_blocks=1, norm_num_groups=4)
    vae["autoencoder_train"].update(batch_size=2, patch_size=[32, 32], max_epochs=1)
    (tmp_path / "config" / "vae_dente_no_adv.json").write_text(json.dumps(vae))
    reg = json.loads((ROOT / "config" / "reg_edente_from_dente.json").read_text())
    reg["data"].update(patch_size=[32, 32], num_workers=1, train_split=0.5)
    reg["regression_train"].update(batch_size=2, max_epochs=1)
    (tmp_path / "config" / "reg_edente_from_dente.json").write_text(json.dumps(reg))
    ldm = json.loads((ROOT / "config" / "ldm_dente.json").read_text())
    ldm["diffusion_train"].update(batch_size=3, max_epochs=1)
    (tmp_path / "config" / "ldm_dente.json").write_text(json.dumps(ldm))
    assert reg["vae"]["checkpoint"] == ldm["vae"]["checkpoint"] == (
        "./runs/vae_dente_no_adv/trained_weights/autoencoder_last")

    train_vae(["-c", "config/vae_dente_no_adv.json", "--device", "cpu", "--no-wandb",
               "--num-workers", "1"])
    assert (tmp_path / "runs/vae_dente_no_adv/trained_weights/autoencoder_last.pth").is_file()
    result = train_regression(["-c", "config/reg_edente_from_dente.json", "--device", "cpu"])
    assert np.isfinite(result["best_val"])
    assert (tmp_path / "runs/reg_edente_from_dente/trained_weights/head_last.pth").is_file()
    result = train_diffusion(["-c", "config/ldm_dente.json", "--input-dir", "data/train_val",
                              "--device", "cpu", "--num-workers", "1"])
    assert result["total_step"] == 2 and np.isfinite(result["final_loss"])
    assert (tmp_path / "runs/ldm_dente/trained_weights/diffusion_last.pth").is_file()
    shutil.rmtree(tmp_path / "runs")

"""The port's training entry point on the CPU: ``cli.train_vae --device cpu``
on synthetic TIFs with a tiny config. It trains, validates, writes best/last
checkpoints in the reference's ``.pth`` layout, resumes, and its best
checkpoint loads in the port's inference CLI. The split file is the JAX
package's ``split_dataset`` on the same paths and seed.
"""

import json
import os

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.data.datasets import list_tif_paths as jax_list_tif_paths
from pti_ldm_vae_tpu.data.datasets import split_dataset as jax_split_dataset
from pti_ldm_vae_tpu_torch.checkpoint.manager import CheckpointManager
from pti_ldm_vae_tpu_torch.cli.inference_vae import main as inference_main
from pti_ldm_vae_tpu_torch.cli.train_vae import main, parse_args
from pti_ldm_vae_tpu_torch.config import resolve_refs
from pti_ldm_vae_tpu_torch.data.io import write_tif
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.train.loop import VAETrainer, resolve_ar_settings
from pti_ldm_vae_tpu_torch.train.state import create_train_state

N_IMAGES = 12


def _config(root, **train_overrides):
    train = {"batch_size": 4, "patch_size": [32, 32], "lr": 1e-3, "perceptual_weight": 1.0,
             "kl_weight": 1e-3, "recon_loss": "l1", "adv_weight": 0.5, "adv_enabled": False,
             "max_epochs": 2, "val_interval": 1}
    train.update(train_overrides)
    return {
        "spatial_dims": 2, "image_channels": 1, "latent_channels": 3,
        "data_base_dir": str(root / "data"), "data_source": "dente", "train_split": 0.75,
        "run_dir": str(root / "run"),
        "autoencoder_def": {
            "spatial_dims": "@spatial_dims", "in_channels": "@image_channels",
            "out_channels": "@image_channels", "latent_channels": "@latent_channels",
            "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4,
            "norm_eps": 1e-6, "attention_levels": [False, False],
            "with_encoder_nonlocal_attn": True, "with_decoder_nonlocal_attn": True,
        },
        "autoencoder_train": train,
        "wandb": {"enabled": False},
    }


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_cli")
    data = root / "data" / "dente"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        img = rng.uniform(0.1, 1.0, size=(40, 40)).astype(np.float32)
        img[:4] = 0.0
        write_tif(str(data / f"dente_{i:03d}.tif"), img)
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(_config(root)))
    return root, cfg_path


@pytest.fixture(scope="module")
def first_run(workspace):
    root, cfg_path = workspace
    result = main(["-c", str(cfg_path), "--device", "cpu", "--no-wandb", "--num-workers", "2"])
    return root, cfg_path, result


def _metrics(root):
    with open(root / "run" / "metrics.jsonl", encoding="utf-8") as fh:
        return [json.loads(line) for line in fh]


def test_trains_validates_and_logs(first_run):
    root, _, result = first_run
    # 9 train images in batches of 4 -> 3 steps per epoch (the last one padded)
    assert result["total_step"] == 6 and np.isfinite(result["best_val_loss"])
    rows = _metrics(root)
    train_rows = [r for r in rows if "train/loss_total" in r]
    val_rows = [r for r in rows if "val/loss_total" in r]
    assert [r["train/step"] for r in train_rows] == [1, 2, 3, 4, 5, 6]
    assert [r["epoch"] for r in val_rows] == [0, 1]
    for r in train_rows:
        assert {"train/recon_loss", "train/kl_loss", "train/perceptual_loss", "train/adv_gen_loss",
                "train/adv_disc_loss", "train/loss_total", "train/step"} <= set(r)
        assert not any(k.startswith("debug/") for k in r)
    for r in val_rows:
        assert {"val/recon_loss", "val/kl_loss", "val/perceptual_loss", "val/adv_gen_loss",
                "val/adv_disc_loss", "val/loss_total"} <= set(r)
    assert all(np.isfinite(v) for r in train_rows + val_rows for k, v in r.items()
               if k.startswith(("train/", "val/")))
    assert any("time_per_epoch" in r for r in rows)
    assert sum("train/triplets/count" in r for r in rows) == 2
    # training moves the loss it optimises
    assert train_rows[-1]["train/loss_total"] < train_rows[0]["train/loss_total"]
    run_config = json.loads((root / "run" / "run_config.json").read_text())
    assert run_config["perceptual_pretrained"] is False and run_config["channels"] == [8, 16]


def test_split_file_matches_jax_split(first_run):
    root, _, _ = first_run
    split = json.loads((root / "run" / "splits" / "vae_split.json").read_text())
    paths = jax_list_tif_paths(str(root / "data"), "dente")
    train, val, _, _ = jax_split_dataset(paths, train_split=0.75, seed=42)
    assert split["train_files"] == train and split["val_files"] == val
    assert len(train) == 9 and len(val) == 3 and split["seed"] == 42


def test_checkpoints_in_reference_layout(first_run):
    root, _, result = first_run
    weights = root / "run" / "trained_weights"
    names = sorted(os.listdir(weights))
    full = [n for n in names if n.startswith("checkpoint_epoch")]
    assert "autoencoder_last.pth" in names and len(full) == 1  # the previous best is deleted
    epoch = int(full[0][len("checkpoint_epoch"):-len(".pth")])
    assert f"autoencoder_epoch{epoch}.pth" in names
    assert not any(n.endswith(".tmp") for n in names) and "CHECKPOINT_WRITE_FAILED" not in names
    raw = torch.load(weights / full[0], map_location="cpu", weights_only=True)
    assert {"autoencoder_state_dict", "optimizer_g_state_dict", "epoch", "best_val_loss",
            "total_step"} <= set(raw)
    assert raw["epoch"] == epoch and raw["best_val_loss"] == pytest.approx(result["best_val_loss"])
    assert "encoder.blocks.0.conv.weight" in raw["autoencoder_state_dict"]
    assert raw["optimizer_g_state_dict"]["param_groups"][0]["lr"] == pytest.approx(1e-3)


def test_best_checkpoint_loads_in_inference_cli(first_run):
    root, cfg_path, _ = first_run
    weights = root / "run" / "trained_weights"
    best = next(p for p in weights.iterdir() if p.name.startswith("autoencoder_epoch"))
    n = inference_main(["-c", str(cfg_path), "--checkpoint", str(best), "--input-dir",
                        str(root / "data"), "--output-dir", str(root / "infer"), "--device", "cpu",
                        "--batch-size", "4", "--num-workers", "2"])
    assert n == N_IMAGES and len(os.listdir(root / "infer" / "results_tif")) == N_IMAGES
    n = inference_main(["-c", str(cfg_path), "--checkpoint", str(weights / "autoencoder_last.pth"),
                        "--input-dir", str(root / "data"), "--output-dir", str(root / "infer_last"),
                        "--device", "cpu", "--num-samples", "2"])
    assert n == 2


def test_non_empty_run_dir_is_refused(first_run):
    _, cfg_path, _ = first_run
    with pytest.raises(ValueError, match="Run directory already exists"):
        main(["-c", str(cfg_path), "--device", "cpu", "--no-wandb"])


def test_resume_continues_at_next_epoch(first_run):
    root, _, first = first_run
    cfg = _config(root, max_epochs=3)
    cfg["resume_ckpt"] = True
    path = root / "resume.json"
    path.write_text(json.dumps(cfg))
    weights = root / "run" / "trained_weights"
    best_epoch = int(next(n for n in os.listdir(weights)
                          if n.startswith("checkpoint_epoch"))[len("checkpoint_epoch"):-len(".pth")])
    rows_before = len(_metrics(root))
    result = main(["-c", str(path), "--device", "cpu", "--no-wandb", "--num-workers", "2"])
    new_rows = _metrics(root)[rows_before:]
    epochs = [r["epoch"] for r in new_rows if "val/loss_total" in r]
    assert epochs == list(range(best_epoch + 1, 3))
    steps = [r["train/step"] for r in new_rows if "train/step" in r]
    assert steps[0] == 3 * (best_epoch + 1) + 1  # the step count continues from the checkpoint
    assert result["best_val_loss"] <= first["best_val_loss"]


def test_resume_without_checkpoint_raises(workspace, tmp_path):
    root, _ = workspace
    cfg = resolve_refs(_config(root))
    cfg["run_dir"], cfg["resume_ckpt"] = str(tmp_path / "empty_run"), True
    with pytest.raises(FileNotFoundError, match="No checkpoint to resume"):
        VAETrainer(cfg, device="cpu", use_wandb=False)


# AR-VAE is ported: switched on without an attribute mapping it is refused
# (ValueError) as early as the features that are not ported yet
_NO_MAPPING = "attribute_latent_mapping must be provided"


@pytest.mark.parametrize("patch,error,match", [
    (lambda c: (c["autoencoder_train"].update(adv_enabled=True), c.update(spatial_dims=3)),
     NotImplementedError, "adversarial"),
    (lambda c: c["autoencoder_train"].update(ar_vae_enabled=True), ValueError, _NO_MAPPING),
    (lambda c: c.update(regularized_attributes={"enabled": True}), ValueError, _NO_MAPPING),
    (lambda c: c.update(parallelism={"spatial": 2}), NotImplementedError, "parallelism"),
], ids=["adv", "ar_train", "ar_block", "parallelism"])
def test_unported_features_raise(workspace, tmp_path, patch, error, match):
    root, _ = workspace
    cfg = resolve_refs(_config(root))
    cfg["run_dir"] = str(tmp_path / "run")
    patch(cfg)
    with pytest.raises(error, match=match):
        VAETrainer(cfg, device="cpu", use_wandb=False)
    assert not (tmp_path / "run").exists()  # refused before anything is written


@pytest.mark.parametrize("flags", [["--profile-port", "9999"]])
def test_unported_flags_fail_loudly(workspace, tmp_path, flags):
    root, _ = workspace
    cfg = _config(root)
    cfg["run_dir"] = str(tmp_path / "run")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="not ported"):
        main(["-c", str(path), "--device", "cpu", "--no-wandb", *flags])


def _knobs(model):
    return {"remat": (model.encoder.remat, model.decoder.remat),
            "s2d_stem": (model.encoder.s2d_stem, model.decoder.s2d_stem),
            "norm_stats": model.encoder.blocks[-2].norm_stats}


# the apply-time knobs: config key -> (encoder, decoder) forms the trainer builds
_KNOB_CONFIGS = [
    ({"remat": True}, {"remat": (True, True), "s2d_stem": (False, False)}),
    ({"s2d_stem": "encoder"}, {"remat": (False, False), "s2d_stem": (True, False)}),
    ({"s2d_stem": True}, {"s2d_stem": (True, True)}),
    ({"s2d_stem": "decoder"}, {"s2d_stem": (False, True)}),
    ({"s2d_stem": "auto"}, {"s2d_stem": (False, False)}),  # the H100 train profile at b4
    ({"s2d_stem": "false"}, {"s2d_stem": (False, False)}),
    ({"norm_stats": "two_pass"}, {"norm_stats": "two_pass"}),
]


@pytest.mark.parametrize("keys,want", _KNOB_CONFIGS,
                         ids=["remat", "s2d_encoder", "s2d_true", "s2d_decoder", "s2d_auto",
                              "s2d_false_string", "two_pass"])
def test_knob_config_keys_reach_the_model(workspace, tmp_path, keys, want):
    """The JAX trainer's resolution of the top-level knobs (``loop.py``):
    "auto" from the train profile on the batch, strings and booleans as
    ``resolve_bool`` reads them."""
    root, _ = workspace
    cfg = resolve_refs(_config(root))
    cfg["run_dir"] = str(tmp_path / "run")
    cfg.update(keys)
    got = _knobs(VAETrainer(cfg, device="cpu", use_wandb=False).model)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("flags,want", [
    (["--s2d-stem", "encoder"], {"s2d_stem": (True, False)}),
    (["--remat"], {"remat": (True, True)}),
    (["--s2d-stem"], {"s2d_stem": (True, True)}),
    (["--s2d-stem", "decoder"], {"s2d_stem": (False, True)}),
    (["--norm-stats", "two_pass"], {"norm_stats": "two_pass"}),
], ids=["s2d_encoder", "remat", "s2d_bare", "s2d_decoder", "two_pass"])
def test_knob_flags_reach_the_model(workspace, tmp_path, monkeypatch, flags, want):
    root, _ = workspace
    cfg = _config(root)
    cfg["run_dir"] = str(tmp_path / "run")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(VAETrainer, "train", lambda self: _knobs(self.model))
    got = main(["-c", str(path), "--device", "cpu", "--no-wandb", *flags])
    assert {k: got[k] for k in want} == want


def test_remat_s2d_encoder_step_writes_a_standard_checkpoint(workspace, tmp_path):
    """One train step with ``--remat --s2d-stem encoder``: finite losses, and
    its checkpoint loads ``strict=True`` into a standard-form model, which
    reconstructs as the trained form does."""
    root, _ = workspace
    cfg = _config(root, max_epochs=1)
    cfg["run_dir"] = str(tmp_path / "run")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    result = main(["-c", str(path), "--device", "cpu", "--no-wandb", "--num-workers", "1",
                   "--subset-size", "4", "--remat", "--s2d-stem", "encoder"])
    assert result["total_step"] == 1 and np.isfinite(result["best_val_loss"])
    sd = torch.load(tmp_path / "run" / "trained_weights" / "autoencoder_last.pth",
                    weights_only=True)
    arch = resolve_refs(_config(root))["autoencoder_def"]
    standard = autoencoder_from_config(arch)
    standard.load_state_dict(sd, strict=True)
    trained_form = autoencoder_from_config(arch, s2d_stem="encoder", remat=True)
    trained_form.load_state_dict(sd, strict=True)
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        torch.testing.assert_close(trained_form.reconstruct_deterministic(x),
                                   standard.reconstruct_deterministic(x), rtol=1e-4, atol=1e-5)


def test_every_reference_flag_parses():
    args = parse_args(["-c", "x.json", "-g", "2", "--batch-size", "3", "--max-epochs", "4",
                       "--lr", "0.1", "--num-workers", "1", "--cache-rate", "0.5", "--seed", "7",
                       "--subset-size", "5", "--no-wandb", "--remat", "--s2d-stem", "auto",
                       "--norm-stats", "one_pass", "--f32", "--trace-at-step", "2",
                       "--profile-port", "1234", "--device", "cpu"])
    assert (args.gpus, args.batch_size, args.max_epochs, args.lr, args.seed) == (2, 3, 4, 0.1, 7)
    assert args.s2d_stem == "auto" and args.f32 and args.device == "cpu"
    assert parse_args(["-c", "x.json"]).device == "cuda"


def test_overrides_and_subset_reach_the_trainer(workspace, tmp_path):
    root, _ = workspace
    cfg = _config(root)
    cfg["run_dir"] = str(tmp_path / "run")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    result = main(["-c", str(path), "--device", "cpu", "--no-wandb", "--batch-size", "2",
                   "--max-epochs", "1", "--lr", "0.01", "--subset-size", "8", "--seed", "3",
                   "--cache-rate", "1.0", "--num-workers", "1", "--s2d-stem", "false", "--f32"])
    assert result["total_step"] == 3  # 6 train images in batches of 2
    split = json.loads((tmp_path / "run" / "splits" / "vae_split.json").read_text())
    assert split["subset_size"] == 8 and split["seed"] == 3 and len(split["val_files"]) == 2
    raw = torch.load(next((tmp_path / "run" / "trained_weights").glob("checkpoint_epoch*.pth")),
                     weights_only=True)
    assert raw["optimizer_g_state_dict"]["param_groups"][0]["lr"] == pytest.approx(0.01)


def test_train_cli_without_device_cpu_refuses_to_run_without_cuda(workspace):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    _, cfg_path = workspace
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["-c", str(cfg_path), "--no-wandb"])


def test_resolve_ar_settings_reads_both_blocks():
    assert resolve_ar_settings({"autoencoder_train": {}})["enabled"] is False
    got = resolve_ar_settings({"autoencoder_train": {"ar_vae_enabled": "true", "ar_vae_weight": "2.5"},
                               "regularized_attributes": {"gamma": 1.0, "pairwise": "subset"}})
    assert got["enabled"] and got["gamma"] == 2.5 and got["pairwise"] == "subset"
    got = resolve_ar_settings({"autoencoder_train": {"ar_vae_weight": "@missing"},
                               "regularized_attributes": {"enabled": True, "gamma": 0.7}})
    assert got["enabled"] and got["gamma"] == 0.7


# ------------------------------------------------------------ checkpoint manager
def _tiny_state():
    torch.manual_seed(0)
    model = autoencoder_from_config(dict(
        spatial_dims=2, in_channels=1, out_channels=1, latent_channels=2, channels=[4],
        num_res_blocks=1, norm_num_groups=2, with_encoder_nonlocal_attn=False,
        with_decoder_nonlocal_attn=False))
    state = create_train_state(model, lr=1e-2)
    model(torch.randn(1, 8, 8, 1), generator=torch.Generator().manual_seed(0))[0].sum().backward()
    state.apply_g()
    return state


def test_checkpoint_manager_best_last_semantics(tmp_path):
    state = _tiny_state()
    ckpt = CheckpointManager(str(tmp_path))
    best = ckpt.save_epoch(state=state, epoch=0, val_loss=0.5, best_val_loss=100.0, total_step=1)
    assert best == 0.5 and {"autoencoder_last.pth", "autoencoder_epoch0.pth",
                            "checkpoint_epoch0.pth"} == set(os.listdir(tmp_path))
    best = ckpt.save_epoch(state=state, epoch=1, val_loss=0.7, best_val_loss=best, total_step=2)
    assert best == 0.5 and "checkpoint_epoch1.pth" not in os.listdir(tmp_path)
    best = ckpt.save_epoch(state=state, epoch=2, val_loss=0.4, best_val_loss=best, total_step=3)
    assert best == 0.4 and {"autoencoder_last.pth", "autoencoder_epoch2.pth",
                            "checkpoint_epoch2.pth"} == set(os.listdir(tmp_path))

    fresh = _tiny_state()
    for p in fresh.model_g.parameters():
        p.data.add_(1.0)
    meta = CheckpointManager(str(tmp_path)).restore(fresh)
    assert meta == {"epoch": 2, "best_val_loss": 0.4, "total_step": 3} and fresh.step == 3
    for a, b in zip(fresh.model_g.parameters(), state.model_g.parameters()):
        assert torch.equal(a, b)
    ours = fresh.optimizer_g.state_dict()["state"]
    theirs = state.optimizer_g.state_dict()["state"]
    assert all(torch.equal(ours[k]["exp_avg_sq"], theirs[k]["exp_avg_sq"]) for k in theirs)
    assert CheckpointManager(str(tmp_path / "none")).restore(fresh) is None


def test_checkpoint_write_failure_leaves_marker_and_old_best(tmp_path, monkeypatch, capsys):
    state = _tiny_state()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_epoch(state=state, epoch=0, val_loss=0.5, best_val_loss=100.0, total_step=1)

    def full_disk(payload, path):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr("pti_ldm_vae_tpu_torch.checkpoint.manager.save_atomic", full_disk)
    with pytest.raises(OSError):
        ckpt.save_epoch(state=state, epoch=1, val_loss=0.1, best_val_loss=0.5, total_step=2)
    monkeypatch.undo()
    assert "CHECKPOINT_WRITE_FAILED" in os.listdir(tmp_path)
    assert "checkpoint_epoch0.pth" in os.listdir(tmp_path)  # the old best survives
    again = CheckpointManager(str(tmp_path))
    assert "FAILED" in capsys.readouterr().err
    again.save_epoch(state=state, epoch=1, val_loss=0.9, best_val_loss=0.5, total_step=2)
    assert "CHECKPOINT_WRITE_FAILED" not in os.listdir(tmp_path)

"""The port's adversarial training through its entry point on the CPU:
``cli.train_vae --device cpu`` with ``adv_enabled: true`` on synthetic TIFs
and a tiny config. The warm-up gate flips at the configured epoch, the
discriminator and both optimizers are checkpointed and resumed, and a
reference-layout full checkpoint (``.pth``) loads into the port's state with
the same weights, Adam moments and counters as the JAX package's
``load_reference_checkpoint`` gives.
"""

import json
import os

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.reference_resume import load_reference_checkpoint as jax_load_reference
from pti_ldm_vae_tpu.checkpoint.torch_convert import disc_to_torch_state_dict, to_torch_state_dict
from pti_ldm_vae_tpu_torch.checkpoint.manager import CheckpointManager
from pti_ldm_vae_tpu_torch.checkpoint.reference_resume import load_reference_checkpoint
from pti_ldm_vae_tpu_torch.cli.train_vae import main, parse_args
from pti_ldm_vae_tpu_torch.config import resolve_refs
from pti_ldm_vae_tpu_torch.data.io import write_tif
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import Convolution, autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
from pti_ldm_vae_tpu_torch.train.loop import VAETrainer
from pti_ldm_vae_tpu_torch.train.state import create_train_state

N_IMAGES = 12
STEPS_PER_EPOCH = 3  # 9 train images in batches of 4, the last one padded
AE_DEF = {
    "spatial_dims": 2, "in_channels": 1, "out_channels": 1, "latent_channels": 3,
    "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4, "norm_eps": 1e-6,
    "attention_levels": [False, False],
    "with_encoder_nonlocal_attn": True, "with_decoder_nonlocal_attn": True,
}


def _config(root, run="run", **train_overrides):
    train = {"batch_size": 4, "patch_size": [32, 32], "lr": 1e-3, "perceptual_weight": 1.0,
             "kl_weight": 1e-3, "recon_loss": "l1", "adv_weight": 3.0, "adv_enabled": True,
             "adv_warmup_epochs": 0, "max_epochs": 3, "val_interval": 1}
    train.update(train_overrides)
    return {
        "spatial_dims": 2, "image_channels": 1, "latent_channels": 3,
        "data_base_dir": str(root / "data"), "data_source": "dente", "train_split": 0.75,
        "run_dir": str(root / run), "autoencoder_def": dict(AE_DEF),
        "autoencoder_train": train, "wandb": {"enabled": False},
    }


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_adv_train_cli")
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
    result = main(["-c", str(cfg_path), "--device", "cpu", "--no-wandb", "--num-workers", "2",
                   "--conv-kernel"])
    return root, cfg_path, result


def _metrics(root, run="run"):
    with open(root / run / "metrics.jsonl", encoding="utf-8") as fh:
        return [json.loads(line) for line in fh]


def test_warm_up_gate_flips_at_the_configured_epoch(first_run):
    root, _, result = first_run
    assert result["total_step"] == 3 * STEPS_PER_EPOCH and np.isfinite(result["best_val_loss"])
    rows = _metrics(root)
    train_rows = [r for r in rows if "train/loss_total" in r]
    val_rows = {r["epoch"]: r for r in rows if "val/loss_total" in r}
    assert len(train_rows) == 9 and sorted(val_rows) == [0, 1, 2]
    # adv_warmup_epochs 0: epoch 0 is warm-up (0 > 0 is false), epochs 1 and 2 adversarial
    for r in train_rows[:STEPS_PER_EPOCH]:
        assert r["train/adv_gen_loss"] == 0.0 and r["train/adv_disc_loss"] == 0.0
    for r in train_rows[STEPS_PER_EPOCH:]:
        assert r["train/adv_gen_loss"] > 0.0 and r["train/adv_disc_loss"] > 0.0
    assert val_rows[0]["val/adv_gen_loss"] == 0.0 and val_rows[0]["val/adv_disc_loss"] == 0.0
    for epoch in (1, 2):
        assert val_rows[epoch]["val/adv_gen_loss"] > 0.0 and val_rows[epoch]["val/adv_disc_loss"] > 0.0
    assert all(np.isfinite(v) for r in train_rows + list(val_rows.values()) for k, v in r.items()
               if k.startswith(("train/", "val/")))


@pytest.mark.parametrize("warmup,epoch,active", [(5, 5, False), (5, 6, True), (0, 0, False),
                                                  (0, 1, True), (2, 2, False), (2, 3, True)])
def test_adv_active_is_epoch_beyond_warmup(workspace, tmp_path, warmup, epoch, active):
    root, _ = workspace
    cfg = resolve_refs(_config(root, adv_warmup_epochs=warmup))
    cfg["run_dir"] = str(tmp_path / "run")
    trainer = VAETrainer(cfg, device="cpu", use_wandb=False, num_workers=1)
    try:
        assert trainer._adv_active(epoch) is active
        assert set(trainer._train_steps) == set(trainer._eval_steps) == {False, True}
        assert trainer.state.model_d is trainer.disc and trainer.state.optimizer_d is not None
    finally:
        trainer.close()


def test_defaults_follow_the_reference_and_adv_off_builds_no_discriminator(workspace, tmp_path):
    root, _ = workspace
    cfg = resolve_refs(_config(root))
    del cfg["autoencoder_train"]["adv_enabled"], cfg["autoencoder_train"]["adv_warmup_epochs"]
    cfg["run_dir"] = str(tmp_path / "run_default")
    trainer = VAETrainer(cfg, device="cpu", use_wandb=False, num_workers=1)
    try:
        assert trainer.adv_enabled and trainer.adv_warmup_epochs == 5
        assert not trainer._adv_active(5) and trainer._adv_active(6)
        assert list(trainer.disc.state_dict())[0] == "initial_conv.conv.weight"
        assert not trainer.model.conv_kernel  # the convolution kernels are opt-in
    finally:
        trainer.close()
    cfg = resolve_refs(_config(root, adv_enabled=False))
    cfg["run_dir"] = str(tmp_path / "run_off")
    trainer = VAETrainer(cfg, device="cpu", use_wandb=False, num_workers=1)
    try:
        assert trainer.disc is None and trainer.state.optimizer_d is None
        assert set(trainer._train_steps) == {False} and not trainer._adv_active(99)
    finally:
        trainer.close()


def test_conv_kernel_flag_reaches_the_model(workspace, tmp_path):
    root, _ = workspace
    assert parse_args(["-c", "x.json", "--conv-kernel"]).conv_kernel
    assert not parse_args(["-c", "x.json"]).conv_kernel
    cfg = resolve_refs(_config(root))
    cfg["run_dir"] = str(tmp_path / "run")
    trainer = VAETrainer(cfg, device="cpu", use_wandb=False, num_workers=1, conv_kernel=True)
    try:
        convs = [m for m in trainer.model.modules() if isinstance(m, Convolution)]
        routed = [m for m in convs if m.conv_kernel]
        assert trainer.model.conv_kernel and 0 < len(routed) < len(convs)
        assert all(m.conv.kernel_size == (3, 3) and m.conv.stride == (1, 1) for m in routed)
    finally:
        trainer.close()


def test_checkpoints_hold_the_discriminator_and_both_optimizers(first_run):
    root, _, result = first_run
    weights = root / "run" / "trained_weights"
    names = sorted(os.listdir(weights))
    full = [n for n in names if n.startswith("checkpoint_epoch")]
    assert {"autoencoder_last.pth", "discriminator_last.pth"} <= set(names) and len(full) == 1
    epoch = int(full[0][len("checkpoint_epoch"):-len(".pth")])
    assert {f"autoencoder_epoch{epoch}.pth", f"discriminator_epoch{epoch}.pth"} <= set(names)
    assert len([n for n in names if n.startswith("discriminator_epoch")]) == 1
    assert not any(n.endswith(".tmp") for n in names)
    raw = torch.load(weights / full[0], map_location="cpu", weights_only=True)
    assert {"autoencoder_state_dict", "discriminator_state_dict", "optimizer_g_state_dict",
            "optimizer_d_state_dict", "epoch", "best_val_loss", "total_step"} == set(raw)
    assert list(raw["discriminator_state_dict"])[0] == "initial_conv.conv.weight"
    last = torch.load(weights / "discriminator_last.pth", map_location="cpu", weights_only=True)
    PatchDiscriminator().load_state_dict(last, strict=True)
    # seed 42 + 1 is the trainer's discriminator init: training moved every tensor from it
    init = PatchDiscriminator(generator=torch.Generator().manual_seed(43)).state_dict()
    assert all(not torch.equal(init[k], v) for k, v in last.items())
    # the discriminator took Adam steps only in the adversarial epochs (1 and 2)
    steps = {int(e["step"]) for e in raw["optimizer_d_state_dict"]["state"].values()}
    assert steps <= {STEPS_PER_EPOCH * e for e in (0, 1, 2)} and raw["best_val_loss"] == \
        pytest.approx(result["best_val_loss"])


def test_resume_restores_discriminator_and_both_optimizers(first_run):
    root, _, _ = first_run
    cfg = resolve_refs(_config(root, max_epochs=4))
    cfg["resume_ckpt"] = True
    weights = root / "run" / "trained_weights"
    full = next(p for p in weights.iterdir() if p.name.startswith("checkpoint_epoch"))
    raw = torch.load(full, map_location="cpu", weights_only=True)
    trainer = VAETrainer(cfg, device="cpu", use_wandb=False, num_workers=1)
    try:
        assert trainer.start_epoch == raw["epoch"] + 1 and trainer.total_step == raw["total_step"]
        for key, value in trainer.disc.state_dict().items():
            assert torch.equal(value, raw["discriminator_state_dict"][key]), key
        for name, opt in (("g", trainer.state.optimizer_g), ("d", trainer.state.optimizer_d)):
            theirs = raw[f"optimizer_{name}_state_dict"]["state"]
            ours = opt.state_dict()["state"]
            assert set(ours) == set(theirs)
            for idx, entry in theirs.items():
                assert torch.equal(ours[idx]["exp_avg"], entry["exp_avg"])
                assert torch.equal(ours[idx]["exp_avg_sq"], entry["exp_avg_sq"])
                assert int(ours[idx]["step"]) == int(entry["step"])
        rows_before = len(_metrics(root))
        result = trainer.train()
    finally:
        trainer.close()
    new_rows = _metrics(root)[rows_before:]
    assert [r["epoch"] for r in new_rows if "val/loss_total" in r] == list(range(raw["epoch"] + 1, 4))
    steps = [r["train/step"] for r in new_rows if "train/step" in r]
    assert steps[0] == raw["total_step"] + 1 and result["total_step"] == steps[-1]


# ------------------------------------------------------------ checkpoint manager
def _tiny_gan_state(seed=0):
    torch.manual_seed(seed)
    model = autoencoder_from_config(dict(AE_DEF, channels=[4], latent_channels=2, norm_num_groups=2,
                                         attention_levels=[False], with_encoder_nonlocal_attn=False,
                                         with_decoder_nonlocal_attn=False))
    disc = PatchDiscriminator(channels=4, generator=torch.Generator().manual_seed(seed + 1))
    state = create_train_state(model, lr=1e-2, model_d=disc)
    x = torch.randn(1, 32, 32, 1)
    model(x, generator=torch.Generator().manual_seed(0))[0].sum().backward()
    state.apply_g()
    disc(x)[-1].square().mean().backward()
    state.apply_d()
    return state


def test_checkpoint_manager_round_trip_with_discriminator(tmp_path):
    state = _tiny_gan_state()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_epoch(state=state, epoch=0, val_loss=0.5, best_val_loss=100.0, total_step=1)
    assert set(os.listdir(tmp_path)) == {
        "autoencoder_last.pth", "discriminator_last.pth", "autoencoder_epoch0.pth",
        "discriminator_epoch0.pth", "checkpoint_epoch0.pth"}
    ckpt.save_epoch(state=state, epoch=3, val_loss=0.4, best_val_loss=0.5, total_step=4)
    assert set(os.listdir(tmp_path)) == {
        "autoencoder_last.pth", "discriminator_last.pth", "autoencoder_epoch3.pth",
        "discriminator_epoch3.pth", "checkpoint_epoch3.pth"}  # the previous best is deleted

    fresh = _tiny_gan_state(seed=5)
    meta = CheckpointManager(str(tmp_path)).restore(fresh)
    assert meta == {"epoch": 3, "best_val_loss": 0.4, "total_step": 4} and fresh.step == 4
    for ours, theirs in ((fresh.model_g, state.model_g), (fresh.model_d, state.model_d)):
        for a, b in zip(ours.parameters(), theirs.parameters()):
            assert torch.equal(a, b)
    ours = fresh.optimizer_d.state_dict()["state"]
    theirs = state.optimizer_d.state_dict()["state"]
    assert ours.keys() == theirs.keys() and len(theirs) == 7
    assert all(torch.equal(ours[k]["exp_avg"], theirs[k]["exp_avg"]) for k in theirs)


def test_restore_of_a_checkpoint_without_discriminator_keeps_the_live_one(tmp_path):
    no_adv = _tiny_gan_state()
    no_adv.model_d = no_adv.optimizer_d = None
    CheckpointManager(str(tmp_path)).save_epoch(state=no_adv, epoch=1, val_loss=0.3,
                                                best_val_loss=1.0, total_step=2)
    assert "discriminator_last.pth" not in os.listdir(tmp_path)
    fresh = _tiny_gan_state(seed=9)
    before = {k: v.clone() for k, v in fresh.model_d.state_dict().items()}
    meta = CheckpointManager(str(tmp_path)).restore(fresh)
    assert meta["epoch"] == 1
    assert all(torch.equal(before[k], v) for k, v in fresh.model_d.state_dict().items())


# ------------------------------------------------------------ reference resume
def _reference_checkpoint(path, with_disc=True):
    """A file in the reference's layout (``train_vae.py:740-765``): MONAI-keyed
    state dicts and ``torch.optim.Adam`` state dicts after a few steps."""
    torch.manual_seed(3)
    model = autoencoder_from_config(AE_DEF)
    disc = PatchDiscriminator(channels=32, generator=torch.Generator().manual_seed(4))
    opt_g = torch.optim.Adam(model.parameters(), lr=2e-3)
    opt_d = torch.optim.Adam(disc.parameters(), lr=2e-3)
    for i in range(3):
        x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(10 + i))
        recon, z_mu, _ = model(x, generator=torch.Generator().manual_seed(i))
        ((recon - x).abs().mean() + 1e-3 * z_mu.square().mean()).backward()
        opt_g.step(), opt_g.zero_grad()
        disc(x)[-1].square().mean().backward()
        opt_d.step(), opt_d.zero_grad()
    payload = {"epoch": 7, "autoencoder_state_dict": model.state_dict(),
               "optimizer_g_state_dict": opt_g.state_dict(), "best_val_loss": 0.123,
               "total_step": 321}
    if with_disc:
        payload["discriminator_state_dict"] = disc.state_dict()
        payload["optimizer_d_state_dict"] = opt_d.state_dict()
    torch.save(payload, path)
    return payload


def _fresh_state():
    torch.manual_seed(20)
    model = autoencoder_from_config(AE_DEF)
    disc = PatchDiscriminator(generator=torch.Generator().manual_seed(21))
    return create_train_state(model, lr=1e-3, model_d=disc)


def _moments(optimizer, model, name):
    """An optimizer's ``exp_avg`` / ``exp_avg_sq`` keyed by parameter name."""
    state = optimizer.state_dict()["state"]
    return {key: state[i][name].numpy() for i, (key, _) in enumerate(model.named_parameters())}


def test_load_reference_checkpoint_matches_the_jax_function(tmp_path):
    import jax

    path = str(tmp_path / "checkpoint_epoch7.pth")
    payload = _reference_checkpoint(path)
    state = _fresh_state()
    meta = load_reference_checkpoint(path, state)

    jax_state, jax_meta = jax_load_reference(path, AE_DEF, lr=1e-3)
    assert meta == jax_meta == {"epoch": 7, "best_val_loss": 0.123, "total_step": 321}
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    assert state.step == int(jax_state.step) == 3
    for ours, theirs in (
        (state.model_g.state_dict(), to_torch_state_dict(as_np(jax_state.params_g), AE_DEF)),
        (state.model_d.state_dict(), disc_to_torch_state_dict(as_np(jax_state.params_d))),
    ):
        assert set(ours) == set(theirs)
        for key, value in theirs.items():
            np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    adam_g, adam_d = jax_state.opt_state_g[0], jax_state.opt_state_d[0]
    assert int(adam_g.count) == int(adam_d.count) == 3
    for optimizer, model, adam, convert in (
        (state.optimizer_g, state.model_g, adam_g, lambda t: to_torch_state_dict(as_np(t), AE_DEF)),
        (state.optimizer_d, state.model_d, adam_d, lambda t: disc_to_torch_state_dict(as_np(t))),
    ):
        for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            ours, theirs = _moments(optimizer, model, name), convert(tree)
            assert set(ours) == set(theirs)
            for key, value in theirs.items():
                np.testing.assert_array_equal(ours[key], value, err_msg=f"{name} {key}")
        steps = {int(e["step"]) for e in optimizer.state_dict()["state"].values()}
        assert steps == {3}
    assert state.optimizer_g.param_groups[0]["lr"] == pytest.approx(2e-3)  # the file's, as torch loads it
    assert torch.equal(state.model_g.state_dict()["decoder.blocks.0.conv.weight"],
                       payload["autoencoder_state_dict"]["decoder.blocks.0.conv.weight"])


def test_load_reference_checkpoint_without_discriminator_keeps_the_fresh_one(tmp_path):
    path = str(tmp_path / "old.pth")
    _reference_checkpoint(path, with_disc=False)
    state = _fresh_state()
    before = {k: v.clone() for k, v in state.model_d.state_dict().items()}
    meta = load_reference_checkpoint(path, state)
    assert meta["epoch"] == 7
    assert all(torch.equal(before[k], v) for k, v in state.model_d.state_dict().items())
    assert state.optimizer_d.state_dict()["state"] == {}
    torch.save({"state_dict": {}}, tmp_path / "not_a_checkpoint.pth")
    with pytest.raises(KeyError, match="not a reference full checkpoint"):
        load_reference_checkpoint(str(tmp_path / "not_a_checkpoint.pth"), state)


def test_trainer_resumes_from_a_reference_checkpoint_file(workspace, tmp_path):
    root, _ = workspace
    path = str(tmp_path / "checkpoint_epoch7.pth")
    payload = _reference_checkpoint(path)
    cfg = resolve_refs(_config(root, run="run_from_reference", max_epochs=9))
    cfg["resume_ckpt"], cfg["checkpoint_dir"] = True, path
    trainer = VAETrainer(cfg, device="cpu", use_wandb=False, num_workers=1)
    try:
        assert (trainer.start_epoch, trainer.total_step, trainer.best_val_loss) == (8, 321, 0.123)
        assert torch.equal(trainer.disc.state_dict()["2.conv.weight"],
                           payload["discriminator_state_dict"]["2.conv.weight"])
        result = trainer.train()  # epoch 8: adversarial (8 > 0), from the loaded moments
    finally:
        trainer.close()
    assert result["total_step"] == 321 + STEPS_PER_EPOCH
    rows = [r for r in _metrics(root, "run_from_reference") if "train/loss_total" in r]
    assert [r["train/step"] for r in rows] == [322, 323, 324]
    assert all(r["train/adv_disc_loss"] > 0 and np.isfinite(r["train/loss_total"]) for r in rows)

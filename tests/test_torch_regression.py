"""The port's regression modules against the JAX package on the CPU, at toy
size (VAE channels [8, 16], one ResBlock, 4 groups, 32² patches): the
channel-major flatten, the MLP head in every activation with and without its
dropout layout, the frozen VAE + head, the flattened size at the toy patch
and at both regression configs' 256², the target normalizer and its JSON,
both losses, three train steps on one batch with a padded row (dropout off)
across loss / normalizer / optimizer choices, the eval step, the regression
loaders, and head checkpoints that the JAX package loads.

Bars: flatten and loaders exact; head rtol 1e-5 / atol 1e-6; VAE + head
rtol 1e-4 / atol 1e-5; train-step losses rtol 1e-5, head parameters rtol
1e-4 / atol 1e-5; eval loss rtol 1e-5, predictions rtol 1e-4 / atol 1e-5 of
their scale.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pti_ldm_vae_tpu.data import factory as jax_factory
from pti_ldm_vae_tpu.data.io import write_tif
from pti_ldm_vae_tpu.models import regressor as jax_reg
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.utils import regression_utils as jax_ru
from pti_ldm_vae_tpu_torch.checkpoint.regressor_convert import (
    linear_indices,
    regressor_state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax
from pti_ldm_vae_tpu_torch.config import load_config
from pti_ldm_vae_tpu_torch.data import factory
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.regressor import (
    LatentRegressor,
    VAELatentRegressor,
    flatten_latent,
    infer_flat_dim_from_patch,
)
from pti_ldm_vae_tpu_torch.utils import regression_utils as ru

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=4,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, False],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
PATCH = 32
FLAT = 4 * 16 * 16
TARGETS = ["height_0", "width_0", "width_1"]
HEAD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def toy():
    """The toy VAE in both frameworks (JAX init, weights carried across),
    a batch of 4 images at 32² whose last row is padding, and targets of a
    few hundred (as the mask attributes are)."""
    jax_vae = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    variables = jax.jit(jax_vae.init)(jax.random.key(0), jnp.zeros((1, PATCH, PATCH, 1)),
                                      jax.random.key(1))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    vae = autoencoder_from_config(TOY)
    vae.load_state_dict(state_dict_from_flax(variables, TOY), strict=True)
    vae.requires_grad_(False).eval()
    rng = np.random.default_rng(0)
    images = rng.uniform(0.0, 1.0, size=(4, PATCH, PATCH, 1)).astype(np.float32)
    targets = rng.uniform(50.0, 400.0, size=(4, len(TARGETS))).astype(np.float32)
    images[3], targets[3] = 0.0, 0.0
    mask = np.array([1, 1, 1, 0], np.float32)
    return dict(jax_vae=jax_vae, variables=variables, vae=vae, images=images, targets=targets,
                mask=mask)


def _heads(hidden, dropout=0.0, activation="relu", seed=0):
    """A Flax head and the port's head with the same weights."""
    jax_head = jax_reg.LatentRegressor(hidden_dims=tuple(hidden), output_dim=len(TARGETS),
                                       dropout=dropout, activation=activation)
    params = jax.tree_util.tree_map(
        np.asarray, jax_head.init(jax.random.key(seed), jnp.zeros((1, FLAT))))
    head = LatentRegressor(FLAT, hidden, len(TARGETS), dropout=dropout, activation=activation)
    head.load_state_dict(regressor_state_dict_from_flax(params, dropout=dropout > 0), strict=True)
    return jax_head, params, head


# ---- flatten, head, frozen VAE + head ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (2, 3, 5, 6, 4)], ids=["2d", "3d"])
def test_flatten_latent_is_channel_major(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_reg.flatten_latent(jnp.asarray(x)))
    t = torch.from_numpy(x)
    if len(shape) == 4:  # the encoder's output lies in channels_last memory
        t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(flatten_latent(t).numpy(), want)


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout_layout"])
@pytest.mark.parametrize("activation", ["relu", "gelu", "leaky_relu", "elu"])
def test_latent_regressor_matches_flax(activation, dropout):
    jax_head, params, head = _heads([16, 8], dropout, activation)
    x = np.random.default_rng(2).normal(size=(5, FLAT)).astype(np.float32)
    want = np.asarray(jax_head.apply(params, jnp.asarray(x)))
    head.eval()
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **HEAD_TOL)
    keys = sorted({k.rsplit(".", 1)[0] for k in head.state_dict()})
    assert keys == sorted(f"mlp.{i}" for i in linear_indices(2, dropout > 0))


def test_unknown_activation_and_output_dim_raise():
    with pytest.raises(ValueError, match="Unsupported activation: tanh. Choose from relu, gelu, "
                                         "leaky_relu, elu."):
        LatentRegressor(8, [4], 1, activation="tanh")
    with pytest.raises(ValueError, match="output_dim must be positive"):
        LatentRegressor(8, [4], 0)


def test_dropout_draws_from_the_generator_and_scales_kept_entries():
    head = LatentRegressor(64, [4096], 1, dropout=0.25)
    dropout = head.mlp[2]
    x = torch.ones(2, 4096)
    head.train()
    a = dropout(x, torch.Generator().manual_seed(3))
    b = dropout(x, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.02
    head.eval()
    assert dropout(x, torch.Generator().manual_seed(3)) is x


def test_head_init_is_flax_lecun_normal():
    a = LatentRegressor(4096, [256], 6, generator=torch.Generator().manual_seed(0))
    b = LatentRegressor(4096, [256], 6, generator=torch.Generator().manual_seed(0))
    for (key, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=key)
    w = a.mlp[0].weight.detach()
    std = (1.0 / 4096) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert float(a.mlp[0].bias.detach().abs().max()) == 0.0
    # Flax's own init of the same layer has the same spread
    flax_k = jax_reg.LatentRegressor(hidden_dims=(256,), output_dim=6).init(
        jax.random.key(0), jnp.zeros((1, 4096)))["params"]["dense_0"]["kernel"]
    assert abs(float(jnp.std(flax_k)) / float(w.std()) - 1.0) < 0.02


def test_vae_latent_regressor_matches_jax(toy):
    jax_head, params, head = _heads([16], 0.1, "gelu")
    jax_model = jax_reg.VAELatentRegressor(toy["jax_vae"], toy["variables"], jax_head,
                                           latent_dim=FLAT)
    want = np.asarray(jax_model.apply(params, jnp.asarray(toy["images"])))
    model = VAELatentRegressor(toy["vae"], head, latent_dim=FLAT).eval()
    got = model(torch.from_numpy(toy["images"]))
    assert got.requires_grad  # through the head's parameters
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    flat = model.encode_flat(torch.from_numpy(toy["images"]))
    assert flat.shape == (4, FLAT) and not flat.requires_grad
    assert not torch.is_inference(flat)


def test_large_flattened_dimension_warns(toy):
    with pytest.warns(UserWarning, match="Flattened latent dimension"):
        VAELatentRegressor(toy["vae"], LatentRegressor(8, [], 1), latent_dim=131073)


@pytest.mark.parametrize("case", ["toy_32", "toy_33x20", "reg_edente_from_dente",
                                  "nreg_edente_from_both"])
def test_infer_flat_dim_matches_jax(toy, case):
    if case.startswith("toy"):
        patch = (PATCH, PATCH) if case == "toy_32" else (33, 20)
        ae_def, jax_vae, variables = TOY, toy["jax_vae"], toy["variables"]
    else:
        reg_cfg = json.loads((ROOT / "config" / f"{case}.json").read_text())
        ae_def = load_config(ROOT / reg_cfg["vae"]["config_file"])["autoencoder_def"]
        patch = tuple(reg_cfg["data"]["patch_size"])
        jax_vae = jax_from_config(ae_def, use_pallas_attention=False, s2d_stem=False)
        variables = jax.eval_shape(jax_vae.init, jax.random.key(0),
                                   jnp.zeros((1, *patch, 1)), jax.random.key(1))
    want = jax_reg.infer_flat_dim_from_patch(jax_vae, variables, patch)
    got = infer_flat_dim_from_patch(autoencoder_from_config(ae_def), patch)
    assert got == want
    if not case.startswith("toy"):
        assert got == 4096


# ---- normalizer, losses ---------------------------------------------------------------------

def test_normalizer_json_and_mismatch(tmp_path):
    targets = np.random.default_rng(3).normal(5.0, 3.0, size=(20, 3)).astype(np.float32)
    targets[:, 2] = 7.0  # a constant column: std 0 becomes 1
    ours, theirs = ru.compute_target_normalizer(targets), jax_ru.compute_target_normalizer(targets)
    ru.save_target_normalizer(tmp_path / "ours.json", ours, TARGETS)
    jax_ru.save_target_normalizer(tmp_path / "theirs.json", theirs, TARGETS)
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    np.testing.assert_array_equal(ours.std[:2], targets.std(axis=0)[:2])  # population std
    assert ours.std[2] == 1.0
    loaded = ru.load_target_normalizer(tmp_path / "theirs.json", TARGETS)
    np.testing.assert_array_equal(loaded.normalize(targets), theirs.normalize(targets))
    with pytest.raises(ValueError, match="Target order mismatch"):
        ru.load_target_normalizer(tmp_path / "ours.json", TARGETS[::-1])
    assert ru.load_optional_normalizer(tmp_path, TARGETS) is None


@pytest.mark.parametrize("name", ["mse", "smooth_l1", "huber"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    pred = rng.normal(size=(6, 3)).astype(np.float32) * 2
    tgt = rng.normal(size=(6, 3)).astype(np.float32)
    want = float(jax_ru.build_loss_fn(name)(jnp.asarray(pred), jnp.asarray(tgt)))
    got = float(ru.build_loss_fn(name)(torch.from_numpy(pred), torch.from_numpy(tgt)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="Unsupported loss"):
        ru.build_loss_fn("mae")


# ---- steps --------------------------------------------------------------------------------

STEP_CASES = {
    "mse_adam": ("mse", False, 0.0),
    "mse_standard_adamw": ("mse", True, 1e-2),
    "smooth_l1_standard_adam": ("smooth_l1", True, 0.0),
    "smooth_l1_adamw": ("smooth_l1", False, 1e-2),
}


def _normalizer(toy, standard):
    if not standard:
        return None, None
    stats = toy["targets"][:3]
    return ru.compute_target_normalizer(stats), jax_ru.compute_target_normalizer(stats)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_train_steps_match_jax(toy, case):
    loss_name, standard, weight_decay = STEP_CASES[case]
    lr = 1e-3
    norm, jax_norm = _normalizer(toy, standard)
    jax_head, params, head = _heads([16], 0.0)
    jax_model = jax_reg.VAELatentRegressor(toy["jax_vae"], toy["variables"], jax_head,
                                           latent_dim=FLAT)
    tx = optax.adamw(lr, weight_decay=weight_decay) if weight_decay else optax.adam(lr)
    jax_train, _ = jax_ru.make_regression_steps(jax_model, jax_ru.build_loss_fn(loss_name), tx,
                                                jax_norm)
    model = VAELatentRegressor(toy["vae"], head, latent_dim=FLAT)
    vae_before = {k: v.clone() for k, v in model.vae.state_dict().items()}
    opt = ru.build_optimizer(model.regressor.parameters(), lr, weight_decay)
    assert isinstance(opt, torch.optim.AdamW if weight_decay else torch.optim.Adam)
    train_step, _ = ru.make_regression_steps(model, loss_name, opt, norm)

    batch = [toy[k] for k in ("images", "targets", "mask")]
    opt_state, jax_losses, losses = tx.init(params), [], []
    for i in range(3):
        params, opt_state, loss = jax_train(params, opt_state, *map(jnp.asarray, batch),
                                            jax.random.key(i))
        jax_losses.append(float(loss))
        losses.append(float(train_step(*map(torch.from_numpy, batch), torch.Generator())))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    want = regressor_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                          dropout=False)
    for key, value in model.regressor.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), **TOL, err_msg=key)
    assert all(p.grad is None and not p.requires_grad for p in model.vae.parameters())
    for key, value in model.vae.state_dict().items():
        assert torch.equal(value, vae_before[key]), key


@pytest.mark.parametrize("standard", [False, True], ids=["raw", "standard"])
def test_eval_step_matches_jax(toy, standard):
    norm, jax_norm = _normalizer(toy, standard)
    jax_head, params, head = _heads([16], 0.1)
    jax_model = jax_reg.VAELatentRegressor(toy["jax_vae"], toy["variables"], jax_head,
                                           latent_dim=FLAT)
    _, jax_eval = jax_ru.make_regression_steps(jax_model, jax_ru.build_loss_fn("mse"),
                                               optax.adam(1e-3), jax_norm)
    _, eval_step = ru.make_regression_steps(VAELatentRegressor(toy["vae"], head, latent_dim=FLAT),
                                            "mse", None, norm)
    batch = [toy[k] for k in ("images", "targets", "mask")]
    want_loss, want_preds = jax_eval(params, *map(jnp.asarray, batch))
    loss, preds = eval_step(*map(torch.from_numpy, batch))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_preds = np.asarray(want_preds)
    np.testing.assert_allclose(preds.numpy(), want_preds, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want_preds).max()))


# ---- loaders, checkpoints -----------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """11 TIFs under ``<root>/data/dente`` and their attributes; 5 more under
    ``<root>/val/dente``."""
    root = tmp_path_factory.mktemp("torch_reg_data")
    rng = np.random.default_rng(5)
    attrs = {}
    for sub, n in (("data", 11), ("val", 5)):
        (root / sub / "dente").mkdir(parents=True)
        for i in range(n):
            name = f"{sub}_{i:03d}.tif"
            write_tif(str(root / sub / "dente" / name),
                      rng.uniform(0.1, 1.0, size=(40, 36)).astype(np.float32))
            attrs[name] = {t: float(rng.uniform(50, 400)) for t in TARGETS + ["width_4"]}
    (root / "attributes.json").write_text(json.dumps(attrs))
    return root


def _batches(loader, epochs):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out += list(loader)
    return out


def _assert_same_batches(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("val_dir", [False, True], ids=["split", "val_dir"])
def test_regression_loaders_match_jax(dataset, val_dir):
    kwargs = dict(data_source="dente", train_split=0.75, num_workers=2, seed=7,
                  val_dir=str(dataset / "val") if val_dir else None,
                  normalize_attributes={"enabled": True, "divisor": 4.0})
    args = (str(dataset / "data"), str(dataset / "attributes.json"), TARGETS, 3, (32, 32))
    ours = factory.create_regression_dataloaders(*args, **kwargs)
    theirs = jax_factory.create_regression_dataloaders(*args, **kwargs)
    assert ours[2:] == theirs[2:]
    np.testing.assert_array_equal(ours[0].stacked_targets(), theirs[0].stacked_targets())
    for loader, jax_loader in zip(ours[:2], theirs[:2]):
        _assert_same_batches(_batches(loader, (1, 2)), _batches(jax_loader, (1, 2)))
        assert loader.batch_size == 3
    last = _batches(ours[0], (1,))[-1]
    assert last["mask"].tolist() == [1.0] * (len(ours[2]) % 3 or 3) + [0.0] * (-len(ours[2]) % 3)
    assert not last["target"][last["mask"] == 0].any()
    for loader in ours[:2]:
        loader.close()


def test_regression_eval_and_inference_loaders_match_jax(dataset):
    args = (str(dataset / "data"), str(dataset / "attributes.json"), TARGETS, 4, (32, 32))
    kwargs = dict(data_source="dente", num_samples=10, num_workers=2)
    ours, paths = factory.create_regression_eval_dataloader(*args, **kwargs)
    theirs, jax_paths = jax_factory.create_regression_eval_dataloader(*args, **kwargs)
    assert paths == jax_paths and len(paths) == 10
    _assert_same_batches(list(ours), list(theirs))
    ours.close()
    ours, paths = factory.create_regression_inference_dataloader(str(dataset / "data"), (32, 32), 4)
    theirs, jax_paths = jax_factory.create_regression_inference_dataloader(
        str(dataset / "data"), (32, 32), 4)
    assert paths == jax_paths
    _assert_same_batches(list(ours), list(theirs))
    ours.close()
    with pytest.raises(KeyError, match="Missing"):
        factory.create_regression_eval_dataloader(*args[:2], ["nope"], *args[3:], **kwargs)


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout_layout"])
def test_port_head_checkpoint_loads_in_jax(tmp_path, dropout):
    head = LatentRegressor(FLAT, [16, 8], len(TARGETS), dropout=dropout,
                           generator=torch.Generator().manual_seed(1))
    ru.save_regression_checkpoint(tmp_path / "head_best.pth", head, TARGETS, epoch=3,
                                  latent_dim=FLAT)
    params, meta = jax_ru.load_regression_checkpoint(tmp_path / "head_best.pth", TARGETS)
    assert meta == {"targets": TARGETS, "epoch": 3, "latent_dim": FLAT}
    back = regressor_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                          dropout=dropout > 0)
    for key, value in head.state_dict().items():
        assert torch.equal(back[key], value), key
    jax_head = jax_reg.LatentRegressor(hidden_dims=(16, 8), output_dim=len(TARGETS),
                                       dropout=dropout)
    x = np.random.default_rng(6).normal(size=(3, FLAT)).astype(np.float32)
    with torch.no_grad():
        got = head.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_head.apply(params, jnp.asarray(x))), **HEAD_TOL)

    state, meta = ru.load_regression_checkpoint(tmp_path / "head_best.pth", TARGETS)
    assert meta["epoch"] == 3 and set(state) == set(head.state_dict())
    with pytest.raises(ValueError, match="Target mismatch"):
        ru.load_regression_checkpoint(tmp_path / "head_best.pth", TARGETS[::-1])
    (tmp_path / "orbax_head").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        ru.load_regression_checkpoint(tmp_path / "orbax_head", TARGETS)


def test_best_and_last_checkpoints(tmp_path):
    head = LatentRegressor(8, [4], 2)
    best, path = ru.maybe_save_best_regression_checkpoint(tmp_path, head, ["a", "b"], 1, 0.5,
                                                          float("inf"), 8)
    assert best == 0.5 and path.name == "head_best.pth" and path.exists()
    best, _ = ru.maybe_save_best_regression_checkpoint(tmp_path, head, ["a", "b"], 2, 0.7, best, 8)
    assert best == 0.5
    assert ru.load_regression_checkpoint(path, ["a", "b"])[1]["epoch"] == 1
    last = ru.save_last_regression_checkpoint(tmp_path, head, ["a", "b"], 2, 8)
    assert last.name == "head_last.pth"
    assert ru.load_regression_checkpoint(last, ["a", "b"])[1] == {
        "targets": ["a", "b"], "epoch": 2, "latent_dim": 8}

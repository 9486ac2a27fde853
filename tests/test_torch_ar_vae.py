"""The AR-VAE slice against the JAX package on the CPU: the attribute loss
(``losses/ar_vae.py``) in both pair modes, the attribute join, the seeded
split with attributes, the loader's ``"attributes"`` batches, and one toy
train step with the AR term in each GAN phase (loss terms, gradients,
parameters after Adam).

Inputs are made with numpy from seeds and handed to both packages. The
"subset" pairs are drawn on the JAX side with ``jax.random.choice`` on the
same key the JAX step uses and passed to the port as flat pair indices.

Bars: the loss rtol 1e-4 / atol 1e-5; train steps those of
``tests/test_torch_adv_step.py`` (loss terms rtol 1e-4; gradients rtol 1e-3
with atol 1e-4 x the tensor's max; parameters after Adam within 2 lr, and
within 2% of lr where the gradient is above 1e-6 of its tensor's max). The
debug means of ``z_mu`` / ``z_sigma`` take the padded row too, whose constant
image GroupNorm turns into rounding noise over sqrt(eps): 2e-3 absolute.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.torch_convert import disc_to_torch_state_dict, to_torch_state_dict
from pti_ldm_vae_tpu.data import datasets as jax_datasets
from pti_ldm_vae_tpu.data.factory import create_vae_dataloaders as jax_create_vae_dataloaders
from pti_ldm_vae_tpu.losses import ar_vae as jax_ar
from pti_ldm_vae_tpu.models import lpips as jax_lpips
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from pti_ldm_vae_tpu.train import steps as jax_steps
from pti_ldm_vae_tpu.train.state import create_train_state as jax_create_state
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import (
    disc_state_dict_from_flax,
    lpips_params_from_jax,
    state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.data import datasets
from pti_ldm_vae_tpu_torch.data.factory import create_vae_dataloaders
from pti_ldm_vae_tpu_torch.data.io import write_tif
from pti_ldm_vae_tpu_torch.data.loader import ShardedDataLoader
from pti_ldm_vae_tpu_torch.losses.ar_vae import (
    compute_ar_vae_loss,
    draw_subset_pairs,
    make_ar_vae_spec,
)
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
from pti_ldm_vae_tpu_torch.train.state import create_train_state
from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_eval_step, make_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
MAPPING = {"_comment": "channels 0 and 2", "height_0": {"latent_channel": 0, "delta": 1.0},
           "width_0": {"latent_channel": 2, "delta": 2.0}}


def _inputs(seed, batch, latent_shape):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(batch, *latent_shape)).astype(np.float32)
    attrs = {"height_0": rng.normal(size=(batch,)).astype(np.float32),
             "width_0": rng.integers(0, 2, size=(batch,)).astype(np.float32)}  # ties
    return z, attrs


def _both(z, attrs, mapping=MAPPING, mask=None, jax_kwargs=None, port_kwargs=None, **spec_kw):
    jspec = jax_ar.make_ar_vae_spec(mapping, **spec_kw)
    pspec = make_ar_vae_spec(mapping, **spec_kw)
    want = jax_ar.compute_ar_vae_loss(
        jnp.asarray(z), {k: jnp.asarray(v) for k, v in attrs.items()}, jspec,
        sample_mask=None if mask is None else jnp.asarray(mask), **(jax_kwargs or {}))
    got = compute_ar_vae_loss(
        torch.from_numpy(z), {k: torch.from_numpy(v) for k, v in attrs.items()}, pspec,
        sample_mask=None if mask is None else torch.from_numpy(mask), **(port_kwargs or {}))
    return got, want


def _assert_same(got, want):
    total, per_attr, counts = got
    np.testing.assert_allclose(float(total), float(want[0]), **TOL)
    assert set(per_attr) == set(want[1]) == {"height_0", "width_0"}
    for name in per_attr:
        np.testing.assert_allclose(float(per_attr[name]), float(want[1][name]), **TOL)
        assert int(counts[name]) == int(want[2][name])


@pytest.mark.parametrize("latent_shape", [(5,), (3, 4, 5)], ids=["flat", "nhwc"])
@pytest.mark.parametrize("batch", [2, 6])
def test_all_pairs_loss_matches_jax(latent_shape, batch):
    z, attrs = _inputs(batch, batch, latent_shape)
    _assert_same(*_both(z, attrs, pairwise_mode="all", latent_dim=5))


def test_sample_mask_keeps_padded_rows_out_of_every_pair():
    z, attrs = _inputs(1, 6, (2, 2, 5))
    mask = np.array([1, 1, 0, 1, 0, 1], dtype=np.float32)
    got, want = _both(z, attrs, mask=mask)
    _assert_same(got, want)
    # the padded rows' values do not matter
    z2, attrs2 = z.copy(), {k: v.copy() for k, v in attrs.items()}
    z2[[2, 4]] = 9.0
    attrs2["height_0"][[2, 4]] = -5.0
    again, _ = _both(z2, attrs2, mask=mask)
    assert float(again[0]) == pytest.approx(float(got[0]), rel=1e-6)


def test_attribute_without_an_ordered_pair_contributes_zero():
    z, attrs = _inputs(2, 4, (5,))
    attrs["width_0"][:] = 1.0  # all ties: no pair has an ordering
    got, want = _both(z, attrs)
    _assert_same(got, want)
    assert float(got[1]["width_0"]) == 0.0 and int(got[2]["width_0"]) == 0
    assert float(got[0]) == pytest.approx(float(got[1]["height_0"]))


def test_delta_global_fallback_matches_jax():
    mapping = {"height_0": {"latent_channel": 1}, "width_0": {"latent_channel": 3, "delta": 0.5}}
    dg = {"enabled": True, "value": 2.5}
    assert make_ar_vae_spec(mapping, delta_global=dg).deltas == (2.5, 0.5)
    z, attrs = _inputs(3, 5, (4,))
    _assert_same(*_both(z, attrs, mapping=mapping, delta_global=dg))


@pytest.mark.parametrize("batch,pairs", [(8, 10), (4, 12), (3, 50)])
def test_subset_loss_with_the_jax_draw_matches_jax(batch, pairs):
    z, attrs = _inputs(4, batch, (2, 3, 5))
    mask = np.ones(batch, dtype=np.float32)
    mask[-1] = 0.0
    key = jax.random.key(batch)
    n_all = batch * (batch - 1)
    flat = np.asarray(jax.random.choice(key, n_all, shape=(min(pairs, n_all),), replace=False))
    got, want = _both(z, attrs, mask=mask, jax_kwargs={"rng": key},
                      port_kwargs={"pair_indices": torch.from_numpy(flat)},
                      pairwise_mode="subset", subset_pairs=pairs)
    _assert_same(got, want)


def test_subset_draw_is_distinct_ordered_pairs_from_the_generator():
    a = draw_subset_pairs(8, 10, torch.Generator().manual_seed(0))
    b = draw_subset_pairs(8, 10, torch.Generator().manual_seed(0))
    c = draw_subset_pairs(8, 10, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len(set(a.tolist())) == 10 and int(a.min()) >= 0 and int(a.max()) < 56
    assert len(draw_subset_pairs(3, 50, torch.Generator().manual_seed(0))) == 6  # all 3*2 pairs
    z, attrs = _inputs(5, 8, (5,))
    spec = make_ar_vae_spec(MAPPING, pairwise_mode="subset", subset_pairs=10)
    tz, ta = torch.from_numpy(z), {k: torch.from_numpy(v) for k, v in attrs.items()}
    drawn = compute_ar_vae_loss(tz, ta, spec, generator=torch.Generator().manual_seed(0))
    given = compute_ar_vae_loss(tz, ta, spec, pair_indices=a)
    assert float(drawn[0]) == float(given[0])


def test_errors_match_jax():
    with pytest.raises(ValueError, match="Delta not provided"):
        make_ar_vae_spec({"a": {"latent_channel": 0}})
    with pytest.raises(ValueError, match="exceeds latent size"):
        make_ar_vae_spec({"a": {"latent_channel": 4, "delta": 1.0}}, latent_dim=4)
    with pytest.raises(ValueError, match="pairwise"):
        make_ar_vae_spec(MAPPING, pairwise_mode="some")
    with pytest.raises(ValueError, match="subset_pairs"):
        make_ar_vae_spec(MAPPING, pairwise_mode="subset")
    spec = make_ar_vae_spec(MAPPING)
    z, attrs = _inputs(6, 4, (5,))
    with pytest.raises(KeyError, match="width_0"):
        compute_ar_vae_loss(torch.from_numpy(z), {"height_0": torch.from_numpy(attrs["height_0"])},
                            spec)
    with pytest.raises(ValueError, match="latent shape"):
        compute_ar_vae_loss(torch.zeros(4, 2, 5), {k: torch.from_numpy(v) for k, v in attrs.items()},
                            spec)


# ---- the attribute join, the split, the loader --------------------------------------------

def test_source_is_read_off_the_whole_path():
    sources = {"edente": {"a.tif": {"height_0": 1.0, "width_0": 2.0}},
               "dente": {"a.tif": {"height_0": 3.0, "width_0": 4.0}}}
    mapping = {"_c": {}, "height_0": {}, "width_0": {}}
    paths = ["/x/edente/a.tif", "/x/dente/a.tif", "/runs/edente_sweep/dente/a.tif"]
    got = datasets.attributes_for_paths(paths, sources, mapping)
    assert got == jax_datasets.attributes_for_paths(paths, sources, mapping)
    # "edente" is tested first: a directory above the file named after it wins
    assert [a["height_0"] for a in got] == [1.0, 3.0, 1.0]
    for bad, error in ((["/x/other/a.tif"], ValueError), (["/x/dente/b.tif"], FileNotFoundError)):
        with pytest.raises(error):
            datasets.attributes_for_paths(bad, sources, mapping)
    with pytest.raises(KeyError, match="missing_attr"):
        datasets.attributes_for_paths(paths[:1], sources, {"missing_attr": {}})


@pytest.mark.parametrize("normalize", [None, {"enabled": False, "divisor": 4.0},
                                       {"enabled": True, "divisor": 256.0}])
def test_attribute_join_matches_jax(tmp_path, normalize):
    attr = {f"img_{i:03d}.tif": {"height_0": float(i), "width_0": 2.0 * i, "extra": 1.0}
            for i in range(9)}
    path = tmp_path / "attributes.json"
    path.write_text(json.dumps(attr))
    for spec in (str(path), {"dente": str(path)}):
        assert datasets.select_attribute_sources(spec, "dente") == \
            jax_datasets.select_attribute_sources(spec, "dente")
    sources = datasets.select_attribute_sources(str(path), "dente")
    paths = [f"/data/dente/img_{i:03d}.tif" for i in range(9)]
    got = datasets.attributes_for_paths(paths, sources, MAPPING, normalize)
    assert got == jax_datasets.attributes_for_paths(paths, sources, MAPPING, normalize)
    assert set(got[0]) == {"height_0", "width_0"}
    assert datasets.normalize_attributes(got[5], normalize) == \
        jax_datasets.normalize_attributes(got[5], normalize)
    with pytest.raises(ValueError, match="divisor"):
        datasets.normalize_attributes(got[5], {"enabled": True, "divisor": 0})
    with pytest.raises(FileNotFoundError):
        datasets.load_attribute_json(str(tmp_path / "absent.json"))
    (tmp_path / "bad.json").write_text("{")
    with pytest.raises(ValueError, match="Invalid"):
        datasets.load_attribute_json(str(tmp_path / "bad.json"))
    with pytest.raises(ValueError, match="string or mapping"):
        datasets.select_attribute_sources(3, "dente")


@pytest.mark.parametrize("seed,train_split", [(42, 0.9), (7, 0.5), (None, 0.75)])
def test_split_carries_attributes_in_the_jax_order(seed, train_split):
    paths = [f"/data/dente/img_{i:03d}.tif" for i in range(23)]
    attrs = [{"height_0": float(i)} for i in range(23)]
    got = datasets.split_dataset(paths, train_split=train_split, seed=seed, attributes=attrs)
    assert got == jax_datasets.split_dataset(paths, train_split=train_split, seed=seed,
                                             attributes=attrs)
    train, _, train_attrs, _ = got
    assert [int(p[-7:-4]) for p in train] == [int(a["height_0"]) for a in train_attrs]
    # the shuffled paths are the same permutation as without attributes
    assert train == datasets.split_dataset(paths, train_split=train_split, seed=seed)[0]


@pytest.fixture
def tif_tree(tmp_path):
    """12 small TIFs under ``<tmp>/data/dente`` and an attribute file beside them."""
    base = tmp_path / "data"
    (base / "dente").mkdir(parents=True)
    rng = np.random.default_rng(0)
    attr = {}
    for i in range(12):
        img = rng.uniform(0.1, 2.0, size=(20, 24)).astype(np.float32)
        img[:3] = 0.0
        write_tif(str(base / "dente" / f"img_{i:03d}.tif"), img)
        attr[f"img_{i:03d}.tif"] = {"height_0": float(i) + 0.5, "width_0": float(i % 3)}
    (base / "attributes.json").write_text(json.dumps(attr))
    return base


@pytest.mark.parametrize("val_dir", [False, True], ids=["split", "val_dir"])
def test_loader_batches_match_the_jax_loader(tif_tree, val_dir):
    block = {"attribute_file": str(tif_tree / "attributes.json"), "attribute_latent_mapping": MAPPING,
             "normalize_attributes": {"enabled": True, "divisor": 4.0}}
    kw = dict(data_source="dente", train_split=0.7, num_workers=2, seed=5, ar_vae_enabled=True,
              regularized_attributes=block, val_dir=str(tif_tree) if val_dir else None)
    ours = create_vae_dataloaders(str(tif_tree), 5, (16, 16), **kw)
    theirs = jax_create_vae_dataloaders(str(tif_tree), 5, (16, 16), **kw)
    assert ours[2:] == theirs[2:]
    for mine, jaxs in zip(ours[:2], theirs[:2]):  # both on the native fused decoder
        for epoch in range(2):
            mine.set_epoch(epoch)
            jaxs.set_epoch(epoch)
            got, want = list(mine), list(jaxs)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["image"], b["image"])
                np.testing.assert_array_equal(a["mask"], b["mask"])
                assert set(a["attributes"]) == set(b["attributes"]) == {"height_0", "width_0"}
                for name, values in b["attributes"].items():
                    np.testing.assert_array_equal(a["attributes"][name], values)
                    assert a["attributes"][name].dtype == np.float32
                    assert np.all(a["attributes"][name][a["mask"] == 0] == 0.0)  # padded rows
        mine.close()


def test_loader_refuses_misaligned_attributes(tif_tree):
    paths = sorted(str(p) for p in (tif_tree / "dente").glob("*.tif"))
    with pytest.raises(ValueError, match="align"):
        ShardedDataLoader(paths, (16, 16), 4, attributes=[{"height_0": 1.0}])


# ---- one toy train step with the AR term in each GAN phase ---------------------------------

TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, True],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
DISC = dict(spatial_dims=2, num_layers_d=3, channels=8)
LR = 1e-3
LOSS = dict(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0, adv_weight=3.0, ar_gamma=0.5,
            ar_vae_enabled=True)
GRAD_FLOOR = 1e-6
# warm-up phase: all pairs; adversarial phase: 5 of the 12 ordered pairs
PHASES = {"warmup": (False, {"pairwise_mode": "all"}),
          "adversarial": (True, {"pairwise_mode": "subset", "subset_pairs": 5})}


def _perturbed(variables, rng, gain=1.0):
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    leaves = [np.asarray(a) * gain + 0.05 * rng.normal(size=a.shape).astype(np.float32)
              for a in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module", params=list(PHASES))
def phase(request):
    """One JAX AR train step (and its gradients) and the same step of the port."""
    adv_active, spec_kw = PHASES[request.param]
    rng = np.random.default_rng(1)
    jax_model = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    jax_disc = JaxPatchDiscriminator(**DISC)
    dummy = jnp.zeros((1, 32, 32, 1))
    params_g = _perturbed(jax.jit(jax_model.init)(jax.random.key(0), dummy, jax.random.key(1)), rng)
    params_d = _perturbed(jax.jit(jax_disc.init)(jax.random.key(2), dummy), rng, gain=2.0)
    lpips_tree = jax.tree_util.tree_map(np.asarray, jax_lpips.init_lpips_params(1))
    images = rng.normal(size=(4, 32, 32, 1)).astype(np.float32)
    images[3] = 0.0
    mask = np.array([1.0, 1.0, 1.0, 0.0], dtype=np.float32)
    attrs = {"height_0": np.array([0.3, -1.0, 2.0, 0.0], np.float32),
             "width_0": np.array([1.0, 0.0, 1.0, 0.0], np.float32)}
    key = jax.random.key(21)
    rng_sample, rng_ar = jax.random.split(key)
    eps = np.array(jax.random.normal(rng_sample, (4, 16, 16, 3), dtype=jnp.float32))
    pairs = (np.asarray(jax.random.choice(rng_ar, 12, shape=(5,), replace=False))
             if spec_kw["pairwise_mode"] == "subset" else None)

    jspec = jax_ar.make_ar_vae_spec(MAPPING, latent_dim=3, **spec_kw)
    lcfg = jax_steps.LossConfig(**LOSS, ar_spec=jspec)
    jimages, jmask = jnp.asarray(images), jnp.asarray(mask)
    jattrs = {k: jnp.asarray(v) for k, v in attrs.items()}
    jdisc = jax_disc if adv_active else None

    @jax.jit
    def grads_of(pg, pd):
        def g_loss(p):
            return jax_steps._generator_losses(jax_model, jdisc, lcfg, p, pd, lpips_tree,
                                               jimages, jmask, jattrs, key, adv_active)
        (total, aux), grads = jax.value_and_grad(g_loss, has_aux=True)(pg)
        return total, grads

    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    state = jax_create_state(params_g, lr=LR, params_d=params_d)
    step = jax_steps.make_train_step(jax_model, jdisc, lcfg, adv_active=adv_active, donate=False)
    total, grads_g = grads_of(state.params_g, state.params_d)
    eval_metrics, _ = jax_steps.make_eval_step(jax_model, jdisc, lcfg, adv_active=adv_active)(
        state, jimages, jmask, jattrs, lpips_tree, key)
    new_state, metrics = step(state, jimages, jmask, jattrs, lpips_tree, key)

    # the port, from the same parameters, batch, noise and pairs
    model = autoencoder_from_config(TOY)
    model.load_state_dict(state_dict_from_flax(as_np(params_g), TOY), strict=True)
    disc = PatchDiscriminator(**DISC)
    disc.load_state_dict(disc_state_dict_from_flax(as_np(params_d)), strict=True)
    plcfg = LossConfig(**LOSS, ar_spec=make_ar_vae_spec(MAPPING, latent_dim=3, **spec_kw))
    pstate = create_train_state(model, lr=LR, model_d=disc)
    pstep = make_train_step(model, disc if adv_active else None, plcfg, adv_active=adv_active)
    tattrs = {k: torch.from_numpy(v) for k, v in attrs.items()}
    tpairs = None if pairs is None else torch.from_numpy(pairs)
    lpips = lpips_params_from_jax(lpips_tree)
    peval, _ = make_eval_step(model, disc if adv_active else None, plcfg, adv_active=adv_active)(
        None, torch.from_numpy(images), torch.from_numpy(mask), tattrs, lpips,
        eps=torch.from_numpy(eps), pair_indices=tpairs)
    seen = {}
    real = pstate.optimizer_g.step

    def capture(*a, **kw):
        seen["grads"] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        return real(*a, **kw)

    pstate.optimizer_g.step = capture
    _, pmetrics = pstep(pstate, torch.from_numpy(images), torch.from_numpy(mask), tattrs, lpips,
                        eps=torch.from_numpy(eps), pair_indices=tpairs)
    pstate.optimizer_g.step = real
    return dict(
        name=request.param,
        jax_metrics={k: float(v) for k, v in metrics.items()}, jax_total=float(total),
        jax_eval={k: float(v) for k, v in eval_metrics.items()},
        jax_grads=to_torch_state_dict(as_np(grads_g), TOY),
        jax_params=to_torch_state_dict(as_np(new_state.params_g), TOY),
        jax_params_d=disc_to_torch_state_dict(as_np(new_state.params_d)),
        start=to_torch_state_dict(as_np(params_g), TOY),
        metrics={k: float(v) for k, v in pmetrics.items()},
        eval={k: float(v) for k, v in peval.items()},
        grads=seen["grads"],
        params={k: v.detach().clone() for k, v in model.state_dict().items()},
        params_d={k: v.detach().clone() for k, v in disc.state_dict().items()},
    )


def test_ar_step_loss_terms_match_jax(phase):
    want, got = phase["jax_metrics"], phase["metrics"]
    assert set(got) == set(want)
    assert {"train/ar_loss_total", "train/ar_loss_height_0", "train/ar_loss_width_0"} <= set(got)
    for name, value in want.items():
        # the debug stats also average the padded row: GroupNorm of its constant
        # (all-zero) image divides rounding noise by sqrt(eps) = 1e-3 on both sides
        tol = dict(abs=2e-3) if name.startswith("debug/") else dict(rel=1e-4, abs=1e-6)
        assert got[name] == pytest.approx(value, **tol), name
    assert got["train/ar_loss_total"] > 0
    assert got["train/loss_total"] == pytest.approx(phase["jax_total"], rel=1e-4)
    if phase["name"] == "adversarial":
        assert got["train/adv_gen_loss"] > 0 and got["train/adv_disc_loss"] > 0


def test_ar_eval_step_matches_jax(phase):
    want, got = phase["jax_eval"], phase["eval"]
    assert set(got) == set(want)
    assert {"ar_loss", "ar_loss_height_0", "ar_loss_width_0"} <= set(got)
    for name, value in want.items():
        assert got[name] == pytest.approx(value, rel=1e-4, abs=1e-6), name


def test_ar_step_gradients_match_jax(phase):
    want, got = phase["jax_grads"], phase["grads"]
    assert set(got) == set(want)
    for key, theirs in want.items():
        if key.endswith("to_k.bias"):  # 0 in exact arithmetic: rounding noise on both sides
            assert np.abs(theirs).max() < 1e-6 and float(got[key].abs().max()) < 1e-6, key
            continue
        np.testing.assert_allclose(got[key].numpy(), theirs, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(theirs).max()), err_msg=key)


def test_ar_step_parameters_after_adam_match_jax(phase):
    want, got = phase["jax_params"], phase["params"]
    n_firm = 0
    for key, theirs in want.items():
        diff = np.abs(got[key].numpy() - theirs)
        assert diff.max() <= 2 * LR, key
        g = np.abs(phase["jax_grads"][key])
        firm = g > GRAD_FLOOR * max(1.0, float(g.max()))
        n_firm += int(firm.sum())
        if firm.any():
            assert diff[firm].max() <= 0.02 * LR, key
        if not key.endswith("to_k.bias"):
            assert np.abs(theirs - phase["start"][key]).max() > 0.5 * LR, key
    assert n_firm > 0.9 * sum(v.size for v in want.values())
    if phase["name"] == "adversarial":  # the discriminator's Adam step too
        for key, theirs in phase["jax_params_d"].items():
            assert np.abs(phase["params_d"][key].numpy() - theirs).max() <= 2 * LR, key

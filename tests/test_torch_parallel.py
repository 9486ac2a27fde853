"""Data parallelism of the port (``pti_ldm_vae_tpu_torch/parallel``) on the CPU:
two gloo ranks against the JAX package's step on the same global batch.

One ``torchrun --standalone --nproc_per_node 2`` launch of this file (the
worker under ``__main__``, which imports no JAX) runs every case; each rank
writes its results to one ``.npz``. Rank ``r`` takes rows ``r::2`` of the
global batch, as the loader's ``rank::world`` schedule gives them, and the
same rows of the posterior noise ``eps``, which the JAX side draws for the
global batch. The JAX side runs its own functions on the global batch: the
train step built with ``world_size=2`` (LR x 2), its ``parallel.mesh.pad_batch``
for the padded batch, and its ``compute_ar_vae_loss`` (with
``jax.value_and_grad``) for the AR-VAE term. Both sides start from the port's
seeded inits, carried to the JAX trees by the JAX package's converters.
Cases:

* ``gen8``: the generator step at global batch 8 (4 + 4);
* ``gen7``: global batch 7, padded by the JAX ``pad_batch`` with one masked
  row, which lands on rank 1;
* ``adv``: the adversarial step, both Adams;
* ``ar``: the AR-VAE term ("all") on the gathered global batch, its value
  and the gradient that reaches each rank's rows, and "subset" pairs drawn
  alike on both ranks.

The gradients each optimizer steps on, after the ranks' all-reduce, are
held to the port's own one-process step on the global batch (the port's
one-process gradients are held to JAX's in ``test_torch_train_step.py`` and
``test_torch_adv_step.py``). World 1 under a gloo group is held bit for bit
to no group in this process.

Bars (f32): loss terms, metrics and the AR term against JAX rtol 1e-4 / atol
1e-5; against the one-process port, metrics rtol 1e-5 and gradients rtol
1e-4 with atol 1e-5 x the tensor's largest entry (the same sums in another
order: a bias's gradient sums B x H x W terms of both signs); parameters
after Adam against JAX, where ``|g| > 1e-4 x`` the tensor's largest
gradient, rtol 1e-4 / atol 1e-5, and every entry within 2 lr (one Adam step
from a fresh state moves an entry by about ``lr x sign(g)``, so an entry
whose gradient is at the rounding of its tensor's sums can take the other
sign). The two ranks hold the same gradients and parameters bit for bit.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pti_ldm_vae_tpu_torch.losses.ar_vae import compute_ar_vae_loss, make_ar_vae_spec
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
from pti_ldm_vae_tpu_torch.parallel import (
    maybe_initialize_distributed,
    pad_batch,
    process_rank,
    world_size,
)
from pti_ldm_vae_tpu_torch.train.state import create_train_state
from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[4, 8], num_res_blocks=1, norm_num_groups=2, norm_eps=1e-6,
    attention_levels=[False, False],
    with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False,
)
DISC = dict(spatial_dims=2, num_layers_d=3, channels=8)
IMAGE, LATENT = 32, 16
GLOBAL_BATCH, WORLD = 8, 2
LR = 1e-3
LOSS = dict(recon_loss="l1", kl_weight=1e-3, perceptual_weight=0.0, adv_weight=3.0,
            use_perceptual=False)
AR_MAPPING = {"height": {"latent_channel": 0, "delta": 1.0},
              "width": {"latent_channel": 2, "delta": 2.0}}
GRAD_FLOOR = 1e-4


# ---- both sides of the launch: the port's cases --------------------------------------

def _capture(optimizer, into: dict, key: str, params) -> None:
    """Record the gradients (after the ranks' all-reduce) when ``optimizer``
    steps."""
    real = optimizer.step

    def step(*a, **kw):
        into[key] = {name: p.grad.detach().clone() for name, p in params}
        optimizer.step = real
        return real(*a, **kw)

    optimizer.step = step


def port_step(data: dict, case: str, rows: slice) -> dict[str, np.ndarray]:
    """One port train step of ``case`` on ``rows`` of the global batch:
    metrics, the gradients each optimizer saw, and the parameters after."""
    adv = case == "adv"
    model = autoencoder_from_config(TOY)
    model.load_state_dict(data["sd_g"], strict=True)
    disc = None
    if adv:
        disc = PatchDiscriminator(**DISC)
        disc.load_state_dict(data["sd_d"], strict=True)
    state = create_train_state(model, lr=LR, world_size=world_size(), model_d=disc)
    step = make_train_step(model, disc, LossConfig(**LOSS), adv_active=adv)
    seen: dict = {}
    _capture(state.optimizer_g, seen, "g", list(model.named_parameters()))
    if adv:
        _capture(state.optimizer_d, seen, "d", list(disc.named_parameters()))
    images = data[f"{case}_images"][rows]
    _, metrics = step(state, images, data[f"{case}_mask"][rows], None, {},
                      eps=data[f"{case}_eps"][rows])
    out = {f"metric/{k}": v.numpy() for k, v in metrics.items()}
    out.update({f"grad_g/{k}": v.numpy() for k, v in seen["g"].items()})
    out.update({f"param_g/{k}": v.detach().numpy() for k, v in model.state_dict().items()})
    if adv:
        out.update({f"grad_d/{k}": v.numpy() for k, v in seen["d"].items()})
        out.update({f"param_d/{k}": v.detach().numpy() for k, v in disc.state_dict().items()})
    return out


def port_ar(data: dict, rows: slice) -> dict[str, np.ndarray]:
    """The AR-VAE term on ``rows`` of the global batch: "all" with the
    gradient at this rank's rows, and "subset" from a generator seeded alike."""
    z = data["ar_z"][rows].clone().requires_grad_(True)
    attrs = {k: data[f"ar_{k}"][rows] for k in AR_MAPPING}
    mask = data["ar_mask"][rows]
    total, per, _ = compute_ar_vae_loss(z, attrs, make_ar_vae_spec(AR_MAPPING, latent_dim=3),
                                        sample_mask=mask)
    total.backward()
    subset = make_ar_vae_spec(AR_MAPPING, pairwise_mode="subset", subset_pairs=20, latent_dim=3)
    sub_total, _, _ = compute_ar_vae_loss(z.detach(), attrs, subset, sample_mask=mask,
                                          generator=torch.Generator().manual_seed(5))
    return {"total": total.detach().numpy(), "grad": z.grad.numpy(),
            "subset_total": sub_total.numpy(),
            **{f"per/{k}": v.detach().numpy() for k, v in per.items()}}


def worker(inputs: str, out_dir: str) -> None:
    """One rank of the launch: every case on its rows, results to
    ``out_dir/rank{r}.npz``."""
    torch.manual_seed(0)
    if not maybe_initialize_distributed("cpu"):
        raise RuntimeError("the worker runs under torchrun")
    try:
        data = torch.load(inputs, weights_only=True)
        rows = slice(process_rank(), None, world_size())
        out = {}
        for case in ("gen8", "gen7", "adv"):
            out.update({f"{case}/{k}": v for k, v in port_step(data, case, rows).items()})
        out.update({f"ar/{k}": v for k, v in port_ar(data, rows).items()})
        np.savez(Path(out_dir) / f"rank{process_rank()}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---- the test process: inputs, the JAX references, the launch ------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the JAX references on the global batch, and both ranks'
    results of one two-rank launch."""
    import jax
    import jax.numpy as jnp

    from pti_ldm_vae_tpu.checkpoint.torch_convert import (
        disc_from_torch_state_dict,
        disc_to_torch_state_dict,
        from_torch_state_dict,
        to_torch_state_dict,
    )
    from pti_ldm_vae_tpu.losses.ar_vae import compute_ar_vae_loss as jax_ar_loss
    from pti_ldm_vae_tpu.losses.ar_vae import make_ar_vae_spec as jax_ar_spec
    from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
    from pti_ldm_vae_tpu.models.discriminator import PatchDiscriminator as JaxDisc
    from pti_ldm_vae_tpu.parallel.mesh import pad_batch as jax_pad_batch
    from pti_ldm_vae_tpu.train import steps as jax_steps
    from pti_ldm_vae_tpu.train.state import create_train_state as jax_create_state

    work = tmp_path_factory.mktemp("torch_parallel")
    rng = np.random.default_rng(0)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    jax_model = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    jax_disc = JaxDisc(**DISC)
    # the port's seeded inits, perturbed (non-trivial norm affines and biases), carried
    # across to the JAX trees
    torch.manual_seed(0)
    sd_g = {k: v + 0.05 * torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
            for k, v in autoencoder_from_config(TOY).state_dict().items()}
    # 0.02-scale weights give logits near 0: scale them up so the discriminator matters
    sd_d = {k: 2.0 * v + 0.05 * torch.from_numpy(rng.normal(size=tuple(v.shape))
                                                 .astype(np.float32))
            for k, v in PatchDiscriminator(**DISC).state_dict().items()}
    params_g = from_torch_state_dict({k: v.numpy() for k, v in sd_g.items()}, TOY)
    params_d = disc_from_torch_state_dict({k: v.numpy() for k, v in sd_d.items()})

    images8 = rng.uniform(0.1, 1.0, size=(GLOBAL_BATCH, IMAGE, IMAGE, 1)).astype(np.float32)
    padded = jax_pad_batch({"image": images8[:7], "mask": np.ones(7, np.float32)}, GLOBAL_BATCH)
    key = jax.random.key(11)
    eps = np.array(jax.random.normal(jax.random.split(key)[0],
                                       (GLOBAL_BATCH, LATENT, LATENT, 3), jnp.float32))
    batches = {"gen8": (images8, np.ones(GLOBAL_BATCH, np.float32)),
               "gen7": (padded["image"], padded["mask"]), "adv": (images8, np.ones(8, np.float32))}

    # the AR-VAE term on a global batch of 8 latents, the last row padding
    ar_z = rng.normal(size=(GLOBAL_BATCH, 3)).astype(np.float32)
    ar_attrs = {k: rng.normal(size=GLOBAL_BATCH).astype(np.float32) for k in AR_MAPPING}
    ar_attrs["height"][2] = ar_attrs["height"][5]  # a tie: sign 0, no pair
    ar_mask = np.ones(GLOBAL_BATCH, np.float32)
    ar_mask[7] = 0.0
    data = {"sd_g": sd_g, "sd_d": sd_d,
            "ar_z": torch.from_numpy(ar_z), "ar_mask": torch.from_numpy(ar_mask),
            **{f"ar_{k}": torch.from_numpy(v) for k, v in ar_attrs.items()}}
    for case, (x, m) in batches.items():
        data.update({f"{case}_images": torch.from_numpy(np.asarray(x)),
                     f"{case}_mask": torch.from_numpy(np.asarray(m)),
                     f"{case}_eps": torch.from_numpy(eps)})
    torch.save(data, work / "inputs.pt")

    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    # the launch runs while the JAX references compile
    log = open(work / "torchrun.log", "w+", encoding="utf-8")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={WORLD}", __file__, str(work / "inputs.pt"), str(work)],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        lcfg = jax_steps.LossConfig(**LOSS)
        jax_out = {}
        for adv in (False, True):
            step = jax_steps.make_train_step(jax_model, jax_disc if adv else None, lcfg,
                                             adv_active=adv, donate=False)
            start = jax_create_state(params_g, lr=LR, world_size=WORLD,
                                     params_d=params_d if adv else None)
            for case in (("adv",) if adv else ("gen8", "gen7")):
                x, m = map(jnp.asarray, batches[case])
                state, metrics = step(start, x, m, {}, {}, key)
                jax_out[case] = {
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "param_g": to_torch_state_dict(as_np(state.params_g), TOY),
                    **({"param_d": disc_to_torch_state_dict(as_np(state.params_d))} if adv else {}),
                }

        spec = jax_ar_spec(AR_MAPPING, latent_dim=3)

        def ar_total(z):
            total, per, _ = jax_ar_loss(z, {k: jnp.asarray(v) for k, v in ar_attrs.items()}, spec,
                                        sample_mask=jnp.asarray(ar_mask))
            return total, per

        (total, per), grad = jax.jit(jax.value_and_grad(ar_total, has_aux=True))(jnp.asarray(ar_z))
        jax_out["ar"] = {"total": float(total), "per": {k: float(v) for k, v in per.items()},
                         "grad": np.asarray(grad)}

        proc.wait(timeout=240)
    finally:
        proc.kill()
        log.seek(0)
        out = log.read()
        log.close()
    assert proc.returncode == 0, f"torchrun failed:\n{out[-6000:]}"
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(data=data, jax=jax_out, ranks=ranks)


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("case", ["gen8", "gen7", "adv"])
def test_metrics_match_jax_global_batch(world, case):
    got = world["ranks"][0]
    want = world["jax"][case]["metrics"]
    keys = {k.split("/", 2)[2] for k in got if k.startswith(f"{case}/metric/")}
    assert keys == set(want)
    for key in want:
        _close(got[f"{case}/metric/{key}"], want[key], f"{case} {key}")
        # every rank reads the same global values
        np.testing.assert_array_equal(world["ranks"][1][f"{case}/metric/{key}"],
                                      got[f"{case}/metric/{key}"])


@pytest.fixture(scope="module")
def one_process(world):
    """The same cases in this process, no group, on the whole global batch."""
    return {case: port_step(world["data"], case, slice(None)) for case in ("gen8", "gen7", "adv")}


@pytest.mark.parametrize("case", ["gen8", "gen7", "adv"])
def test_summed_gradients_match_one_process(world, one_process, case):
    """The gradients each optimizer steps on (after the all-reduce) are the
    one-process gradients of the global batch, up to the order of the sum."""
    got, want = world["ranks"][0], one_process[case]
    keys = [k for k in want if k.startswith(("grad_g/", "grad_d/"))]
    assert len(keys) == len([k for k in got if k.startswith(f"{case}/grad_")])
    for key in keys:
        g = want[key]
        np.testing.assert_allclose(got[f"{case}/{key}"], g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=f"{case} {key}")
        np.testing.assert_array_equal(world["ranks"][1][f"{case}/{key}"], got[f"{case}/{key}"])


@pytest.mark.parametrize("case", ["gen8", "gen7", "adv"])
def test_metrics_match_one_process(world, one_process, case):
    got, want = world["ranks"][0], one_process[case]
    for key in (k for k in want if k.startswith("metric/")):
        np.testing.assert_allclose(got[f"{case}/{key}"], want[key], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{case} {key}")


@pytest.mark.parametrize("case,model", [("gen8", "g"), ("gen7", "g"), ("adv", "g"),
                                        ("adv", "d")])
def test_parameters_after_adam_match_jax(world, one_process, case, model):
    ranks = world["ranks"]
    want = world["jax"][case][f"param_{model}"]
    grads = {k.split("/", 1)[1]: v for k, v in one_process[case].items()
             if k.startswith(f"grad_{model}/")}
    lr = LR * WORLD
    for key, p in want.items():
        ours = ranks[0][f"{case}/param_{model}/{key}"]
        np.testing.assert_array_equal(ranks[1][f"{case}/param_{model}/{key}"], ours)
        if key not in grads:  # buffers
            np.testing.assert_array_equal(ours, p)
            continue
        g = np.abs(grads[key])
        firm = g > GRAD_FLOOR * g.max()
        _close(ours[firm], p[firm], f"{case} param {key}")
        assert np.abs(ours - p).max() <= 2 * lr * 1.001, key


def test_padded_row_is_masked_on_rank1(world):
    data = world["data"]
    assert data["gen7_mask"].tolist() == [1.0] * 7 + [0.0]
    assert data["gen7_mask"][1::WORLD].tolist() == [1.0, 1.0, 1.0, 0.0]
    # a masked row takes no part: the 7-row step differs from the 8-row one
    assert not np.allclose(world["ranks"][0]["gen7/metric/train/recon_loss"],
                           world["ranks"][0]["gen8/metric/train/recon_loss"])


def test_ar_vae_term_over_the_global_batch(world):
    want = world["jax"]["ar"]
    for r, got in enumerate(world["ranks"]):
        _close(got["ar/total"], want["total"], "AR total")
        for name, value in want["per"].items():
            _close(got[f"ar/per/{name}"], value, f"AR {name}")
        # the gradient at this rank's rows, counted once
        np.testing.assert_allclose(got["ar/grad"], want["grad"][r::WORLD], rtol=1e-4,
                                   atol=1e-5 * np.abs(want["grad"]).max())


def test_ar_vae_subset_pairs_drawn_alike(world):
    """Both ranks draw the same pairs of the global batch: the term equals
    the one-process term on the global batch from the same seed."""
    data = world["data"]
    subset = make_ar_vae_spec(AR_MAPPING, pairwise_mode="subset", subset_pairs=20, latent_dim=3)
    want, _, _ = compute_ar_vae_loss(data["ar_z"], {k: data[f"ar_{k}"] for k in AR_MAPPING},
                                     subset, sample_mask=data["ar_mask"],
                                     generator=torch.Generator().manual_seed(5))
    for got in world["ranks"]:
        np.testing.assert_allclose(got["ar/subset_total"], want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("n,multiple", [(7, 8), (8, 8), (5, 2), (3, 1)])
def test_pad_batch_matches_jax(n, multiple):
    from pti_ldm_vae_tpu.parallel.mesh import pad_batch as jax_pad_batch

    rng = np.random.default_rng(n)
    batch = {"image": rng.normal(size=(n, 4, 4, 1)).astype(np.float32),
             "mask": np.ones(n, np.float32), "step": np.float32(3.0),
             "attributes": {"height": rng.normal(size=n).astype(np.float32)}}
    got, want = pad_batch(batch, multiple), jax_pad_batch(batch, multiple)
    for key in ("image", "mask", "step"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    np.testing.assert_array_equal(got["attributes"]["height"],
                                  np.asarray(want["attributes"]["height"]))


def test_world_one_group_is_bit_identical_to_no_group(world):
    """A gloo group of one rank runs every collective and changes no bit:
    the adversarial step (all-reduced gradients of both optimizers, global
    masked means, reduced metrics) and the AR-VAE term's gather."""
    data = world["data"]
    rows = slice(None)
    plain = port_step(data, "adv", rows), port_ar(data, rows)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        assert maybe_initialize_distributed("cpu") and world_size() == 1
        grouped = port_step(data, "adv", rows), port_ar(data, rows)
    finally:
        dist.destroy_process_group()
    for a, b in zip(plain, grouped):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])

"""Shared by ``tests/test_torch_spatial_parallel.py`` and
``tests/test_torch_tensor_parallel.py``: the port's cases under a model axis
(run by both ranks of one ``torchrun --standalone --nproc_per_node 2`` launch
of this file, gloo on the CPU) and in one process with no group, and the JAX
package's references on the same inputs.

The toy model is ``TINY`` of ``tests/test_spatial_sharding.py`` (the tensor
file turns on its level-1 attention, as ``tests/test_tensor_parallel.py``
does) at 32², batch 4, with a PatchGAN of 8 channels and 2 layers, LPIPS and
the AR-VAE term: one adversarial train step covers the generator and the
discriminator. The port's seeded inits, perturbed, reach the JAX trees
through the JAX package's converters. With ``data = 1`` both ranks of the
model group hold the whole batch (a height tile or a channel block of it),
so a run is the one-process run at batch 4.

This module imports no JAX unless the JAX references are asked for; the
worker (``__main__``) never does.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pti_ldm_vae_tpu_torch.checkpoint.manager import CheckpointManager, whole_state
from pti_ldm_vae_tpu_torch.checkpoint.reference_resume import load_reference_checkpoint
from pti_ldm_vae_tpu_torch.losses.ar_vae import make_ar_vae_spec
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
from pti_ldm_vae_tpu_torch.parallel import maybe_initialize_distributed, process_rank
from pti_ldm_vae_tpu_torch.parallel.mesh import (
    data_size,
    first_local_rows,
    make_mesh,
    model_size,
    set_mesh,
)
from pti_ldm_vae_tpu_torch.parallel.spatial import gather_height, spatial_split
from pti_ldm_vae_tpu_torch.parallel.tensor import _gather_dim0, tensor_parallel_params
from pti_ldm_vae_tpu_torch.train.state import create_train_state
from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step

ROOT = Path(__file__).resolve().parents[1]
MODEL = 2
IMAGE, LATENT, BATCH = 32, 16, 4
LR = 1e-3
DISC = dict(spatial_dims=2, num_layers_d=2, channels=8)
LOSS = dict(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0, adv_weight=0.5, ar_gamma=0.5,
            ar_vae_enabled=True)
AR_MAPPING = {"height_0": {"latent_channel": 0, "delta": 1.0}}
RTOL, ATOL = 2e-4, 1e-5  # the JAX sharding tests' own bars


def tiny_def(attention_levels: tuple[bool, bool]) -> dict:
    """``TINY`` of ``tests/test_spatial_sharding.py`` as an ``autoencoder_def``."""
    return dict(spatial_dims=2, in_channels=1, out_channels=1, latent_channels=2,
                channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
                attention_levels=list(attention_levels), with_encoder_nonlocal_attn=True,
                with_decoder_nonlocal_attn=True)


def zero_gradient_in_exact_arithmetic(key: str) -> bool:
    """Softmax is invariant to a constant added along the keys: a key
    projection's bias has gradient 0, and every run holds rounding noise."""
    return key.endswith("to_k.bias")


# ---- the port's cases -------------------------------------------------------------------

def _model(data: dict, **knobs) -> torch.nn.Module:
    model = autoencoder_from_config(json.loads(data["ae_def"]), **knobs)
    model.load_state_dict(data["sd_g"], strict=True)
    return model


def _disc(data: dict) -> PatchDiscriminator:
    disc = PatchDiscriminator(**DISC)
    disc.load_state_dict(data["sd_d"], strict=True)
    return disc


def _state(data: dict, kind: str | None):
    model, disc = _model(data), _disc(data)
    if kind == "tensor":
        tensor_parallel_params(model)
        tensor_parallel_params(disc)
    return create_train_state(model, lr=LR, world_size=data_size(), model_d=disc)


def _whole_grads(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    full = getattr(module, "tp_full_shapes", {})
    return {k: (_gather_dim0(p.grad.contiguous(), full[k][0]) if k in full else p.grad).clone()
            for k, p in module.named_parameters()}


def _capture(optimizer, module, into: dict, key: str) -> None:
    """Record the gradients (after the ranks' all-reduce) when ``optimizer``
    steps."""
    real = optimizer.step

    def step(*a, **kw):
        into[key] = _whole_grads(module)
        optimizer.step = real
        return real(*a, **kw)

    optimizer.step = step


def _np(tree: dict, prefix: str) -> dict[str, np.ndarray]:
    return {f"{prefix}/{k}": v.detach().numpy() for k, v in tree.items()}


def port_case(data: dict, kind: str | None, work: Path) -> dict[str, np.ndarray]:
    """The port's results on the global batch: under a ``kind`` mesh of
    ``MODEL`` ranks (``data = 1``) or, with ``kind`` None, in one process.
    Reconstructs (cuDNN, the convolution kernels' plain versions, s2d), one
    adversarial step with AR-VAE (metrics, the gradients each optimizer
    steps on, parameters and Adam moments after), and the checkpoints it
    writes before and after the step into ``work``."""
    if kind is not None:
        make_mesh(kind, MODEL)
    out: dict[str, np.ndarray] = {}
    rows = kind == "spatial"
    try:
        images, eps = data["images"], data["eps"]
        if rows:
            images, eps = spatial_split(images), spatial_split(eps)
            out["first_local_rows"] = first_local_rows(images)
        for tag, knobs in (("recon", {}), ("recon_kernel", {"conv_kernel": True}),
                           ("recon_s2d", {"s2d_stem": True})):
            with torch.no_grad():
                out[tag] = gather_height(_model(data, **knobs).reconstruct_deterministic(
                    images)).numpy()

        state = _state(data, kind)
        ckpt = CheckpointManager(str(work / "ckpt_before"), rank=process_rank())
        ckpt.save_epoch(state=state, epoch=0, val_loss=0.5, best_val_loss=1.0, total_step=0)
        seen: dict = {}
        _capture(state.optimizer_g, state.model_g, seen, "g")
        _capture(state.optimizer_d, state.model_d, seen, "d")
        step = make_train_step(state.model_g, state.model_d,
                               LossConfig(**LOSS, ar_spec=make_ar_vae_spec(AR_MAPPING)),
                               adv_active=True)
        _, metrics = step(state, images, data["mask"], {"height_0": data["height_0"]},
                          data["lpips"], eps=eps)
        # this rank's Adam moments: a sharded parameter's hold its block only
        out.update({f"adam_rows/{n}": np.array(state.optimizer_g.state[p]["exp_avg"].shape[0])
                    for n, p in state.model_g.named_parameters()})
        out.update({f"metric/{k}": v.numpy() for k, v in metrics.items()})
        out.update(_np(seen["g"], "grad_g"))
        out.update(_np(seen["d"], "grad_d"))
        whole = whole_state(state)
        out.update(_np(whole["model_g"], "param_g"))
        out.update(_np(whole["model_d"], "param_d"))
        for tag in ("g", "d"):
            names = list(whole[f"model_{tag}"])
            for i, entry in whole[f"optimizer_{tag}"]["state"].items():
                out[f"exp_avg_{tag}/{names[i]}"] = entry["exp_avg"].numpy()
        ckpt = CheckpointManager(str(work / "ckpt_after"), rank=process_rank())
        ckpt.save_epoch(state=state, epoch=0, val_loss=0.5, best_val_loss=1.0, total_step=1)
        # both resume paths take the written files back into a fresh (sharded) state
        for tag, load in (("restore", lambda s: ckpt.restore(s)),
                          ("reference", lambda s: load_reference_checkpoint(
                              str(work / "ckpt_after" / "checkpoint_epoch0.pth"), s))):
            again = _state(data, kind)
            load(again)
            back = whole_state(again)
            out[f"resume_equal/{tag}"] = np.array(all(
                torch.equal(back[part][k], whole[part][k]) for part in ("model_g", "model_d")
                for k in whole[part]) and all(
                torch.equal(back[part]["state"][i][m], whole[part]["state"][i][m])
                for part in ("optimizer_g", "optimizer_d") for i in whole[part]["state"]
                for m in ("exp_avg", "exp_avg_sq")))
        out["model_size"] = np.array(model_size())
    finally:
        set_mesh(None)
    return out


def worker(kind: str, inputs: str, out_dir: str) -> None:
    """One rank of the launch: every case on its shard, results to
    ``out_dir/rank{r}.npz`` (rank 0 writes the checkpoints)."""
    torch.manual_seed(0)
    if not maybe_initialize_distributed("cpu"):
        raise RuntimeError("the worker runs under torchrun")
    try:
        data = torch.load(inputs, weights_only=False)
        out = port_case(data, kind, Path(out_dir) / "sharded")
        np.savez(Path(out_dir) / f"rank{process_rank()}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---- the test process: inputs, the launch, the JAX references ----------------------------

def _jax_lpips_tree(params: dict) -> dict:
    """The port's LPIPS parameters as the JAX package's tree (numpy leaves,
    HWIO kernels): the inverse of ``lpips_params_from_jax``."""
    out = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out[key] = _jax_lpips_tree(value)
        else:
            a = value.numpy()
            out[key] = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a
    return out


def make_inputs(ae_def: dict) -> dict:
    """Seeded inputs and weights (the port's inits perturbed, the port's
    seeded LPIPS parameters), with the JAX trees they convert to; the
    posterior noise is the JAX step's own draw."""
    import jax
    import jax.numpy as jnp

    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    sd_g = {k: v + 0.05 * torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
            for k, v in autoencoder_from_config(ae_def).state_dict().items()}
    # 0.02-scale weights give logits near 0: scale them up so the discriminator matters
    sd_d = {k: 2.0 * v + 0.05 * torch.from_numpy(rng.normal(size=tuple(v.shape))
                                                 .astype(np.float32))
            for k, v in PatchDiscriminator(**DISC).state_dict().items()}
    images = rng.uniform(0.1, 1.0, size=(BATCH, IMAGE, IMAGE, 1)).astype(np.float32)
    key = jax.random.key(11)
    eps = np.array(jax.random.normal(jax.random.split(key)[0], (BATCH, LATENT, LATENT, 2),
                                     jnp.float32))
    lpips = init_lpips_params(1)
    return {"ae_def": json.dumps(ae_def), "sd_g": sd_g, "sd_d": sd_d,
            "images": torch.from_numpy(images), "eps": torch.from_numpy(eps),
            "mask": torch.ones(BATCH), "key": 11,
            "height_0": torch.from_numpy(rng.normal(size=BATCH).astype(np.float32)),
            "lpips": lpips, "lpips_tree": _jax_lpips_tree(lpips)}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_launch(kind: str, data: dict, work: Path) -> tuple[subprocess.Popen, object]:
    """Start the two-rank launch (it runs while the JAX references compile)."""
    torch.save({k: v for k, v in data.items() if k != "lpips_tree"}, work / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "PTI_LPIPS_WEIGHTS": "none"}
    log = open(work / "torchrun.log", "w+", encoding="utf-8")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={MODEL}", __file__, kind, str(work / "inputs.pt"), str(work)],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def finish_launch(proc: subprocess.Popen, log, work: Path) -> list[dict[str, np.ndarray]]:
    try:
        proc.wait(timeout=240)
    finally:
        proc.kill()
        log.seek(0)
        text = log.read()
        log.close()
    assert proc.returncode == 0, f"torchrun failed:\n{text[-6000:]}"
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(MODEL)]


def jax_references(data: dict) -> dict:
    """The JAX package on the global batch, unsharded: the reconstruct and
    the adversarial train step with AR-VAE (LR as one process's)."""
    import jax
    import jax.numpy as jnp

    from pti_ldm_vae_tpu.checkpoint.torch_convert import (
        disc_from_torch_state_dict,
        disc_to_torch_state_dict,
        from_torch_state_dict,
        to_torch_state_dict,
    )
    from pti_ldm_vae_tpu.losses.ar_vae import make_ar_vae_spec as jax_ar_spec
    from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
    from pti_ldm_vae_tpu.models.discriminator import PatchDiscriminator as JaxDisc
    from pti_ldm_vae_tpu.train import steps as jax_steps
    from pti_ldm_vae_tpu.train.state import create_train_state as jax_create_state

    ae_def = json.loads(data["ae_def"])
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    model = jax_from_config(ae_def, use_pallas_attention=False, s2d_stem=False)
    disc = JaxDisc(**DISC)
    params_g = from_torch_state_dict({k: v.numpy() for k, v in data["sd_g"].items()}, ae_def)
    params_d = disc_from_torch_state_dict({k: v.numpy() for k, v in data["sd_d"].items()},
                                          num_layers_d=DISC["num_layers_d"])
    x = jnp.asarray(data["images"].numpy())
    recon = jax.jit(lambda p, xx: model.apply(p, xx, method=model.reconstruct_deterministic))(
        params_g, x)
    lcfg = jax_steps.LossConfig(**LOSS, ar_spec=jax_ar_spec(AR_MAPPING), use_perceptual=True)
    step = jax_steps.make_train_step(model, disc, lcfg, adv_active=True, donate=False)
    state = jax_create_state(params_g, lr=LR, params_d=params_d)
    state, metrics = step(state, x, jnp.asarray(data["mask"].numpy()),
                          {"height_0": jnp.asarray(data["height_0"].numpy())},
                          data["lpips_tree"], jax.random.key(data["key"]))
    return {"recon": np.asarray(recon),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "param_g": to_torch_state_dict(as_np(state.params_g), ae_def),
            "param_d": disc_to_torch_state_dict(as_np(state.params_d),
                                                num_layers_d=DISC["num_layers_d"])}


# ---- the checks both files make on a launch's results -------------------------------------

def world(kind: str, ae_def: dict, work: Path) -> dict:
    """Inputs, the launch's two ranks, the JAX references and the port's
    one-process results (the JAX references compile while the launch runs)."""
    data = make_inputs(ae_def)
    proc, log = start_launch(kind, data, work)
    try:
        jax_out = jax_references(data)
        one = port_case(data, None, work / "one")
    finally:
        ranks = finish_launch(proc, log, work)
    return dict(data=data, jax=jax_out, one=one, ranks=ranks, work=work)


def check_reconstruct(w: dict, form: str) -> None:
    """``recon`` against JAX; the other forms against the port's one process
    (which the single-device tests hold to JAX) and JAX."""
    for got in w["ranks"]:
        want = w["jax"]["recon"] if form == "recon" else w["one"][form]
        np.testing.assert_allclose(got[form], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w["one"][form], w["jax"]["recon"], rtol=1e-4, atol=1e-5)


def check_loss_terms(w: dict) -> None:
    want = w["jax"]["metrics"]
    for got in w["ranks"]:
        assert {k.split("/", 1)[1] for k in got if k.startswith("metric/")} == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[f"metric/{key}"], value, rtol=RTOL, atol=ATOL,
                                       err_msg=key)


def check_gradients(w: dict, which: str) -> None:
    want = {k: v for k, v in w["one"].items() if k.startswith(f"grad_{which}/")}
    assert want
    for got in w["ranks"]:
        for key, g in want.items():
            atol = 1e-6 if zero_gradient_in_exact_arithmetic(key) else ATOL * np.abs(g).max()
            np.testing.assert_allclose(got[key], g, rtol=RTOL, atol=atol, err_msg=key)


def check_parameters(w: dict, which: str) -> None:
    """After Adam, against JAX where the gradient is firm; every entry within
    2 lr (a fresh Adam step moves an entry by about lr x sign(g))."""
    for got in w["ranks"]:
        for key, p in w["jax"][f"param_{which}"].items():
            ours = got[f"param_{which}/{key}"]
            g = np.abs(w["one"][f"grad_{which}/{key}"])
            firm = g > 1e-4 * g.max()
            if not zero_gradient_in_exact_arithmetic(key):  # noise: only the 2 lr bound
                np.testing.assert_allclose(ours[firm], p[firm], rtol=RTOL, atol=ATOL, err_msg=key)
            assert np.abs(ours - p).max() <= 2 * LR * 1.001, key


def check_same_ranks(w: dict) -> None:
    a, b = w["ranks"]
    assert a.keys() == b.keys()
    for key in a:
        if not key.startswith("adam_rows/"):  # each rank's own block
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def check_checkpoints(w: dict) -> None:
    """Rank 0 writes the one-process run's files: the same names and keys,
    the same values before the step; after it the parameters at
    :func:`check_parameters`' bars and Adam's moments at
    :func:`check_gradients`' (one step from zero: ``exp_avg = (1 - b1) g``,
    ``exp_avg_sq = (1 - b2) g^2``), each slot to the one-process slot of the
    same name; both resume paths take them back into the sharded state bit
    for bit."""
    for name in ("ckpt_before", "ckpt_after"):
        got_dir, want_dir = w["work"] / "sharded" / name, w["work"] / "one" / name
        names = sorted(p.name for p in want_dir.iterdir())
        assert sorted(p.name for p in got_dir.iterdir()) == names
        for file in names:
            got = torch.load(got_dir / file, weights_only=True)
            want = torch.load(want_dir / file, weights_only=True)
            where = f"{name}/{file}"
            if name == "ckpt_before":
                _same_tree(got, want, where)
            elif file.startswith("checkpoint_"):
                assert got.keys() == want.keys(), where
                for key in want:
                    d = "discriminator" in key or key == "optimizer_d_state_dict"
                    if key.startswith("optimizer_"):
                        names = list(want["discriminator_state_dict" if d
                                          else "autoencoder_state_dict"])
                        _held_moments(got[key], want[key], names, f"{where}/{key}")
                    elif key.endswith("_state_dict"):
                        _held_parameters(w, got[key], want[key], "d" if d else "g",
                                         f"{where}/{key}")
                    else:
                        _same_tree(got[key], want[key], f"{where}/{key}")
            else:
                _held_parameters(w, got, want, "d" if file.startswith("discriminator") else "g",
                                 where)
    for got in w["ranks"]:
        assert got["resume_equal/restore"] and got["resume_equal/reference"]


def _held_parameters(w: dict, got: dict, want: dict, which: str, where: str) -> None:
    """A written state dict after the step against the one-process one: firm
    entries (by the one-process gradient) at rtol / atol, every entry within
    2 lr."""
    assert got.keys() == want.keys(), where
    for key, p in want.items():
        ours, p = got[key].numpy(), p.numpy()
        assert ours.shape == p.shape and got[key].dtype == want[key].dtype, f"{where}/{key}"
        g = np.abs(w["one"][f"grad_{which}/{key}"])
        firm = g > 1e-4 * g.max()
        if not zero_gradient_in_exact_arithmetic(key):
            np.testing.assert_allclose(ours[firm], p[firm], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{where}/{key}")
        assert np.abs(ours - p).max() <= 2 * LR * 1.001, f"{where}/{key}"


def _held_moments(got: dict, want: dict, names: list[str], where: str) -> None:
    """A written Adam state after one step against the one-process one: the
    param groups and steps equal, ``exp_avg / (1 - b1)`` and
    ``sqrt(exp_avg_sq / (1 - b2))`` (the gradient and its magnitude) at the
    gradient bars of :func:`check_gradients`."""
    _same_tree(got["param_groups"], want["param_groups"], f"{where}/param_groups")
    b1, b2 = want["param_groups"][0]["betas"]
    assert got["state"].keys() == want["state"].keys() and len(want["state"]) == len(names), where
    for i, entry in want["state"].items():
        at = f"{where}/{names[i]}"
        ours = got["state"][i]
        assert ours.keys() == entry.keys(), at
        _same_tree(ours["step"], entry["step"], f"{at}/step")
        for moment, to_gradient in (("exp_avg", lambda m: m / (1 - b1)),
                                    ("exp_avg_sq", lambda v: np.sqrt(v / (1 - b2)))):
            assert ours[moment].shape == entry[moment].shape, f"{at}/{moment}"
            g = to_gradient(entry[moment].numpy())
            atol = (1e-6 if zero_gradient_in_exact_arithmetic(names[i])
                    else ATOL * np.abs(g).max())
            np.testing.assert_allclose(to_gradient(ours[moment].numpy()), g, rtol=RTOL, atol=atol,
                                       err_msg=f"{at}/{moment}")


def _same_tree(got, want, where: str) -> None:
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for key in want:
            _same_tree(got[key], want[key], f"{where}/{key}")
    elif torch.is_tensor(want):
        assert got.shape == want.shape and got.dtype == want.dtype, where
        assert torch.equal(got, want), where
    else:
        assert got == want, where


if __name__ == "__main__":
    worker(*sys.argv[1:4])

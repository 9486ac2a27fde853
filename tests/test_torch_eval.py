"""The port's evaluation metrics and ``cli.evaluate_vae`` against the JAX
package, f32 on the CPU, from the same numpy inputs, weights carried across
and the JAX side's own posterior noise.

Bars: PSNR / SSIM / MSE / MAE rtol 1e-4 / atol 1e-5 (SSIM is a ratio of
blurred moments: summation order); evaluation summaries rtol 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.cli.evaluate_vae import evaluate as jax_evaluate
from pti_ldm_vae_tpu.models import lpips as jax_lpips
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.utils import eval_metrics as jax_metrics
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import lpips_params_from_jax, state_dict_from_flax
from pti_ldm_vae_tpu_torch.cli.evaluate_vae import evaluate, main, parse_args
from pti_ldm_vae_tpu_torch.data.io import write_tif
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.utils import eval_metrics as metrics

TOL = dict(rtol=1e-4, atol=1e-5)
TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, False],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.normal(size=shape), 0.0, 1.0).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("name", ["compute_psnr", "compute_ssim", "compute_mse", "compute_mae"])
@pytest.mark.parametrize("shape", [(3, 32, 32, 1), (2, 20, 28, 3), (1, 9, 9, 2)],
                         ids=["square", "ragged_rgb", "smaller_than_window"])
def test_metric_matches_jax(name, shape):
    pred, target = _pair(shape, seed=len(name) + shape[1])
    want = np.asarray(getattr(jax_metrics, name)(jnp.asarray(pred), jnp.asarray(target)))
    got = getattr(metrics, name)(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.shape == (shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_metrics_on_identical_and_scaled_inputs():
    x = torch.from_numpy(_pair((2, 16, 16, 1), 0)[1])
    assert torch.allclose(metrics.compute_ssim(x, x), torch.ones(2), atol=1e-6)
    assert float(metrics.compute_psnr(x, x)[0]) == pytest.approx(120.0, abs=1e-3)  # the 1e-12 floor
    assert float(metrics.compute_mse(x, x).max()) == 0.0 and float(metrics.compute_mae(x, x).max()) == 0.0
    pred, target = _pair((2, 16, 16, 1), 1)
    want = np.asarray(jax_metrics.compute_psnr(jnp.asarray(pred * 255), jnp.asarray(target * 255),
                                               data_range=255.0))
    got = metrics.compute_psnr(torch.from_numpy(pred * 255), torch.from_numpy(target * 255),
                               data_range=255.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # rank 5 is the depth-slice mean (tests/test_torch_spatial_dims.py); rank 3 has no SSIM
    with pytest.raises(ValueError, match="rank 3"):
        metrics.compute_ssim(torch.zeros(1, 8, 1), torch.zeros(1, 8, 1))


def test_metrics_take_bf16_and_answer_in_f32():
    pred, target = _pair((2, 16, 16, 1), 2)
    p, t = torch.from_numpy(pred).bfloat16(), torch.from_numpy(target).bfloat16()
    for fn in (metrics.compute_psnr, metrics.compute_ssim, metrics.compute_mse, metrics.compute_mae):
        out = fn(p, t)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.fixture(scope="module")
def world():
    jax_model = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    variables = jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 1)),
                                        jax.random.key(1))
    rng = np.random.default_rng(3)
    images = rng.uniform(0.0, 1.0, size=(2, 4, 32, 32, 1)).astype(np.float32)
    images[1, 3] = 0.0
    batches = [{"image": images[0], "mask": np.ones(4, np.float32)},
               {"image": images[1], "mask": np.array([1, 1, 1, 0], np.float32)}]
    lpips_tree = jax.tree_util.tree_map(np.asarray, jax_lpips.init_lpips_params(1))
    # the JAX loop's noise: key = key(seed); per batch key, sub = split(key); eps ~ normal(sub)
    key, eps = jax.random.key(42), []
    for _ in batches:
        key, sub = jax.random.split(key)
        eps.append(torch.from_numpy(np.array(jax.random.normal(sub, (4, 16, 16, 3), dtype=jnp.float32))))
    want = jax_evaluate(jax_model, variables, batches, recon_kind="l1", perceptual_weight=0.5,
                        lpips_params=lpips_tree, seed=42)
    port = autoencoder_from_config(TOY, conv_kernel=True)
    port.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), TOY),
                         strict=True)
    return dict(port=port, batches=batches, eps=eps, want=want,
                lpips=lpips_params_from_jax(lpips_tree))


def test_evaluate_summary_matches_jax(world):
    got = evaluate(world["port"], world["batches"], recon_kind="l1", perceptual_weight=0.5,
                   lpips_params=world["lpips"], eps=world["eps"])
    assert set(got) == set(world["want"]) == {
        f"{m}_{s}" for m in ("recon_loss", "kl_loss", "perceptual_loss", "loss_total", "psnr",
                             "ssim", "mse", "mae") for s in ("mean", "std")}
    for name, value in world["want"].items():
        assert got[name] == pytest.approx(value, rel=1e-4, abs=1e-6), name
    # KL enters the total at weight 1 (the reference's evaluation, not its training objective)
    assert got["loss_total_mean"] == pytest.approx(
        got["recon_loss_mean"] + got["kl_loss_mean"] + 0.5 * got["perceptual_loss_mean"], rel=1e-5)


def test_padded_row_is_left_out_of_every_metric(world):
    other = [dict(b) for b in world["batches"]]
    other[1] = {"image": other[1]["image"].copy(), "mask": other[1]["mask"]}
    other[1]["image"][3] = 0.7
    kwargs = dict(recon_kind="l1", perceptual_weight=0.5, lpips_params=world["lpips"], eps=world["eps"])
    a = evaluate(world["port"], world["batches"], **kwargs)
    b = evaluate(world["port"], other, **kwargs)
    for name in a:
        assert a[name] == pytest.approx(b[name], rel=1e-6), name


def test_evaluate_cli_writes_metrics_json(world, tmp_path):
    data = tmp_path / "data" / "dente"
    data.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(5):
        write_tif(str(data / f"dente_{i:03d}.tif"), rng.uniform(0.1, 1.0, size=(40, 40)).astype(np.float32))
    cfg = {"autoencoder_def": TOY,
           "autoencoder_train": {"patch_size": [32, 32], "perceptual_weight": 1.0, "recon_loss": "l1"}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    torch.save(world["port"].state_dict(), tmp_path / "w.pth")
    argv = ["-c", str(tmp_path / "cfg.json"), "--checkpoint", str(tmp_path / "w.pth"),
            "--input-dir", str(tmp_path / "data"), "--output-dir", str(tmp_path / "evals"),
            "--device", "cpu", "--batch-size", "2", "--num-workers", "1"]
    summary = main(argv)
    payload = json.loads((tmp_path / "evals" / "metrics.json").read_text())
    assert payload["metrics"] == summary and len(payload["files"]) == 5
    assert payload["perceptual_pretrained"] is False and payload["args"]["batch_size"] == 2
    assert all(np.isfinite(v) for v in summary.values())
    assert 0.0 < summary["ssim_mean"] <= 1.0 and summary["psnr_mean"] > 0.0
    # the same seed draws the same noise; the convolution kernels' plain path agrees with cuDNN's
    again = main(argv + ["--conv-kernel", "--output-dir", str(tmp_path / "evals2")])
    for name, value in summary.items():
        assert again[name] == pytest.approx(value, rel=1e-4, abs=1e-6), name
    assert parse_args(argv).device == "cpu" and not parse_args(argv).conv_kernel

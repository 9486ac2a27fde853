"""The regression pipeline through the port's entry points on the CPU:
``compute_mask_metrics`` on seeded mask pairs, then ``train_regression``,
``evaluate_regression`` and ``inference_regression --device cpu`` on both
regression configs of ``config/`` (``reg_edente_from_dente.json``: raw
targets; ``nreg_edente_from_both.json``: standard-normalized), cut to toy
size: a VAE of channels [8, 16], one ResBlock, 4 groups, 32² patches
(random weights in a MONAI-keyed ``.pth``), batch 4, 2 epochs. The head's
architecture, dropout, loss and target choice stay the configs'.

The port's ``metrics.json`` and ``predictions.json`` equal the JAX CLIs'
on the same head checkpoint (the port's ``head_best.pth``, which the JAX
package reads) and VAE weights: rtol 1e-4 (atol 1e-4 of each prediction
column's scale); ``--conv-kernel`` (the convolution kernels' plain versions
here) gives the same predictions within 1e-5 of their scale.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.cli.evaluate_regression import main as jax_evaluate
from pti_ldm_vae_tpu.cli.inference_regression import main as jax_inference
from pti_ldm_vae_tpu_torch.cli.compute_mask_metrics import main as mask_metrics
from pti_ldm_vae_tpu_torch.cli.evaluate_regression import main as evaluate
from pti_ldm_vae_tpu_torch.cli.inference_regression import main as inference
from pti_ldm_vae_tpu_torch.cli.train_regression import main as train
from pti_ldm_vae_tpu_torch.data.io import write_tif
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("reg_edente_from_dente", "nreg_edente_from_both")
N_IMAGES = 12
EPOCHS = 2
AE_DEF = {
    "spatial_dims": 2, "in_channels": 1, "out_channels": 1, "latent_channels": 4,
    "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4, "norm_eps": 1e-6,
    "attention_levels": [False, False],
    "with_encoder_nonlocal_attn": True, "with_decoder_nonlocal_attn": True,
}


def _mask(rng, h=180, w=120):
    mask = np.zeros((h, w), np.float32)
    for y in range(int(rng.integers(10, 50)), int(rng.integers(120, h))):
        half = int(rng.integers(10, 40))
        mask[y, w // 2 - half:w // 2 + half] = 1.0
    return mask


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Mask pairs and images sharing stems, the attributes the port's
    ``compute_mask_metrics`` writes from the masks, a toy VAE, and the two
    configs pointed at them."""
    root = tmp_path_factory.mktemp("torch_reg_cli")
    rng = np.random.default_rng(0)
    for sub in ("masks/edente", "masks/dente", "images/dente"):
        (root / sub).mkdir(parents=True)
    for i in range(N_IMAGES):
        name = f"img_{i:03d}.tif"
        write_tif(str(root / "masks" / "edente" / name), _mask(rng))
        write_tif(str(root / "masks" / "dente" / name), _mask(rng))
        write_tif(str(root / "images" / "dente" / name),
                  rng.uniform(0.1, 1.0, size=(40, 40)).astype(np.float32))
    attributes = root / "metrics" / "attributes_edente.json"
    mask_metrics(["--edente-dir", str(root / "masks" / "edente"), "--dente-dir",
                  str(root / "masks" / "dente"), "--output-edente", str(attributes),
                  "--output-dente", str(root / "metrics" / "attributes_dente.json")])
    (root / "vae.json").write_text(json.dumps({
        "spatial_dims": 2, "autoencoder_def": AE_DEF,
        "autoencoder_train": {"patch_size": [32, 32], "batch_size": 4}}))
    torch.manual_seed(3)
    torch.save(autoencoder_from_config(AE_DEF).state_dict(), root / "vae.pth")
    for name in CONFIGS:
        cfg = json.loads((ROOT / "config" / f"{name}.json").read_text())
        cfg["run_dir"] = str(root / "runs" / name)
        for block in ("data", "evaluation"):
            cfg[block].update(data_base_dir=str(root / "images"), attributes_path=str(attributes),
                              patch_size=[32, 32], num_workers=2)
        cfg["data"]["train_split"] = 0.75  # 9 train images: the last batch of 4 is padded
        cfg["vae"].update(config_file=str(root / "vae.json"), checkpoint=str(root / "vae.pth"))
        cfg["regression_train"].update(batch_size=4, lr=1e-3, max_epochs=EPOCHS)
        (root / f"{name}.json").write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope="module", params=CONFIGS)
def trained(workspace, request):
    name = request.param
    result = train(["-c", str(workspace / f"{name}.json"), "--device", "cpu"])
    run_dir = workspace / "runs" / name
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return dict(name=name, cfg=workspace / f"{name}.json", result=result, run_dir=run_dir,
                rows=rows, head=run_dir / "trained_weights" / "head_best.pth", root=workspace)


def test_attributes_have_the_configs_targets(workspace):
    targets = json.loads((ROOT / "config" / f"{CONFIGS[0]}.json").read_text())["targets"]
    attrs = json.loads((workspace / "metrics" / "attributes_edente.json").read_text())
    assert sorted(attrs) == [f"img_{i:03d}.tif" for i in range(N_IMAGES)]
    assert all(list(v) == targets for v in attrs.values())


def test_train_writes_metrics_and_checkpoints(trained):
    rows, weights = trained["rows"], trained["run_dir"] / "trained_weights"
    assert [r["epoch"] for r in rows] == list(range(1, EPOCHS + 1))
    targets = json.loads(trained["cfg"].read_text())["targets"]
    for r in rows:
        keys = {"train/loss_mse", "val/loss_mse", "best/val_loss_mse", "val/mae", "val/mse",
                *(f"val/{m}_{t}" for m in ("mae", "mse") for t in targets)}
        assert keys <= set(r) and all(np.isfinite(r[k]) for k in keys)
    assert trained["result"]["best_val"] == min(r["val/loss_mse"] for r in rows)
    for file in ("head_best.pth", "head_last.pth"):
        ckpt = torch.load(weights / file, weights_only=True)
        assert ckpt["targets"] == targets and ckpt["latent_dim"] == 4 * 16 * 16
        assert sorted(ckpt["regressor_state_dict"]) == sorted(
            f"mlp.{i}.{p}" for i in (0, 3, 6) for p in ("weight", "bias"))  # dropout 0.1
    assert torch.load(weights / "head_last.pth", weights_only=True)["epoch"] == EPOCHS
    stats = weights / "target_norm_stats.json"
    assert stats.exists() == trained["name"].startswith("nreg")


def _eval_args(trained, out):
    return ["-c", str(trained["cfg"]), "--checkpoint", str(trained["head"]), "--output-dir", str(out)]


def test_evaluate_matches_the_jax_cli(trained, tmp_path):
    evaluate(_eval_args(trained, tmp_path / "port") + ["--device", "cpu"])
    jax_evaluate(_eval_args(trained, tmp_path / "jax"))
    ours = json.loads((tmp_path / "port" / "metrics.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    assert ours["files"] == theirs["files"] and len(ours["files"]) == N_IMAGES
    assert set(ours["metrics"]) == set(theirs["metrics"])
    for key, value in theirs["metrics"].items():
        np.testing.assert_allclose(ours["metrics"][key], value, rtol=1e-4, err_msg=key)
    assert ours["args"]["device"] == "cpu"


def _predictions(path):
    payload = json.loads(path.read_text())
    return payload, np.array([[row[t] for t in payload["targets"]] for row in payload["predictions"]])


def test_inference_matches_the_jax_cli(trained, tmp_path):
    args = _eval_args(trained, tmp_path / "port") + [
        "--input-dir", str(trained["root"] / "images" / "dente"), "--batch-size", "5"]
    inference(args + ["--device", "cpu"])
    jax_inference([a.replace("port", "jax") for a in args])
    inference([a.replace("port", "conv") for a in args] + ["--device", "cpu", "--conv-kernel"])
    (ours, got), (theirs, want) = (_predictions(tmp_path / d / "predictions.json")
                                   for d in ("port", "jax"))
    assert [r["file"] for r in ours["predictions"]] == [r["file"] for r in theirs["predictions"]]
    assert got.shape == (N_IMAGES, 6) and np.isfinite(got).all()
    scale = np.abs(want).max(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(scale.max()))
    _, conv = _predictions(tmp_path / "conv" / "predictions.json")
    np.testing.assert_allclose(conv, got, rtol=0, atol=1e-5 * float(scale.max()))


def test_resume_from_a_head_checkpoint(trained, tmp_path):
    cfg = json.loads(trained["cfg"].read_text())
    cfg["run_dir"] = str(tmp_path / "resumed")
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    train(["-c", str(tmp_path / "cfg.json"), "--device", "cpu", "--max-epochs", "1",
           "--resume-checkpoint", str(trained["head"])])
    assert (tmp_path / "resumed" / "trained_weights" / "head_last.pth").exists()


@pytest.mark.parametrize("main", [train, evaluate, inference],
                         ids=["train_regression", "evaluate_regression", "inference_regression"])
def test_cli_without_device_cpu_refuses_to_run_without_cuda(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["-c", "unused.json", "--checkpoint", "unused.pth", "--input-dir", str(tmp_path)][
            :2 if main is train else None])


@pytest.mark.parametrize("name", CONFIGS)
def test_the_shipped_configs_orbax_vae_path_is_refused(name, tmp_path, monkeypatch):
    """The configs' ``vae.checkpoint`` as the JAX trainer leaves it, an orbax
    directory with no exported ``.pth`` beside it, is refused with the export
    command (``.../autoencoder_last.pth`` would be loaded instead)."""
    monkeypatch.chdir(tmp_path)  # the CLI creates the config's relative run_dir
    cfg = json.loads((ROOT / "config" / f"{name}.json").read_text())
    (tmp_path / cfg["vae"]["checkpoint"]).mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax.*export_jax_checkpoint.py vae"):
        train(["-c", str(ROOT / "config" / f"{name}.json"), "--device", "cpu"])

"""AR-VAE training through the port's entry point on the CPU:
``cli.train_vae --device cpu`` on synthetic TIFs with an attributes JSON the
test writes, from the two AR configs of ``config/`` cut to toy width (their
``regularized_attributes`` blocks and ``@`` references kept): the flagship-like
``ar_vae_dente.json`` (two levels, attributes divided by 256) and the
kl1e3-like ``ar_vae_dente_kl1e3.json`` (three levels, adversarial branch from
epoch 1). The AR terms are logged per step and per validation, the split and
the checkpoints are written, and ``cli.evaluate_vae`` runs on the result.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from pti_ldm_vae_tpu_torch.cli.evaluate_vae import main as evaluate_main
from pti_ldm_vae_tpu_torch.cli.train_vae import main
from pti_ldm_vae_tpu_torch.data.io import write_tif

ROOT = Path(__file__).resolve().parents[1]
N_IMAGES = 12
STEPS_PER_EPOCH = 3  # 9 train images in batches of 4, the last one padded
EPOCHS = 2
ATTRS = ("height_0", "width_0", "width_1", "width_2", "width_3", "width_4")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """12 TIFs under ``<root>/data/dente`` and their six attributes (values of
    a few hundred, as the configs' divisor of 256 expects)."""
    root = tmp_path_factory.mktemp("torch_ar_train_cli")
    data = root / "data" / "dente"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    attrs = {}
    for i in range(N_IMAGES):
        img = rng.uniform(0.1, 1.0, size=(40, 40)).astype(np.float32)
        img[:4] = 0.0
        write_tif(str(data / f"img_{i:03d}.tif"), img)
        attrs[f"img_{i:03d}.tif"] = {name: float(rng.uniform(50, 400)) for name in ATTRS}
    (root / "attributes.json").write_text(json.dumps(attrs))
    return root


def _toy(root: Path, config: str, channels: list[int]) -> Path:
    """``config/<config>`` at toy width, pointed at the workspace."""
    cfg = json.loads((ROOT / "config" / config).read_text())
    cfg["data_base_dir"] = str(root / "data")
    cfg["run_dir"] = str(root / f"run_{Path(config).stem}")
    cfg["regularized_attributes"]["attribute_file"] = str(root / "attributes.json")
    cfg["train_split"] = 0.75
    cfg["autoencoder_def"].update(channels=channels, num_res_blocks=1, norm_num_groups=4,
                                  attention_levels=[False] * len(channels))
    cfg["autoencoder_train"].update(batch_size=4, patch_size=[32, 32], lr=1e-3, max_epochs=EPOCHS,
                                    adv_warmup_epochs=0)
    path = root / f"{Path(config).stem}_toy.json"
    path.write_text(json.dumps(cfg))
    return path


CASES = {"ar_vae_dente": ("ar_vae_dente.json", [8, 16]),
         "ar_vae_dente_kl1e3": ("ar_vae_dente_kl1e3.json", [8, 16, 16])}


@pytest.fixture(scope="module", params=list(CASES))
def run(workspace, request):
    config, channels = CASES[request.param]
    cfg_path = _toy(workspace, config, channels)
    result = main(["-c", str(cfg_path), "--device", "cpu", "--no-wandb", "--num-workers", "2",
                   "--conv-kernel"])
    run_dir = workspace / f"run_{request.param}"
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return dict(name=request.param, cfg_path=cfg_path, result=result, run_dir=run_dir, rows=rows,
                root=workspace)


def test_ar_terms_are_logged_per_step_and_per_validation(run):
    assert run["result"]["total_step"] == EPOCHS * STEPS_PER_EPOCH
    train_rows = [r for r in run["rows"] if "train/loss_total" in r]
    val_rows = [r for r in run["rows"] if "val/loss_total" in r]
    assert len(train_rows) == EPOCHS * STEPS_PER_EPOCH and len(val_rows) == EPOCHS
    for prefix, rows in (("train", train_rows), ("val", val_rows)):
        for r in rows:
            keys = {f"{prefix}/ar_loss_total"} | {f"{prefix}/ar_loss_{a}" for a in ATTRS}
            assert keys <= set(r), sorted(r)
            assert all(np.isfinite(r[k]) for k in r if k.startswith(prefix + "/"))
            assert r[f"{prefix}/ar_loss_total"] == pytest.approx(
                sum(r[f"{prefix}/ar_loss_{a}"] for a in ATTRS), rel=1e-5)
    # each epoch's last batch holds one real image and three padded rows: no pair
    # of samples is left, so its AR terms are 0; every other batch has pairs
    for step, r in enumerate(train_rows):
        last = step % STEPS_PER_EPOCH == STEPS_PER_EPOCH - 1
        assert (r["train/ar_loss_total"] == 0.0) if last else (r["train/ar_loss_total"] > 0)
    assert all(r["val/ar_loss_total"] > 0 for r in val_rows)  # 3 real images
    adversarial = [r["train/adv_disc_loss"] > 0 for r in train_rows[STEPS_PER_EPOCH:]]
    # only the kl1e3 config trains its discriminator (from epoch 1: adv_warmup_epochs 0)
    assert all(adversarial) if run["name"].endswith("kl1e3") else not any(adversarial)


def test_split_and_checkpoints(run):
    split = json.loads((run["run_dir"] / "splits" / "vae_split.json").read_text())
    assert len(split["train_files"]) == 9 and len(split["val_files"]) == 3
    weights = run["run_dir"] / "trained_weights"
    assert (weights / "autoencoder_last.pth").exists()
    assert (weights / "discriminator_last.pth").exists() == run["name"].endswith("kl1e3")


def test_evaluate_vae_on_the_trained_checkpoint(run, tmp_path):
    weights = run["run_dir"] / "trained_weights" / "autoencoder_last.pth"
    summary = evaluate_main(["-c", str(run["cfg_path"]), "--checkpoint", str(weights),
                             "--input-dir", str(run["root"] / "data"), "--output-dir",
                             str(tmp_path / "eval"), "--device", "cpu", "--batch-size", "4",
                             "--num-workers", "1"])
    written = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    assert summary and written
    assert all(np.isfinite(v) for v in summary.values() if isinstance(v, float))

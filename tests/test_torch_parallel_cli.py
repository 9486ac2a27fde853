"""The port's entry points under data parallelism, on the CPU.

* ``train_vae``: one ``torchrun --standalone --nproc_per_node 2`` launch of
  this file (the worker under ``__main__``) calls the CLI's ``main`` with
  ``--device cpu --batch-size 4``, which joins the gloo group from the
  torchrun environment; it is held to one process at ``--batch-size 8`` with
  twice the LR (the LR x ranks rule) on a toy config and 16 synthetic images
  (8 train, 8 validation: no loader pads). In the same launch a
  ``parallelism`` block whose ``data`` is not the number of ranks raises, and
  so does ``spatial`` (not ported: ROADMAP A.13). Only rank 0 writes the run
  directory: its files and ``metrics.jsonl`` lines are the one-process run's.
* ``sample_diffusion`` and ``run_pti`` split their rows over the ranks and
  never talk, so their splits run in this process as (rank 0, world 2) and
  (rank 1, world 2), with no group: together they write the files of world 1.
* ``train_diffusion`` under two ranks (``slow``): the same rows as one
  process at twice the batch, the same LR.

Bars (f32): logged losses rtol 1e-4 (the validation's after each update
too); parameters after the run: every entry within 2 lr per step, and at
least 99% of all entries within rtol 1e-4 / atol 1e-5 (an Adam step moves
an entry by about ``lr x sign(g)``, so an entry whose gradient is at the
rounding of its sums, which two orders of summation round apart, can take
either sign; the summed gradients themselves are held to one process in
``test_torch_parallel.py``); written images and latents within 1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu_torch.cli.run_pti import main as pti_main
from pti_ldm_vae_tpu_torch.cli.sample_diffusion import main as sample_main
from pti_ldm_vae_tpu_torch.cli.train_diffusion import main as diffusion_main
from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main
from pti_ldm_vae_tpu_torch.config import load_config
from pti_ldm_vae_tpu_torch.data.io import read_image, write_tif
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.parallel import maybe_initialize_distributed, mesh
from pti_ldm_vae_tpu_torch.train.loop import check_parallelism
from pti_ldm_vae_tpu_torch.utils.cli_common import load_ldm_models

ROOT = Path(__file__).resolve().parents[1]
AE_DEF = {
    "spatial_dims": 2, "in_channels": 1, "out_channels": 1, "latent_channels": 2,
    "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4, "norm_eps": 1e-6,
    "attention_levels": [False, False],
    "with_encoder_nonlocal_attn": True, "with_decoder_nonlocal_attn": False,
}
UNET_DEF = dict(spatial_dims=2, in_channels=2, out_channels=2, channels=[8, 16],
                attention_levels=[False, True], num_head_channels=[0, 8], num_res_blocks=1,
                with_conditioning=True, cross_attention_dim=16, norm_num_groups=4)
N_IMAGES = 16
LR, EPOCHS = 1e-3, 2


def _vae_config(root: Path, name: str, **extra) -> Path:
    train = {"batch_size": 4, "patch_size": [32, 32], "lr": LR, "perceptual_weight": 1.0,
             "kl_weight": 1e-3, "recon_loss": "l1", "adv_enabled": False,
             "max_epochs": EPOCHS, "val_interval": 1}
    path = root / f"{name}.json"
    path.write_text(json.dumps({
        "data_base_dir": str(root / "data"), "data_source": "dente", "train_split": 0.5,
        "run_dir": str(root / "runs" / name), "autoencoder_def": AE_DEF,
        "autoencoder_train": train, "wandb": {"enabled": False}, **extra}))
    return path


def _train_args(cfg: Path, batch: int, *extra: str) -> list[str]:
    return ["-c", str(cfg), "--device", "cpu", "--no-wandb", "--num-workers", "1",
            "--batch-size", str(batch), *extra]


def worker(mode: str, root: str) -> None:
    """One rank of a two-rank launch (the CLIs join the gloo group from the
    torchrun environment)."""
    root = Path(root)
    rank = int(os.environ["RANK"])
    if mode == "train_vae":
        refused = {}
        for name in ("data3", "spatial2"):
            try:
                train_main(_train_args(root / f"{name}.json", 4))
            except ValueError as exc:
                refused[name] = [type(exc).__name__, str(exc)]
        (root / f"refused_rank{rank}.json").write_text(json.dumps(refused))
        train_main(_train_args(root / "ddp.json", 4))
    elif mode == "train_diffusion":
        diffusion_main(["-c", str(root / "ldm_ddp.json"), "--input-dir", str(root / "imgs"),
                        "--device", "cpu", "--num-workers", "1", "--seed", "3",
                        "--batch-size", "2"])
    else:
        raise ValueError(mode)


def _torchrun(mode: str, root: Path) -> None:
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "PTI_LPIPS_WEIGHTS": "none"}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=2", __file__, mode, str(root)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"torchrun failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}"


@pytest.fixture(scope="module")
def vae_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel_cli")
    data = root / "data" / "dente"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        img = rng.uniform(0.1, 1.0, size=(40, 40)).astype(np.float32)
        img[:4] = 0.0
        write_tif(str(data / f"dente_{i:03d}.tif"), img)
    _vae_config(root, "data3", parallelism={"data": 3})
    _vae_config(root, "spatial2", parallelism={"spatial": 2, "tensor": 2})
    _vae_config(root, "ddp", parallelism={"data": 2})
    _torchrun("train_vae", root)
    # one process, the global batch, twice the LR
    train_main(_train_args(_vae_config(root, "single"), 8, "--lr", str(2 * LR)))
    return root


def _metrics(run: Path) -> list[dict]:
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def _close_params(got: dict, want: dict, steps: int, lr: float) -> None:
    """Every entry within 2 lr per step; at least 99% of all entries within
    rtol 1e-4 / atol 1e-5 (see the module's bars)."""
    assert got.keys() == want.keys()
    near = total = 0
    for key, w in want.items():
        g, w = got[key].numpy(), w.numpy()
        assert np.abs(g - w).max() <= 2 * lr * steps * 1.001, key
        near += int(np.isclose(g, w, rtol=1e-4, atol=1e-5).sum())
        total += w.size
    assert near / total >= 0.99, near / total


def test_two_ranks_train_like_one_process_at_the_global_batch(vae_runs):
    ddp, single = vae_runs / "runs" / "ddp", vae_runs / "runs" / "single"
    rows, want = _metrics(ddp), _metrics(single)
    assert len(rows) == len(want)
    assert sum("train/recon_loss" in r for r in want) == EPOCHS  # one global step an epoch
    assert sum("val/recon_loss" in r for r in want) == EPOCHS
    for got_row, want_row in zip(rows, want):
        assert got_row.keys() == want_row.keys()
        for key, value in want_row.items():
            if key.startswith(("train/", "val/")) and not key.endswith(("step", "count")):
                np.testing.assert_allclose(got_row[key], value, rtol=1e-4, err_msg=key)
            elif key not in ("_time", "time_per_epoch"):
                assert got_row[key] == value, key
    names = sorted(p.name for p in (single / "trained_weights").glob("autoencoder_*.pth"))
    assert "autoencoder_last.pth" in names and len(names) == 2  # last and best
    for name in names:
        _close_params(torch.load(ddp / "trained_weights" / name, weights_only=True),
                      torch.load(single / "trained_weights" / name, weights_only=True),
                      steps=EPOCHS, lr=2 * LR)


def test_only_rank0_writes_the_run_directory(vae_runs):
    def listing(run: Path) -> list[str]:
        return sorted(p.relative_to(run).as_posix() for p in run.rglob("*"))

    ddp, single = vae_runs / "runs" / "ddp", vae_runs / "runs" / "single"
    assert listing(ddp) == listing(single)
    split = json.loads((ddp / "splits" / "vae_split.json").read_text())
    assert len(split["train_files"]) == len(split["val_files"]) == N_IMAGES // 2


def test_parallelism_block_is_checked_on_every_rank(vae_runs):
    for rank in (0, 1):
        refused = json.loads((vae_runs / f"refused_rank{rank}.json").read_text())
        assert refused["data3"][0] == "ValueError" and "data=3" in refused["data3"][1]
        assert refused["spatial2"][0] == "ValueError"
        assert "mutually exclusive" in refused["spatial2"][1]
    assert not (vae_runs / "runs" / "data3").exists()
    assert not (vae_runs / "runs" / "spatial2").exists()


@pytest.mark.parametrize("block,error", [({"data": 2}, "data=2"),
                                         ({"tensor": 2}, "tensor=2 does not divide 1"),
                                         ({"spatial": 4, "data": 1},
                                          "tensor=4 does not divide 1")])
def test_parallelism_block_without_a_group(block, error):
    with pytest.raises(ValueError, match=error):
        check_parallelism(block, 1)


def test_parallelism_data_equal_to_the_world_is_accepted():
    check_parallelism({"data": 1, "spatial": 1, "tensor": 1}, 1)
    check_parallelism(None, 1)
    check_parallelism({"data": 4}, 4)


TORCHRUN_ENV = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                "MASTER_PORT": "29511"}


def test_no_torchrun_environment_starts_no_group(monkeypatch):
    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    assert maybe_initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()


def test_a_cuda_group_without_nccl_raises_instead_of_taking_gloo(monkeypatch):
    """No fallback: a CUDA run under torchrun needs NCCL (this PyTorch has
    none), and gloo, which would stage every collective through the host,
    is not taken in its place."""
    for key, value in TORCHRUN_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        maybe_initialize_distributed("cuda")
    assert not torch.distributed.is_initialized()


def test_a_partial_torchrun_environment_raises(monkeypatch):
    for key, value in TORCHRUN_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT missing"):
        maybe_initialize_distributed("cpu")


# ---- row splits of the entry points whose ranks do not talk ---------------------------

@pytest.fixture
def as_rank(monkeypatch):
    """Run an entry point as rank ``r`` of ``world`` (no group: its ranks
    never talk)."""
    def enter(rank: int, world: int) -> None:
        monkeypatch.setattr(mesh, "process_rank", lambda: rank)
        monkeypatch.setattr(mesh, "world_size", lambda: world)
    return enter


@pytest.fixture(scope="module")
def ldm(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel_ldm")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(1)
    for i in range(8):
        write_tif(str(root / "imgs" / f"img_{i:02d}.tif"),
                  rng.uniform(0.1, 1.0, size=(16, 16)).astype(np.float32))
    torch.manual_seed(0)
    vae_def = {**AE_DEF, "with_encoder_nonlocal_attn": False}
    torch.save(autoencoder_from_config(vae_def).state_dict(), root / "vae.pth")
    (root / "vae_config.json").write_text(json.dumps({
        "autoencoder_def": vae_def, "autoencoder_train": {"patch_size": [16, 16]}}))
    for name in ("ldm", "ldm_ddp", "ldm_single"):
        (root / f"{name}.json").write_text(json.dumps({
            "run_dir": str(root / "runs" / name),
            "vae": {"config_file": str(root / "vae_config.json"),
                    "checkpoint": str(root / "vae.pth")},
            "diffusion_def": UNET_DEF,
            "diffusion_train": {"batch_size": 4, "lr": 1e-3, "max_epochs": 2,
                                "num_train_timesteps": 50},
            "sampling": {"num_inference_steps": 3, "eta": 0.5},
            "wandb": {"enabled": False}}))
    # a random UNet and projector, as train_diffusion writes them
    torch.manual_seed(7)
    m = load_ldm_models(load_config(str(root / "ldm.json")), device=torch.device("cpu"))
    torch.save({"unet": m.unet.state_dict(), "projector": m.projector.state_dict()},
               root / "diffusion.pth")
    return root


def _images(out: Path, pattern: str) -> dict[str, np.ndarray]:
    return {p.name: read_image(str(p)) for p in sorted(out.glob(pattern))}


def test_sampling_split_writes_the_files_of_one_rank(ldm, as_rank):
    def sample(out: str) -> Path:
        return sample_main(["-c", str(ldm / "ldm.json"), "--checkpoint", str(ldm / "diffusion.pth"),
                            "--output-dir", str(ldm / out), "--num-images", "5",
                            "--condition-dir", str(ldm / "imgs"), "--device", "cpu",
                            "--num-workers", "1", "--seed", "5"])

    want = _images(sample("one"), "sample_*.tif")
    got = {}
    for rank in (0, 1):
        as_rank(rank, 2)
        part = _images(sample(f"rank{rank}"), "sample_*.tif")
        assert sorted(part) == [f"sample_{i:03d}.tif" for i in range(rank, 5, 2)]
        got.update(part)
    assert sorted(got) == sorted(want) == [f"sample_{i:03d}.tif" for i in range(5)]
    for name, image in want.items():
        np.testing.assert_allclose(got[name], image, rtol=1e-4, atol=1e-4, err_msg=name)


def test_sampling_refuses_a_rank_without_rows(ldm, as_rank):
    as_rank(2, 3)
    with pytest.raises(ValueError, match="no sample"):
        sample_main(["-c", str(ldm / "ldm.json"), "--checkpoint", str(ldm / "diffusion.pth"),
                     "--output-dir", str(ldm / "none"), "--num-images", "2",
                     "--condition-dir", str(ldm / "imgs"), "--device", "cpu"])


def test_pti_split_tunes_each_image_once(ldm, as_rank):
    vae_cfg = ldm / "pti_vae.json"
    vae_cfg.write_text(json.dumps({"spatial_dims": 2, "autoencoder_def": {
        **AE_DEF, "with_encoder_nonlocal_attn": False},
        "autoencoder_train": {"patch_size": [16, 16]}}))

    def pti(out: str) -> Path:
        return pti_main(["-c", str(vae_cfg), "--checkpoint", str(ldm / "vae.pth"),
                         "--input-dir", str(ldm / "imgs"), "--output-dir", str(ldm / out),
                         "--batch-size", "2", "--num-samples", "5", "--num-workers", "1",
                         "--latent-steps", "3", "--tune-steps", "2", "--tune-lr", "1e-3",
                         "--device", "cpu"])

    one = pti("pti_one")
    names = [f"img_{i:02d}" for i in range(5)]
    for rank in (0, 1):
        as_rank(rank, 2)
        out = pti(f"pti_rank{rank}")
        assert sorted(p.stem for p in out.glob("*_pti.tif")) == [
            f"{n}_pti" for n in names[rank::2]]
        for name in names[rank::2]:
            got, want = np.load(out / f"{name}_pivot.npz"), np.load(one / f"{name}_pivot.npz")
            for key in ("latent", "latent_loss", "tune_loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name} {key}")
            np.testing.assert_allclose(read_image(str(out / f"{name}_pti.tif")),
                                       read_image(str(one / f"{name}_pti.tif")),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


def test_pti_vmap_form_split_tunes_each_image_once(ldm, as_rank):
    """The row split hands each rank's rows to the ``vmap`` form too: two
    ranks write the files of one process, with its values."""
    vae_cfg = ldm / "pti_vae_vmap.json"
    vae_cfg.write_text(json.dumps({"spatial_dims": 2, "autoencoder_def": {
        **AE_DEF, "with_encoder_nonlocal_attn": False},
        "autoencoder_train": {"patch_size": [16, 16]}}))

    def pti(out: str) -> Path:
        return pti_main(["-c", str(vae_cfg), "--checkpoint", str(ldm / "vae.pth"),
                         "--input-dir", str(ldm / "imgs"), "--output-dir", str(ldm / out),
                         "--batch-size", "2", "--num-samples", "5", "--num-workers", "1",
                         "--latent-steps", "3", "--tune-steps", "2", "--tune-lr", "1e-3",
                         "--tune-formulation", "vmap", "--device", "cpu"])

    one = pti("pti_vmap_one")
    names = [f"img_{i:02d}" for i in range(5)]
    for rank in (0, 1):
        as_rank(rank, 2)
        out = pti(f"pti_vmap_rank{rank}")
        assert sorted(p.stem for p in out.glob("*_pti.tif")) == [
            f"{n}_pti" for n in names[rank::2]]
        for name in names[rank::2]:
            got, want = np.load(out / f"{name}_pivot.npz"), np.load(one / f"{name}_pivot.npz")
            for key in ("latent", "latent_loss", "tune_loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name} {key}")
            np.testing.assert_allclose(read_image(str(out / f"{name}_pti.tif")),
                                       read_image(str(one / f"{name}_pti.tif")),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.slow
def test_train_diffusion_two_ranks_like_one_process(ldm):
    """Two ranks at batch 2 against one process at batch 4, the same LR: the
    same images per step, the same encoder noise, timesteps and noise rows."""
    _torchrun("train_diffusion", ldm)
    diffusion_main(["-c", str(ldm / "ldm_single.json"), "--input-dir", str(ldm / "imgs"),
                    "--device", "cpu", "--num-workers", "1", "--seed", "3", "--batch-size", "4"])
    runs = ldm / "runs"
    got, want = _metrics(runs / "ldm_ddp"), _metrics(runs / "ldm_single")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train/eps_mse"], w["train/eps_mse"], rtol=1e-4)
    ckpt = "trained_weights/diffusion_last.pth"
    g, w = (torch.load(runs / name / ckpt, weights_only=True) for name in ("ldm_ddp", "ldm_single"))
    for part in ("unet", "projector"):
        _close_params(g[part], w[part], steps=4, lr=1e-3)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])

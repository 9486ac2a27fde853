"""The port's profiling utilities (CPU): ``StepTimer`` against the JAX
package's on a patched clock, ``trace_if`` on ``torch.profiler``, and the
trainer's ``--trace-at-step`` / ``--profile-port``."""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.utils import profiling as jax_profiling
from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_vae
from pti_ldm_vae_tpu_torch.data.io import write_tif
from pti_ldm_vae_tpu_torch.utils import profiling


def _clock(monkeypatch, module, ticks):
    values = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(values))


def test_step_timer_summary_equals_jax(monkeypatch):
    ticks = [10.0, 10.5, 11.25, 11.5, 13.0, 13.125, 14.0, 14.75]  # init, 5 ticks, reset, tick
    _clock(monkeypatch, profiling, ticks)
    ours = profiling.StepTimer()
    for _ in range(5):
        ours.tick()
    ours.reset()
    ours.tick()
    _clock(monkeypatch, jax_profiling, ticks)
    theirs = jax_profiling.StepTimer()
    for _ in range(5):
        theirs.tick()
    theirs.reset()
    theirs.tick()
    assert ours.summary() == theirs.summary()
    assert ours.summary()["steps"] == 6
    monkeypatch.undo()
    assert profiling.StepTimer().summary() == {}


def test_a_disabled_trace_writes_nothing(tmp_path):
    with profiling.trace_if(tmp_path / "traces", enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "traces").exists()


def _trace_events(folder: Path) -> list[dict]:
    files = sorted(folder.glob("*.pt.trace.json*"))
    assert len(files) == 1, files
    opener = gzip.open if files[0].suffix == ".gz" else open
    with opener(files[0], "rt") as fh:
        return json.load(fh)["traceEvents"]


def test_trace_if_writes_a_readable_chrome_trace(tmp_path):
    with profiling.trace_if(tmp_path / "traces"):
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    names = {e.get("name") for e in _trace_events(tmp_path / "traces")}
    assert "aten::matmul" in names


def test_start_profiler_server_raises():
    with pytest.raises(NotImplementedError, match="no live profiler endpoint.*--trace-at-step"):
        profiling.start_profiler_server(9999)


def _toy_run(tmp_path: Path, flags: list[str]) -> dict:
    data = tmp_path / "data" / "dente"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(8):
        write_tif(str(data / f"img_{i:02d}.tif"), rng.uniform(0.1, 1.0, (40, 40)).astype(np.float32))
    cfg = {
        "data_base_dir": str(tmp_path / "data"), "data_source": "dente", "train_split": 0.75,
        "run_dir": str(tmp_path / "run"),
        "autoencoder_def": {"spatial_dims": 2, "in_channels": 1, "out_channels": 1,
                            "latent_channels": 3, "channels": [8, 16], "num_res_blocks": 1,
                            "norm_num_groups": 4, "norm_eps": 1e-6,
                            "attention_levels": [False, False],
                            "with_encoder_nonlocal_attn": True,
                            "with_decoder_nonlocal_attn": True},
        "autoencoder_train": {"batch_size": 2, "patch_size": [32, 32], "lr": 1e-3,
                              "perceptual_weight": 0.0, "kl_weight": 1e-3, "recon_loss": "l1",
                              "adv_enabled": False, "max_epochs": 1, "val_interval": 1},
        "wandb": {"enabled": False},
    }
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    return train_vae(["-c", str(tmp_path / "cfg.json"), "--device", "cpu", "--no-wandb",
                      "--num-workers", "1", *flags])


def test_train_vae_traces_the_asked_step(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    result = _toy_run(tmp_path, ["--trace-at-step", "2"])
    assert result["total_step"] == 3  # 6 train images in batches of 2
    assert "[INFO] profiler trace captured at step 2" in capsys.readouterr().out
    events = _trace_events(tmp_path / "run" / "traces")
    names = {e.get("name", "") for e in events}
    # one step: the forward's convolutions and the backward's autograd nodes
    assert any("conv" in n for n in names) and any("Backward" in n for n in names)


def test_train_vae_profile_port_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="not ported.*--trace-at-step"):
        _toy_run(tmp_path, ["--profile-port", "9012"])
    assert not (tmp_path / "run").exists()  # refused before anything is written

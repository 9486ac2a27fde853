"""Whole runs of the harness on the CPU at a tiny size (the look for a card
skipped): a sound run is correct and prints the contract's line; the float8
control and each fault the cells can have, planted in the program, come out
not correct; a run that loaded the JAX stack, or found no card, prints no
result; a cell added by files alone runs."""

from __future__ import annotations

import hashlib
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import run as harness
from benchmark.check import verdict
from benchmark.tests.tiny import make_checkout

SEED = 2**31 + 77
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
CELLS = ["train.flagship.b128", "train.kl1e3.b64", "eval.flagship.b64"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory) -> Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))


def run_cell(checkout: Path, monkeypatch, capsys, workload: str, *extra: str, seed: int = SEED):
    monkeypatch.chdir(checkout)
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", "0", *extra], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 and out else None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_prints_the_contract_line(checkout, monkeypatch, capsys, workload):
    rc, result = run_cell(checkout, monkeypatch, capsys, workload)
    assert rc == 0 and result["correct"] is True
    assert set(result) == RESULT_KEYS and list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    manifest = json.loads((checkout / "BENCHMARK.json").read_text())
    assert set(result["metrics"]) == {m["name"] for m in harness.cell_metrics(manifest, workload,
                                                                               "end_to_end")}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_float8_control_fails_the_limits(checkout, monkeypatch, capsys, workload):
    rc, result = run_cell(checkout, monkeypatch, capsys, workload, "--control", "fp8")
    assert rc == 0 and result["correct"] is True
    limits = {k: v["limit"] for k, v in result["checks"].items()}
    control = result["controls"]["fp8"]
    assert not verdict({k: (v, limits[k]) for k, v in control.items() if k in limits})


def _unchanged_state(monkeypatch):
    from pti_ldm_vae_tpu_torch.train.state import GanTrainState

    def apply_g(self):
        self.optimizer_g.zero_grad(set_to_none=True)
        self.step += 1

    monkeypatch.setattr(GanTrainState, "apply_g", apply_g)


def _half_batch_train(monkeypatch):
    from pti_ldm_vae_tpu_torch.train.loop import VAETrainer

    device_batch = VAETrainer._device_batch

    def half(self, batch):
        images, mask, attributes = device_batch(self, batch)
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return images, mask, attributes

    monkeypatch.setattr(VAETrainer, "_device_batch", half)


def _altered_row(monkeypatch):
    from pti_ldm_vae_tpu_torch.data.loader import ShardedDataLoader

    make = ShardedDataLoader._make_batch

    def altered(self, idx):
        out = make(self, idx)
        out["image"][0] = -out["image"][0]
        return out

    monkeypatch.setattr(ShardedDataLoader, "_make_batch", altered)


def _eval_fault(monkeypatch, kind):
    from pti_ldm_vae_tpu_torch.cli import evaluate_vae

    evaluate = evaluate_vae.evaluate_batch

    def faulty(model, images, mask, **kw):
        if kind == "half_batch":  # the batch's second half left out, the means over the first
            half = images.shape[0] // 2
            images, mask = images[:half], mask[:half]
        out = evaluate(model, images, mask, **kw)
        if kind == "altered":  # two samples' answers exchanged
            for name in ("psnr", "ssim", "mse", "mae"):
                out[name] = torch.cat([out[name][1:2], out[name][0:1], out[name][2:]])
        return out

    monkeypatch.setattr(evaluate_vae, "evaluate_batch", faulty)


@pytest.mark.parametrize("workload,fault", [
    ("train.flagship.b128", "unchanged"), ("train.flagship.b128", "half_batch"),
    ("train.flagship.b128", "altered"), ("train.kl1e3.b64", "unchanged"),
    ("train.kl1e3.b64", "half_batch"), ("train.kl1e3.b64", "altered"),
    ("eval.flagship.b64", "half_batch"), ("eval.flagship.b64", "altered"),
])
def test_a_fault_in_the_timed_path_is_not_correct(checkout, monkeypatch, capsys, workload, fault):
    if workload.startswith("eval"):
        _eval_fault(monkeypatch, fault)
    else:
        {"unchanged": _unchanged_state, "half_batch": _half_batch_train,
         "altered": _altered_row}[fault](monkeypatch)
    rc, result = run_cell(checkout, monkeypatch, capsys, workload)
    assert rc == 0 and result["correct"] is False


@pytest.mark.parametrize("name,flagged", [("jax", True), ("jaxlib.xla_client", True),
                                          ("flax.linen", True), ("optax", True), ("orbax", True),
                                          ("pti_ldm_vae_tpu", True), ("pti_ldm_vae_tpu.ops", True),
                                          ("pti_ldm_vae_tpu_torch", False),
                                          ("jaxtyping", False)])
def test_foreign_modules_by_whole_top_level_name(name, flagged):
    from benchmark.harness import foreign_modules

    assert (foreign_modules({name: None}) != []) == flagged


def test_a_run_that_loaded_jax_prints_no_result(checkout, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, result = run_cell(checkout, monkeypatch, capsys, "eval.flagship.b64")
    assert rc != 0 and result is None


def test_no_card_no_result(checkout, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.chdir(checkout)
    rc = harness.main(["--workload", "eval.flagship.b64", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out.strip() == ""


def test_a_cell_added_by_files_alone(checkout, tmp_path, monkeypatch, capsys):
    import shutil

    root = tmp_path / "co"
    shutil.copytree(checkout, root)
    bench = root / "benchmark"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in bench.rglob("*") if p.is_file()}
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "flagship.json").read_text())
    cfg["config"]["autoencoder_def"]["num_res_blocks"] = 2
    (bench / "configs" / "flagship_deep.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "train.b128.json").read_text())
    traffic["batch_size"] = 4
    (bench / "traffic" / "train.b4.json").write_text(json.dumps(traffic))
    (bench / "limits" / "train.flagship_deep.b4.json").write_text(
        (bench / "limits" / "train.flagship.b128.json").read_text())
    (bench / "metrics" / "steps.train.py").write_text(
        "def read(run):\n    return float(run.counts['steps'])\n")
    manifest["configs"].append({**manifest["configs"][0], "name": "flagship_deep",
                                "file": "benchmark/configs/flagship_deep.json"})
    manifest["workloads"].append({"name": "train.flagship_deep.b4", "config": "flagship_deep",
                                  "traffic": "train.b4", "chips": 1, "why": "a cell of files"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_imgs_per_s":
            m["workloads"].append("train.flagship_deep.b4")
    manifest["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                                  "source": "host_clock", "layer": "step",
                                  "moves": "train_imgs_per_s",
                                  "workloads": ["train.flagship_deep.b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    rc, result = run_cell(root, monkeypatch, capsys, "train.flagship_deep.b4")
    assert rc == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"train_imgs_per_s", "setup_s"}
    per_layer = harness.cell_metrics(manifest, "train.flagship_deep.b4", "per_layer")
    assert [m["name"] for m in per_layer] == ["steps.train"]
    reader = harness.load_module(bench / "metrics" / "steps.train.py", "metric_steps_train")
    assert reader.read(types.SimpleNamespace(counts={"steps": 3})) == 3.0
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before  # no file of the benchmark was edited


@pytest.mark.cuda
def test_a_cell_on_the_card(tmp_path):
    """One short untraced and traced run of the evaluation cell on the card
    (``python -m pytest benchmark/tests -m cuda`` on a machine with one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess

    repo = Path(__file__).resolve().parents[2]
    for trace in ("0", "1"):
        proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                               "eval.flagship.b64", "--seed", str(SEED), "--seconds", "3",
                               "--trace", trace], cwd=repo, capture_output=True, text=True,
                              timeout=900)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True

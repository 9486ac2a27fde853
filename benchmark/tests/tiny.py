"""A checkout of the benchmark with tiny cells the CPU runs in seconds: the
same entries, references and readers, at widths a test can hold."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _ae(latent: int) -> dict:
    return {"spatial_dims": 2, "in_channels": 1, "out_channels": 1, "latent_channels": latent,
            "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4, "norm_eps": 1e-6,
            "attention_levels": [False, False], "with_encoder_nonlocal_attn": True,
            "with_decoder_nonlocal_attn": True}


def tiny_config(name: str) -> dict:
    """The named configuration of the benchmark with its widths cut for the CPU."""
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    latent = 8 if cfg["config"]["regularized_attributes"].get("enabled") else 4
    cfg["config"]["autoencoder_def"] = _ae(latent)
    cfg["config"]["latent_channels"] = latent
    cfg["config"]["autoencoder_train"]["patch_size"] = [32, 32]
    cfg.update(images_per_domain=40, source_hw=[40, 40], precision="float32")
    return cfg


# the evaluation cell, whose files are in ``benchmark/`` but which BENCHMARK.json
# leaves out (its run-to-run spread on the card is wider than a bound may be)
EVAL_CELL = "eval.flagship.b64"
EVAL_E2E = [
    {"name": "infer_imgs_per_s", "unit": "imgs/s", "better": "higher", "bound": 0.25,
     "source": "host_clock", "workloads": [EVAL_CELL]},
    {"name": "infer_batch_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock", "workloads": [EVAL_CELL]},
]
EVAL_PER_LAYER = {"loader_wait_share": "lower", "mfu": "higher", "glue_share": "lower",
                  "gn_silu_roofline": "higher", "idle_share": "lower", "peak_gb": "lower"}


def with_eval_cell(manifest: dict) -> dict:
    manifest["workloads"].append({"name": EVAL_CELL, "config": "flagship", "traffic": "eval.b64",
                                  "chips": 1, "why": "evaluate_vae batches"})
    manifest["end_to_end"] += EVAL_E2E
    manifest["per_layer"] += [{"name": f"{m}.infer", "unit": "%", "better": better,
                               "source": "device_trace", "layer": m, "moves": "infer_imgs_per_s",
                               "workloads": [EVAL_CELL]} for m, better in EVAL_PER_LAYER.items()]
    return manifest


def make_checkout(root: Path) -> Path:
    """``root`` holding BENCHMARK.json (with the evaluation cell) and
    ``benchmark/`` with each cell cut to a tiny size (batch 8, 36 training
    images: the last batch of an epoch padded)."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = with_eval_cell(json.loads((REPO / "BENCHMARK.json").read_text()))
    bench = root / "benchmark"
    for c in manifest["configs"]:
        (bench / "configs" / f"{c['name']}.json").write_text(json.dumps(tiny_config(c["name"])))
    for w in manifest["workloads"]:
        path = bench / "traffic" / f"{w['traffic']}.json"
        traffic = json.loads(path.read_text())
        traffic.update(batch_size=8, num_workers=2, check_block_rows=4)
        path.write_text(json.dumps(traffic))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root

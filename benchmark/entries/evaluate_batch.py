"""Entry ``evaluate_batch``: ``evaluate_vae``'s loop on one card, through
its public pieces: the model and the loader built as the CLI builds them
(``load_config_and_model`` on a checkpoint file, ``build_inference_dataloader``
over the input folder), then ``evaluate_batch`` per batch, its metrics read
to the host as ``evaluate`` reads them. The folder is evaluated again and
again until the window closes.

Each batch's time runs from the request to the loader to its results on
the host. ``correct`` compares a sample of the window's batches, drawn from
the seed (the first and the last always among them), with the reference.
"""

from __future__ import annotations

import copy
import gc
import json
import random

import numpy as np
import torch

from .. import check, inputs
from ..harness import Run, Window, now_ns
from ..reference.preprocess import preprocess
from ..reference.train import evaluate_batch as reference_batch
from ..reference.train import reference_ops
from ..reference.vae import VAE
from ..work import count

BATCH_TERMS = ("recon_loss", "kl_loss", "perceptual_loss", "loss_total")
SAMPLE_TERMS = ("psnr", "ssim", "mse", "mae")
SAMPLE_FROM = 32  # the compared batches are drawn from the window's first ones


class EvaluateBatch:
    def __init__(self, run: Run):
        self.run = run

    def setup(self) -> None:
        from pti_ldm_vae_tpu_torch.utils.cli_common import (build_inference_dataloader,
                                                            load_config_and_model)

        run, traffic = self.run, self.run.traffic
        t0 = now_ns()
        self.n_images = int(run.config["images_per_domain"])
        self.src_hw = tuple(run.config["source_hw"])
        raw = inputs.raw_images(self.n_images, self.src_hw, run.seed, run.device)
        self.input_dir = run.scratch / "data"
        inputs.write_dataset(self.input_dir, raw, None, [])
        del raw
        t_data = now_ns()
        self.cfg = copy.deepcopy(run.config["config"])
        self.ae = self.cfg["autoencoder_def"]
        cfg_path, ckpt = run.scratch / "config.json", run.scratch / "vae.pth"
        cfg_path.write_text(json.dumps(self.cfg))
        weights = inputs.vae_weights(self.ae, run.seed, run.device)
        torch.save({k: v.cpu() for k, v in weights.items()}, ckpt)
        config, self.model = load_config_and_model(str(cfg_path), str(ckpt), device=run.device,
                                                   conv_kernel=bool(traffic["conv_kernel"]))
        self.loader, _ = build_inference_dataloader(
            input_dir=str(self.input_dir), config=config, batch_size=int(traffic["batch_size"]),
            num_samples=None, num_workers=int(traffic["num_workers"]))
        self.recon_kind = config.autoencoder_train.get("recon_loss", "l1")
        self.perceptual_weight = float(config.autoencoder_train["perceptual_weight"])
        self.lpips = {**inputs.nested(inputs.lpips_weights(run.seed, run.device)),
                      "_pretrained": torch.zeros((), device=run.device)}
        self.generator = inputs.generator(run.seed, "noise", run.device)
        rng = random.Random(inputs.derive(run.seed, "sample"))
        self.sample = {0, *rng.sample(range(1, SAMPLE_FROM), int(traffic["check_batches"]) - 2)}
        self.kept: dict[int, tuple] = {}
        self.results: list[dict] = []
        self.valid: list[int] = []
        self.latency_ns: list[int] = []
        self.images = 0.0
        t_built = now_ns()
        self._batches(None, int(traffic["warmup_batches"]))
        run.notes.append(f"setup s: data {(t_data - t0) / 1e9:.2f} "
                         f"model {(t_built - t_data) / 1e9:.2f} "
                         f"warm-up {(now_ns() - t_built) / 1e9:.2f}")
        self.kept.clear()
        self.results.clear()
        self.valid.clear()
        self.latency_ns.clear()
        self.images = 0.0
        run.sync()

    def _batches(self, window: Window | None, limit: int | None) -> None:
        """Evaluate batches until ``limit`` of them or until the window closes."""
        from pti_ldm_vae_tpu_torch.cli.evaluate_vae import evaluate_batch

        run, device = self.run, self.run.device
        it = iter(self.loader)
        n = 0
        last = None
        while limit is None or n < limit:
            if window is not None and window.due():
                window.close()
                break
            start = now_ns()
            batch = next(it, None)
            if batch is None:  # the folder is done: evaluate it again
                it = iter(self.loader)
                batch = next(it)
            run.span("loader_wait", start)
            state = self.generator.get_state()
            images = torch.from_numpy(batch["image"]).to(device)
            mask = torch.from_numpy(batch["mask"]).to(device)
            out = evaluate_batch(self.model, images, mask, recon_kind=self.recon_kind,
                                 perceptual_weight=self.perceptual_weight,
                                 lpips_params=self.lpips, generator=self.generator)
            read = now_ns()
            valid = int(batch["mask"].sum())
            result = {name: float(out[name]) for name in BATCH_TERMS}
            result.update({name: out[name][:valid].cpu().tolist() for name in SAMPLE_TERMS})
            run.span("read", read)
            self.latency_ns.append(now_ns() - start)
            self.results.append(result)
            self.valid.append(valid)
            self.images += valid
            if n in self.sample:
                self.kept[n] = (batch, state)
            last = (n, batch, state)
            n += 1
        if last is not None:
            self.kept[last[0]] = last[1:]

    def window(self) -> None:
        run = self.run
        window = Window(run)
        window.open()
        self._batches(window, None)
        ms = np.asarray(self.latency_ns) / 1e6
        run.end_to_end["infer_imgs_per_s"] = self.images / run.window_s
        run.end_to_end["infer_batch_ms_p95"] = float(np.percentile(ms, 95))
        run.counts.update(batches=len(self.results), images=self.images)
        self.loader.close()
        del self.model
        gc.collect()
        if run.cuda:
            torch.cuda.empty_cache()

    def attempted(self) -> tuple[int, int]:
        return int(self.run.counts["images"]), 0

    def work(self) -> None:
        run, tr = self.run, self.run.traffic
        patch = tuple(self.cfg["autoencoder_train"]["patch_size"])
        flops, log = count.evaluation(self.ae, int(tr["batch_size"]), patch, self.perceptual_weight)
        run.work = count.scaled([(run.counts["batches"], flops, log)], run.config["precision"],
                                bool(tr["conv_kernel"]))

    def check(self) -> None:
        run = self.run
        patch = tuple(self.cfg["autoencoder_train"]["patch_size"])
        ref_images = preprocess(inputs.raw_images(self.n_images, self.src_hw, run.seed, run.device),
                                patch)
        vae = VAE(self.ae, reference_ops())
        P = inputs.vae_weights(self.ae, run.seed, run.device)
        L = inputs.lpips_weights(run.seed, run.device)
        block = int(run.traffic["check_block_rows"])
        loader_gap, loader_control, compared = 0.0, 0.0, []
        for n, (batch, state) in sorted(self.kept.items()):
            rows = torch.from_numpy(batch["image"]).to(run.device)
            mask = torch.from_numpy(batch["mask"]).to(run.device)
            valid = mask > 0
            idx, gap = check.identify(rows[valid], ref_images)
            if len(set(idx.tolist())) != len(idx):
                gap = float("inf")
            loader_gap = max(loader_gap, gap)
            image = torch.zeros_like(rows)
            image[valid] = ref_images[idx]
            loader_control = max(loader_control, check.bf16_loader_gap(image))
            g = torch.Generator(device=run.device)
            g.set_state(state)
            eps = torch.randn(vae.latent_shape(rows.shape[0], *patch), generator=g,
                              device=run.device)
            compared.append((n, {"image": image, "mask": mask, "eps": eps}, int(valid.sum())))
        del ref_images

        def answers(ops_precision: str, alter=None) -> list[dict]:
            out = []
            for _, b, valid in compared:
                if alter is not None:
                    b = alter(b)
                r = reference_batch(VAE(self.ae, reference_ops(ops_precision)), P, L, b,
                                    self.perceptual_weight, self.recon_kind, block)
                out.append({k: (float(v) if k in BATCH_TERMS else v[:valid]) for k, v in r.items()})
            return out

        def numbers(prog: list[dict], ref: list[dict]) -> dict[str, float]:
            """``loss_gap.<term>``: the worst compared batch's relative gap;
            ``metric_gap.<metric>``: the worst sample's."""
            out = {f"loss_gap.{k}": max(check.rel(p[k], r[k]) for p, r in zip(prog, ref))
                   for k in BATCH_TERMS}
            for k in SAMPLE_TERMS:  # rows with no answer are counted in answers_missing
                out[f"metric_gap.{k}"] = max(float(check.sample_gaps(
                    torch.as_tensor(p[k][:len(r[k])]), torch.as_tensor(r[k][:len(p[k])])).max())
                    for p, r in zip(prog, ref))
            return out

        ref = answers("f32")
        prog = [self.results[n] for n, _, _ in compared]
        for k in BATCH_TERMS:
            run.notes.append(f"{k} " + " ".join(f"{p[k]:.6g}/{r[k]:.6g}"
                                                for p, r in zip(prog, ref)))
        # every answer due in the window: each valid row's metrics came back
        missing = sum(v - min(len(r[k]) for k in SAMPLE_TERMS)
                      for r, v in zip(self.results, self.valid))
        check.record(run, {"loader_gap": loader_gap, "answers_missing": float(missing),
                           **numbers(prog, ref)})
        run.counts["compared_batches"] = len(compared)
        del vae
        for variant in run.control:
            if variant == "fp8":
                other = answers("fp8")
            elif variant == "half_batch":  # half of each batch left out, the mean over the rest
                def half(b):
                    mask = b["mask"].clone()
                    mask[len(mask) // 2:] = 0
                    return {**b, "mask": mask}

                other = answers("f32", half)
            elif variant == "altered":  # two samples' answers exchanged
                other = [{k: (torch.cat([v[1:2], v[0:1], v[2:]]) if k in SAMPLE_TERMS else v)
                          for k, v in o.items()} for o in ref]
            else:
                raise ValueError(f"unknown control {variant!r}")
            run.controls[variant] = numbers(other, ref)
        if "fp8" in run.controls:
            run.controls["fp8"]["loader_gap"] = loader_control


def make(run: Run) -> EvaluateBatch:
    return EvaluateBatch(run)

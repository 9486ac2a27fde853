"""Entry ``train_epoch``: ``train_vae``'s epoch loop on one card, driven
through the public trainer: ``VAETrainer.train_epoch(e)`` then
``validate(e)``, epoch after epoch (checkpoint writes left out).

Set-up builds the trainer on the benchmark's TIFs, puts the benchmark's
weights, LPIPS features and posterior-noise generator in place, and runs
``warmup_steps`` steps of epoch 0 and one ``validate``: every shape of the
window is built and warm then. Those first steps are also what ``correct``
compares: the same trainer object then runs the window.

The window opens at the first batch request of epoch 1 and closes, after a
device sync, at the first request after ``seconds`` have passed. A
:class:`Feed` stands in for the public ``trainer.train_loader``: it keeps
``set_epoch`` / ``__iter__`` / ``close``, times each request (the
``loader_wait`` spans) and ends the epoch whose request comes after the
window closed.
"""

from __future__ import annotations

import copy
import gc
from typing import Any

import torch

from .. import check, inputs
from ..harness import Run, Window, now_ns
from ..reference.preprocess import preprocess
from ..reference.train import Objective, reference_ops, train_steps
from ..reference.vae import VAE
from ..work import count

DATA_SOURCE = "dente"


class Feed:
    """Stands in for a trainer's loader: times requests, counts what the
    window ran, ends an epoch at ``limit`` batches or when the window closes,
    and hands each delivered batch to ``capture``."""

    def __init__(self, inner, run: Run, label: str = "loader_wait"):
        self.inner, self.run, self.label = inner, run, label
        self.window: Window | None = None
        self.limit: int | None = None
        self.on_request = None
        self.capture: list | None = None
        self.batches = 0
        self.images = 0.0
        self.loop_end_ns = 0

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def close(self) -> None:
        self.inner.close()

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        k = 0
        while True:
            if self.on_request is not None:
                self.on_request(k)
            if self.limit is not None and k >= self.limit:
                break
            window = self.window
            if window is not None and not window.closed and window.due():
                window.close()
            if window is not None and window.closed:
                break
            start = now_ns()
            batch = next(it, None)
            if batch is None:
                break
            self.run.span(self.label, start)
            if window is not None:
                self.batches += 1
                self.images += float(batch["mask"].sum())
            if self.capture is not None:
                self.capture.append(batch)
            k += 1
            yield batch
        self.loop_end_ns = now_ns()


def run_config(run: Run, data_root, attribute_file) -> dict[str, Any]:
    cfg = copy.deepcopy(run.config["config"])
    cfg["data_base_dir"] = str(data_root)
    cfg["run_dir"] = str(run.scratch / "run")
    cfg["data_source"] = DATA_SOURCE
    cfg["autoencoder_train"]["batch_size"] = int(run.traffic["batch_size"])
    if attribute_file is not None:
        cfg["regularized_attributes"]["attribute_file"] = str(attribute_file)
    cfg["wandb"] = {**cfg.get("wandb", {}), "enabled": False}
    return cfg


def attribute_names(cfg: dict) -> list[str]:
    reg = cfg.get("regularized_attributes") or {}
    if not reg.get("enabled", False):
        return []
    return [k for k in reg["attribute_latent_mapping"] if not str(k).startswith("_")]


def objective(cfg: dict, adv: bool) -> Objective:
    train = cfg["autoencoder_train"]
    names = attribute_names(cfg)
    reg = cfg.get("regularized_attributes") or {}
    mapping = reg.get("attribute_latent_mapping", {})
    if names and reg.get("pairwise", "all") != "all":
        raise ValueError("the reference computes the attribute term over all pairs only")
    default_delta = (reg.get("delta_global") or {}).get("value")
    return Objective(
        kl_weight=float(train["kl_weight"]), perceptual_weight=float(train["perceptual_weight"]),
        recon_kind=train.get("recon_loss", "l1"),
        adv_weight=float(train.get("adv_weight", 0.5)) if adv else None,
        ar_channels=tuple(int(mapping[n]["latent_channel"]) for n in names),
        ar_deltas=tuple(float(mapping[n].get("delta", default_delta)) for n in names),
        ar_gamma=float(reg.get("gamma", 0.0)) if names else 0.0)


def _norms(tensors: list[torch.Tensor]) -> list[float]:
    return torch.stack([t.detach().float().norm() for t in tensors]).tolist()


class TrainEpoch:
    def __init__(self, run: Run):
        self.run = run

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from pti_ldm_vae_tpu_torch.train.loop import VAETrainer

        run, traffic = self.run, self.run.traffic
        t0 = now_ns()
        self.n_images = int(run.config["images_per_domain"])
        self.src_hw = tuple(run.config["source_hw"])
        base = run.config["config"]
        self.attr_names = attribute_names(base)
        raw = inputs.raw_images(self.n_images, self.src_hw, run.seed, run.device)
        attrs = (inputs.attributes(self.n_images, self.attr_names, run.seed, run.device)
                 if self.attr_names else None)
        data_root = run.scratch / "data"
        attr_file = inputs.write_dataset(data_root / DATA_SOURCE, raw, attrs, self.attr_names)
        del raw, attrs
        t_data = now_ns()
        self.cfg = run_config(run, data_root, attr_file)
        self.ae = self.cfg["autoencoder_def"]
        trainer = VAETrainer(self.cfg, device=run.device, seed=run.seed,
                             num_workers=int(traffic["num_workers"]), use_wandb=False,
                             conv_kernel=bool(traffic["conv_kernel"]))
        self.trainer = trainer
        # the compared steps (epoch 0) and the window (epochs 1, 2, ...) run one GAN phase
        self.adv = trainer._adv_active(0)
        if trainer._adv_active(1) != self.adv:
            raise ValueError("the warm-up epoch and the window would run different GAN phases")
        with torch.no_grad():
            trainer.model.load_state_dict(inputs.vae_weights(self.ae, run.seed, run.device))
            if trainer.disc is not None:
                trainer.disc.load_state_dict(inputs.disc_weights(run.seed, run.device))
        trainer.lpips_params = {**inputs.nested(inputs.lpips_weights(run.seed, run.device)),
                                "_pretrained": torch.zeros((), device=run.device)}
        trainer.generator = inputs.generator(run.seed, "noise", run.device)
        self.feed = Feed(trainer.train_loader, run)
        self.val_feed = Feed(trainer.val_loader, run, label="validate")
        trainer.train_loader, trainer.val_loader = self.feed, self.val_feed
        t_built = now_ns()
        self._warm_up()
        run.notes.append(f"setup s: data {(t_data - t0) / 1e9:.2f} "
                         f"trainer {(t_built - t_data) / 1e9:.2f} "
                         f"warm-up {(now_ns() - t_built) / 1e9:.2f}")

    def _warm_up(self) -> None:
        run, trainer, feed = self.run, self.trainer, self.feed
        steps = int(run.traffic["warmup_steps"])
        self.payloads: list[dict] = []
        log = trainer.logger.log

        def logged(payload, step=None):
            if "train/step" in payload:
                self.payloads.append(dict(payload))
            log(payload, step=step)

        self.states: list[torch.Tensor] = []
        self.batches: list[dict] = []
        self.grad_norms: dict[str, dict[str, float]] = {}

        def on_request(k: int) -> None:
            if k == 1:  # step 0's updates are enqueued: Adam's first moment is (1 - b1) g
                self.grad_norms = self._first_gradients()
            if k < steps:
                self.states.append(trainer.generator.get_state())

        trainer.logger.log = logged
        feed.limit, feed.on_request, feed.capture = steps, on_request, self.batches
        trainer.train_epoch(0)
        trainer.validate(0)
        trainer.logger.log = log
        feed.limit, feed.on_request, feed.capture = None, None, None
        self.change_norms = self._changes()
        run.sync()

    def _models(self):
        t = self.trainer
        out = [("g", t.model, t.state.optimizer_g)]
        if t.disc is not None and self.adv:
            out.append(("d", t.disc, t.state.optimizer_d))
        return out

    def _first_gradients(self) -> dict[str, dict[str, float]]:
        out = {}
        for key, model, opt in self._models():
            b1 = opt.param_groups[0]["betas"][0]
            named = list(model.named_parameters())
            # a leaf the optimizer never stepped holds no moment: its gradient reads 0
            zero = torch.zeros((), device=self.run.device)
            norms = _norms([opt.state[p].get("exp_avg", zero) for _, p in named])
            out[key] = {name: n / (1 - b1) for (name, _), n in zip(named, norms)}
        return out

    def _changes(self) -> dict[str, dict[str, float]]:
        run = self.run
        start = {"g": inputs.vae_weights(self.ae, run.seed, run.device),
                 "d": inputs.disc_weights(run.seed, run.device)}
        out = {}
        for key, model, _ in self._models():
            named = list(model.named_parameters())
            out[key] = dict(zip([n for n, _ in named],
                                _norms([p.detach() - start[key][n] for n, p in named])))
        return out

    # -- window -------------------------------------------------------------
    def window(self) -> None:
        run, trainer = self.run, self.trainer
        window = Window(run)
        self.feed.window = self.val_feed.window = window
        self.epochs = 0
        window.open()
        epoch = 1
        while True:
            trainer.train_epoch(epoch)
            run.span("epoch_end", self.feed.loop_end_ns)
            if window.closed:
                break
            self.epochs += 1
            start = now_ns()
            trainer.validate(epoch)
            run.span("validate", start)
            epoch += 1
        run.end_to_end["train_imgs_per_s"] = self.feed.images / run.window_s
        run.counts.update(steps=self.feed.batches, images=self.feed.images,
                          val_batches=self.val_feed.batches, epochs=self.epochs)
        trainer.close()
        del self.trainer, trainer
        gc.collect()
        if run.cuda:
            torch.cuda.empty_cache()

    def attempted(self) -> tuple[int, int]:
        return int(self.run.counts["images"]), 0

    # -- work ---------------------------------------------------------------
    def work(self) -> None:
        run, tr = self.run, self.run.traffic
        b, patch = int(tr["batch_size"]), tuple(self.cfg["autoencoder_train"]["patch_size"])
        obj = objective(self.cfg, self.adv)
        parts = [(run.counts["steps"], *count.train_step(self.ae, obj, b, patch)),
                 (run.counts["val_batches"], *count.validation_step(self.ae, obj, b, patch)),
                 (run.counts["epochs"], *count.reconstruct(self.ae, 1, patch))]
        run.work = count.scaled(parts, run.config["precision"], bool(tr["conv_kernel"]))

    # -- correct ------------------------------------------------------------
    def _reference_batches(self) -> tuple[list[dict], float, float]:
        """The compared steps' batches as the reference makes them from the raw
        images (each program row found by its content), the loader's gap, and
        the gap it reads with each batch's first row altered where the loader
        produced it (the fault reading of ``loader_gap``)."""
        run = self.run
        patch = tuple(self.cfg["autoencoder_train"]["patch_size"])
        ref_images = preprocess(inputs.raw_images(self.n_images, self.src_hw, run.seed, run.device),
                                patch)
        ref_attrs = (inputs.attributes(self.n_images, self.attr_names, run.seed, run.device)
                     if self.attr_names else None)
        vae = VAE(self.ae, reference_ops())
        batches, gap, altered, seen = [], 0.0, 0.0, []
        self.loader_control = 0.0
        for state, batch in zip(self.states, self.batches):
            rows = torch.from_numpy(batch["image"]).to(run.device)
            mask = torch.from_numpy(batch["mask"]).to(run.device)
            valid = mask > 0
            idx, row_gap = check.identify(rows[valid], ref_images)
            gap = max(gap, row_gap)
            bad = rows[valid].clone()
            bad[0] = -bad[0]
            altered = max(altered, check.identify(bad, ref_images)[1])
            seen += idx.tolist()
            image = torch.zeros_like(rows)
            image[valid] = ref_images[idx]
            self.loader_control = max(self.loader_control, check.bf16_loader_gap(image))
            ref = {"image": image, "mask": mask}
            if ref_attrs is not None:
                prog = torch.stack([torch.from_numpy(batch["attributes"][n])
                                    for n in self.attr_names], dim=1).to(run.device)
                attrs = torch.zeros_like(prog)
                attrs[valid] = ref_attrs[idx]
                gap = max(gap, float((prog - attrs).abs().max()))
                ref["attrs"] = attrs
            g = torch.Generator(device=run.device)
            g.set_state(state)
            ref["eps"] = torch.randn(vae.latent_shape(rows.shape[0], *patch), generator=g,
                                     device=run.device)
            batches.append(ref)
        if len(set(seen)) != len(seen):
            gap = float("inf")  # a row delivered twice in the compared steps
        del ref_images
        return batches, gap, altered

    def _numbers(self, prog: dict, ref: dict, note: bool = False) -> dict[str, float]:
        """``loss_gap.<term>`` for each loss term the step reports (worst
        step), ``grad_gap.<g|d>`` and ``change_gap.<g|d>`` for the generator
        and the discriminator (worst leaf)."""
        out: dict[str, float] = {}
        for term in ref["terms"][0]:
            if all(r[term] == 0 for r in ref["terms"]):
                continue  # a term the step does not compute
            out[f"loss_gap.{term}"] = max(check.rel(p[term], r[term])
                                          for p, r in zip(prog["terms"], ref["terms"]))
        for key in ("g", "d"):
            if ref.get("grad_" + key) is None or key not in prog["grad"]:
                continue
            rg = {k: float(v.norm()) for k, v in ref["grad_" + key].items()}
            start = ref["start_" + key]
            rc = {k: float((ref["params_" + key][k] - start[k]).norm()) for k in start}
            moved = check.moved_leaves(rg)
            out[f"grad_gap.{key}"] = check.leaf_gap(prog["grad"][key], rg)
            out[f"change_gap.{key}"] = check.leaf_gap(prog["change"][key], rc, moved)
            if note:
                self.run.notes += [f"change {key}: {len(moved)} of {len(rc)} leaves compared",
                                   f"grad {key}: " + check.worst_leaves(prog["grad"][key], rg),
                                   f"change {key}: " + check.worst_leaves(prog["change"][key], rc,
                                                                          moved)]
        if note:
            self.run.notes += ["loss_total " + " ".join(
                f"{p['loss_total']:.6g}/{r['loss_total']:.6g}"
                for p, r in zip(prog["terms"], ref["terms"]))]
        return out

    def _reference(self, batches: list[dict], precision: str = "f32") -> dict:
        run = self.run
        start_g = inputs.vae_weights(self.ae, run.seed, run.device)
        start_d = inputs.disc_weights(run.seed, run.device) if self.adv else None
        out = train_steps(VAE(self.ae, reference_ops(precision)), objective(self.cfg, self.adv),
                          start_g, start_d, inputs.lpips_weights(run.seed, run.device), batches,
                          float(self.cfg["autoencoder_train"]["lr"]),
                          int(run.traffic["check_block_rows"]))
        out.update(start_g=start_g, start_d=start_d)
        return out

    def check(self) -> None:
        run = self.run
        batches, loader_gap, altered = self._reference_batches()
        ref = self._reference(batches)
        prog = {"terms": [{k.removeprefix("train/"): v for k, v in p.items()}
                          for p in self.payloads],
                "grad": self.grad_norms, "change": self.change_norms}
        numbers = {"loader_gap": loader_gap, **self._numbers(prog, ref, note=True)}
        check.record(run, numbers)
        for variant in run.control:
            if variant == "altered":
                run.controls[variant] = {"loader_gap": altered}
            else:
                run.controls[variant] = self._control(variant, batches, ref)
        if "fp8" in run.controls:
            run.controls["fp8"]["loader_gap"] = self.loader_control

    def _control(self, variant: str, batches: list[dict], ref: dict) -> dict[str, float]:
        """The reference in the program's place: in float8 (the control), or
        with half of each batch left out (the mean taken over the rest)."""
        if variant == "fp8":
            other = self._reference(batches, "fp8")
        elif variant == "half_batch":
            changed = []
            for b in batches:
                b = dict(b, mask=b["mask"].clone())
                b["mask"][b["mask"].shape[0] // 2:] = 0
                changed.append(b)
            other = self._reference(changed)
        else:
            raise ValueError(f"unknown control {variant!r}")
        prog = {"terms": other["terms"],
                "grad": {k: {n: float(v.norm()) for n, v in other["grad_" + k].items()}
                         for k in ("g", "d") if other.get("grad_" + k) is not None},
                "change": {k: {n: float((other["params_" + k][n] - other["start_" + k][n]).norm())
                               for n in other["start_" + k]}
                           for k in ("g", "d") if other.get("params_" + k) is not None}}
        return self._numbers(prog, ref)


def make(run: Run) -> TrainEpoch:
    return TrainEpoch(run)

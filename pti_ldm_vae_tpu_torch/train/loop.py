"""VAE training orchestration — the ``train_vae`` workload (counterpart of
``pti_ldm_vae_tpu/train/loop.py``).

Behavioral equivalent of the reference script (``vae_scripts/train_vae.py``):
config -> loaders -> models/optimizers -> epoch loop with per-epoch
validation, last/best checkpointing, metric logging, validation triplet dumps,
resume (from the run's own checkpoints or from a reference full checkpoint
file). With ``adv_enabled`` (the default, as in the reference) a PatchGAN
discriminator trains beside the autoencoder once ``epoch >
adv_warmup_epochs`` (default 5: the reference hardcodes ``epoch > 5``,
``train_vae.py:399,449``); one train and one eval step are built per phase.

* one device, no mesh: the batch goes to the trainer's device as it is;
* bf16 compute / f32 parameters and Adam state by default on CUDA, f32 on the
  CPU or when ``mixed_precision=False``;
* metrics stay on the device during an epoch and are read after it: a host
  read per step would stall the launch queue;
* the host loader's prefetch overlaps IO with device compute.

With AR-VAE on (``regularized_attributes.enabled`` or
``autoencoder_train.ar_vae_enabled``) the loaders carry each image's
attributes and the steps add the attribute term at ``gamma``; its totals and
per-attribute terms are logged as ``train/ar_loss_*`` and ``val/ar_loss_*``.

``trace_at_step=N`` captures a ``torch.profiler`` trace of global step N
into ``run_dir/traces`` (``utils/profiling.py:trace_if``; the device is
synchronized inside the traced block, so the step's kernels end within it).

Top-level model knobs as in the JAX trainer: ``remat`` (activation
checkpointing of the ResBlocks and attention blocks), ``norm_stats`` and
``s2d_stem`` (default ``"auto"``, resolved here on the batch with the train
profile of ``ops/space_to_depth.py:s2d_auto_mode``; ``"encoder"``,
``"decoder"`` and booleans pass as they are). Not ported yet, and raising
when configured: ``parallelism``. ``profile_port`` raises: torch has no live
profiler endpoint.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..checkpoint.reference_resume import load_reference_checkpoint
from ..config import filter_comment_keys, resolve_bool
from ..data.factory import create_vae_dataloaders
from ..data.io import write_tif
from ..losses.ar_vae import ARVaeSpec, make_ar_vae_spec
from ..losses.composite import compute_total_loss
from ..models.autoencoder_kl import autoencoder_from_config
from ..models.discriminator import PatchDiscriminator
from ..models.lpips import load_lpips_params, lpips_is_pretrained
from ..ops.norm import DEFAULT_NORM_STATS
from ..ops.space_to_depth import s2d_auto_mode
from ..utils.determinism import set_determinism
from ..utils.logging import MetricLogger, init_wandb_config
from ..utils.profiling import start_profiler_server, trace_if
from ..utils.visualization import normalize_batch_for_display
from .state import create_train_state
from .steps import LossConfig, make_eval_step, make_inference_fn, make_train_step

__all__ = ["VAETrainer", "build_ar_spec", "resolve_ar_settings"]


def resolve_ar_settings(cfg: dict[str, Any]) -> dict[str, Any]:
    """AR-VAE flags from both config blocks (reference ``train_vae.py:776-792``)."""
    reg = cfg.get("regularized_attributes") or {}
    train = cfg.get("autoencoder_train", {})
    enabled = resolve_bool(train.get("ar_vae_enabled", False)) or resolve_bool(
        reg.get("enabled", False)
    )
    raw_gamma = train.get("ar_vae_weight", reg.get("gamma", 0.0))
    if isinstance(raw_gamma, str):
        try:
            gamma = float(raw_gamma)
        except ValueError:
            gamma = float(reg.get("gamma", 0.0))
    else:
        gamma = float(raw_gamma)
    return {
        "enabled": enabled,
        "gamma": gamma,
        "pairwise": reg.get("pairwise", "all"),
        "subset_pairs": reg.get("subset_pairs"),
        "block": reg,
    }


def build_ar_spec(cfg: dict[str, Any], ar: dict[str, Any]) -> ARVaeSpec | None:
    """The AR-VAE spec of a config (JAX ``train/loop.py:262-270``), or None
    when the term is off; an enabled term without an attribute mapping raises."""
    if not ar["enabled"]:
        return None
    mapping = filter_comment_keys(ar["block"].get("attribute_latent_mapping", {}))
    if not mapping:
        raise ValueError("attribute_latent_mapping must be provided when AR-VAE is enabled.")
    return make_ar_vae_spec(
        mapping, pairwise_mode=ar["pairwise"], subset_pairs=ar["subset_pairs"],
        delta_global=ar["block"].get("delta_global"),
        latent_dim=cfg["autoencoder_def"]["latent_channels"])


def _not_ported(what: str, later: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet; it comes with {later}")


class VAETrainer:
    def __init__(
        self,
        cfg: dict[str, Any],
        *,
        device: torch.device | str = "cuda",
        seed: int = 42,
        num_workers: int = 4,
        cache_rate: float = 0.0,
        subset_size: int | None = None,
        resume: bool | None = None,
        mixed_precision: bool | None = None,
        log_every: int = 1,
        use_wandb: bool | None = None,
        profile_port: int | None = None,
        trace_at_step: int | None = None,
        conv_kernel: bool = False,
    ):
        self.cfg = cfg
        self.seed = seed
        self.rank = 0
        self.world = 1
        self.device = torch.device(device)
        if profile_port:
            start_profiler_server(profile_port)
        self.trace_at_step = trace_at_step

        train_cfg = cfg["autoencoder_train"]
        self.batch_size = int(train_cfg["batch_size"])
        self.patch_size = tuple(train_cfg["patch_size"])
        self.max_epochs = int(train_cfg["max_epochs"])
        self.val_interval = int(train_cfg.get("val_interval", 1))
        self.adv_enabled = resolve_bool(train_cfg.get("adv_enabled", True))
        self.adv_warmup_epochs = int(train_cfg.get("adv_warmup_epochs", 5))
        self.run_dir = Path(cfg["run_dir"])
        self.model_dir = self.run_dir / "trained_weights"
        self.resume = resolve_bool(cfg.get("resume_ckpt", False)) if resume is None else resume
        self.log_every = log_every
        self.ar = resolve_ar_settings(cfg)

        if self.adv_enabled and int(cfg.get("spatial_dims", 2)) != 2:
            raise _not_ported("the adversarial branch for spatial_dims other than 2 (a 1-D or "
                              "3-D PatchGAN discriminator)", "the 1-D / 3-D model slice")
        ar_spec = build_ar_spec(cfg, self.ar)
        if cfg.get("parallelism"):
            raise _not_ported("the 'parallelism' config block", "the multi-device slice")
        # "auto" resolves here from the train profile on the (one device's)
        # batch: the model's own "auto" gate is the inference profile
        s2d_stem = cfg.get("s2d_stem", "auto")
        if s2d_stem == "auto":
            s2d_stem = s2d_auto_mode("train", self.batch_size)
        elif s2d_stem not in ("encoder", "decoder"):
            s2d_stem = resolve_bool(s2d_stem)

        if mixed_precision is None:
            mixed_precision = self.device.type == "cuda"
        compute_dtype = torch.bfloat16 if mixed_precision else torch.float32

        # Overwrite protection (reference ``train_vae.py:794-803``).
        if self.run_dir.exists() and not self.resume and any(self.run_dir.iterdir()):
            raise ValueError(
                f"Run directory already exists: {self.run_dir}\n"
                "Change 'run_dir' in the config or set 'resume_ckpt: true'."
            )
        self.model_dir.mkdir(parents=True, exist_ok=True)
        (self.run_dir / "splits").mkdir(parents=True, exist_ok=True)

        # seeds python / numpy / torch (parameter init) and gives the device
        # generator the posterior noise is drawn from
        self.generator = set_determinism(seed, self.device)

        # ---- data -------------------------------------------------------
        self.train_loader, self.val_loader, train_paths, val_paths = create_vae_dataloaders(
            cfg["data_base_dir"],
            batch_size=self.batch_size,
            patch_size=self.patch_size,
            data_source=cfg.get("data_source", "edente"),
            train_split=cfg.get("train_split", 0.9),
            num_workers=num_workers,
            seed=seed,
            subset_size=subset_size,
            val_dir=cfg.get("val_dir"),
            cache_rate=cache_rate,
            ar_vae_enabled=self.ar["enabled"],
            regularized_attributes=self.ar["block"] or None,
        )
        split_payload = {
            "seed": seed,
            "train_split": cfg.get("train_split", 0.9),
            "subset_size": subset_size,
            "val_dir": cfg.get("val_dir"),
            "train_files": list(train_paths),
            "val_files": list(val_paths),
        }
        with open(self.run_dir / "splits" / "vae_split.json", "w", encoding="utf-8") as fh:
            json.dump(split_payload, fh, indent=2)

        # ---- models, optimizers -------------------------------------------
        self.model = autoencoder_from_config(
            cfg["autoencoder_def"], compute_dtype=compute_dtype,
            norm_stats=str(cfg.get("norm_stats", DEFAULT_NORM_STATS)), s2d_stem=s2d_stem,
            remat=resolve_bool(cfg.get("remat", False)), conv_kernel=conv_kernel,
        ).to(device=self.device, memory_format=torch.channels_last)
        self.disc = None
        if self.adv_enabled:
            # the reference's fixed PatchGAN (``train_vae.py:268-275``), its
            # init drawn from a generator of its own seeded from the run's seed
            self.disc = PatchDiscriminator(
                spatial_dims=cfg.get("spatial_dims", 2), num_layers_d=3, channels=32,
                in_channels=1, out_channels=1, compute_dtype=compute_dtype,
                generator=torch.Generator().manual_seed(seed + 1),
            ).to(device=self.device, memory_format=torch.channels_last)
        self.state = create_train_state(self.model, lr=float(train_cfg["lr"]),
                                        world_size=self.world, model_d=self.disc)

        # ---- losses -------------------------------------------------------
        self.lcfg = LossConfig(
            recon_loss=train_cfg.get("recon_loss", "l1"),
            kl_weight=float(train_cfg["kl_weight"]),
            perceptual_weight=float(train_cfg["perceptual_weight"]),
            adv_weight=float(train_cfg.get("adv_weight", 0.5)),
            ar_gamma=self.ar["gamma"],
            ar_vae_enabled=self.ar["enabled"],
            ar_spec=ar_spec,
            kl_mode=cfg.get("kl_mode", "reference"),
        )
        self.lpips_params = load_lpips_params(device=self.device)
        # whether the perceptual loss is real LPIPS or the random-feature
        # fallback is recorded in the run config: no silent fallback
        self.perceptual_pretrained = lpips_is_pretrained(self.lpips_params)
        if not self.perceptual_pretrained:
            print("[WARN] perceptual loss uses RANDOM features (no converted LPIPS weights "
                  "found: set $PTI_LPIPS_WEIGHTS or place weights/lpips_squeeze.npz)")

        # ---- steps (one per GAN phase) -----------------------------------
        phases = (False, True) if self.adv_enabled else (False,)
        self._train_steps = {on: make_train_step(self.model, self.disc, self.lcfg, adv_active=on)
                             for on in phases}
        self._eval_steps = {on: make_eval_step(self.model, self.disc, self.lcfg, adv_active=on)
                            for on in phases}
        self._triplet_infer = make_inference_fn(self.model)

        # ---- bookkeeping ---------------------------------------------------
        self.ckpt = CheckpointManager(str(self.model_dir))
        self.start_epoch = 0
        self.best_val_loss = 100.0
        self.total_step = 0
        if self.resume:
            ckpt_path = str(cfg.get("checkpoint_dir") or "")
            if ckpt_path and Path(ckpt_path).is_file():
                # a reference full checkpoint (torch .pth): weights, Adam
                # moments and counters load as they are, so a run started
                # under the torch reference continues here
                meta = load_reference_checkpoint(ckpt_path, self.state)
                print(f"[INFO] Resumed from reference checkpoint {ckpt_path} "
                      f"(epoch {meta['epoch']})")
            else:
                meta = self.ckpt.restore(self.state)
                if meta is None:
                    raise FileNotFoundError(f"No checkpoint to resume in {self.model_dir}")
            self.start_epoch = meta["epoch"] + 1
            self.best_val_loss = meta["best_val_loss"]
            self.total_step = meta["total_step"]

        wandb_cfg = cfg.get("wandb") or {}
        if use_wandb is False:
            wandb_cfg = {**wandb_cfg, "enabled": False}
        run_config = init_wandb_config(cfg)
        run_config["perceptual_pretrained"] = self.perceptual_pretrained
        self.logger = MetricLogger(str(self.run_dir), rank=self.rank, wandb_cfg=wandb_cfg,
                                   run_config=run_config)

    # -- helpers --------------------------------------------------------------
    def _device_batch(self, batch) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
        """Images, mask and (AR-VAE) attributes of a host batch on the device."""
        images = torch.from_numpy(batch["image"]).to(self.device, non_blocking=True)
        mask = torch.from_numpy(batch["mask"]).to(self.device, non_blocking=True)
        attributes = None
        if "attributes" in batch:
            attributes = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                          for k, v in batch["attributes"].items()}
        return images, mask, attributes

    def _adv_active(self, epoch: int) -> bool:
        return bool(self.adv_enabled and epoch > self.adv_warmup_epochs)

    def close(self) -> None:
        """Stop the loaders' decode threads and close the metric sink."""
        self.train_loader.close()
        self.val_loader.close()
        self.logger.finish()

    # -- epochs -----------------------------------------------------------------
    def train_epoch(self, epoch: int) -> None:
        self.train_loader.set_epoch(epoch)
        self.model.train()
        step_fn = self._train_steps[self._adv_active(epoch)]
        # Metrics stay on the device during the epoch (no host sync per step)
        # and are flushed after the last batch with correct step numbering;
        # the batch-0 debug print and triplet panel are deferred the same way.
        buffered: list[tuple[int, dict]] = []
        batch0: tuple[dict, torch.Tensor] | None = None
        for step, batch in enumerate(self.train_loader):
            images, mask, attributes = self._device_batch(batch)
            traced = self.trace_at_step is not None and self.total_step + 1 == self.trace_at_step
            with trace_if(self.run_dir / "traces", enabled=traced):
                _, metrics = step_fn(self.state, images, mask, attributes, self.lpips_params,
                                     generator=self.generator)
                if traced and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            if traced:
                print(f"[INFO] profiler trace captured at step {self.total_step + 1} "
                      f"-> {self.run_dir / 'traces'}")
            self.total_step += 1
            if step % self.log_every == 0:
                buffered.append((self.total_step, metrics))
            if step == 0:
                batch0 = (metrics, images[:1])
        if batch0 is not None:
            metrics0, img0 = batch0
            # KL-explosion debug stats (reference ``train_vae.py:432-442``)
            print(
                f"[DEBUG] Train batch0 stats | z_mu mean={float(metrics0['debug/z_mu_mean']):.4f} | "
                f"z_sigma mean={float(metrics0['debug/z_sigma_mean']):.4f} | "
                f"kl_loss={float(metrics0['train/kl_loss']):.4f}"
            )
            self._log_train_triplet(img0, epoch)
        for step_num, metrics in buffered:
            payload = {k: float(v) for k, v in metrics.items() if not k.startswith("debug/")}
            payload["train/step"] = step_num
            self.logger.log(payload, step=step_num)

    def _log_train_triplet(self, img: torch.Tensor, epoch: int) -> None:
        """[original | reconstruction | diff] panel for the epoch's first
        image, rot90 k=3 display convention (reference ``train_vae.py:479-493``);
        the reconstruction uses end-of-epoch weights."""
        recon = self._triplet_infer(img).cpu().numpy()
        img = img.cpu().numpy()
        diff = np.abs(img - recon)
        panels = np.concatenate([
            normalize_batch_for_display(img),
            normalize_batch_for_display(recon),
            normalize_batch_for_display(diff),
        ], axis=2)[0, :, :, 0]
        triplet = np.rot90(panels, k=3)
        self.logger.log_images("train/triplets", [(triplet * 255).astype(np.uint8)],
                               step=self.total_step)

    def validate(self, epoch: int) -> float:
        """Returns the epoch-mean reconstruction loss (the best-model
        criterion, reference ``validate`` -> ``val_recon_epoch_loss``)."""
        self.model.eval()
        eval_fn = self._eval_steps[self._adv_active(epoch)]
        sums: dict[str, torch.Tensor] | None = None
        n_batches = 0
        start_epoch_to_save, save_every = 10, 5
        do_save_images = epoch >= start_epoch_to_save and epoch % save_every == 0
        epoch_dir = self.run_dir / "validation_samples" / f"epoch_{epoch}"
        if do_save_images:
            for sub in ("originale", "reconstruction", "diff"):
                (epoch_dir / sub).mkdir(parents=True, exist_ok=True)

        dumps: list[tuple[int, torch.Tensor, torch.Tensor]] = []
        for step, batch in enumerate(self.val_loader):
            images, mask, attributes = self._device_batch(batch)
            metrics, recon = eval_fn(self.state, images, mask, attributes, self.lpips_params,
                                     generator=self.generator)
            # sums accumulate on the device; one host read after the loop
            sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
            n_batches += 1
            if do_save_images:
                dumps.append((step, images[0, :, :, 0], recon[0, :, :, 0]))

        for step, img_dev, rec_dev in dumps:
            img, rec = img_dev.cpu().numpy(), rec_dev.cpu().numpy()
            diff = np.abs(img - rec)
            # rot90 k=3 display convention (reference ``train_vae.py:616-618``)
            write_tif(str(epoch_dir / "originale" / f"step{step:03}.tif"), np.rot90(img, k=3))
            write_tif(str(epoch_dir / "reconstruction" / f"step{step:03}.tif"), np.rot90(rec, k=3))
            write_tif(str(epoch_dir / "diff" / f"step{step:03}.tif"), np.rot90(diff, k=3))

        means = {k: float(v) / max(n_batches, 1) for k, v in (sums or {}).items()}
        val_total = compute_total_loss(
            means.get("recon_loss", 0.0),
            means.get("kl_loss", 0.0),
            means.get("perceptual_loss", 0.0),
            means.get("adv_gen_loss", 0.0),
            means.get("ar_loss", 0.0),
            kl_weight=self.lcfg.kl_weight,
            perceptual_weight=self.lcfg.perceptual_weight,
            adv_weight=self.lcfg.adv_weight,
            ar_gamma=self.lcfg.ar_gamma,
            ar_vae_enabled=self.lcfg.ar_vae_enabled,
        )
        payload = {
            "val/recon_loss": means.get("recon_loss", 0.0),
            "val/kl_loss": means.get("kl_loss", 0.0),
            "val/perceptual_loss": means.get("perceptual_loss", 0.0),
            "val/adv_gen_loss": self.lcfg.adv_weight * means.get("adv_gen_loss", 0.0)
            if self.adv_enabled else 0.0,
            "val/adv_disc_loss": self.lcfg.adv_weight * means.get("adv_disc_loss", 0.0)
            if self.adv_enabled else 0.0,
            "val/loss_total": float(val_total),
            "epoch": epoch,
        }
        if self.lcfg.ar_vae_enabled:
            payload["val/ar_loss_total"] = means.get("ar_loss", 0.0)
            payload.update({f"val/{k}": v for k, v in means.items() if k.startswith("ar_loss_")})
        self.logger.log(payload)
        return means.get("recon_loss", 0.0)

    # -- main loop -------------------------------------------------------------
    def train(self) -> dict[str, Any]:
        try:
            for epoch in range(self.start_epoch, self.max_epochs):
                start_time = time.time()
                self.train_epoch(epoch)
                if epoch % self.val_interval == 0:
                    val_loss = self.validate(epoch)
                    elapsed = time.time() - start_time
                    print(f"Epoch {epoch} val_loss: {val_loss:.4f} | Time: {elapsed:.1f}s")
                    self.logger.log({"time_per_epoch": elapsed, "epoch": epoch})
                    self.best_val_loss = self.ckpt.save_epoch(
                        state=self.state,
                        epoch=epoch,
                        val_loss=val_loss,
                        best_val_loss=self.best_val_loss,
                        total_step=self.total_step,
                    )
        finally:
            self.close()
        return {"best_val_loss": self.best_val_loss, "total_step": self.total_step}

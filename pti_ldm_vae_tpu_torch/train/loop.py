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

* one device per process; under a process group (``parallel/``, launched by
  torchrun) each rank's loader takes its ``rank::world`` share of the files
  (``batch_size`` rows per rank and step), the losses are global masked
  means, each optimizer sums the ranks' gradients before its update, the LR
  is scaled by the number of ranks, and rank 0 alone writes the run
  directory (split, checkpoints, metrics, dumps, traces); the others wait
  at a barrier where they read what it wrote;
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

While a ``torch.profiler`` records (``trace_at_step``, a ``profile_port``
window, a caller's own profile), the loop records spans of its host work
(``utils/profiling.py:span``): ``train.step`` around each batch's copy and
step (``step`` and ``arg`` the global step), ``h2d`` around each batch's
copy to the device (``arg`` its bytes; inside ``train.step`` or
``val.epoch``), ``train.epoch_end`` around the epoch's triplet panel, debug
print and metric flush, ``val.epoch`` around the whole of :meth:`validate`
and ``ckpt.save`` around each epoch's checkpoint write; the loader adds
``loader.wait``. With no profiler recording, a span costs one flag read.

``profile_port=P`` serves live captures, the JAX trainer's
``jax.profiler.start_server`` (``utils/profiling.py:start_profiler_server``):
a listener on ``127.0.0.1`` takes requests for a window of D ms, and the
train loop records the window itself, from the first train-step boundary
after the request through the step at which D ms have passed, then sends the
trace back (``python -m pti_ldm_vae_tpu_torch.utils.profiling --port P
--duration-ms D --logdir DIR``). With no request pending a boundary costs one
attribute read, so the run's numbers are the bits of a run without the
flag. Every process serves one port, as every JAX process starts its own
server: under torchrun that is ``P + LOCAL_RANK``, since one machine holds
several of the port's processes (each its own card), and rank 0 prints the
ports of its machine. A window never overlaps the ``trace_at_step`` step: a
recording window ends at the boundary before it, and a request pending there
opens at the boundary after it.

Top-level model knobs as in the JAX trainer: ``remat`` (activation
checkpointing of the ResBlocks and attention blocks), ``norm_stats`` and
``s2d_stem`` (default ``"auto"``, resolved here on the batch with the train
profile of ``ops/space_to_depth.py:s2d_auto_mode``; ``"encoder"``,
``"decoder"`` and booleans pass as they are; ``"auto"`` decides on the
per-rank batch).

``parallelism`` (JAX ``train/loop.py:111-134``): ``{"spatial": M}`` shards
image height over ``M`` ranks (``parallel/spatial.py``), ``{"tensor": M}``
channels (``parallel/tensor.py``); ``data`` defaults to ``world // M``
(:func:`check_parallelism`). Rank ``r = d * M + m``: the ``M`` ranks of model
group ``d`` load the same rows (the loader's ``rank::world`` schedule runs on
``d`` over ``data``), so the global batch is ``data x batch_size`` rows and
the LR scales by ``data``; with ``data = 1`` the run is the one-process run.
Under tensor sharding the parameters are cut after every rank took rank 0's
initial values, before the optimizers are built. The triplet panel,
validation dumps, metrics and checkpoints are the unsharded run's (the
height tiles stitched, the channel blocks gathered).
"""

from __future__ import annotations

import json
import os
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
from ..models.autoencoder_kl import autoencoder_from_config, channels_last_format
from ..models.discriminator import PatchDiscriminator
from ..models.lpips import load_lpips_params, lpips_is_pretrained
from ..ops.norm import DEFAULT_NORM_STATS
from ..ops.space_to_depth import s2d_auto_mode
from ..parallel.mesh import (
    barrier_sync,
    broadcast_module,
    data_rank,
    data_size,
    first_local_rows,
    make_mesh,
    process_rank,
    set_mesh,
    world_size,
)
from ..parallel.multihost import torchrun_local_rank
from ..parallel.spatial import shard_batch_spatial, spatial
from ..parallel.tensor import tensor_parallel_params
from ..ops.space_to_depth import shard_height_multiple
from ..utils.determinism import set_determinism
from ..utils.logging import MetricLogger, init_wandb_config
from ..utils.profiling import span, start_profiler_server, trace_if
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


def check_parallelism(block: dict[str, Any] | None, world: int, *,
                      patch_size: tuple[int, ...] | None = None, levels: int = 1,
                      s2d: bool | str = False) -> tuple[str | None, int, int]:
    """The config's ``parallelism`` block against the process group, as the
    JAX trainer checks it (``train/loop.py:111-131``): ``spatial`` and
    ``tensor`` above 1 together raise (both ride the model axis); the model
    axis must divide the world; ``data`` defaults to ``world // model`` and
    must give ``data x model == world``. A rank drives one card, so the JAX
    case of fewer devices than the mesh (a sub-mesh of one process's chips)
    does not arise: every rank is in the mesh. Under spatial sharding the
    shard height ``patch_size[0] / M`` must divide by what the levels' halving
    needs (``ops/space_to_depth.py:shard_height_multiple``). Returns ``(kind,
    model, data)``, kind None without model parallelism."""
    block = block or {}
    spatial_m, tensor_m = int(block.get("spatial", 1)), int(block.get("tensor", 1))
    if spatial_m > 1 and tensor_m > 1:
        raise ValueError("parallelism 'spatial' and 'tensor' are mutually exclusive "
                         "(both shard over the model axis)")
    model = max(spatial_m, tensor_m)
    if world % model:
        raise ValueError(f"spatial/tensor={model} does not divide {world} rank(s)")
    data = int(block.get("data", world // model))
    if data * model != world:
        raise ValueError(f"parallelism data={data} x model={model} but the process group has "
                         f"{world} rank(s): launch one process per card with torchrun "
                         "--nproc_per_node")
    if spatial_m > 1 and patch_size is not None:
        need = shard_height_multiple(levels, s2d)
        if patch_size[0] % (spatial_m * need):
            raise ValueError(f"spatial={spatial_m} cuts height {patch_size[0]} into shards of "
                             f"{patch_size[0] / spatial_m:g} rows; {levels} levels"
                             f"{' with s2d_stem' if s2d else ''} need a multiple of {need}")
    kind = "spatial" if spatial_m > 1 else "tensor" if tensor_m > 1 else None
    return kind, model, data


def _host_bytes(batch: dict[str, Any]) -> int:
    """Bytes of a host batch's arrays (images, mask, attributes)."""
    arrays = [batch["image"], batch["mask"], *batch.get("attributes", {}).values()]
    return sum(a.nbytes for a in arrays)


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
        self.rank = process_rank()
        self.world = world_size()
        self.device = torch.device(device)
        self.trace_at_step = trace_at_step
        self.profiler_server = None

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

        disc_dims = int(cfg.get("spatial_dims", 2))
        if self.adv_enabled and disc_dims != int(cfg["autoencoder_def"].get("spatial_dims", 2)):
            # the JAX trainer builds its discriminator from the top-level key too, and its
            # init on the model's patch fails there
            raise ValueError(f"the discriminator's spatial_dims (top-level, {disc_dims}) differs "
                             f"from autoencoder_def's ({cfg['autoencoder_def'].get('spatial_dims', 2)})")
        ar_spec = build_ar_spec(cfg, self.ar)
        # "auto" resolves here from the train profile on the (one rank's)
        # batch: the model's own "auto" gate is the inference profile
        s2d_stem = cfg.get("s2d_stem", "auto")
        if s2d_stem == "auto":
            s2d_stem = s2d_auto_mode("train", self.batch_size)
        elif s2d_stem not in ("encoder", "decoder"):
            s2d_stem = resolve_bool(s2d_stem)
        kind, model_par, _ = check_parallelism(
            cfg.get("parallelism"), self.world, patch_size=self.patch_size,
            levels=len(cfg["autoencoder_def"]["channels"]), s2d=s2d_stem)
        # a model axis splits the ranks into data x model groups (every rank makes them)
        set_mesh(make_mesh(kind, model_par) if kind is not None else None)
        self.sharded = kind is not None
        self.data_rank, self.data = data_rank(), data_size()

        if mixed_precision is None:
            mixed_precision = self.device.type == "cuda"
        compute_dtype = torch.bfloat16 if mixed_precision else torch.float32

        # Overwrite protection (reference ``train_vae.py:794-803``): rank 0
        # decides before anything is written (a rank that raises ends the
        # torchrun launch; the others wait at the "run_dir" barrier below)
        if self.rank == 0:
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
            rank=self.data_rank,
            world_size=self.data,
        )
        split_payload = {
            "seed": seed,
            "train_split": cfg.get("train_split", 0.9),
            "subset_size": subset_size,
            "val_dir": cfg.get("val_dir"),
            "train_files": list(train_paths),
            "val_files": list(val_paths),
        }
        if self.rank == 0:
            with open(self.run_dir / "splits" / "vae_split.json", "w", encoding="utf-8") as fh:
                json.dump(split_payload, fh, indent=2)

        # ---- models, optimizers -------------------------------------------
        self.model = autoencoder_from_config(
            cfg["autoencoder_def"], compute_dtype=compute_dtype,
            norm_stats=str(cfg.get("norm_stats", DEFAULT_NORM_STATS)), s2d_stem=s2d_stem,
            remat=resolve_bool(cfg.get("remat", False)), conv_kernel=conv_kernel,
        )
        memory_format = channels_last_format(self.model.spatial_dims)
        self.model = self.model.to(device=self.device, memory_format=memory_format)
        self.disc = None
        if self.adv_enabled:
            # the reference's fixed PatchGAN (``train_vae.py:268-275``), its
            # init drawn from a generator of its own seeded from the run's seed
            self.disc = PatchDiscriminator(
                spatial_dims=disc_dims, num_layers_d=3, channels=32,
                in_channels=1, out_channels=1, compute_dtype=compute_dtype,
                generator=torch.Generator().manual_seed(seed + 1),
            ).to(device=self.device, memory_format=memory_format)
        # every rank starts from rank 0's parameters (the seeds make them
        # equal already; the broadcast makes it a property of the run)
        for module in (self.model, self.disc):
            if module is not None:
                broadcast_module(module)
                if kind == "tensor":  # channel blocks, as JAX shards before its optimizer
                    tensor_parallel_params(module)
        # the LR scales by the number of distinct batches a step sees
        self.state = create_train_state(self.model, lr=float(train_cfg["lr"]),
                                        world_size=self.data, model_d=self.disc)

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
        if not self.perceptual_pretrained and self.rank == 0:
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
        # the run directory exists from here on (rank 0 made it, or raised)
        barrier_sync("run_dir")
        self.ckpt = CheckpointManager(str(self.model_dir), rank=self.rank)
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
        if profile_port:
            # one port per process of this machine (the module docstring)
            port = profile_port + (torchrun_local_rank() or 0)
            try:
                self.profiler_server = start_profiler_server(port, device=self.device)
            except OSError:
                self.close()
                raise
            if self.rank == 0:
                local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
                ports = str(port) if local == 1 else f"{port}-{port + local - 1}"
                print(f"[INFO] profiler server on 127.0.0.1:{ports} (port + local rank); capture "
                      f"with python -m pti_ldm_vae_tpu_torch.utils.profiling --port {port} "
                      "--duration-ms D --logdir DIR")

    # -- helpers --------------------------------------------------------------
    def _device_batch(self, batch) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
        """Images, mask and (AR-VAE) attributes of a host batch on the device
        (under spatial sharding this rank's height tile of the images)."""
        if spatial():
            batch = shard_batch_spatial(batch)
        with span("h2d", arg=lambda: _host_bytes(batch)):
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
        """Stop the loaders' decode threads, close the metric sink and leave
        the mesh; an open profiler window ends and the profiler port closes."""
        if self.profiler_server is not None:
            self.profiler_server.close()
        self.train_loader.close()
        self.val_loader.close()
        self.logger.finish()
        set_mesh(None)

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
        server = self.profiler_server
        for step, batch in enumerate(self.train_loader):
            traced = (self.rank == 0 and self.trace_at_step is not None
                      and self.total_step + 1 == self.trace_at_step)
            if server is not None and server.request is not None:  # a capture is open
                server.step_boundary(self.total_step + 1, hold=traced)
            with trace_if(self.run_dir / "traces", enabled=traced), \
                    span("train.step", step=self.total_step + 1, arg=self.total_step + 1):
                images, mask, attributes = self._device_batch(batch)
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
        with span("train.epoch_end", step=self.total_step):
            self._flush_epoch(batch0, buffered)

    def _flush_epoch(self, batch0: tuple[dict, torch.Tensor] | None,
                     buffered: list[tuple[int, dict]]) -> None:
        """The epoch's deferred host work: the triplet panel and debug print
        of its first batch, then its buffered metrics."""
        if batch0 is not None:
            metrics0, img0 = batch0
            # every rank of a model group stitches or gathers the panel; rank 0 writes it
            triplet = self._train_triplet(img0) if self.rank == 0 or self.sharded else None
            if self.rank == 0:
                # KL-explosion debug stats (reference ``train_vae.py:432-442``)
                print(
                    f"[DEBUG] Train batch0 stats | z_mu mean="
                    f"{float(metrics0['debug/z_mu_mean']):.4f} | "
                    f"z_sigma mean={float(metrics0['debug/z_sigma_mean']):.4f} | "
                    f"kl_loss={float(metrics0['train/kl_loss']):.4f}"
                )
                self.logger.log_images("train/triplets", [(triplet * 255).astype(np.uint8)],
                                       step=self.total_step)
        for step_num, metrics in buffered:
            payload = {k: float(v) for k, v in metrics.items() if not k.startswith("debug/")}
            payload["train/step"] = step_num
            self.logger.log(payload, step=step_num)

    def _train_triplet(self, img: torch.Tensor) -> np.ndarray:
        """[original | reconstruction | diff] panel for the epoch's first
        image, rot90 k=3 display convention (reference ``train_vae.py:479-493``);
        the reconstruction uses end-of-epoch weights. Under a mesh every rank
        calls it (the model runs sharded)."""
        recon = first_local_rows(self._triplet_infer(img))
        img = first_local_rows(img)
        diff = np.abs(img - recon)
        panels = np.concatenate([
            normalize_batch_for_display(img),
            normalize_batch_for_display(recon),
            normalize_batch_for_display(diff),
        ], axis=2)[0, :, :, 0]
        return np.rot90(panels, k=3)

    def validate(self, epoch: int) -> float:
        """Returns the epoch-mean reconstruction loss (the best-model
        criterion, reference ``validate`` -> ``val_recon_epoch_loss``)."""
        with span("val.epoch", step=self.total_step):
            return self._validate(epoch)

    def _validate(self, epoch: int) -> float:
        self.model.eval()
        eval_fn = self._eval_steps[self._adv_active(epoch)]
        sums: dict[str, torch.Tensor] | None = None
        n_batches = 0
        start_epoch_to_save, save_every = 10, 5
        save_epoch = epoch >= start_epoch_to_save and epoch % save_every == 0
        do_save_images = self.rank == 0 and save_epoch
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
            if do_save_images or (save_epoch and spatial()):
                dumps.append((step, images[:1], recon[:1]))

        for step, img_dev, rec_dev in dumps:
            # every rank of a model group stitches its tiles; rank 0 writes
            img, rec = first_local_rows(img_dev)[0, :, :, 0], first_local_rows(rec_dev)[0, :, :, 0]
            if not do_save_images:
                continue
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
                    if self.rank == 0:
                        print(f"Epoch {epoch} val_loss: {val_loss:.4f} | Time: {elapsed:.1f}s")
                    self.logger.log({"time_per_epoch": elapsed, "epoch": epoch})
                    with span("ckpt.save", step=self.total_step):
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

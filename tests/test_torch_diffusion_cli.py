"""The port's diffusion CLIs on the CPU (``--device cpu``), on synthetic 16²
TIFs at the toy size of the JAX package's ``tests/test_diffusion_clis.py``:
``train_diffusion`` writes ``diffusion_last.pth`` (MONAI-keyed UNet plus
projector) and ``metrics.jsonl``, ``sample_diffusion`` reads it and writes
TIFs and PNGs; the unconditioned configuration runs both without a
projector; orbax directories, a run without ``--device cpu`` on a machine
without CUDA, and the unported ``remat`` are refused. The sampled latents are
held to a DDIM run of the same UNet, noise and context outside the CLI."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu_torch.checkpoint.unet_convert import (
    load_diffusion_checkpoint,
    unet_expected_torch_keys,
)
from pti_ldm_vae_tpu_torch.cli.sample_diffusion import main as sample_main
from pti_ldm_vae_tpu_torch.cli.train_diffusion import main as train_main
from pti_ldm_vae_tpu_torch.config import load_config
from pti_ldm_vae_tpu_torch.data.io import read_image, write_tif
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.unet import project_latent_condition
from pti_ldm_vae_tpu_torch.train.diffusion import ddim_sample
from pti_ldm_vae_tpu_torch.utils.cli_common import load_ldm_models

VAE_ARCH = dict(spatial_dims=2, in_channels=1, out_channels=1, latent_channels=2,
                channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
                attention_levels=[False, False], with_encoder_nonlocal_attn=False,
                with_decoder_nonlocal_attn=False)
UNET_DEF = dict(spatial_dims=2, in_channels=2, out_channels=2, channels=[8, 16],
                attention_levels=[False, True], num_head_channels=[0, 8], num_res_blocks=1,
                with_conditioning=True, cross_attention_dim=16, norm_num_groups=4)


def _ldm_config(root: Path, name: str, **diffusion_def) -> Path:
    path = root / f"{name}.json"
    path.write_text(json.dumps({
        "run_dir": str(root / "runs" / name),
        "vae": {"config_file": str(root / "vae_config.json"), "checkpoint": str(root / "vae.pth")},
        "diffusion_def": {**UNET_DEF, **diffusion_def},
        "diffusion_train": {"batch_size": 3, "lr": 1e-4, "max_epochs": 2, "num_train_timesteps": 50},
        "sampling": {"num_inference_steps": 4, "eta": 0.0},
        "wandb": {"enabled": False},
    }))
    return path


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldm_cli")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):  # two batches of 3, the second padded and masked
        write_tif(str(root / "imgs" / f"img_{i:02d}.tif"),
                  rng.uniform(0.1, 1.0, size=(16, 16)).astype(np.float32))
    torch.manual_seed(0)
    torch.save(autoencoder_from_config(VAE_ARCH).state_dict(), root / "vae.pth")
    (root / "vae_config.json").write_text(json.dumps({
        "autoencoder_def": VAE_ARCH, "autoencoder_train": {"patch_size": [16, 16]}}))
    return root


def _train(cfg: Path, ws: Path) -> dict:
    return train_main(["-c", str(cfg), "--input-dir", str(ws / "imgs"), "--device", "cpu",
                       "--num-workers", "1", "--seed", "3"])


@pytest.fixture(scope="module")
def trained(ws):
    cfg = _ldm_config(ws, "ldm")
    return cfg, _train(cfg, ws)


def test_train_writes_a_monai_keyed_checkpoint(trained):
    cfg, result = trained
    assert result["total_step"] == 4 and np.isfinite(result["final_loss"])
    unet_sd, projector_sd = load_diffusion_checkpoint(result["checkpoint"])
    assert set(unet_sd) == set(unet_expected_torch_keys(UNET_DEF))
    assert set(projector_sd) == {"weight", "bias"} and projector_sd["weight"].shape == (16, 2)
    rows = [json.loads(line) for line in
            (Path(result["weights_dir"]).parent / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["train/eps_mse"]) for r in rows)


def test_train_moves_every_parameter_from_its_seeded_init(trained):
    cfg, result = trained
    unet_sd, projector_sd = load_diffusion_checkpoint(result["checkpoint"])
    torch.manual_seed(3)  # the CLI's seeding before it builds the models
    init = load_ldm_models(load_config(str(cfg)), device=torch.device("cpu"))
    for saved, module in ((unet_sd, init.unet), (projector_sd, init.projector)):
        for key, value in module.state_dict().items():
            assert torch.isfinite(saved[key]).all()
            assert not torch.equal(saved[key], value), key


def test_sample_from_the_trained_checkpoint(trained, ws):
    cfg, result = trained
    out = sample_main(["-c", str(cfg), "--checkpoint", result["checkpoint"], "--output-dir",
                       str(ws / "samples"), "--num-images", "2", "--condition-dir", str(ws / "imgs"),
                       "--device", "cpu", "--num-workers", "1", "--seed", "5"])
    tifs, pngs = sorted(out.glob("sample_*.tif")), sorted(out.glob("sample_*.png"))
    assert [p.name for p in tifs] == ["sample_000.tif", "sample_001.tif"] and len(pngs) == 2
    images = [read_image(str(p)) for p in tifs]
    assert all(img.shape == (16, 16) and np.isfinite(img).all() for img in images)

    # the same samples from the library: seeded noise, the condition latents, 4 DDIM steps
    m = load_ldm_models(load_config(str(cfg)), device=torch.device("cpu"))
    unet_sd, projector_sd = load_diffusion_checkpoint(result["checkpoint"])
    m.unet.load_state_dict(unet_sd)
    m.projector.load_state_dict(projector_sd)
    paths = sorted((ws / "imgs").glob("*.tif"))[:2]
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np

    images_in = torch.from_numpy(np.stack([preprocess_image_np(read_image(str(p)), (16, 16))
                                           for p in paths]))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        ctx = project_latent_condition(m.projector, m.vae.encode_deterministic(images_in))
        noise = torch.randn((2, *m.latent_shape), generator=gen)
        want = m.vae.decode_stage_2_outputs(ddim_sample(m.unet.eval(), m.schedule, noise,
                                                        num_inference_steps=4, context=ctx))
    np.testing.assert_allclose(np.stack(images), want[..., 0].numpy(), rtol=1e-5, atol=1e-6)


def test_latent_shape_is_the_encoders(ws, trained):
    cfg, _ = trained
    m = load_ldm_models(load_config(str(cfg)), device=torch.device("cpu"))
    with torch.no_grad():
        z = m.vae.encode_deterministic(torch.zeros(1, 16, 16, 1))
    assert tuple(z.shape[1:]) == m.latent_shape == (8, 8, 2)


def test_unconditioned_train_and_sample(ws):
    cfg = _ldm_config(ws, "ldm_uncond", with_conditioning=False)
    result = _train(cfg, ws)
    unet_sd, projector_sd = load_diffusion_checkpoint(result["checkpoint"])
    assert projector_sd is None and np.isfinite(result["final_loss"])
    out = sample_main(["-c", str(cfg), "--checkpoint", result["checkpoint"], "--output-dir",
                       str(ws / "samples_uncond"), "--num-images", "3", "--device", "cpu"])
    assert len(list(out.glob("sample_*.tif"))) == 3


def test_sample_refuses_an_orbax_directory(ws, trained):
    cfg, _ = trained
    (ws / "orbax_ckpt").mkdir(exist_ok=True)
    with pytest.raises(ValueError, match="orbax"):
        sample_main(["-c", str(cfg), "--checkpoint", str(ws / "orbax_ckpt"), "--output-dir",
                     str(ws / "never"), "--condition-dir", str(ws / "imgs"), "--device", "cpu"])


def test_conditioned_sampling_needs_a_condition_dir(ws, trained):
    cfg, result = trained
    with pytest.raises(ValueError, match="--condition-dir"):
        sample_main(["-c", str(cfg), "--checkpoint", result["checkpoint"], "--output-dir",
                     str(ws / "never"), "--device", "cpu"])


def test_vae_orbax_directory_is_refused(ws):
    cfg = json.loads(_ldm_config(ws, "ldm_orbax_vae").read_text())
    (ws / "vae_orbax").mkdir(exist_ok=True)
    cfg["vae"]["checkpoint"] = str(ws / "vae_orbax")
    (ws / "ldm_orbax_vae.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="orbax"):
        _train(ws / "ldm_orbax_vae.json", ws)


def test_remat_is_refused(ws):
    with pytest.raises(NotImplementedError, match="remat"):
        train_main(["-c", str(_ldm_config(ws, "ldm_remat")), "--input-dir", str(ws / "imgs"),
                    "--device", "cpu", "--remat"])


@pytest.mark.parametrize("cli", ["train", "sample"])
def test_without_device_cpu_refuses_to_run_without_cuda(ws, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = str(ws / "unused.json")
    with pytest.raises(RuntimeError, match="--device cpu"):
        if cli == "train":
            train_main(["-c", cfg, "--input-dir", str(ws / "imgs")])
        else:
            sample_main(["-c", cfg, "--checkpoint", "unused.pth"])

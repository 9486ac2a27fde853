"""``cli.run_pti --device cpu`` of the port on synthetic TIFs and a toy
checkpoint: the JAX CLI's outputs per image (``{name}_pivot.npz`` with
``latent`` / ``latent_loss`` / ``tune_loss``, ``{name}_pti.tif``,
``{name}_pti.png``), equal to the JAX CLI's on the same ``.pth`` at batch 1;
batch 3 over 4 images (a last batch with two padded rows, which are not
written) equal to batch 1; ``--save-tuned`` writes ``{name}_decoder.pth``,
which the port's ``inference_vae`` loads with ``strict=True``.

Bars: pivots rtol 1e-4 with atol 1e-4 of their largest entry, losses rtol
1e-4 (against JAX); the batched path against the sequential one 1e-5;
reconstructions through the tuned decoders 1e-4 of their largest entry.
"""

import json

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.cli.run_pti import main as jax_main
from pti_ldm_vae_tpu_torch.cli.inference_vae import main as inference_main
from pti_ldm_vae_tpu_torch.cli.run_pti import main, parse_args
from pti_ldm_vae_tpu_torch.data.io import read_image, write_tif
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

AE_DEF = {
    "spatial_dims": 2, "in_channels": 1, "out_channels": 1, "latent_channels": 3,
    "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4, "norm_eps": 1e-6,
    "attention_levels": [False, False],
    "with_encoder_nonlocal_attn": True, "with_decoder_nonlocal_attn": True,
}
STEPS = ["--latent-steps", "4", "--tune-steps", "3", "--tune-lr", "1e-3"]
N_IMAGES = 4


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pti_cli")
    data = root / "inputs" / "dente"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        img = rng.uniform(0.1, 1.0, size=(40, 40)).astype(np.float32)
        img[:4] = 0.0
        write_tif(str(data / f"img_{i:03d}.tif"), img)
    cfg = {"spatial_dims": 2, "autoencoder_def": AE_DEF,
           "autoencoder_train": {"patch_size": [16, 16], "batch_size": 2}}
    (root / "config.json").write_text(json.dumps(cfg))
    torch.manual_seed(3)
    torch.save(autoencoder_from_config(AE_DEF).state_dict(), root / "vae.pth")
    return root


def _args(root, out, batch, *extra):
    return ["-c", str(root / "config.json"), "--checkpoint", str(root / "vae.pth"),
            "--input-dir", str(root / "inputs"), "--output-dir", str(out), "--batch-size",
            str(batch), "--num-workers", "1", *STEPS, *extra]


def _outputs(out, names):
    return {name: (dict(np.load(out / f"{name}_pivot.npz")), read_image(str(out / f"{name}_pti.tif")))
            for name in names}


@pytest.fixture(scope="module")
def sequential(workspace):
    out = workspace / "seq"
    main(_args(workspace, out, 1, "--device", "cpu", "--save-tuned"))
    return out


NAMES = [f"img_{i:03d}" for i in range(N_IMAGES)]


def test_outputs_per_image(sequential):
    files = sorted(p.name for p in sequential.iterdir())
    assert files == sorted(f"{n}_{s}" for n in NAMES
                           for s in ("pivot.npz", "pti.tif", "pti.png", "decoder.pth"))
    for name, (npz, recon) in _outputs(sequential, NAMES).items():
        assert npz["latent"].shape == (1, 8, 8, 3)
        assert npz["latent_loss"].shape == (4,) and npz["tune_loss"].shape == (3,)
        assert npz["latent_loss"][-1] < npz["latent_loss"][0]
        assert npz["tune_loss"][-1] < npz["tune_loss"][0]
        assert recon.shape == (16, 16) and np.isfinite(recon).all()


def test_batch_one_matches_the_jax_cli(workspace, sequential, tmp_path):
    out = tmp_path / "jax"
    jax_main(_args(workspace, out, 1, "--num-samples", "2"))
    ours, theirs = _outputs(sequential, NAMES[:2]), _outputs(out, NAMES[:2])
    for name in NAMES[:2]:
        (got, got_recon), (want, want_recon) = ours[name], theirs[name]
        scale = float(np.abs(want["latent"]).max())
        np.testing.assert_allclose(got["latent"], want["latent"], rtol=1e-4, atol=1e-4 * scale)
        for key in ("latent_loss", "tune_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(got_recon, want_recon, rtol=0,
                                   atol=1e-4 * float(np.abs(want_recon).max()))


def test_batch_three_with_a_padded_row_matches_batch_one(workspace, sequential, tmp_path):
    out = tmp_path / "batched"
    main(_args(workspace, out, 3, "--device", "cpu"))
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{n}_{s}" for n in NAMES for s in ("pivot.npz", "pti.tif", "pti.png"))
    ours, seq = _outputs(out, NAMES), _outputs(sequential, NAMES)
    for name in NAMES:
        (got, got_recon), (want, want_recon) = ours[name], seq[name]
        scale = float(np.abs(want["latent"]).max())
        np.testing.assert_allclose(got["latent"], want["latent"], rtol=1e-5, atol=1e-5 * scale)
        for key in ("latent_loss", "tune_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got_recon, want_recon, rtol=0,
                                   atol=1e-4 * float(np.abs(want_recon).max()))


def test_saved_tuned_autoencoder_loads_into_inference(workspace, sequential, tmp_path):
    original = torch.load(workspace / "vae.pth", weights_only=True)
    tuned = torch.load(sequential / "img_000_decoder.pth", weights_only=True)
    assert set(tuned) == set(original)
    model = autoencoder_from_config(AE_DEF)
    model.load_state_dict(tuned, strict=True)
    for key, value in tuned.items():
        moved = not torch.equal(value, original[key])
        # the decoder was tuned (a key projection's bias may stay: its gradient is 0)
        assert moved == key.startswith(("decoder.", "post_quant_conv.")) or key.endswith("to_k.bias")
    n = inference_main(["-c", str(workspace / "config.json"), "--checkpoint",
                        str(sequential / "img_000_decoder.pth"), "--input-dir",
                        str(workspace / "inputs"), "--output-dir", str(tmp_path / "inf"),
                        "--device", "cpu", "--num-workers", "1"])
    assert n == N_IMAGES


def test_vmap_and_missing_cuda_are_refused(workspace, tmp_path):
    with pytest.raises(NotImplementedError, match="vmap"):
        main(_args(workspace, tmp_path / "vmap", 2, "--device", "cpu", "--tune-formulation", "vmap"))
    assert not (tmp_path / "vmap").exists()
    assert parse_args(["-c", "x", "--checkpoint", "y", "--input-dir", "z"]).batch_size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(_args(workspace, tmp_path / "cuda", 1))


def test_remat_config_gives_the_plain_runs_outputs(workspace, sequential, tmp_path):
    """A config with ``"remat": true`` reaches PTI's decoder (``load_vae_model``
    keeps it): the outputs are the plain run's bits on the CPU."""
    cfg = json.loads((workspace / "config.json").read_text())
    cfg["remat"] = True
    (tmp_path / "remat.json").write_text(json.dumps(cfg))
    args = _args(workspace, tmp_path / "out", 1, "--device", "cpu")
    args[args.index("-c") + 1] = str(tmp_path / "remat.json")
    main(args)
    got, want = _outputs(tmp_path / "out", NAMES), _outputs(sequential, NAMES)
    for name in NAMES:
        for key, value in want[name][0].items():
            np.testing.assert_array_equal(got[name][0][key], value, err_msg=f"{name} {key}")
        np.testing.assert_array_equal(got[name][1], want[name][1])

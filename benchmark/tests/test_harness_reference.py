"""The plain reference against the port's CPU path at a tiny width, on the
benchmark's own seeded weights: the autoencoder, LPIPS, the PatchGAN and the
loaders' preprocessing. (The reference imports nothing of the port; only
this test holds the two side by side.)"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference.nets import disc_logits, lpips_per_sample
from benchmark.reference.ops import Ops
from benchmark.reference.preprocess import preprocess
from benchmark.reference.vae import VAE

AE = {"spatial_dims": 2, "in_channels": 1, "out_channels": 1, "latent_channels": 4,
      "channels": [8, 16, 16], "num_res_blocks": 1, "norm_num_groups": 4, "norm_eps": 1e-6,
      "attention_levels": [False, True, False], "with_encoder_nonlocal_attn": True,
      "with_decoder_nonlocal_attn": True}
CPU = torch.device("cpu")
SEED = 2**31 + 12345
FORBIDDEN = ("pti_ldm_vae_tpu_torch", "pti_ldm_vae_tpu", "jax")


def test_reference_imports_nothing_of_the_program():
    root = Path(__file__).resolve().parents[1] / "reference"
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                for name in names:
                    assert name.split(".")[0] not in FORBIDDEN, path


def test_autoencoder_matches_the_port():
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    model = autoencoder_from_config(AE)
    weights = inputs.vae_weights(AE, SEED, CPU)
    model.load_state_dict(weights, strict=True)
    x = preprocess(inputs.raw_images(2, (40, 40), SEED, CPU), (32, 32))  # the loaders' output
    vae = VAE(AE, Ops())
    eps = torch.randn(vae.latent_shape(2, 32, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x, eps)
        got = vae.forward(weights, x, eps)
    # float32 both, in other orders (the port's GroupNorm takes one-pass statistics): the
    # largest difference within 2e-5 of each output's largest magnitude
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-5 * float(b.abs().max())


def test_lpips_and_discriminator_match_the_port():
    from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
    from pti_ldm_vae_tpu_torch.models.lpips import lpips_distance_per_sample

    flat = inputs.lpips_weights(SEED, CPU)
    x, y = (inputs.raw_images(3, (40, 40), s, CPU)[..., None] for s in (SEED, SEED + 1))
    torch.testing.assert_close(lpips_per_sample(Ops(), flat, x, y),
                               lpips_distance_per_sample(inputs.nested(flat), x, y),
                               rtol=1e-5, atol=1e-6)
    disc = PatchDiscriminator()
    weights = inputs.disc_weights(SEED, CPU)
    disc.load_state_dict(weights, strict=True)
    with torch.no_grad():
        torch.testing.assert_close(disc_logits(Ops(), weights, x).permute(0, 2, 3, 1),
                                   disc(x)[-1], rtol=1e-4, atol=1e-5)


def test_preprocessing_matches_the_loader(tmp_path):
    from pti_ldm_vae_tpu_torch.data.loader import ShardedDataLoader

    raw = inputs.raw_images(4, (300, 300), SEED, CPU)
    inputs.write_dataset(tmp_path, raw, None, [])
    loader = ShardedDataLoader(sorted(str(p) for p in tmp_path.glob("*.tif")), (256, 256), 4,
                               num_workers=1)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    np.testing.assert_allclose(batch["image"], preprocess(raw, (256, 256)).numpy(), atol=2e-5)


@pytest.mark.parametrize("precision,differs", [("f32", False), ("fp8", True)])
def test_fp8_control_rounds_where_f32_does_not(precision, differs):
    t = torch.randn(64, generator=torch.Generator().manual_seed(0))
    assert (not torch.equal(Ops(precision).q(t), t)) == differs

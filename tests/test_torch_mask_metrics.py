"""``cli.compute_mask_metrics`` of the port against the JAX package's on the
CPU: the same attribute JSON files byte for byte on seeded mask pairs (a pair
with an empty edente mask is skipped, a stem found in one directory only is
ignored), the helpers on random masks, and the errors. The CLI is host-side
numpy: it takes no ``--device``."""

import numpy as np
import pytest

from pti_ldm_vae_tpu.cli import compute_mask_metrics as jax_cmm
from pti_ldm_vae_tpu_torch.cli import compute_mask_metrics as cmm
from pti_ldm_vae_tpu_torch.data.io import write_tif


def _ridge(rng, h, w):
    """A binary mask whose rows hold one run of foreground of varying width."""
    mask = np.zeros((h, w), np.float32)
    top, bottom = int(rng.integers(5, h // 3)), int(rng.integers(2 * h // 3, h))
    for y in range(top, bottom):
        half = int(rng.integers(3, w // 3))
        centre = w // 2 + int(rng.integers(-4, 5))
        mask[y, max(0, centre - half):centre + half] = float(rng.uniform(0.5, 255.0))
    return mask


@pytest.fixture(scope="module")
def masks(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mask_metrics")
    rng = np.random.default_rng(0)
    for sub in ("edente", "dente"):
        (root / sub).mkdir()
    for i in range(6):
        h, w = (180, 120) if i % 2 else (64, 90)
        edente = _ridge(rng, h, w) if i != 4 else np.zeros((h, w), np.float32)
        write_tif(str(root / "edente" / f"m_{i:03d}.tif"), edente)
        write_tif(str(root / "dente" / f"m_{i:03d}.tif"), _ridge(rng, h, w))
    write_tif(str(root / "dente" / "only_dente.tif"), _ridge(rng, 64, 64))
    return root


@pytest.mark.parametrize("extra", [[], ["--edente-width-samples", "0"],
                                   ["--pixel-size-mm", "0.3", "--dente-heights-mm", "2", "7.5",
                                    "--edente-width-samples", "3"]],
                         ids=["defaults", "no_widths", "custom"])
def test_cli_writes_the_jax_cli_bytes(masks, tmp_path, extra):
    outs = {}
    for name, main in (("port", cmm.main), ("jax", jax_cmm.main)):
        out = tmp_path / name
        summary = main(["--edente-dir", str(masks / "edente"), "--dente-dir", str(masks / "dente"),
                        "--output-edente", str(out / "attributes_edente.json"),
                        "--output-dente", str(out / "attributes_dente.json"), *extra])
        outs[name] = out
        assert summary["edente_entries"] == summary["dente_entries"] == 5  # m_004 skipped
    for file in ("attributes_edente.json", "attributes_dente.json"):
        assert (outs["port"] / file).read_bytes() == (outs["jax"] / file).read_bytes()


def test_helpers_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(5):
        mask = (_ridge(rng, 150, 100) > 0).astype(np.uint8)
        box = cmm.compute_bbox(mask)
        assert box == jax_cmm.compute_bbox(mask)
        for samples in (0, 1, 5, 9):
            assert (cmm.compute_edente_widths(mask, *box, samples)
                    == jax_cmm.compute_edente_widths(mask, *box, samples))
        for row in (0, 40, 149):
            assert cmm.compute_dente_width(mask, row) == jax_cmm.compute_dente_width(mask, row)
    heights = (5.0, 10.0, 14.0, 18.0, 22.0)
    assert cmm.pixel_offsets_mm(heights, 0.15) == jax_cmm.pixel_offsets_mm(heights, 0.15)


def test_missing_directories_and_pairs_raise(masks, tmp_path):
    (tmp_path / "empty").mkdir()
    base = dict(output_edente=tmp_path / "e.json", output_dente=tmp_path / "d.json",
                pixel_size_mm=0.15, dente_heights_mm=(5.0,), edente_width_samples=2)
    with pytest.raises(FileNotFoundError, match="Edente directory"):
        cmm.process_dataset(cmm.MetricConfig(edente_dir=tmp_path / "nope",
                                             dente_dir=masks / "dente", **base))
    with pytest.raises(FileNotFoundError, match="No matching TIFF"):
        cmm.process_dataset(cmm.MetricConfig(edente_dir=tmp_path / "empty",
                                             dente_dir=masks / "dente", **base))
    with pytest.raises(ValueError, match="foreground"):
        cmm.compute_bbox(np.zeros((4, 4), np.uint8))

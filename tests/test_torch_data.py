"""The PyTorch port's host data path, held to the JAX package bit for bit:
preprocessing, path listing, the seeded split, sharding and epoch order,
loader batches and masks, and TIF/PNG files written by one package and read
by the other."""

import numpy as np
import pytest

from pti_ldm_vae_tpu.data import io as jax_io
from pti_ldm_vae_tpu.data.datasets import list_tif_paths as jax_list_tif_paths
from pti_ldm_vae_tpu.data.datasets import split_dataset as jax_split_dataset
from pti_ldm_vae_tpu.data.factory import create_vae_dataloaders as jax_create_vae_dataloaders
from pti_ldm_vae_tpu.data.loader import ShardedDataLoader as JaxLoader
from pti_ldm_vae_tpu.data.loader import shard_indices as jax_shard_indices
from pti_ldm_vae_tpu.data.transforms import local_normalize_by_mask_np as jax_normalize
from pti_ldm_vae_tpu.data.transforms import preprocess_image_np as jax_preprocess
from pti_ldm_vae_tpu.data.transforms import resize_area_np as jax_resize
from pti_ldm_vae_tpu.ops.resize import _area_matrix_np as jax_area_matrix
from pti_ldm_vae_tpu.utils.visualization import normalize_batch_for_display as jax_display
from pti_ldm_vae_tpu_torch.data import io
from pti_ldm_vae_tpu_torch.data.datasets import list_tif_paths, split_dataset
from pti_ldm_vae_tpu_torch.data.factory import (
    create_vae_dataloaders,
    create_vae_inference_dataloader,
)
from pti_ldm_vae_tpu_torch.data.loader import shard_indices
from pti_ldm_vae_tpu_torch.data.transforms import (
    local_normalize_by_mask_np,
    preprocess_image_np,
    resize_area_np,
)
from pti_ldm_vae_tpu_torch.ops.resize import _area_matrix_np
from pti_ldm_vae_tpu_torch.utils.visualization import normalize_batch_for_display


def _image(seed, shape, zero_rows=3):
    img = np.random.default_rng(seed).uniform(0.1, 2.0, size=shape).astype(np.float32)
    img[:zero_rows] = 0.0
    return img


@pytest.mark.parametrize("sizes", [(300, 256), (40, 32), (20, 32), (7, 3), (5, 5)])
def test_area_matrix_identical(sizes):
    np.testing.assert_array_equal(_area_matrix_np(*sizes), jax_area_matrix(*sizes))


@pytest.mark.parametrize("shape,patch", [
    ((300, 300), (256, 256)), ((40, 36), (32, 32)), ((20, 24), (32, 32)),
    ((30, 30, 1), (16, 16)), ((1, 30, 30), (16, 16)),
])
def test_preprocessing_bit_identical(shape, patch):
    img = _image(0, shape)
    np.testing.assert_array_equal(preprocess_image_np(img, patch), jax_preprocess(img, patch))
    if len(shape) == 2:
        np.testing.assert_array_equal(resize_area_np(img, patch), jax_resize(img, patch))
    np.testing.assert_array_equal(local_normalize_by_mask_np(img), jax_normalize(img))


def test_normalize_edge_cases_bit_identical():
    for img in (np.zeros((8, 8), np.float32), np.full((8, 8), 3.0, np.float32)):
        np.testing.assert_array_equal(local_normalize_by_mask_np(img), jax_normalize(img))


def test_display_normalization_bit_identical():
    batch = np.stack([_image(1, (16, 16, 1)), np.zeros((16, 16, 1), np.float32)])
    np.testing.assert_array_equal(normalize_batch_for_display(batch), jax_display(batch))


@pytest.mark.parametrize("n,world,shuffle", [(10, 1, False), (10, 3, True), (7, 4, False)])
def test_shard_indices_identical(n, world, shuffle):
    for rank in range(world):
        kw = dict(rank=rank, world=world, shuffle=shuffle, seed=3, epoch=2)
        np.testing.assert_array_equal(shard_indices(n, **kw), jax_shard_indices(n, **kw))


@pytest.fixture(scope="module")
def tif_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tifs")
    for sub, n in (("dente", 6), ("edente", 5)):
        (root / sub).mkdir()
        for i in range(n):
            jax_io.write_tif(str(root / sub / f"{sub}_{i:03d}.tif"), _image(10 + i, (40, 36)))
    return root


@pytest.mark.parametrize("source", ["dente", "edente", "both"])
def test_list_tif_paths_identical(tif_dir, source):
    assert list_tif_paths(str(tif_dir), source) == jax_list_tif_paths(str(tif_dir), source)


def test_list_tif_paths_errors(tmp_path):
    with pytest.raises(ValueError):
        list_tif_paths(str(tmp_path), "neither")
    with pytest.raises(FileNotFoundError):
        list_tif_paths(str(tmp_path), "dente")


@pytest.mark.parametrize("batch_size,num_samples", [(4, None), (3, 7), (16, None)])
def test_loader_batches_and_masks_equal(tif_dir, batch_size, num_samples):
    """Against the JAX loader, both on their default transform (the native
    fused decoder, the same source and flags): the same bits."""
    ours, paths = create_vae_inference_dataloader(
        str(tif_dir), (32, 32), batch_size, num_samples=num_samples, num_workers=2)
    theirs = JaxLoader(paths, (32, 32), batch_size, shuffle=False, num_workers=2)
    assert paths == jax_list_tif_paths(str(tif_dir), "both")[:num_samples]
    assert len(ours) == len(theirs)
    got, want = list(ours), list(theirs)
    ours.close()
    assert len(got) == len(want) == len(ours)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
    assert got[-1]["image"].shape[0] == batch_size  # padded last batch
    assert got[-1]["mask"].sum() == len(paths) - (len(got) - 1) * batch_size


def test_loader_surfaces_decode_errors(tmp_path):
    (tmp_path / "bad.tif").write_bytes(b"not an image")
    loader, _ = create_vae_inference_dataloader(str(tmp_path), (8, 8), 2, num_workers=1)
    with pytest.raises(Exception):
        list(loader)
    loader.close()


@pytest.mark.parametrize("shape", [(32, 64), (300, 300), (1, 5)])
def test_tif_round_trips_between_packages(tmp_path, shape):
    img = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    io.write_tif(str(tmp_path / "port.tif"), img)
    jax_io.write_tif(str(tmp_path / "jax.tif"), img)
    for name in ("port.tif", "jax.tif"):
        for reader in (io.read_image, jax_io.read_image):
            np.testing.assert_array_equal(reader(str(tmp_path / name)), img)


def test_tif_integer_and_big_endian(tmp_path):
    import struct

    img = np.arange(12, dtype=">u2").reshape(3, 4)
    entries = [(256, 3, 4), (257, 3, 3), (258, 3, 16), (259, 3, 1), (273, 4, 8 + 2 + 12 * 7 + 4),
               (278, 3, 3), (279, 4, img.nbytes)]
    ifd = struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHI", t, k, 1) + (struct.pack(">I", v) if k == 4 else struct.pack(">HH", v, 0))
        for t, k, v in entries) + struct.pack(">I", 0)
    (tmp_path / "be.tif").write_bytes(b"MM" + struct.pack(">HI", 42, 8) + ifd + img.tobytes())
    np.testing.assert_array_equal(io.read_image(str(tmp_path / "be.tif")), img.astype(np.float32))


@pytest.mark.parametrize("shape", [(32, 64), (9, 7, 3), (5, 4, 1)])
def test_png_round_trips_between_packages(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, size=shape).astype(np.uint8)
    io.write_png(str(tmp_path / "port.png"), img)
    jax_io.write_png(str(tmp_path / "jax.png"), img)
    want = img[..., 0] if shape[-1] == 1 else img
    for name in ("port.png", "jax.png"):
        for reader in (io.read_image, jax_io.read_image):
            np.testing.assert_array_equal(reader(str(tmp_path / name)), want.astype(np.float32))


def test_png_reader_undoes_every_filter(tmp_path):
    import struct
    import zlib

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(5, 6, 3)).astype(np.int64)
    bpp, rows, prev = 3, [], np.zeros(18, np.int64)
    for y, ftype in enumerate([0, 1, 2, 3, 4]):
        cur = img[y].reshape(-1)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [np.zeros_like(cur), left, prev, (left + prev) >> 1,
                np.array([io._paeth(int(a), int(b), int(c)) for a, b, c in zip(left, prev, up_left)])][ftype]
        rows.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    header = struct.pack(">IIBBBBB", 6, 5, 8, 2, 0, 0, 0)
    data = (io._PNG_SIGNATURE + io._png_chunk(b"IHDR", header)
            + io._png_chunk(b"IDAT", zlib.compress(b"".join(rows))) + io._png_chunk(b"IEND", b""))
    (tmp_path / "f.png").write_bytes(data)
    np.testing.assert_array_equal(io.read_image(str(tmp_path / "f.png")), img.astype(np.float32))


@pytest.mark.parametrize("seed,train_split", [(42, 0.9), (7, 0.5), (None, 0.75)])
def test_split_dataset_identical(seed, train_split):
    paths = [f"/data/dente/img_{i:03d}.tif" for i in range(23)]
    want = jax_split_dataset(paths, train_split=train_split, seed=seed)
    assert split_dataset(paths, train_split=train_split, seed=seed) == want
    override = ["/val/a.tif", "/val/b.tif"]
    want = jax_split_dataset(paths, seed=seed, val_paths_override=override)
    assert split_dataset(paths, seed=seed, val_paths_override=override) == want
    with pytest.raises(ValueError, match="train_split"):
        split_dataset(paths, train_split=1.0)


@pytest.mark.parametrize("batch_size,drop_last", [(2, False), (4, False), (4, True)])
def test_training_loaders_follow_the_jax_epoch_order(tif_dir, batch_size, drop_last):
    """Same split, same per-epoch shuffle (``default_rng(seed + epoch)``), same
    batches and masks as the JAX package's train and val loaders, for three
    epochs; cached samples are served unchanged. Both loaders take their
    default transform, the native fused decoder: the batches are bit-equal."""
    kw = dict(data_source="both", train_split=0.7, num_workers=2, seed=5, cache_rate=0.5)
    ours_train, ours_val, train_paths, val_paths = create_vae_dataloaders(
        str(tif_dir), batch_size, (32, 32), **kw)
    theirs_train, theirs_val, jax_train_paths, jax_val_paths = jax_create_vae_dataloaders(
        str(tif_dir), batch_size, (32, 32), **kw)
    assert (train_paths, val_paths) == (jax_train_paths, jax_val_paths)
    for loader in (ours_train, theirs_train):
        loader.drop_last = drop_last
    assert len(ours_train) == len(theirs_train) and len(ours_val) == len(theirs_val)
    orders = []
    for epoch in range(3):
        ours_train.set_epoch(epoch)
        theirs_train.set_epoch(epoch)
        got, want = list(ours_train), list(theirs_train)
        assert len(got) == len(want) == len(ours_train)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["mask"], b["mask"])
        orders.append(np.concatenate([a["image"][:, 5, 5, 0] for a in got]))
    assert not np.array_equal(orders[0], orders[1])  # reshuffled every epoch
    for a, b in zip(list(ours_val), list(theirs_val)):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
    assert len(ours_train._cache) == int(0.5 * len(train_paths))
    assert len(ours_val._cache) == len(val_paths)  # validation is fully cached
    ours_train.close()
    ours_val.close()


def test_training_loader_factory_rejects_unported_and_bad_arguments(tif_dir):
    # the AR-VAE branch is ported; without its config block it has no attributes to join
    with pytest.raises(ValueError, match="regularized_attributes config is missing"):
        create_vae_dataloaders(str(tif_dir), 2, (32, 32), ar_vae_enabled=True)
    with pytest.raises(ValueError, match="cache_rate"):
        create_vae_dataloaders(str(tif_dir), 2, (32, 32), data_source="both", cache_rate=1.5)

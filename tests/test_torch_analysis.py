"""The port's analysis modules against the JAX package on the CPU, at toy
size (the toy VAE of ``tests/test_analyze_clis.py`` with both non-local
attention blocks on, so that flash attention's plain version is on the
path), and ``analysis/projection.py`` against scikit-learn, whose calls it
replaces.

Bars: distances, ``compute_distance_metrics``, statistics files and the
colour legend exact (the same bytes); ``encode_images`` rtol 1e-4 / atol
1e-5; PCA at N <= 500 within 1e-4 of the largest entry with the same signs;
the first 10 explained variances at N = 600 x 4096 (scikit-learn randomized
there) within 1e-3 relative; P within 1e-5 of its largest entry (measured
3e-7); the gradient within 1e-5 of its largest entry of a float64 numpy
reference (measured 1.7e-7) and of ``_kl_divergence_bh(angle=0)`` at a
unit-scale embedding, and within 5e-3 of the latter at the PCA init
(measured 3.4e-3: at its 1e-4 scale the Barnes-Hut tree departs from the
exact sum, while the port stays at 1.7e-7 of the float64 one); the whole
PCA -> t-SNE at N = 120 trustworthiness no worse than the JAX package's by
more than 0.02 and KL(P || Q) at most 1.05 x its; against
``TSNE(method="barnes_hut", angle=0)`` after the 250 exaggerated iterations
(``max_iter=250``; the two embeddings are arranged differently by then, the
iteration being chaotic) KL(P || Q) at most 1.05 x its (measured 0.956 x),
trustworthiness within 0.02 (measured 0.008) and the extent within 10%
(measured 1.6%).
"""

import importlib
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import squareform
from sklearn.manifold import TSNE as SkTSNE
from sklearn.manifold import trustworthiness as sk_trustworthiness
from sklearn.manifold._t_sne import (
    _joint_probabilities_nn,
    _kl_divergence,
    _kl_divergence_bh,
)
from sklearn.neighbors import NearestNeighbors

from pti_ldm_vae_tpu.analysis import latent_space as jax_ls
from pti_ldm_vae_tpu.analysis.common import create_transforms as jax_create_transforms
from pti_ldm_vae_tpu.analysis.latent_cache import LatentCache as JaxLatentCache
from pti_ldm_vae_tpu.data.io import write_tif
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu_torch.analysis import latent_space, projection
from pti_ldm_vae_tpu_torch.analysis.common import create_transforms
from pti_ldm_vae_tpu_torch.analysis.latent_cache import LatentCache
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax
from pti_ldm_vae_tpu_torch.data.io import read_image, write_png
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.utils import visualization

# the packages export functions of these modules' names, so import the modules by path
jax_distance = importlib.import_module("pti_ldm_vae_tpu.analysis.latent_distance")
latent_distance = importlib.import_module("pti_ldm_vae_tpu_torch.analysis.latent_distance")

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=2,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, False],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
PATCH = 16
TOL = dict(rtol=1e-4, atol=1e-5)
CPU = "cpu"


def _clustered(rng, n: int, d: int, clusters: int = 12, spread: float = 3.0) -> np.ndarray:
    """``n`` float32 points in ``d`` dimensions around ``clusters`` centres,
    with a decaying spectrum (the analysis CLIs' latents are clustered by
    patient)."""
    centres = rng.normal(size=(clusters, d)) * spread
    scale = 1.0 / np.sqrt(1.0 + np.arange(d) / 8.0)
    return (centres[rng.integers(0, clusters, n)] + rng.normal(size=(n, d)) * scale).astype(
        np.float32)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy VAE in both frameworks (JAX init, weights carried across) and
    11 TIFs named ``ID_HA_YEAR_MONTH_PATIENT.tif``."""
    root = tmp_path_factory.mktemp("torch_analysis")
    jax_vae = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    variables = jax.jit(jax_vae.init)(jax.random.key(0), jnp.zeros((1, PATCH, PATCH, 1)),
                                      jax.random.key(1))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    vae = autoencoder_from_config(TOY)
    vae.load_state_dict(state_dict_from_flax(variables, TOY), strict=True)
    vae.requires_grad_(False).eval()
    rng = np.random.default_rng(0)
    (root / "imgs").mkdir()
    for i in range(11):
        write_tif(str(root / "imgs" / f"20{i:02d}_HA_2021_02_{i % 4}.tif"),
                  rng.uniform(0.1, 1.0, size=(20, 20)).astype(np.float32))
    paths = sorted(str(p) for p in (root / "imgs").glob("*.tif"))
    weights = root / "vae.pth"
    torch.save(vae.state_dict(), weights)
    return dict(root=root, jax_vae=jax_vae, variables=variables, vae=vae, paths=paths,
                weights=weights)


@pytest.fixture(scope="module")
def analyzers(toy):
    jax_an = jax_ls.LatentSpaceAnalyzer(toy["jax_vae"], toy["variables"],
                                        jax_create_transforms((PATCH, PATCH)), batch_size=4)
    port = latent_space.LatentSpaceAnalyzer(toy["vae"], create_transforms((PATCH, PATCH)),
                                            batch_size=4, device=CPU)
    return jax_an, port


# -- distances -------------------------------------------------------------------

def test_latent_distances_equal():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(5, 7)), rng.normal(size=(3, 7))
    assert latent_distance.latent_distance(a[0], b[1]) == jax_distance.latent_distance(a[0], b[1])
    assert (latent_distance.latent_distance_from_indices(a, 1, 4)
            == jax_distance.latent_distance_from_indices(a, 1, 4))
    assert (latent_distance.latent_distance_cross(a, 2, b, 0)
            == jax_distance.latent_distance_cross(a, 2, b, 0))


@pytest.mark.parametrize("call", [
    lambda m, a, b: m.latent_distance(a, b[:, :3]),
    lambda m, a, b: m.latent_distance(a[0], b[0, :3]),
    lambda m, a, b: m.latent_distance_from_indices(a[0], 0, 1),
    lambda m, a, b: m.latent_distance_from_indices(a, 0, 9),
    lambda m, a, b: m.latent_distance_cross(a, 0, b[:, :3], 0),
    lambda m, a, b: m.latent_distance_cross(a, 7, b, 0),
    lambda m, a, b: m.latent_distance_cross(a, 0, b, -1),
], ids=["ndim", "shape", "latents_ndim", "index", "dims", "idx_a", "idx_b"])
def test_latent_distance_validation_messages_equal(call):
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(5, 7)), rng.normal(size=(3, 7))
    with pytest.raises(ValueError) as port_err:
        call(latent_distance, a, b)
    with pytest.raises(ValueError) as jax_err:
        call(jax_distance, a, b)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("sizes", [(4, 3), (1, 5), (6, 1), (0, 2)])
def test_compute_distance_metrics_equal(sizes):
    rng = np.random.default_rng(3)
    p1, p2 = list(rng.normal(size=(sizes[0], 4))), list(rng.normal(size=(sizes[1], 4)))
    assert latent_space.compute_distance_metrics(p1, p2) == jax_ls.compute_distance_metrics(p1, p2)


@pytest.mark.parametrize("name", ["1001_HA_2021_02_P7.tif", "plain", "a.b_c.tif", "x_y"])
def test_patient_id_extraction_equal(name):
    assert (latent_space.extract_patient_id_from_filename(name)
            == jax_ls.extract_patient_id_from_filename(name))


def test_load_image_paths_equal(toy):
    for max_images in (None, 3):
        assert (latent_space.load_image_paths(str(toy["root"] / "imgs"), max_images)
                == jax_ls.load_image_paths(str(toy["root"] / "imgs"), max_images))


# -- encoding and cache ------------------------------------------------------------

def test_encode_images_matches_jax(toy, analyzers):
    """11 images at batch 4: the last batch is padded and its padded rows dropped."""
    jax_an, port = analyzers
    want, want_ids = jax_an.encode_images(toy["paths"])
    got, got_ids = port.encode_images(toy["paths"])
    assert got.dtype == np.float32 and got.shape == want.shape == (11, 2 * 8 * 8)
    assert got_ids == want_ids == [str(i % 4) for i in range(11)]
    np.testing.assert_allclose(got, want, **TOL)
    got5, _ = port.encode_images(toy["paths"], max_images=5, batch_size=3)
    np.testing.assert_allclose(got5, want[:5], **TOL)
    with pytest.raises(ValueError, match="cannot be empty"):
        port.encode_images([])


def _refuse(paths):
    raise AssertionError(f"cache miss: {paths}")


def test_caches_are_read_by_the_other_package(toy, analyzers, tmp_path):
    """A cache written by either package is read by the other with 0 misses,
    and both write the same ``_metadata.json`` bytes and ``.npz`` entries."""
    jax_an, port = analyzers
    paths, weights = toy["paths"], str(toy["weights"])
    caches = {}
    for name, cls, an in (("jax", JaxLatentCache, jax_an), ("port", LatentCache, port)):
        cache = cls(cache_root=tmp_path / name)
        caches[name] = cache.get_or_encode_batch(
            paths, lambda p, an=an: an.encode_images(p, show_progress=False), weights,
            (PATCH, PATCH), "edente")
    for writer, reader in (("jax", LatentCache), ("port", JaxLatentCache)):
        lat, ids, got_paths = reader(cache_root=tmp_path / writer).get_or_encode_batch(
            paths, _refuse, weights, (PATCH, PATCH), "edente")
        np.testing.assert_array_equal(lat, caches[writer][0])
        assert ids == caches[writer][1] and got_paths == paths
    sig = LatentCache(tmp_path / "port")._get_model_signature(weights, (PATCH, PATCH))
    assert sig == JaxLatentCache(tmp_path / "jax")._get_model_signature(weights, [PATCH, PATCH])
    meta = [(tmp_path / name / sig / "_metadata.json").read_bytes() for name in ("jax", "port")]
    assert meta[0] == meta[1]
    files = [sorted(p.name for p in (tmp_path / name / sig).glob("*.npz")) for name in ("jax", "port")]
    assert files[0] == files[1] and len(files[0]) == len(paths)
    for f in files[0]:
        a, b = np.load(tmp_path / "jax" / sig / f), np.load(tmp_path / "port" / sig / f)
        assert sorted(a.files) == sorted(b.files) == ["latent", "patient_id"]
        assert str(a["patient_id"]) == str(b["patient_id"])
        np.testing.assert_allclose(b["latent"], a["latent"], **TOL)


def test_cache_reencodes_a_corrupted_entry_and_reports_stats(toy, analyzers, tmp_path):
    _, port = analyzers
    paths, weights = toy["paths"][:3], str(toy["weights"])
    cache = LatentCache(cache_root=tmp_path)
    first = cache.get_or_encode_batch(paths, port.encode_images, weights, (PATCH, PATCH), "g")
    entry = cache._get_cache_file_path(paths[1], cache._get_model_signature(weights, (16, 16)))
    entry.write_bytes(b"not an npz")
    calls = []

    def encode(p):
        calls.append(list(p))
        return port.encode_images(p)

    again = cache.get_or_encode_batch(paths, encode, weights, (PATCH, PATCH), "g")
    assert calls == [[paths[1]]]
    np.testing.assert_array_equal(again[0], first[0])
    stats = cache.get_cache_stats()
    assert [v["num_images"] for v in stats.values()] == [3]
    cache.clear_cache()
    assert cache.get_cache_stats() == {}


# -- PCA ------------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(300, 256), (120, 128), (60, 500)])
def test_pca_matches_jax_package_exact_solver(analyzers, n, d):
    """At N <= 500 scikit-learn's PCA is exact: the same projection and
    signs (components: the largest-magnitude entry positive)."""
    jax_an, port = analyzers
    x = _clustered(np.random.default_rng(n + d), n, d)
    want, jpca = jax_an._apply_pca(x, 50)
    got, ppca = port._apply_pca(x, 50)
    got = got.numpy()
    assert got.shape == want.shape == (n, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.all(np.sign(got).sum(0) * np.sign(want).sum(0) >= 0)
    assert np.all(np.einsum("ij,ij->j", got, want) > 0)  # no component flipped
    comps = ppca.components_.numpy()
    np.testing.assert_allclose(comps, jpca.components_, rtol=0, atol=1e-4)
    assert np.all(comps[np.arange(50), np.abs(comps).argmax(1)] > 0)
    np.testing.assert_allclose(ppca.explained_variance_.numpy(), jpca.explained_variance_,
                               rtol=1e-4)
    np.testing.assert_allclose(ppca.explained_variance_ratio_.numpy(),
                               jpca.explained_variance_ratio_, rtol=1e-4)
    np.testing.assert_allclose(ppca.transform(x[:7]).numpy(), want[:7], rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_pca_explained_variance_against_randomized_solver(analyzers):
    """N = 600 x 4096 (the flagship's flattened latent): scikit-learn's
    "auto" solver is randomized there; the first 10 explained variances agree
    within 1e-3 relative."""
    jax_an, port = analyzers
    x = _clustered(np.random.default_rng(7), 600, 4096)
    _, jpca = jax_an._apply_pca(x, 50)
    _, ppca = port._apply_pca(x, 50)
    assert jpca._fit_svd_solver == "randomized"
    np.testing.assert_allclose(ppca.explained_variance_.numpy()[:10],
                               jpca.explained_variance_[:10], rtol=1e-3)


def test_pca_refuses_too_many_components():
    with pytest.raises(ValueError, match="n_components=5"):
        projection.PCA(5, device=CPU).fit(np.zeros((4, 3)))


# -- t-SNE --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def embedded():
    """PCA-50 of 120 clustered latents (two groups x 60, 12 patients) and its
    affinities P (perplexity 30) from both sides."""
    rng = np.random.default_rng(11)
    x = _clustered(rng, 120, 128)
    xp = projection.PCA(50, device=CPU).fit_transform(x).numpy()
    k = min(119, int(3 * 30 + 1))
    dist = NearestNeighbors(n_neighbors=k).fit(xp).kneighbors_graph(mode="distance")
    dist.data **= 2
    return dict(x=x, xp=xp, p_sk=_joint_probabilities_nn(dist, 30, 0),
                p=projection.joint_probabilities(xp, 30, device=CPU).numpy())


def test_joint_probabilities_match_sklearn(embedded):
    p, want = embedded["p"], embedded["p_sk"].toarray()
    np.testing.assert_allclose(p, want, rtol=0, atol=1e-5 * want.max())
    np.testing.assert_allclose(p, p.T)
    assert abs(p.sum() - 1.0) < 1e-12 and np.all(np.diag(p) == 0)
    assert np.array_equal(p > 0, want > 0)


@pytest.mark.parametrize("where", ["seeded", "pca_init"])
def test_gradient_matches_barnes_hut_at_angle_0(embedded, where):
    p = embedded["p_sk"]
    n = p.shape[0]
    if where == "seeded":
        y, bar = np.random.default_rng(5).normal(size=(n, 2)).astype(np.float32), 1e-5
    else:
        tsne = projection.TSNE(device=CPU)
        y, bar = tsne._initial_embedding(torch.from_numpy(embedded["xp"])).numpy(), 5e-3
    err, grad = _kl_divergence_bh(y.ravel().copy(), p, 1, n, 2, angle=0.0)
    got_err, got = projection.kl_gradient(torch.from_numpy(p.toarray().astype(np.float32)),
                                          torch.from_numpy(y))
    grad, got = grad.reshape(n, 2), got.numpy()
    np.testing.assert_allclose(got, grad, rtol=0, atol=bar * np.abs(grad).max())
    assert abs(float(got_err) - err) <= max(bar, 1e-5) * abs(err)
    # the exact gradient in float64
    y64, p64 = y.astype(np.float64), p.toarray()
    d = y64[:, None, :] - y64[None, :, :]
    w = 1.0 / (1.0 + np.square(d).sum(-1))
    np.fill_diagonal(w, 0.0)
    exact = 4.0 * ((p64 * w - w * w / w.sum())[:, :, None] * d).sum(1)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5 * np.abs(exact).max())


def test_kl_divergence_matches_exact_sklearn(embedded):
    y = np.random.default_rng(6).normal(size=(120, 2))
    p = embedded["p"]
    want = _kl_divergence(y.ravel(), squareform(p, checks=False), 1, 120, 2)[0]
    assert abs(projection.kl_divergence(p, y, device=CPU) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("k", [5, 12])
def test_trustworthiness_matches_sklearn(embedded, k):
    y = embedded["xp"][:, :2] + np.random.default_rng(k).normal(size=(120, 2))
    got = projection.trustworthiness(embedded["x"], y, n_neighbors=k, device=CPU)
    assert abs(got - sk_trustworthiness(embedded["x"], y, n_neighbors=k)) < 1e-12
    with pytest.raises(ValueError, match="n_neighbors"):
        projection.trustworthiness(embedded["x"], y, n_neighbors=60, device=CPU)


def test_tsne_exaggerated_stage_against_barnes_hut_at_angle_0(embedded):
    """``max_iter=250``: only the early-exaggeration stage runs, on both sides."""
    xp = embedded["xp"].astype(np.float32)
    sk = SkTSNE(2, perplexity=30, init="pca", random_state=0, method="barnes_hut", angle=0.0,
                max_iter=250)
    want = sk.fit_transform(xp)
    tsne = projection.TSNE(2, perplexity=30, random_state=0, max_iter=250, device=CPU)
    got = tsne.fit_transform(xp).numpy()
    assert tsne.n_iter_ == sk.n_iter_ == 250 and tsne.kl_divergence_ == sk.kl_divergence_
    assert got.dtype == np.float32 and got.shape == want.shape
    kl = [projection.kl_divergence(embedded["p"], e, device=CPU) for e in (got, want)]
    assert kl[0] <= 1.05 * kl[1]
    trust = [sk_trustworthiness(embedded["x"], e, n_neighbors=5) for e in (got, want)]
    assert abs(trust[0] - trust[1]) <= 0.02
    assert abs(np.abs(got).max() / np.abs(want).max() - 1.0) <= 0.1


def test_reduce_dimensionality_tsne_against_jax_package(analyzers):
    """The whole PCA-50 -> t-SNE at N = 120 (two groups x 60, 12 patients),
    perplexity 30: the port's exact-gradient embedding is as good as the
    JAX package's Barnes-Hut one by trustworthiness and KL(P || Q)."""
    jax_an, port = analyzers
    rng = np.random.default_rng(12)
    centres = rng.normal(size=(12, 128)) * 3
    patients = np.tile(np.arange(12), 10)
    x = np.concatenate([centres[patients] + rng.normal(size=(120, 128)) * s
                        for s in (0.8,)]).astype(np.float32)
    x[60:] += 0.5  # the second group, shifted
    want = jax_an.reduce_dimensionality_tsne(x, perplexity=30, random_state=42)
    got = port.reduce_dimensionality_tsne(x, perplexity=30, random_state=42)
    assert got.shape == want.shape == (120, 2) and got.dtype == np.float32
    assert np.array_equal(got, port.reduce_dimensionality_tsne(x, perplexity=30, random_state=7))
    trust = [projection.trustworthiness(x, e, n_neighbors=5, device=CPU) for e in (got, want)]
    assert trust[0] >= trust[1] - 0.02
    p = projection.joint_probabilities(port._apply_pca(x, 50)[0], 30, device=CPU)
    kl = [projection.kl_divergence(p, e, device=CPU) for e in (got, want)]
    assert kl[0] <= 1.05 * kl[1]


@pytest.mark.parametrize("case", [
    (np.zeros((4, 4, 4)), 2, 1, "Expected 2D array, got 3D array"),
    (np.zeros((10, 4)), 50, 5, "Need at least 50 samples for PCA with 50 components, got 10 samples."),
    (np.zeros((60, 4)), 50, 60, "perplexity (60) must be < n_samples (60)."),
], ids=["ndim", "pca", "perplexity"])
def test_validate_errors_equal(analyzers, case):
    x, pca_components, perplexity, message = case
    for an in analyzers:
        with pytest.raises(ValueError) as err:
            an.reduce_dimensionality_tsne(x, perplexity=perplexity, pca_components=pca_components)
        assert str(err.value) == message


def test_umap_is_gated_as_in_the_jax_package(analyzers, monkeypatch):
    """Without umap-learn: the JAX package's ImportError, after validation;
    with it (a strict fake here), the model's ``transform`` takes RAW latents
    through the port's PCA."""
    _, port = analyzers
    rng = np.random.default_rng(0)
    latents_a = rng.normal(size=(60, 128)).astype(np.float32)
    if latent_space._umap is None:
        with pytest.raises(ImportError, match="^Please install umap-learn: pip install umap-learn$"):
            port.reduce_dimensionality_umap(latents_a)

    class FakeUMAP:
        def __init__(self, n_components=2, random_state=42, n_neighbors=40, min_dist=0.5):
            self.n_components = n_components

        def fit_transform(self, v):
            assert isinstance(v, np.ndarray) and v.shape[1] == 50
            return v[:, :2]

        def transform(self, v):
            assert v.shape[1] == 50, f"transform got raw latents: {v.shape}"
            return v[:, :2]

    monkeypatch.setattr(latent_space, "_umap", type("M", (), {"UMAP": FakeUMAP}))
    emb, model = port.reduce_dimensionality_umap(latents_a, pca_components=50)
    assert emb.shape == (60, 2)
    assert model.transform(rng.normal(size=(20, 128)).astype(np.float32)).shape == (20, 2)


# -- statistics, legend, plots ------------------------------------------------------

def _groups(rng):
    ids1 = [f"P{i % 5}" for i in range(13)]
    ids2 = [f"P{i % 6}" for i in range(9)]
    lat = [rng.normal(size=(13, 32)).astype(np.float32), rng.normal(size=(9, 32)).astype(np.float32)]
    proj = [rng.normal(size=(13, 2)).astype(np.float32), rng.normal(size=(9, 2)).astype(np.float32)]
    return ids1, ids2, lat, proj


def test_group_statistics_and_legend_same_bytes(analyzers, tmp_path):
    rng = np.random.default_rng(4)
    ids1, ids2, lat, proj = _groups(rng)
    for name, an in zip(("jax", "port"), analyzers):
        out = tmp_path / name
        out.mkdir()
        an.compute_group_statistics([(proj[0], ids1, "edente"), (proj[1], ids2, "dente")],
                                    [(lat[0], ids1, "edente"), (lat[1], ids2, "dente")], out)
        an.save_color_legend(*an.create_patient_colormap(ids1 + ids2), out / "color_legend.txt")
    for f in ("distance_metrics.txt", "exams_sorted_by_distance.txt", "color_legend.txt"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    # one group only: nothing written, as in the JAX package
    analyzers[1].compute_group_statistics([(proj[0], ids1, "edente")], [(lat[0], ids1, "e")],
                                          tmp_path / "none")
    assert not (tmp_path / "none").exists()


def test_patient_colormap_equal(analyzers):
    ids = [f"P{i}" for i in (3, 1, 12, 3, 7)] + [f"Q{i}" for i in range(12)]
    assert analyzers[1].create_patient_colormap(ids) == analyzers[0].create_patient_colormap(ids)


@pytest.mark.parametrize("color_by_patient", [True, False])
def test_projection_plot_png(analyzers, tmp_path, color_by_patient):
    """The plot decodes at ``SCATTER_SHAPE``; ``"dente"`` markers are filled
    (their centre takes the colour) and ``"edente"`` ones open (white centre);
    an ``.html`` path is written as ``.png``."""
    _, port = analyzers
    pts = np.array([[0.0, 0.0], [10.0, 10.0]], np.float32)
    path = port.plot_projection_2d([(pts[:1], ["A"], "o", "edente"),
                                    (pts[1:], ["B"], "o_filled", "dente")],
                                   str(tmp_path / "plot.html"), color_by_patient=color_by_patient)
    assert path == tmp_path / "plot.png" and not (tmp_path / "plot.html").exists()
    img = read_image(str(path))
    assert img.shape == (*visualization.SCATTER_SHAPE, 3)
    h, w = visualization.SCATTER_SHAPE
    m = visualization.SCATTER_MARGIN
    lo, hi = -0.5, 10.5  # 5% padding of the [0, 10] range
    def at(x, y):
        col = round(m + (x - lo) / (hi - lo) * (w - 2 * m - 1))
        row = round(h - m - 1 - (y - lo) / (hi - lo) * (h - 2 * m - 1))
        return img[row, col]
    assert np.all(at(0.0, 0.0) == 255)  # open: white centre
    assert not np.all(at(10.0, 10.0) == 255)  # filled


@pytest.mark.parametrize("marker", ["o", "^", "s", "d"])
def test_marker_stamps(marker):
    body, edge = visualization._stamps(marker, True)
    ring, none = visualization._stamps(marker, False)
    r = visualization.MARKER_RADIUS
    assert body[r, r] and not ring[r, r] and not none.any()
    assert not (body & edge).any() and ring.sum() > 0


def test_channel_grid_layout(tmp_path):
    rng = np.random.default_rng(0)
    grid = visualization.draw_channel_grid(rng.normal(size=(16, 16)), rng.normal(size=(16, 16)),
                                           rng.normal(size=(10, 4, 4)), frozenset({0, 5}))
    assert grid.shape == (*visualization.channel_grid_shape(10), 3) and grid.dtype == np.uint8
    g, p = visualization.GRID_GAP, visualization.GRID_PANEL
    assert visualization.channel_grid_shape(10) == (4 * p + 5 * g, 4 * p + 5 * g)
    top = g + p + g  # channel 0: first panel of the second row, framed in red
    assert tuple(grid[top, g]) == (214, 39, 40)
    assert tuple(grid[top, g + p + g]) != (214, 39, 40)  # channel 1: no frame
    write_png(str(tmp_path / "grid.png"), grid)
    np.testing.assert_array_equal(read_image(str(tmp_path / "grid.png")), grid)


@pytest.mark.slow
def test_flagship_encode_images_parity_64(tmp_path):
    """``encode_images`` at the flagship's width (``config/vae_dente_no_adv.json``)
    at 64², batch 2 over 3 images."""
    from pti_ldm_vae_tpu_torch.config import load_config

    ae_def = load_config(ROOT / "config" / "vae_dente_no_adv.json")["autoencoder_def"]
    jax_vae = jax_from_config(ae_def, use_pallas_attention=False, s2d_stem=False)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jax_vae.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 1)), jax.random.key(1)))
    vae = autoencoder_from_config(ae_def)
    vae.load_state_dict(state_dict_from_flax(variables, ae_def), strict=True)
    vae.eval()
    rng = np.random.default_rng(0)
    for i in range(3):
        write_tif(str(tmp_path / f"1_HA_2020_01_{i}.tif"),
                  rng.uniform(0.1, 1.0, size=(80, 70)).astype(np.float32))
    paths = sorted(str(p) for p in tmp_path.glob("*.tif"))
    want, _ = jax_ls.LatentSpaceAnalyzer(jax_vae, variables, jax_create_transforms((64, 64)),
                                         batch_size=2).encode_images(paths)
    got, _ = latent_space.LatentSpaceAnalyzer(vae, create_transforms((64, 64)), batch_size=2,
                                              device=CPU).encode_images(paths)
    np.testing.assert_allclose(got, want, **TOL)
    shutil.rmtree(tmp_path)

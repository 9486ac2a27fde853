"""The PyTorch port's config resolver reads every shipped config exactly as the
JAX package does."""

from pathlib import Path

import pytest

from pti_ldm_vae_tpu import config as jax_config
from pti_ldm_vae_tpu_torch import config

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "config").glob("*.json"))


def test_all_configs_found():
    assert len(CONFIGS) == 12


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_resolves_identically(path):
    ours = config.load_config(path)
    assert ours == jax_config.load_config(path)
    assert config.filter_comment_keys(ours) == jax_config.filter_comment_keys(ours)
    assert vars(config.load_config_namespace(path)) == vars(jax_config.load_config_namespace(path))


@pytest.mark.parametrize("value", [True, False, "true", "Yes", "0", "maybe", None, 1, 0, "y"])
def test_resolve_bool_identical(value):
    assert config.resolve_bool(value) is jax_config.resolve_bool(value)


def test_chained_and_unresolvable_refs():
    doc = {"a": "@b", "b": "@c.0", "c": [7], "d": "@missing", "e": {"x.y": 3}, "f": "@e.x.y"}
    assert config.resolve_refs(doc) == jax_config.resolve_refs(doc)
    assert config.resolve_refs(doc)["a"] == 7 and config.resolve_refs(doc)["d"] == "@missing"

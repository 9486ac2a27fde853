"""JSON config loading with MONAI-``ConfigParser``-compatible ``@ref`` resolution.

The reference drives every workload from JSON configs parsed by MONAI's
``ConfigParser`` (reference: ``vae_scripts/train_vae.py:100-124``,
``src/pti_ldm_vae/utils/vae_loader.py:11-24``). Values like
``"in_channels": "@image_channels"`` or
``"ar_vae_weight": "@regularized_attributes.gamma"`` are references into the
same document, resolved recursively. Keys starting with ``_`` are inline
comments; ConfigParser keeps them and use sites filter them
(``train_vae.py:377``), so we keep them too.

This is a small pure-Python resolver with the same observable semantics so the
*identical* config files drive both frameworks. Nesting separators ``.``,
``#`` and ``::`` are all accepted (superset of MONAI's id syntax). A reference
that cannot be resolved is left as the literal string — the reference train
script tolerates that too (``train_vae.py:784-792``).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from types import SimpleNamespace
from typing import Any

__all__ = [
    "load_config",
    "load_config_namespace",
    "resolve_refs",
    "filter_comment_keys",
    "resolve_bool",
]

_SEP_RE = re.compile(r"::|#|\.")


def _lookup(root: Any, ref_id: str) -> tuple[bool, Any]:
    """Look up ``ref_id`` (e.g. ``regularized_attributes.gamma``) in ``root``.

    Returns (found, value). Tries progressively splitting on any of the
    accepted separators; integer path components index into lists.
    """
    parts = [p for p in _SEP_RE.split(ref_id) if p != ""]

    def walk(node: Any, remaining: list[str]) -> tuple[bool, Any]:
        if not remaining:
            return True, node
        head, *rest = remaining
        if isinstance(node, dict):
            # Greedy: a key may itself contain a separator char; try longest
            # joined prefixes first so keys like "a.b" still resolve.
            for join_len in range(len(remaining), 0, -1):
                candidate = ".".join(remaining[:join_len])
                if candidate in node:
                    found, value = walk(node[candidate], remaining[join_len:])
                    if found:
                        return True, value
            return False, None
        if isinstance(node, list):
            try:
                idx = int(head)
            except ValueError:
                return False, None
            if 0 <= idx < len(node):
                return walk(node[idx], rest)
            return False, None
        return False, None

    return walk(root, parts)


def resolve_refs(config: Any, *, max_passes: int = 16) -> Any:
    """Resolve ``@ref`` strings anywhere inside ``config`` (in-document).

    Multiple passes handle chained references (``@a`` -> ``@b`` -> value).
    Unresolvable references are left as their literal string.
    """

    def resolve_node(node: Any, root: Any) -> tuple[Any, bool]:
        changed = False
        if isinstance(node, dict):
            out = {}
            for key, value in node.items():
                new_value, child_changed = resolve_node(value, root)
                out[key] = new_value
                changed |= child_changed
            return out, changed
        if isinstance(node, list):
            out_list = []
            for value in node:
                new_value, child_changed = resolve_node(value, root)
                out_list.append(new_value)
                changed |= child_changed
            return out_list, changed
        if isinstance(node, str) and node.startswith("@"):
            found, value = _lookup(root, node[1:])
            if found:
                return value, True
            return node, False
        return node, changed

    current = config
    for _ in range(max_passes):
        current, changed = resolve_node(current, current)
        if not changed:
            break
    return current


def filter_comment_keys(node: Any) -> Any:
    """Recursively drop ``_``-prefixed comment keys (use-site convention).

    Mirrors the reference's use-site filtering, e.g.
    ``{k: v for k, v in raw_mapping.items() if not str(k).startswith("_")}``
    (``train_vae.py:377``, ``dataloaders.py:440``).
    """
    if isinstance(node, dict):
        return {
            key: filter_comment_keys(value)
            for key, value in node.items()
            if not str(key).startswith("_")
        }
    if isinstance(node, list):
        return [filter_comment_keys(value) for value in node]
    return node


def load_config(config_file: str | Path) -> dict[str, Any]:
    """Load a JSON config file and resolve ``@ref`` references.

    Comment keys are preserved (parity with ConfigParser); call
    :func:`filter_comment_keys` at use sites that need them stripped.
    """
    with open(config_file, encoding="utf-8") as fh:
        raw = json.load(fh)
    return resolve_refs(raw)


def load_config_namespace(config_file: str | Path) -> SimpleNamespace:
    """Load a config as a ``SimpleNamespace`` (parity with ``load_vae_config``,
    reference ``vae_loader.py:11-24``)."""
    return SimpleNamespace(**load_config(config_file))


def resolve_bool(value: Any) -> bool:
    """Interpret string booleans safely, matching reference ``_resolve_bool``
    (``train_vae.py:246-259``): unrecognized strings default to False."""
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        lowered = value.strip().lower()
        if lowered in {"true", "1", "yes", "y"}:
            return True
        return False
    if value is None:
        return False
    return bool(value)

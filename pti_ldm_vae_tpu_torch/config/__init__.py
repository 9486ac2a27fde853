from .resolver import (
    filter_comment_keys,
    load_config,
    load_config_namespace,
    resolve_bool,
    resolve_refs,
)

__all__ = [
    "filter_comment_keys",
    "load_config",
    "load_config_namespace",
    "resolve_bool",
    "resolve_refs",
]

"""Frozen dataclasses registered as JAX pytrees.

`dataclass` makes a frozen dataclass whose fields are pytree leaves unless
declared with `field(static=True)`. Static fields live in the treedef, so
`jax.jit` specializes (and caches) on their values instead of tracing them.
`.replace(**changes)` returns a copy with some fields changed.
"""
from __future__ import annotations

import dataclasses

import jax


def field(static: bool = False, **kwargs):
    """A dataclass field; `static=True` keeps it out of the pytree leaves."""
    metadata = dict(kwargs.pop("metadata", None) or {}, static=static)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = _replace
    return cls

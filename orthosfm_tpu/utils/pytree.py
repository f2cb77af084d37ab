"""Frozen dataclasses that are JAX pytrees.

`pytree_dataclass` makes a class a frozen dataclass, registers it with
`jax.tree_util.register_dataclass` and gives it a `.replace(**changes)`
method. Fields declared with `static_field` are pytree metadata (part of the
tree structure, so a jitted function retraces when they change); every other
field is a leaf.
"""

from __future__ import annotations

import dataclasses

import jax

_STATIC = "static"


def static_field(default):
    """A metadata (non-leaf) field with a default value."""
    return dataclasses.field(default=default, metadata={_STATIC: True})


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get(_STATIC)],
        meta_fields=[f.name for f in fields if f.metadata.get(_STATIC)])

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    cls.replace = replace
    return cls

"""Frozen-dataclass pytrees.

`@dataclass` turns a class into a frozen dataclass registered with
`jax.tree_util.register_dataclass`, so instances jit, shard and
differentiate like any pytree.  Fields declared with
`field(pytree_node=False)` are static: they live in the treedef (hashable,
part of the jit cache key) instead of being traced.  Every instance gets
`.replace(**changes)`.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration + `.replace`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls

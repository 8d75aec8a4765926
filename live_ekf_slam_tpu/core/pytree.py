"""Frozen dataclasses registered as JAX pytrees.

Every field is a pytree child, so the containers flow through
jit/vmap/scan/shard_map. ``.replace(**kw)`` returns a copy with fields
changed; ``field`` is ``dataclasses.field`` (e.g. ``field(default=None)``).
"""

from __future__ import annotations

import dataclasses

import jax

field = dataclasses.field


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Decorator: frozen dataclass + pytree registration + ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(
        cls, data_fields=names, meta_fields=[]
    )

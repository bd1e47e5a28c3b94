"""Row gathers with a zero fill: out[i] = table[idx[i]].

Semantics: rows with idx outside [0, T) return ZEROS (handy for -1 miss
sentinels — callers need no clamp).  The gather is XLA's own: callers
consolidate many per-attribute lookups into ONE wide-row fetch of a packed
table (integrator/shading.py, models/lights.py, ops/texture.py), and XLA
fuses the masking into the consumers.  The VJP is XLA's scatter-add.
"""

from __future__ import annotations

import jax.numpy as jnp


def take_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """out[i] = table[idx[i]]; zeros where idx is out of range.

    table f32[T, W], idx i32-like[N].
    """
    t = table.shape[0]
    safe = jnp.clip(idx, 0, t - 1)
    rows = table[safe]
    good = ((idx >= 0) & (idx < t))[:, None]
    return jnp.where(good, rows, 0.0)


def take_values(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """1-D convenience: out[i] = table[idx[i]] for table f32[T]."""
    return take_rows(table[:, None], idx)[:, 0]

"""Cross-shard ray exchange: ppermute ring rotation of ray slabs.

SURVEY section 2.10 (ring-exchange analog): under tile sharding each
device's bounce workload diverges — a sky-heavy tile finishes its live
rays early while a geometry-heavy tile keeps full blocks busy.  Because
XLA demands static shapes, the exchange is a STATIC symmetric rotation:
every shard ships the same-size tail SLAB of its (detached) rays one step
around the ring (`jax.lax.ppermute`), traces the received slab
alongside its own head rays, and ships the slab's results back with the
inverse rotation.  Expected live-lane load evens out across shards
whenever occupancy is uncorrelated with shard index; a dynamic quota would
require dynamic shapes, which XLA's programming model trades away.

Ray tracing is a pure per-ray function, so the rotation is semantically
invisible: results return in the caller's order and equal the local trace
(tested in tests/test_sharding.py).  Wired into the integrator via
RenderConfig.exchange_axis — render_sample_sharded(..., exchange=True)
sets it to the mesh tile axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _ring_shift(x, axis: str, shift: int):
    n = jax.lax.axis_size(axis)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis, perm)


def with_ring_exchange(trace, o, d, t_max, axis: str, frac: float = 0.25):
    """Run `trace(o, d, t_max) -> pytree of [N]-leading arrays` with the
    tail `frac` of rays rotated one ring step before tracing (and their
    results rotated back).  o/d/t_max must be DETACHED (sampling-decision
    data): gradients do not cross shards here — parameter gradients ride
    the train step's psum instead."""
    n_loc = o.shape[0]
    m = max(1, int(n_loc * frac))
    cut = n_loc - m
    sg = jax.lax.stop_gradient
    o, d, t_max = sg(o), sg(d), sg(t_max)
    o_all = jnp.concatenate([o[:cut], _ring_shift(o[cut:], axis, 1)])
    d_all = jnp.concatenate([d[:cut], _ring_shift(d[cut:], axis, 1)])
    t_all = jnp.concatenate([t_max[:cut],
                             _ring_shift(t_max[cut:], axis, 1)])
    res = trace(o_all, d_all, t_all)
    return jax.tree.map(
        lambda r: jnp.concatenate(
            [r[:cut], _ring_shift(r[cut:], axis, -1)]), res)

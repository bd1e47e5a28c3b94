"""Multi-device sharding: image-tile data parallelism over a device mesh.

The reference is strictly single-device (one Vulkan queue,
`src/pbr_engine/core/pbr/core/GpuHandle.cpp:76-80`; SURVEY.md section 2.10).
This module is the new distributed backend the north star requires:

  * a `jax.sharding.Mesh` over (tiles,) — or (hosts, chips) reshaped flat —
    with IMAGE ROWS (tiles) and the per-sample ray batch sharded across it;
  * scene/BVH/material arrays REPLICATED per device (they are small relative
    to ray state; BASELINE.json: "replicating the BVH and scene buffers per
    host");
  * film assembly = out_specs row-sharding (an all_gather only materializes
    if a consumer needs the full image);
  * gradient all-reduce = psum over the mesh inside the backward of
    shard_map (grad/ wires this into inverse rendering).

Shard-invariance: per-ray RNG keys derive from GLOBAL pixel ids
(core/rng.py), so an N-device render is bitwise the single-device render.

SURVEY section 2.10 row map (where each parallelism analog lives):
  DP (rays/spp)      -> render_sharded / render_sharded_2d (spp axis psum)
  TP-analog (tiles)  -> render_sample_sharded row sharding
  PP-analog          -> scan frame batching
  SP/CP-analog       -> the path-depth loop is sequential by nature
                        (RR-bounded); its per-lane state never leaves the
                        device — "queue segments" are the per-bounce trace
                        calls, already sharded by tiles, with per-call
                        live-lane compaction inside the tracer
                        (ops/blocktrace.py sort + n_valid=0 block skip)
  Ring exchange      -> parallel/exchange.py ppermute slab rotation
  EP                 -> n/a (no expert-style routing in a renderer)
  Comm backend       -> parallel/distributed.py (jax.distributed bootstrap)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.camera import Camera
from ..core.film import Film
from ..integrator.path import RenderConfig, render_sample
from ..scene.types import Scene

TILE_AXIS = "tiles"


def make_mesh(devices=None, axis_name: str = TILE_AXIS) -> Mesh:
    """1-D device mesh over which image tiles are sharded."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Explicitly place every scene array replicated on the mesh (the
    TransferStager analog: one host->HBM staging of the whole arena,
    SURVEY.md section 3.4)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), scene)


def _check_divisible(height: int, n: int):
    if height % n:
        raise ValueError(
            f"image height {height} must divide by mesh size {n} "
            f"(pad the film or change the tile split)")


def render_sample_sharded(scene: Scene, camera: Camera, key: jax.Array,
                          cfg: RenderConfig, mesh: Mesh,
                          exchange: bool = False) -> jnp.ndarray:
    """One spp over the mesh: each device renders height/n_devices rows.

    exchange=True routes the integrator's block-tracer calls through the
    ppermute ring ray exchange (parallel/exchange.py): each shard rotates a
    fixed tail slab of its rays one ring step, evening live-lane
    load across tiles of unequal occupancy.  Semantically invisible
    (results return in caller order; tested against exchange=False).

    Returns the full [H, W, 3] radiance (row-sharded across devices).
    """
    import dataclasses
    n = mesh.devices.size
    _check_divisible(cfg.height, n)
    rows = cfg.height // n
    if exchange:
        cfg = dataclasses.replace(cfg, exchange_axis=TILE_AXIS)

    def tile_fn(scene, camera, key):
        i = jax.lax.axis_index(TILE_AXIS)
        return render_sample(scene, camera, key, cfg,
                             row_start=i * rows, n_rows=rows)

    # check_vma=True: shard-map's varying-axis checking is ON — integrator
    # scan/while carries derive their inits from the per-ray direction
    # arrays (ops/intersect.py, ops/blocktrace.py, ops/traverse.py) so the
    # carry variance matches without blanket escapes.
    fn = shard_map(tile_fn, mesh=mesh,
                   in_specs=(P(), P(), P()),
                   out_specs=P(TILE_AXIS, None, None))
    return fn(scene, camera, key)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_sharded(scene: Scene, camera: Camera, key: jax.Array,
                   cfg: RenderConfig, mesh: Mesh) -> Film:
    """Full sharded render: scan over spp, tiles over the mesh."""
    film = Film.zeros(cfg.height, cfg.width)
    keys = jax.random.split(key, cfg.spp)

    def body(f, k):
        return f.add_samples(render_sample_sharded(scene, camera, k, cfg,
                                                   mesh)), None

    film, _ = jax.lax.scan(body, film, keys)
    return film


# ---------------------------------------------------------------------------
# 2-D mesh: tiles x spp (TP-analog x DP, SURVEY section 2.10)
# ---------------------------------------------------------------------------

SPP_AXIS = "spp"


def make_mesh_2d(n_tiles: int, n_spp: int, devices=None) -> Mesh:
    """(tiles, spp) mesh: image rows shard over `tiles` (the TP-analog of
    the wavefront queue's tile dimension), samples-per-pixel shard over
    `spp` (pure data parallelism over independent MC samples)."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < n_tiles * n_spp:
        raise ValueError(
            f"mesh ({n_tiles} tiles x {n_spp} spp) needs "
            f"{n_tiles * n_spp} devices, only {len(devices)} available")
    devices = np.asarray(devices[: n_tiles * n_spp]).reshape(
        n_tiles, n_spp)
    return Mesh(devices, (TILE_AXIS, SPP_AXIS))


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_sharded_2d(scene: Scene, camera: Camera, key: jax.Array,
                      cfg: RenderConfig, mesh: Mesh) -> Film:
    """Render over a (tiles, spp) mesh with a PLACED psum over the spp axis.

    Each device renders (height/n_tiles rows) x (spp/n_spp samples); sample
    films all-reduce over the spp axis, rows assemble by out_specs.
    Per-ray RNG keys derive from (global sample index, global pixel id), so
    the result is bitwise `render()` up to f32 psum-reduction order.
    """
    nt = mesh.shape[TILE_AXIS]
    ns = mesh.shape[SPP_AXIS]
    _check_divisible(cfg.height, nt)
    if cfg.spp % ns:
        raise ValueError(f"spp {cfg.spp} must divide by mesh axis "
                         f"'{SPP_AXIS}' size {ns}")
    rows = cfg.height // nt
    spp_local = cfg.spp // ns
    all_keys = jax.random.split(key, cfg.spp)

    def tile_fn(scene, camera, keys):
        i = jax.lax.axis_index(TILE_AXIS)
        j = jax.lax.axis_index(SPP_AXIS)
        local = jax.lax.dynamic_slice_in_dim(keys, j * spp_local,
                                             spp_local)

        def body(hdr, k):
            r = render_sample(scene, camera, k, cfg,
                              row_start=i * rows, n_rows=rows)
            return hdr + r, None

        init = jnp.zeros((rows, cfg.width, 3), jnp.float32)
        init = jax.lax.pcast(init, (TILE_AXIS, SPP_AXIS), to="varying")
        hdr, _ = jax.lax.scan(body, init, local)
        # Placed all-reduce of sample sums over the spp axis.
        return jax.lax.psum(hdr, SPP_AXIS)

    fn = shard_map(tile_fn, mesh=mesh,
                   in_specs=(P(), P(), P()),
                   out_specs=P(TILE_AXIS, None, None))
    hdr = fn(scene, camera, all_keys)
    return Film(hdr=hdr, spp=jnp.asarray(cfg.spp, jnp.float32))

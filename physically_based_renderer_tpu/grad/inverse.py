"""Inverse rendering: optimize scene parameters against target images.

BASELINE config #5: "recover albedo/roughness textures + emitter radiance
via pixel-loss gradients, multi-host sharded tiles".  The reference has no
training of any kind; this subsystem is new.

Structure: a `TrainableParams` pytree selects which scene quantities are
optimized; `apply_params` grafts them into a Scene; `make_train_step` builds
a jitted (optionally mesh-sharded) step: forward render -> pixel loss ->
reverse-mode gradients (through the detached-sampling estimator, see
integrator/path.py) -> optax update.  Under a mesh the whole step runs in
shard_map with an EXPLICITLY PLACED `jax.lax.psum` gradient all-reduce over
the tile axis (make_train_step_spmd) — the collective the north star
prescribes, not GSPMD propagation.  Vertex optimization keeps acceleration
structures live by refitting the cluster grid on-device every step
(_with_live_accel).
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import optax
from ..core import struct

from ..core.camera import Camera
from ..integrator.path import RenderConfig, render
from ..scene.types import Scene


@struct.dataclass
class TrainableParams:
    """Optimizable subset of the scene. None = frozen (not a leaf)."""

    base_color_factor: Any = None   # f32[M,4]
    roughness_factor: Any = None    # f32[M]
    metallic_factor: Any = None     # f32[M]
    emissive_factor: Any = None     # f32[M,3]
    texture_data: Any = None        # f32[R,4] flat texel arena
    env_data: Any = None            # f32[EH,EW,3]
    vertex_positions: Any = None    # f32[V,3]

    @classmethod
    def from_scene(cls, scene: Scene, *, base_color=False, roughness=False,
                   metallic=False, emissive=False, textures=False,
                   env=False, vertices=False) -> "TrainableParams":
        return cls(
            base_color_factor=scene.materials.base_color_factor
            if base_color else None,
            roughness_factor=scene.materials.roughness_factor
            if roughness else None,
            metallic_factor=scene.materials.metallic_factor
            if metallic else None,
            emissive_factor=scene.materials.emissive_factor
            if emissive else None,
            texture_data=scene.textures.texels if textures else None,
            env_data=scene.env.data if (env and scene.env is not None)
            else None,
            vertex_positions=scene.geometry.positions if vertices else None,
        )


def apply_params(scene: Scene, p: TrainableParams) -> Scene:
    """Graft trainable parameters into the scene (with physical clamps)."""
    mats = scene.materials
    if p.base_color_factor is not None:
        mats = mats.replace(base_color_factor=jnp.clip(
            p.base_color_factor, 0.0, 1.0))
    if p.roughness_factor is not None:
        mats = mats.replace(roughness_factor=jnp.clip(
            p.roughness_factor, 0.0, 1.0))
    if p.metallic_factor is not None:
        mats = mats.replace(metallic_factor=jnp.clip(
            p.metallic_factor, 0.0, 1.0))
    if p.emissive_factor is not None:
        mats = mats.replace(emissive_factor=jnp.maximum(
            p.emissive_factor, 0.0))
    scene = scene.replace(materials=mats)
    if p.texture_data is not None:
        scene = scene.replace(textures=scene.textures.replace(
            texels=jnp.clip(p.texture_data, 0.0, None)))
    if p.env_data is not None:
        scene = scene.replace(env=scene.env.replace(
            data=jnp.maximum(p.env_data, 0.0)))
    if p.vertex_positions is not None:
        scene = scene.replace(geometry=scene.geometry.replace(
            positions=p.vertex_positions))
    return scene


def pixel_loss(hdr: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    """Log-space L2: stable under HDR dynamic range and Monte-Carlo noise.

    (A detached relative-L2 was tried first and diverges here: its 1/hdr^2
    weights amplify the 1-spp gradient noise on near-black pixels ~100x.)
    """
    d = jnp.log1p(jnp.maximum(hdr, 0.0)) - jnp.log1p(jnp.maximum(target,
                                                                 0.0))
    return jnp.mean(d * d)


def _with_live_accel(scene: Scene, params: TrainableParams) -> Scene:
    """Keep acceleration structures valid under vertex optimization.

    Cluster grids refit on-device every step (accel/clusters.refit_clusters)
    so the optimized mesh can never escape its (frozen-partition) AABBs; a
    BVH cannot refit inside jit (host builder), so it is dropped and tracing
    falls back to brute force — correct, just slower.  No-op when
    vertices are frozen.
    """
    if params.vertex_positions is None:
        return scene
    if scene.clusters is not None:
        from ..accel.clusters import refit_clusters
        scene = scene.replace(
            clusters=refit_clusters(scene.clusters, scene.geometry))
    if scene.bvh is not None:
        scene = scene.replace(bvh=None)
    return scene


def make_train_step(scene: Scene, camera: Camera, cfg: RenderConfig,
                    optimizer: optax.GradientTransformation,
                    mesh=None, donate: bool = False, edges=None,
                    edge_samples: int = 1024):
    """Build a jitted train step closed over static config/mesh.

    step(params, opt_state, key, target) -> (params, opt_state, loss)

    With `mesh`, uses the explicit-SPMD step (make_train_step_spmd): the
    whole forward+backward runs inside shard_map with a PLACED
    `jax.lax.psum` gradient all-reduce over the mesh axis.

    donate=True donates the incoming params/opt_state buffers to the step
    (XLA updates them in place — steady-state working set is one copy).
    The CALLER must then treat the passed values as consumed: `fit` opts in
    after decoupling its initial params from the scene's own arrays.

    edges (grad.edge.EdgeTable): enables the primary-visibility BOUNDARY
    gradient for vertex optimization — silhouette edge sampling adds the
    term the detached-sampling interior estimator cannot carry (a moving
    silhouette otherwise produces zero gradient).
    """
    if mesh is not None:
        return make_train_step_spmd(scene, camera, cfg, optimizer, mesh,
                                    donate=donate, edges=edges,
                                    edge_samples=edge_samples)

    def loss_fn(params: TrainableParams, scene, key, target):
        s = _with_live_accel(apply_params(scene, params), params)
        if edges is None:
            film = render(s, camera, key, cfg)
            return pixel_loss(film.mean(), target)
        from .edge import edge_boundary_loss
        k_img, k_edge = jax.random.split(key)
        img = render(s, camera, k_img, cfg).mean()
        loss = pixel_loss(img, target)
        dLdI = jax.grad(pixel_loss)(jax.lax.stop_gradient(img), target)
        return loss + edge_boundary_loss(s, camera, cfg, dLdI, k_edge,
                                         edges, n_samples=edge_samples)

    # Scene rides as a jit ARGUMENT, not a closure, so the step never
    # re-embeds scene buffers as program constants.
    @partial(jax.jit, donate_argnums=(0, 1) if donate else ())
    def step_impl(params, opt_state, scene, key, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, key,
                                                  target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def step(params, opt_state, key, target):
        return step_impl(params, opt_state, scene, key, target)

    return step


def make_train_step_spmd(scene: Scene, camera: Camera, cfg: RenderConfig,
                         optimizer: optax.GradientTransformation, mesh,
                         donate: bool = False, edges=None,
                         edge_samples: int = 1024):
    """Explicit-SPMD train step: shard_map over the mesh's `tiles` axis.

    Per device: render its row band (all spp), local pixel loss, reverse-
    mode gradients — then ONE placed `jax.lax.psum` of the parameter
    gradients over the mesh axis (the gradient all-reduce of the BASELINE
    north star), identical replicated optimizer update on
    every device.  Nothing is left to GSPMD propagation: in_specs place the
    target rows on the axis, out_specs keep params/opt_state replicated.

    With `edges` (BASELINE config #5 "multi-host sharded tiles" + vertex
    recovery): the silhouette boundary term is SHARDED over the mesh axis
    too — each device draws an independent edge_samples//n batch (key
    folded with its axis index), looks its screen points up in the FULL
    image-loss gradient assembled by one placed `jax.lax.all_gather` of
    the per-band dLdI, and the boundary gradient rides the same psum as
    the interior gradients.  psum/n of n independent unbiased estimates is
    the single-device estimator with the same total sample count.

    step(params, opt_state, key, target[H,W,3]) -> (params, opt_state, loss)
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..integrator.path import _sample_radiance
    from ..parallel.sharding import TILE_AXIS, _check_divisible

    n = mesh.shape[TILE_AXIS]
    _check_divisible(cfg.height, n)
    rows = cfg.height // n

    def render_band(params, scene, key, i):
        s = _with_live_accel(apply_params(scene, params), params)
        keys = jax.random.split(key, cfg.spp)

        def body(acc, k):
            band = _sample_radiance(s, camera, k, cfg,
                                    row_start=i * rows, n_rows=rows)
            return acc + band, None

        init = jax.lax.pcast(jnp.zeros((rows, cfg.width, 3), jnp.float32),
                             TILE_AXIS, to="varying")
        hdr, _ = jax.lax.scan(body, init, keys)
        return hdr / cfg.spp

    def local_loss(params, scene, key, target_band):
        i = jax.lax.axis_index(TILE_AXIS)
        if edges is None:
            return pixel_loss(render_band(params, scene, key, i),
                              target_band)
        from .edge import edge_boundary_loss
        k_img, k_edge = jax.random.split(key)
        band = render_band(params, scene, k_img, i)
        loss = pixel_loss(band, target_band)
        # Full-image loss gradient for the edge term's pixel lookups: the
        # global loss is the mean of band losses, so each band's dLdI
        # scales by 1/n; ONE placed all_gather assembles [H, W, 3].
        dband = jax.grad(pixel_loss)(jax.lax.stop_gradient(band),
                                     target_band) / n
        dLdI = jax.lax.all_gather(dband, TILE_AXIS).reshape(
            cfg.height, cfg.width, 3)
        s = _with_live_accel(apply_params(scene, params), params)
        k_shard = jax.random.fold_in(k_edge, i)
        return loss + edge_boundary_loss(
            s, camera, cfg, dLdI, k_shard, edges,
            n_samples=max(edge_samples // n, 1))

    def shard_step(params, opt_state, scene, key, target):
        # pcast the differentiated params to VARYING before value_and_grad:
        # shard_map's autodiff inserts an implicit psum into the backward
        # for replicated inputs (each shard's grad silently becomes the
        # cross-shard SUM), which stacked an n x scaling on top of the
        # explicit all-reduce below — a real bug the r4 parity test's
        # tolerance masked (mesh gradient measured at exactly n x the
        # single-device one).  With varying params the per-shard grads
        # stay local and the ONE placed psum below is the gradient
        # all-reduce.
        params_v = jax.tree.map(
            lambda x: jax.lax.pcast(x, TILE_AXIS, to="varying"), params)
        loss, grads = jax.value_and_grad(local_loss)(params_v, scene, key,
                                                     target)
        # The gradient all-reduce, explicitly placed (mean of band losses).
        grads = jax.tree.map(
            lambda g: jax.lax.psum(g, TILE_AXIS) / n, grads)
        loss = jax.lax.psum(loss, TILE_AXIS) / n
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    sharded = shard_map(
        shard_step, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(TILE_AXIS, None, None)),
        out_specs=(P(), P(), P()))

    # Donation as in make_train_step: consumed params/opt_state buffers are
    # reused for the updated ones.  Scene rides as a jit argument (no
    # per-program constant embedding of the replicated buffers).
    @partial(jax.jit, donate_argnums=(0, 1) if donate else ())
    def step_impl(params, opt_state, scene, key, target):
        return sharded(params, opt_state, scene, key, target)

    def step(params, opt_state, key, target):
        return step_impl(params, opt_state, scene, key, target)

    return step


def fit(scene: Scene, camera: Camera, target: jnp.ndarray,
        params: TrainableParams, cfg: RenderConfig, *, steps: int = 100,
        lr: float = 5e-2, seed: int = 0, mesh=None, log_every: int = 10,
        callback=None, edges=None):
    """Run inverse rendering; returns (params, losses)."""
    opt = optax.adam(lr)
    # Decouple the initial params from the scene's own device buffers
    # (TrainableParams.from_scene aliases them), then run with donation:
    # each step consumes the previous params/opt_state allocation.
    params = jax.tree.map(lambda x: x + 0, params)
    opt_state = opt.init(params)
    step = make_train_step(scene, camera, cfg, opt, mesh=mesh, donate=True,
                           edges=edges)
    key = jax.random.key(seed)
    losses = []
    for i in range(steps):
        key, k = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, k, target)
        losses.append(float(loss))
        if callback is not None and (i % log_every == 0 or i == steps - 1):
            callback(i, losses[-1], params)
    return params, losses

"""Inverse-rendering recovery tests: textures, env map, vertices (+refit),
and the explicit-SPMD train step.

BASELINE north star: "gradients flowing to textures, emitters, and vertex
positions"; VERDICT r1 items #4/#5.  Each test perturbs one parameter
family, optimizes against a clean-render target, and asserts substantial
loss reduction plus parameter movement toward the truth.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from physically_based_renderer_tpu.core.camera import Camera
from physically_based_renderer_tpu.grad.inverse import (
    TrainableParams, apply_params, fit, make_train_step, pixel_loss)
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig, render_image)
from physically_based_renderer_tpu.scene import procedural
from physically_based_renderer_tpu.scene.types import (
    TextureStack, make_scene, with_clusters)


def _textured_quad_scene(tex_rgb):
    """Two-triangle quad facing +z with a base-color texture + directional
    light — the smallest textured differentiable scene."""
    positions = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                         np.float32)
    indices = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    g = procedural._geometry_from_arrays(positions, indices,
                                         np.zeros(2, np.int32), uvs=uvs)
    from physically_based_renderer_tpu.scene.types import (
        DirectionalLight, Materials)
    m = Materials.default(1)
    m = m.replace(base_color_tex=np.array([0], np.int32),
                  roughness_factor=np.ones(1, np.float32))
    h = w = tex_rgb.shape[0]
    data = np.concatenate([tex_rgb,
                           np.ones((h, w, 1), np.float32)], axis=-1)
    tex = TextureStack.from_images([data])
    dl = DirectionalLight(direction=np.array([0, 0, -1], np.float32),
                          radiance=np.array([3.0, 3.0, 3.0], np.float32))
    return make_scene(g, m, textures=tex, directional=dl)


def _cam():
    return Camera.make(position=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0),
                       fov_y=1.0)


CFG = RenderConfig(width=24, height=24, spp=2, max_bounces=1)


def test_recover_texture_data():
    h = 8
    true_tex = np.zeros((h, h, 3), np.float32)
    true_tex[:, : h // 2] = (0.9, 0.2, 0.2)
    true_tex[:, h // 2:] = (0.2, 0.9, 0.3)
    scene_true = _textured_quad_scene(true_tex)
    target = render_image(scene_true, _cam(), 7, CFG)

    scene0 = _textured_quad_scene(np.full((h, h, 3), 0.5, np.float32))
    params = TrainableParams.from_scene(scene0, textures=True)
    params, losses = fit(scene0, _cam(), target, params, CFG, steps=60,
                         lr=0.1, seed=1)
    assert losses[-1] < 0.2 * losses[0]
    rec = np.asarray(params.texture_data)[:, :3].reshape(h, h, 3)
    # Left half should have moved decisively toward red, right toward green.
    assert rec[:, : h // 2, 0].mean() > rec[:, : h // 2, 1].mean() + 0.15
    assert rec[:, h // 2:, 1].mean() > rec[:, h // 2:, 0].mean() + 0.15


def test_recover_env_data():
    true_env = procedural.make_gradient_sky(8, 16, zenith=(2.0, 0.3, 0.3),
                                            horizon=(0.3, 0.3, 2.0),
                                            sun_radiance=(0.0,) * 3)
    g = procedural.make_uv_sphere(radius=1.0, rings=8, sectors=12)
    from physically_based_renderer_tpu.scene.types import Materials
    m = Materials.default(1)
    scene_true = make_scene(g, m, env=true_env)
    target = render_image(scene_true, _cam(), 3, CFG)

    flat_env = procedural.make_gradient_sky(8, 16, zenith=(0.8, 0.8, 0.8),
                                            horizon=(0.8, 0.8, 0.8),
                                            sun_radiance=(0.0,) * 3)
    scene0 = make_scene(g, m, env=flat_env)
    params = TrainableParams.from_scene(scene0, env=True)
    params, losses = fit(scene0, _cam(), target, params, CFG, steps=60,
                         lr=0.1, seed=2)
    assert losses[-1] < 0.3 * losses[0]
    rec = np.asarray(params.env_data)
    # Recovered sky: red channel should dominate blue near the top rows.
    assert rec[:2, :, 0].mean() > rec[:2, :, 2].mean()


def _ramp_quad_scene(dx):
    """Textured quad translated by dx: a smooth u-ramp texture makes pixel
    color depend on WHERE the quad is (through the attached barycentric
    re-intersection -> uv), exercising the INTERIOR vertex gradient in
    isolation.  (Flat-colored pure translation — the visibility-only case —
    is covered by the silhouette edge-sampling term, grad/edge.py, tested
    against finite differences in tests/test_edge_grad.py.)"""
    h = 16
    uu = (np.arange(h, dtype=np.float32) + 0.5) / h
    tex = np.stack([np.tile(uu, (h, 1)),                # red ramps with u
                    1.0 - np.tile(uu, (h, 1)),
                    np.full((h, h), 0.3, np.float32)], axis=-1)
    scene = _textured_quad_scene(tex)
    pos = np.asarray(scene.geometry.positions).copy()
    pos[:, 0] += dx
    scene = scene.replace(geometry=scene.geometry.replace(positions=pos))
    return with_clusters(scene)


def test_recover_vertices_with_cluster_refit():
    # Translation recovery with the block tracer active: _with_live_accel
    # must refit the cluster AABBs each step or the moving quad escapes its
    # frozen boxes and gradients die at the stale-accel boundary.
    cfg = dataclasses.replace(CFG, tracer="block")
    target = render_image(_ramp_quad_scene(0.3), _cam(), 5, cfg)
    scene0 = _ramp_quad_scene(0.0)
    params = TrainableParams.from_scene(scene0, vertices=True)
    params, losses = fit(scene0, _cam(), target, params, cfg, steps=60,
                         lr=2e-2, seed=3)
    moved = (np.asarray(params.vertex_positions)[:, 0].mean()
             - np.asarray(scene0.geometry.positions)[:, 0].mean())
    assert moved > 0.1, f"vertices did not move toward target (dx={moved})"
    # MC-noisy 2-spp loss: assert a clear reduction, not convergence.
    assert min(losses) < 0.5 * losses[0]


def test_refit_clusters_tracks_moved_vertices():
    from physically_based_renderer_tpu.accel.clusters import refit_clusters

    scene = _ramp_quad_scene(0.0)
    g = scene.geometry
    moved = g.replace(positions=jnp.asarray(g.positions) + jnp.asarray(
        [2.0, 0.0, 0.0]))
    grid = refit_clusters(scene.clusters, moved)
    np.testing.assert_allclose(np.asarray(grid.aabb_min)[:, 0],
                               np.asarray(scene.clusters.aabb_min)[:, 0]
                               + 2.0, atol=1e-5)
    # Refit soup must match a fresh pack of the moved geometry.
    from physically_based_renderer_tpu.accel.clusters import pack_soup
    soup_ref = pack_soup(scene.clusters, moved)
    np.testing.assert_allclose(np.asarray(grid.soup), np.asarray(soup_ref),
                               atol=1e-6)


def test_spmd_step_matches_single_device():
    """The explicit shard_map+psum step computes the same loss/update as the
    single-device step (same keys, same spp)."""
    from physically_based_renderer_tpu.parallel.sharding import make_mesh

    scene = procedural.make_cornell_box()
    cam = Camera.make(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                      fov_y=0.95)
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=1)
    target = render_image(scene, cam, 11, cfg)
    params = TrainableParams.from_scene(scene, base_color=True)
    opt = optax.sgd(1e-2)

    step1 = make_train_step(scene, cam, cfg, opt)
    stepN = make_train_step(scene, cam, cfg, opt, mesh=make_mesh(
        jax.devices()[:4]))
    key = jax.random.key(42)
    p1, s1, l1 = step1(params, opt.init(params), key, target)
    pN, sN, lN = stepN(params, opt.init(params), key, target)
    np.testing.assert_allclose(float(l1), float(lN), rtol=1e-4)
    # f32 reduction-order noise (band-mean + psum vs global mean) bounds
    # the achievable agreement of the updated params.
    np.testing.assert_allclose(np.asarray(p1.base_color_factor),
                               np.asarray(pN.base_color_factor), atol=5e-4,
                               rtol=1e-3)
    # Guard against gradient-SCALE bugs the atol above can mask (r5 found
    # an n x inflation from shard_map autodiff's implicit psum stacking on
    # the explicit one): update norms must match to a few percent.
    d1 = np.asarray(p1.base_color_factor) - np.asarray(
        scene.materials.base_color_factor)
    dN = np.asarray(pN.base_color_factor) - np.asarray(
        scene.materials.base_color_factor)
    assert np.linalg.norm(d1) > 0.0
    np.testing.assert_allclose(np.linalg.norm(dN), np.linalg.norm(d1),
                               rtol=0.03)

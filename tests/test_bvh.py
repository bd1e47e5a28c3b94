"""BVH build + traversal tests: structural invariants, exact agreement with
the brute-force oracle, any-hit, refit, and full renders through the BVH
path (SURVEY.md section 7 stage 4: 'Validate vs brute-force on random
scenes')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_renderer_tpu.accel.bvh import (
    build_bvh, bvh_depth, refit_bvh, validate_bvh)
from physically_based_renderer_tpu.ops.intersect import (
    intersect_brute, occluded_brute)
from physically_based_renderer_tpu.ops.traverse import intersect_bvh
from physically_based_renderer_tpu.scene.procedural import (
    make_cornell_box, make_random_tris, make_uv_sphere)


def _rand_rays(n, seed, extent=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("num_tris", [1, 5, 33, 500])
def test_structure(num_tris):
    g = make_random_tris(num_tris, seed=num_tris)
    bvh = build_bvh(g.positions, g.indices)
    validate_bvh(bvh, g.positions, g.indices)
    assert bvh_depth(bvh) < 64


@pytest.mark.parametrize("num_tris", [7, 100, 1000])
def test_matches_brute_force(num_tris):
    g = jax.device_put(make_random_tris(num_tris, seed=1))
    bvh = jax.device_put(build_bvh(g.positions, g.indices))
    o, d = _rand_rays(256, seed=2)
    v0, v1, v2 = g.tri_vertices()
    hb = jax.jit(lambda o, d: intersect_brute(o, d, v0, v1, v2))(o, d)
    ht = jax.jit(lambda o, d: intersect_bvh(bvh, g, o, d))(o, d)
    # same hit distance everywhere (tri ids can differ on exact ties)
    np.testing.assert_allclose(np.asarray(ht.t), np.asarray(hb.t), rtol=1e-5)
    same = np.asarray(ht.tri) == np.asarray(hb.tri)
    assert same.mean() > 0.99  # ties are rare on random scenes


def test_cornell_box_agreement():
    from physically_based_renderer_tpu.scene.types import with_bvh
    scene = jax.device_put(make_cornell_box())
    bvh = jax.device_put(
        with_bvh(make_cornell_box()).bvh)
    o, d = _rand_rays(512, seed=3, extent=0.9)
    o = o + jnp.array([0.0, 1.0, 0.0])  # inside the box
    g = scene.geometry
    v0, v1, v2 = g.tri_vertices()
    hb = jax.jit(lambda o, d: intersect_brute(o, d, v0, v1, v2))(o, d)
    ht = jax.jit(lambda o, d: intersect_bvh(bvh, g, o, d))(o, d)
    np.testing.assert_allclose(np.asarray(ht.t), np.asarray(hb.t), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(ht.tri) >= 0,
                                  np.asarray(hb.tri) >= 0)


def test_any_hit_matches_brute():
    g = jax.device_put(make_random_tris(200, seed=4))
    bvh = jax.device_put(build_bvh(g.positions, g.indices))
    o, d = _rand_rays(256, seed=5)
    t_max = jnp.full((256,), 1.5, jnp.float32)
    v0, v1, v2 = g.tri_vertices()
    ob = jax.jit(lambda o, d: occluded_brute(o, d, v0, v1, v2,
                                             t_max=t_max))(o, d)
    ot = jax.jit(lambda o, d: intersect_bvh(bvh, g, o, d, t_max=t_max,
                                            any_hit=True))(o, d)
    np.testing.assert_array_equal(np.asarray(ot), np.asarray(ob))


def test_per_ray_t_max():
    g = jax.device_put(make_random_tris(50, seed=6))
    bvh = jax.device_put(build_bvh(g.positions, g.indices))
    o, d = _rand_rays(64, seed=7)
    h_full = jax.jit(lambda: intersect_bvh(bvh, g, o, d))()
    # cut every ray off just before its hit -> no hits
    t_cut = jnp.where(h_full.tri >= 0, h_full.t * 0.99, 0.1)
    occ = jax.jit(lambda: intersect_bvh(bvh, g, o, d, t_max=t_cut,
                                        any_hit=True))()
    assert not bool(np.asarray(occ)[np.asarray(h_full.tri) >= 0].any())


def test_refit_after_move():
    g = make_random_tris(100, seed=8)
    bvh = build_bvh(g.positions, g.indices)
    moved = np.asarray(g.positions) + np.array([0.5, 0.0, 0.0], np.float32)
    bvh2 = refit_bvh(bvh, moved, g.indices)
    g2 = jax.device_put(g.replace(positions=jnp.asarray(moved)))
    o, d = _rand_rays(128, seed=9)
    v0, v1, v2 = g2.tri_vertices()
    hb = jax.jit(lambda: intersect_brute(o, d, v0, v1, v2))()
    ht = jax.jit(lambda: intersect_bvh(jax.device_put(bvh2), g2, o, d))()
    np.testing.assert_allclose(np.asarray(ht.t), np.asarray(hb.t), rtol=1e-5)


def test_render_with_bvh_matches_brute():
    """Full Cornell render through the BVH == brute-force render (bitwise
    same sampling, same estimator, only the intersector differs)."""
    from physically_based_renderer_tpu.core.camera import Camera
    from physically_based_renderer_tpu.integrator.path import (
        RenderConfig, render)
    from physically_based_renderer_tpu.scene.types import with_bvh

    scene = make_cornell_box()
    scene_bvh = with_bvh(scene)
    cam = Camera.make(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                      fov_y=0.95)
    cfg = RenderConfig(width=24, height=24, spp=2, max_bounces=2)
    key = jax.random.key(0)
    a = np.asarray(render(scene, cam, key, cfg).mean())
    b = np.asarray(render(scene_bvh, cam, key, cfg).mean())
    np.testing.assert_allclose(b, a, atol=1e-5)


def test_bvh_differentiable_wrt_positions():
    """Hit distance gradient flows through BVH traversal to vertices."""
    g = jax.device_put(make_uv_sphere(rings=6, sectors=8))
    bvh = jax.device_put(build_bvh(g.positions, g.indices))
    # off-axis ray (avoid exact-vertex degeneracy at the poles/equator)
    o = jnp.array([[0.13, 0.21, 3.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])

    def hit_t(scale):
        g2 = g.replace(positions=g.positions * scale)
        return intersect_bvh(bvh, g2, o, d).t[0]

    assert float(hit_t(jnp.float32(1.0))) < 3.0  # actually hits
    grad = jax.jit(jax.grad(hit_t))(jnp.float32(1.0))
    eps = 1e-3
    fd = (hit_t(jnp.float32(1.0 + eps))
          - hit_t(jnp.float32(1.0 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(grad), float(fd), rtol=1e-2)


@pytest.mark.parametrize("k", [32, 128])
def test_triton_tracer_matches_brute(k):
    """The Triton block tracer (Pallas interpreter) agrees with brute force
    on closest hit and on sorted any-hit, at cluster widths 32 and 128."""
    from physically_based_renderer_tpu.ops.blocktrace import intersect_blocks
    from physically_based_renderer_tpu.scene.types import (Materials,
                                                           make_scene,
                                                           with_clusters)

    g = make_uv_sphere(radius=1.0, rings=20, sectors=20)
    scene = with_clusters(make_scene(g, Materials.default(1)), k=k)
    assert scene.clusters.k == k
    assert scene.clusters.soup.shape[1:] == (9, k)

    rng = np.random.default_rng(1)
    n = 600
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    h = intersect_blocks(scene.clusters, scene.geometry, o, d, t_min=1e-4,
                         block=128, max_u=96, kernel="triton",
                         interpret=True)
    v0, v1, v2 = scene.geometry.tri_vertices()
    hb = intersect_brute(o, d, v0, v1, v2, t_min=1e-4)
    t_p, t_b = np.asarray(h.t), np.asarray(hb.t)
    hit_match = np.isclose(t_p, t_b, rtol=1e-4, atol=1e-5) | (
        (t_p > 1e29) & (t_b > 1e29))
    assert hit_match.all()
    assert (np.asarray(h.tri) == np.asarray(hb.tri)).all()

    occ = intersect_blocks(scene.clusters, scene.geometry, o, d, t_min=1e-4,
                           t_max=3.0, any_hit=True, block=128, max_u=96,
                           sort=True, kernel="triton", interpret=True)
    ob = occluded_brute(o, d, v0, v1, v2, t_min=1e-4, t_max=3.0)
    assert (np.asarray(occ) == np.asarray(ob)).all()


@pytest.mark.parametrize("k", [32, 128])
def test_triton_last_candidate_and_tiny_scene(k):
    """Regressions: (a) a winner in a block's LAST candidate slot (the
    candidate loop must run to n_valid, not stop a slot early); (b) scenes
    with fewer clusters than the ray tile has lanes, and a ray block
    smaller than the default tile."""
    from physically_based_renderer_tpu.ops.blocktrace import intersect_blocks
    from physically_based_renderer_tpu.scene.types import (Materials,
                                                           make_scene,
                                                           with_clusters)

    # (a) 159 tris; rays aimed at every tri so winners land in every
    # candidate slot, including the last one of each block.
    g = make_random_tris(159, seed=3)
    scene = with_clusters(make_scene(g, Materials.default(1)), k=k)
    v0, v1, v2 = scene.geometry.tri_vertices()
    centers = np.asarray((v0 + v1 + v2) / 3.0)
    o = jnp.asarray(centers + np.array([0, 0, 5.0], np.float32))
    d = jnp.asarray(np.tile(np.array([[0, 0, -1.0]], np.float32),
                            (len(centers), 1)))
    h = intersect_blocks(scene.clusters, scene.geometry, o, d, t_min=1e-4,
                         block=128, max_u=96, kernel="triton",
                         interpret=True)
    hb = intersect_brute(o, d, v0, v1, v2, t_min=1e-4)
    t_p, t_b = np.asarray(h.t), np.asarray(hb.t)
    ok = np.isclose(t_p, t_b, rtol=1e-4, atol=1e-5) | (
        (t_p > 1e29) & (t_b > 1e29))
    assert ok.all()

    # (b) tiny scene: 60-tri sphere -> one or two clusters, 8-ray blocks.
    g2 = make_uv_sphere(radius=1.0, rings=5, sectors=6)
    s2 = with_clusters(make_scene(g2, Materials.default(1)), k=k)
    assert s2.clusters.num_clusters < 4
    o2 = jnp.asarray(np.array([[0, 0, 3.0]] * 8, np.float32))
    d2 = jnp.asarray(np.tile(np.array([[0, 0, -1.0]], np.float32), (8, 1)))
    h2 = intersect_blocks(s2.clusters, s2.geometry, o2, d2, t_min=1e-4,
                          block=8, max_u=96, kernel="triton",
                          interpret=True)
    v0b, v1b, v2b = s2.geometry.tri_vertices()
    hb2 = intersect_brute(o2, d2, v0b, v1b, v2b, t_min=1e-4)
    np.testing.assert_allclose(np.asarray(h2.t), np.asarray(hb2.t),
                               rtol=1e-4)

"""Triton block tracer (ops/pallas_trace.py) in the Pallas interpreter,
the tracer dispatch, and the kernel-level contract of phase B.

The compiled kernel only builds for an NVIDIA GPU; `test_compiled_*` runs
there (gpu marker) and chip_smoke.py checks it at full size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_renderer_tpu.core.camera import Camera
from physically_based_renderer_tpu.integrator import path as path_mod
from physically_based_renderer_tpu.integrator.path import (RenderConfig,
                                                           render,
                                                           select_tracer)
from physically_based_renderer_tpu.ops import blocktrace
from physically_based_renderer_tpu.ops.blocktrace import intersect_blocks
from physically_based_renderer_tpu.ops.intersect import (intersect_brute,
                                                         occluded_brute)
from physically_based_renderer_tpu.ops.pallas_trace import \
    trace_blocks_triton
from physically_based_renderer_tpu.scene.procedural import (
    make_cornell_box, make_random_tris, make_uv_sphere)
from physically_based_renderer_tpu.scene.types import (Materials,
                                                       make_scene,
                                                       with_bvh,
                                                       with_clusters)


def _scene(g, k=32):
    return with_clusters(make_scene(g, Materials.default(1)), k=k)


def _rays(n, seed, extent=2.0):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-extent, extent, (n, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def _same_hits(h, hb):
    t_p, t_b = np.asarray(h.t), np.asarray(hb.t)
    ok = np.isclose(t_p, t_b, rtol=1e-5, atol=1e-6) | (
        (t_p > 1e29) & (t_b > 1e29))
    assert ok.all()
    assert (np.asarray(h.tri) == np.asarray(hb.tri)).all()


@pytest.mark.parametrize("block,lean", [(64, False), (128, True)])
def test_closest_hit_matches_brute(block, lean):
    scene = _scene(make_random_tris(400, seed=2))
    o, d = _rays(300, seed=3)
    v0, v1, v2 = scene.geometry.tri_vertices()
    hb = intersect_brute(o, d, v0, v1, v2, t_min=1e-4)
    h = intersect_blocks(scene.clusters, scene.geometry, o, d, t_min=1e-4,
                         block=block, max_u=96, kernel="triton",
                         interpret=True, lean=lean)
    _same_hits(h, hb)
    if lean:   # lean hits are detached: no barycentrics
        assert not np.asarray(h.u).any() and not np.asarray(h.v).any()


def test_any_hit_per_ray_t_max_matches_brute():
    scene = _scene(make_uv_sphere(radius=1.0, rings=16, sectors=18))
    o, d = _rays(400, seed=5)
    t_max = jnp.asarray(np.random.default_rng(6).uniform(0.0, 4.0, 400),
                        jnp.float32)
    v0, v1, v2 = scene.geometry.tri_vertices()
    ob = occluded_brute(o, d, v0, v1, v2, t_min=1e-4, t_max=t_max)
    for sort in (False, True):
        occ = intersect_blocks(scene.clusters, scene.geometry, o, d,
                               t_min=1e-4, t_max=t_max, any_hit=True,
                               block=64, max_u=96, sort=sort,
                               kernel="triton", interpret=True)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(ob))


def test_partial_final_block_and_tile():
    """A ray count that fills neither the last ray block nor its last
    tile: the padded lanes are dead and every real ray is still traced."""
    scene = _scene(make_random_tris(200, seed=7))
    o, d = _rays(77, seed=8)          # 77 = 2 blocks of 64, 13 in the last
    v0, v1, v2 = scene.geometry.tri_vertices()
    h = intersect_blocks(scene.clusters, scene.geometry, o, d, t_min=1e-4,
                         block=64, max_u=96, kernel="triton",
                         interpret=True)
    _same_hits(h, intersect_brute(o, d, v0, v1, v2, t_min=1e-4))


def test_all_dead_blocks_report_miss():
    """Rays pointing away from the scene die at the root-box cull; their
    blocks have no candidates and the kernel loop runs zero times."""
    scene = _scene(make_uv_sphere(radius=1.0, rings=8, sectors=8))
    n = 256
    o = jnp.tile(jnp.array([[0.0, 0.0, 5.0]]), (n, 1))
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (n, 1))
    h = intersect_blocks(scene.clusters, scene.geometry, o, d, block=64,
                         kernel="triton", interpret=True)
    assert (np.asarray(h.tri) == -1).all()
    assert (np.asarray(h.t) >= 1e29).all()
    occ = intersect_blocks(scene.clusters, scene.geometry, o, d,
                           any_hit=True, t_max=10.0, block=64,
                           kernel="triton", interpret=True)
    assert not np.asarray(occ).any()


def test_candidate_list_shorter_than_tile():
    """max_u smaller than the XLA chunk and the ray tile, on a scene with
    a single cluster: both phase-B versions agree with brute force."""
    scene = _scene(make_uv_sphere(radius=1.0, rings=5, sectors=6), k=128)
    assert scene.clusters.num_clusters == 1
    o, d = _rays(64, seed=9, extent=1.5)
    v0, v1, v2 = scene.geometry.tri_vertices()
    hb = intersect_brute(o, d, v0, v1, v2, t_min=1e-4)
    for kernel, kw in (("triton", {"interpret": True}), ("xla", {})):
        h = intersect_blocks(scene.clusters, scene.geometry, o, d,
                             t_min=1e-4, block=64, max_u=3, kernel=kernel,
                             **kw)
        _same_hits(h, hb)


@pytest.mark.parametrize("any_hit", [False, True])
def test_early_exit_matches_full_scan(any_hit):
    """The early exit changes how many candidates a tile visits, never the
    answer: exit on and off agree bitwise, and with the XLA phase B."""
    scene = _scene(make_random_tris(600, seed=11))
    o, d = _rays(256, seed=12)
    grid = jax.device_put(scene.clusters)
    nb, b = 4, 64
    ob, db = o.reshape(nb, b, 3), d.reshape(nb, b, 3)
    tmb = blocktrace._root_cull(grid, o, d, 1e-4,
                                jnp.full((256,), 2.5 if any_hit else 1e30,
                                         jnp.float32)).reshape(nb, b)
    u_idx, entry, n_valid = blocktrace._select_candidates(
        grid, ob, db, tmb, 1e-4, 96)
    assert int(n_valid.max()) > 2      # there is something to exit from
    runs = [trace_blocks_triton(u_idx, n_valid, entry, ob, db, tmb,
                                grid.soup, t_min=1e-4, any_hit=any_hit,
                                interpret=True, early_exit=ee)
            for ee in (True, False)]
    xla = blocktrace._phase_b_xla(u_idx, n_valid, ob, db, tmb, grid.soup,
                                  1e-4, any_hit)
    for t, flat in runs[1:] + [xla]:
        np.testing.assert_array_equal(np.asarray(runs[0][1]),
                                      np.asarray(flat))
        np.testing.assert_array_equal(np.asarray(runs[0][0]),
                                      np.asarray(t))


def _cornell():
    scene = with_clusters(make_cornell_box())
    cam = Camera.make(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                      fov_y=0.95)
    return scene, cam


def test_cornell_render_triton_matches_block():
    scene, cam = _cornell()
    cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                       block_size=64)
    key = jax.random.key(0)
    a = np.asarray(render(scene, cam, key,
                          dataclasses.replace(cfg, tracer="block")).mean())
    b = np.asarray(render(scene, cam, key, dataclasses.replace(
        cfg, tracer="triton", interpret=True)).mean())
    np.testing.assert_allclose(b, a, atol=1e-5)
    assert a.mean() > 0.0


def test_cornell_gradient_triton_matches_block():
    """d(mean pixel)/d(base colour): the tracer is detached, so both phase-B
    versions must give the same interior gradient."""
    scene, cam = _cornell()
    cfg = RenderConfig(width=8, height=8, spp=1, max_bounces=1,
                       block_size=64)
    key = jax.random.key(1)

    def loss(bc, c):
        s = scene.replace(materials=scene.materials.replace(
            base_color_factor=bc))
        return render(s, cam, key, c).mean().mean()

    bc = jnp.asarray(scene.materials.base_color_factor)
    ga = jax.grad(loss)(bc, dataclasses.replace(cfg, tracer="block"))
    gb = jax.grad(loss)(bc, dataclasses.replace(cfg, tracer="triton",
                                                interpret=True))
    assert np.abs(np.asarray(ga)).sum() > 0.0
    np.testing.assert_allclose(np.asarray(gb), np.asarray(ga), rtol=1e-4,
                               atol=1e-7)


def test_dispatch_by_platform_and_scene(monkeypatch):
    cfg = RenderConfig()
    g = make_random_tris(20, seed=1)
    plain = make_scene(g, Materials.default(1))
    clustered = with_clusters(plain)
    assert select_tracer(clustered, cfg) == "block"      # CPU
    assert select_tracer(with_bvh(plain), cfg) == "bvh"
    assert select_tracer(plain, cfg) == "brute"
    assert select_tracer(clustered, dataclasses.replace(
        cfg, tracer="triton")) == "triton"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert (select_tracer(clustered, cfg)
            == path_mod.GPU_CLUSTER_TRACER)
    # Nothing turns the interpreter on by itself.
    assert RenderConfig().interpret is False


def test_compiled_tracer_off_gpu_raises():
    """Asking for the compiled kernel where it cannot compile is an error,
    never a silent fallback to the interpreter."""
    scene = _scene(make_random_tris(20, seed=1))
    o, d = _rays(8, seed=1)
    with pytest.raises(ValueError, match="NVIDIA GPUs only"):
        intersect_blocks(scene.clusters, scene.geometry, o, d,
                         kernel="triton")
    sc, cam = _cornell()
    with pytest.raises(ValueError, match="NVIDIA GPUs only"):
        render(sc, cam, jax.random.key(0),
               RenderConfig(width=8, height=8, spp=1, tracer="triton"))
    with pytest.raises(ValueError, match="unknown phase-B kernel"):
        intersect_blocks(scene.clusters, scene.geometry, o, d,
                         kernel="mosaic")


@pytest.mark.gpu
def test_compiled_tracer_matches_xla(gpu_device):
    scene = _scene(make_uv_sphere(radius=1.0, rings=40, sectors=40), k=128)
    o, d = _rays(4096, seed=2)
    with jax.default_device(gpu_device):
        hx = intersect_blocks(scene.clusters, scene.geometry, o, d,
                              block=256, kernel="xla")
        ht = intersect_blocks(scene.clusters, scene.geometry, o, d,
                              block=256, kernel="triton")
    np.testing.assert_allclose(np.asarray(ht.t), np.asarray(hx.t),
                               rtol=1e-5)

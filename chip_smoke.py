"""Smoke test of the renderer on one NVIDIA GPU, at full size.

Runs the main path once through the entry points a user calls, in one
process (a JAX process reserves most of the card's memory):

  1. tracer parity on the `helmet` config (~99.4k triangles): the Triton
     block tracer against the XLA block tracer on the helmet's camera,
     bounce and shadow rays, and both against brute force on every 16th
     ray of each stream;
  2. the full `helmet` frame through render_with_stats (512x512, 4 spp,
     3 bounces) with each tracer: finite, rays counted, timed, and the two
     images agreeing;
  3. the CLI renderer writing its PNG (apps.render.main, in-process);
  4. three inverse-rendering steps (grad.inverse.make_train_step) at the
     size of config #5: finite loss, parameters moved;
  5. ACES tonemapping on the card against float64 numpy.

`--four` runs only the multi-card path, on four GPUs: render_sharded over a
4-device mesh against the single-GPU render at 512x512, and the SPMD train
step over 4 against 1 by update-norm parity.

Every phase asserts; any failure exits non-zero with a traceback.  The last
line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

    python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

# Tolerances, each with its reason:
# t from the Triton kernel vs XLA / brute force: both are float32
# Moller-Trumbore on the same rows, but Triton may contract a*b+c into FMA
# and divide differently, so t agrees to a few ulp, not bitwise.
T_RTOL = 1e-5
# Frames with the two tracers, same key: identical estimator and samples;
# only ties between triangles at equal t (edges) may resolve differently.
FRAME_REL_TOL = 1e-3
# Ceiling, per helmet stream, on the share of brute-force hits that the
# block tracers lose because the ray's block needed more than max_u
# candidate clusters.  Camera rays lost 0 of 5872 on one H100.  The
# scattered streams lose most of theirs (468/601 bounce, 556/829 area and
# 419/526 env shadow rays; ROADMAP item 0): those ceilings sit just above
# that reading so that any further loss fails, and come down to the
# camera's once the cap is fixed.
BRUTE_LOST_MAX = {"camera": 2e-3, "bounce": 0.80, "shadow_area": 0.69,
                  "shadow_env": 0.82}
FOUR_SIDE = 512      # frame side of the four-GPU sharded render
# Tonemap on the card vs float64: float32 math with HIGHEST-precision
# colour matrices (no TF32), so the error is float32 rounding.
TONEMAP_ATOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_hits(name, t, tri, t_ref, tri_ref):
    """t allclose at T_RTOL (misses on both sides count as equal); triangle
    ids equal except where the two hits are a tie within that tolerance."""
    t, tri = np.asarray(t), np.asarray(tri)
    t_ref, tri_ref = np.asarray(t_ref), np.asarray(tri_ref)
    miss, miss_ref = t > 1e29, t_ref > 1e29
    t_ok = (miss & miss_ref) | (~miss & ~miss_ref & np.isclose(
        t, t_ref, rtol=T_RTOL, atol=0.0))
    bad_t = int((~t_ok).sum())
    tie = ~miss & np.isclose(t, t_ref, rtol=T_RTOL, atol=0.0)
    bad_tri = int(((tri != tri_ref) & ~tie).sum())
    log(f"  {name}: {t.size} rays, {int((~miss).sum())} hits, "
        f"t mismatches {bad_t}, tri mismatches outside ties {bad_tri}, "
        f"tied tri swaps {int(((tri != tri_ref) & tie).sum())}")
    assert bad_t == 0 and bad_tri == 0, name


def phase_tracer_parity(scene, camera, cfg):
    from bench import helmet_streams
    from physically_based_renderer_tpu.ops.blocktrace import intersect_blocks
    from physically_based_renderer_tpu.ops.intersect import (intersect_brute,
                                                             occluded_brute)
    log("[1] tracer parity on helmet rays (Triton vs XLA block tracer vs "
        "brute force)")
    grid, geom = scene.clusters, scene.geometry
    streams = helmet_streams(scene, camera, cfg)
    out = {}
    for name, (o, d, tmax, any_hit, sort) in streams.items():
        t_min = 0.0 if name == "camera" else cfg.ray_eps
        kw = dict(t_min=t_min, t_max=tmax, any_hit=any_hit,
                  block=cfg.block_size, max_u=cfg.max_u, sort=sort)
        out[name] = (
            intersect_blocks(grid, geom, o, d, kernel="triton", **kw),
            intersect_blocks(grid, geom, o, d, kernel="xla", **kw))
        tri_out, xla_out = out[name]
        if any_hit:
            a, b = np.asarray(tri_out), np.asarray(xla_out)
            log(f"  {name}: {a.size} shadow rays, occluded {int(a.sum())}, "
                f"disagreements {int((a != b).sum())}")
            assert (a == b).all(), name
        else:
            check_hits(f"{name} triton vs xla", tri_out.t, tri_out.tri,
                       xla_out.t, xla_out.tri)
    # Brute force (every ray x every triangle) on every 16th ray of each
    # stream; the stride spreads the check over the screen.  A block whose
    # candidate demand exceeds max_u drops clusters (the tracer's cap, see
    # ops/blocktrace.py), so a ray may MISS its true hit, never gain one:
    # a tracer's hit is never nearer than brute force's, a shadow ray is
    # never occluded where brute force finds it open, and both tracers
    # (one phase A) are off on the same rays.  The share of brute-force
    # hits lost is held to BRUTE_LOST_MAX per stream.
    sl = slice(0, None, 16)
    v0, v1, v2 = geom.tri_vertices()
    for name, (o, d, tmax, any_hit, _) in streams.items():
        t_min = 0.0 if name == "camera" else cfg.ray_eps
        args = (o[sl], d[sl], tmax[sl])
        if any_hit:
            ref = np.asarray(jax.jit(lambda o, d, t: occluded_brute(
                o, d, v0, v1, v2, t_min=t_min, t_max=t))(*args))
            got = [np.asarray(x)[sl] for x in out[name]]
            off = [g != ref for g in got]
            wrong_way = int((got[0] & ~ref).sum())
        else:
            # t_max here is 0 (dead lane) or unbounded
            ref = np.asarray(jax.jit(lambda o, d, t: jnp.where(
                t > 0.0, intersect_brute(o, d, v0, v1, v2, t_min=t_min).t,
                1e30))(*args))
            got = [np.asarray(h.t)[sl] for h in out[name]]
            off = [~(np.isclose(g, ref, rtol=T_RTOL) | ((g > 1e29)
                                                       & (ref > 1e29)))
                   for g in got]
            wrong_way = int((off[0] & (got[0] < ref)).sum())
        hits = int((ref if any_hit else ref < 1e29).sum())
        lost = int(off[0].sum()) / max(hits, 1)
        log(f"  {name} vs brute (every 16th ray, {ref.size} rays, "
            f"{hits} brute hits): {int(off[0].sum())} rays off, "
            f"{wrong_way} of them the wrong way, lost share {lost:.4f} "
            f"(limit {BRUTE_LOST_MAX[name]:g}), same rays for both "
            f"tracers: {bool((off[0] == off[1]).all())}")
        assert (off[0] == off[1]).all() and wrong_way == 0, name
        assert lost <= BRUTE_LOST_MAX[name], name


def phase_frame(scene, camera, cfg, smi):
    from physically_based_renderer_tpu.integrator.path import (
        render_with_stats, select_tracer)
    log(f"[2] helmet frame, render_with_stats {cfg.width}x{cfg.height} "
        f"{cfg.spp} spp {cfg.max_bounces} bounces (auto tracer: "
        f"{select_tracer(scene, cfg)})")
    key = jax.random.key(0)
    imgs = {}
    for tracer in ("triton", "block"):
        c = dataclasses.replace(cfg, tracer=tracer)
        t0 = time.perf_counter()
        film, count = render_with_stats(scene, camera, key, c)
        img = np.asarray(film.mean())
        first = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            film, count = render_with_stats(scene, camera, key, c)
            jax.block_until_ready(film.hdr)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        rays = float(count)
        assert img.shape == (cfg.height, cfg.width, 3)
        assert np.isfinite(img).all() and rays > 0 and img.mean() > 0
        log(f"  tracer={tracer}: frame {dt:.4f} s, {rays:.0f} rays, "
            f"{rays / dt / 1e6:.2f} M rays/s, first call (compile) "
            f"{first:.1f} s, image mean {img.mean():.5f}  [{smi}]")
        imgs[tracer] = img
    rel = float(np.abs(imgs["triton"] - imgs["block"]).mean()
                / imgs["block"].mean())
    log(f"  triton vs block image: mean |diff| / mean = {rel:.2e} "
        f"(limit {FRAME_REL_TOL:g})")
    assert rel < FRAME_REL_TOL


def phase_cli(tmp, cfg):
    from physically_based_renderer_tpu.apps import render as render_app
    from physically_based_renderer_tpu.core import png
    log("[3] CLI: apps.render.main(['helmet', '-o', ...])")
    out = os.path.join(tmp, "helmet.png")
    rc = render_app.main(["helmet", "-o", out, "--stats"])
    assert rc == 0, rc
    img = png.read(out)
    log(f"  wrote {out}: {img.shape}, mean {img.mean():.2f}")
    assert img.shape == (cfg.height, cfg.width, 3) and img.mean() > 1.0


def phase_train():
    import optax
    from physically_based_renderer_tpu.grad.inverse import (
        TrainableParams, make_train_step)
    from physically_based_renderer_tpu.integrator.path import render_image
    from physically_based_renderer_tpu.scene.types import upload_scene
    from physically_based_renderer_tpu.utils import config as config_mod
    bc = config_mod.get("inverse")
    cfg = bc.render
    log(f"[4] inverse rendering, config #5: {cfg.width}x{cfg.height} "
        f"{cfg.spp} spp, 3 make_train_step steps")
    scene, camera = config_mod.build_scene(bc.scene)
    scene = upload_scene(scene)
    target = render_image(scene, camera, 11, cfg)
    params0 = TrainableParams.from_scene(scene, base_color=True,
                                         roughness=True, emissive=True)
    params = jax.tree.map(lambda x: x * 0.8, params0)
    opt = optax.adam(1e-2)
    step = make_train_step(scene, camera, cfg, opt)
    state = opt.init(params)
    p = params
    for i in range(3):
        p, state, loss = step(p, state, jax.random.key(i), target)
        loss = float(loss)
        log(f"  step {i}: loss {loss:.6f}")
        assert np.isfinite(loss)
    moved = max(float(jnp.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(p), jax.tree.leaves(params)))
    log(f"  max parameter change {moved:.3e}")
    assert moved > 0.0


def phase_tonemap():
    from physically_based_renderer_tpu.core.tonemap import (ACES_INPUT,
                                                            ACES_OUTPUT,
                                                            aces_gamma)
    log("[5] aces_gamma on the card vs float64 numpy")
    hdr = np.random.default_rng(0).uniform(0.0, 12.0, (512, 512, 3)
                                           ).astype(np.float32)
    got = np.asarray(jax.jit(aces_gamma)(jnp.asarray(hdr)))
    c = hdr.astype(np.float64) @ np.asarray(ACES_INPUT, np.float64)
    c = (c * (c + 0.0245786) - 0.000090537) / (
        c * (0.983729 * c + 0.4329510) + 0.238081)
    c = c @ np.asarray(ACES_OUTPUT, np.float64)
    ref = np.clip(np.power(np.maximum(c, 0.0), 1 / 2.2), 0.0, 1.0)
    err = float(np.abs(got - ref).max())
    log(f"  max |err| {err:.2e} (limit {TONEMAP_ATOL:g})")
    assert err <= TONEMAP_ATOL


def phase_four():
    import optax
    from physically_based_renderer_tpu.grad.inverse import (
        TrainableParams, make_train_step)
    from physically_based_renderer_tpu.integrator.path import (RenderConfig,
                                                               render)
    from physically_based_renderer_tpu.parallel.sharding import (
        make_mesh, render_sharded, replicate_scene)
    from physically_based_renderer_tpu.scene.types import upload_scene
    from physically_based_renderer_tpu.utils import config as config_mod
    devs = jax.devices()
    assert len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}"
    mesh = make_mesh(devs)
    bc = config_mod.get("inverse")
    host_scene, camera = config_mod.build_scene(bc.scene)
    scene = upload_scene(host_scene)

    cfg = RenderConfig(width=FOUR_SIDE, height=FOUR_SIDE, spp=4,
                       max_bounces=2)
    log(f"[four-1] render_sharded over {len(devs)} GPUs vs single-GPU "
        f"render, cornell {cfg.width}x{cfg.height} {cfg.spp} spp")
    key = jax.random.key(3)
    single = render(scene, camera, key, cfg).mean()
    single = np.asarray(single)
    s4 = replicate_scene(scene, mesh)
    film = render_sharded(s4, camera, key, cfg, mesh)
    placed = {sh.device for sh in film.hdr.addressable_shards}
    log(f"  sharded film on {len(placed)} devices: "
        f"{sorted(str(d) for d in placed)}")
    assert placed == set(devs)
    tiled = np.asarray(film.mean())
    times = {}
    for name, fn in (("1 GPU", lambda: render(scene, camera, key, cfg).hdr),
                     ("4 GPUs", lambda: render_sharded(s4, camera, key, cfg,
                                                       mesh).hdr)):
        fn().block_until_ready()
        t0 = time.perf_counter()
        fn().block_until_ready()
        times[name] = time.perf_counter() - t0
    err = float(np.abs(tiled - single).max())
    log(f"  max |sharded - single| {err:.2e}; frame 1 GPU "
        f"{times['1 GPU']:.4f} s, 4 GPUs {times['4 GPUs']:.4f} s")
    assert err <= 1e-5 * max(1.0, float(single.max()))

    cfg_t = bc.render
    log(f"[four-2] SPMD train step over 4 vs 1 (config #5, "
        f"{cfg_t.width}x{cfg_t.height})")
    target = jnp.zeros((cfg_t.height, cfg_t.width, 3), jnp.float32)
    # host (uncommitted) arrays: each step places them on its own devices
    params = TrainableParams.from_scene(host_scene, base_color=True)
    opt = optax.sgd(1e-2)
    step1 = make_train_step(host_scene, camera, cfg_t, opt)
    step4 = make_train_step(host_scene, camera, cfg_t, opt, mesh=mesh)
    key = jax.random.key(42)
    p1, _, l1 = step1(params, opt.init(params), key, target)
    p4, _, l4 = step4(params, opt.init(params), key, target)
    base = np.asarray(host_scene.materials.base_color_factor)
    n1 = np.linalg.norm(np.asarray(p1.base_color_factor) - base)
    n4 = np.linalg.norm(np.asarray(p4.base_color_factor) - base)
    placed = {sh.device for sh in p4.base_color_factor.addressable_shards}
    log(f"  loss 1={float(l1):.6f} 4={float(l4):.6f}; update norm "
        f"1={n1:.6e} 4={n4:.6e}; params on {len(placed)} devices")
    assert np.isclose(float(l1), float(l4), rtol=1e-4)
    assert n1 > 0.0 and np.isclose(n4, n1, rtol=0.03)
    assert placed == set(devs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded render + train step")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = card()
    log(f"card: {smi}")
    dev = jax.devices()[0]
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")
    t_start = time.perf_counter()
    if args.four:
        phase_four()
    else:
        from physically_based_renderer_tpu.scene.types import upload_scene
        from physically_based_renderer_tpu.utils import config as config_mod
        bc = config_mod.get("helmet")
        t0 = time.perf_counter()
        scene, camera = config_mod.build_scene(bc.scene)
        scene = upload_scene(scene)
        log(f"helmet: {scene.geometry.num_tris} tris, "
            f"{scene.clusters.num_clusters} clusters, "
            f"{scene.textures.num_textures} textures, "
            f"{scene.emitters.num_emitters} emitters + env "
            f"(build {time.perf_counter() - t0:.1f} s)")
        phase_tracer_parity(scene, camera, bc.render)
        phase_frame(scene, camera, bc.render, smi)
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(tmp, bc.render)
        phase_train()
        phase_tonemap()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

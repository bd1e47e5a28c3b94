"""Benchmark harness for one NVIDIA GPU.

Default mode: rays/s of a full-frame `render_with_stats` for each named
config (utils/config.py), one JSON line:
    {"device": {...}, "nvidia_smi": "...", "configs": {name: {...}}}

Ray accounting: rays/s counts ray QUERIES issued by active lanes — one
closest-hit query per bounce plus one shadow query per NEE light sample —
the standard wavefront-path-tracer definition.  Counts come from the real
integrator loop (integrator.path.render_with_stats), not an estimate.
Compilation is reported as set-up time; frames are timed warm, each ending
in block_until_ready.

`--tracers`: the cluster-tracer study on the `helmet` config — phase B of
the XLA block tracer against the Triton kernel (ops/pallas_trace.py) on the
helmet's camera, bounce and shadow ray streams, a sweep of the kernel's
tile, XLA's temp memory for phase B, and the whole frame with each tracer.

Every mode needs a GPU and exits non-zero without one: a number from
another backend is not a device number.

`--tracer block,triton,triton,block` times each config's frame once per
listed tracer, in that order, instead of with the automatic choice.

`--profile CONFIG`: three warm frames of one config (with the one tracer
`--tracer` names) under jax.profiler, reduced to device time per kernel
name and the device idle share.

    python bench.py [--configs triangle,cornell,...] [--tracer ...]
    python bench.py --tracers
    python bench.py --profile helmet
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

CONFIGS = ("triangle", "cornell", "cornell_ggx", "cornell_tex256", "helmet")


def nvidia_smi() -> str:
    """`name, power.limit` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def require_gpu() -> dict:
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"bench: needs an NVIDIA GPU, JAX found "
                 f"{jax.default_backend()!r}")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def timeit(fn, reps: int = 5) -> float:
    """Median wall seconds of fn() (each call ends in block_until_ready);
    one warm call first."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def load_config(name: str):
    from physically_based_renderer_tpu.scene.types import upload_scene
    from physically_based_renderer_tpu.utils import config as config_mod
    bc = config_mod.get(name)
    scene, camera = config_mod.build_scene(bc.scene)
    return upload_scene(scene), camera, bc.render


def bench_frame(scene, camera, cfg, reps: int = 3) -> dict:
    """Compile + warm + timed full frames of render_with_stats."""
    import jax
    from physically_based_renderer_tpu.integrator.path import (
        render_with_stats)
    key = jax.random.key(1)
    t0 = time.perf_counter()
    film, count = render_with_stats(scene, camera, key, cfg)
    jax.block_until_ready(film)
    setup = time.perf_counter() - t0
    dt = timeit(lambda: render_with_stats(scene, camera, key, cfg)[0].hdr,
                reps)
    return {"frame_s": dt, "rays": float(count),
            "rays_per_s": float(count) / dt, "compile_s": setup}


def helmet_streams(scene, camera, cfg):
    """The helmet's first three trace calls of a sample, as the integrator
    issues them: camera rays (morton order), BSDF-sampled bounce rays from
    the camera hits, and area-emitter + environment shadow rays."""
    import jax
    import jax.numpy as jnp
    from physically_based_renderer_tpu.core import rng as rng_mod
    from physically_based_renderer_tpu.core.camera import generate_rays_at
    from physically_based_renderer_tpu.core.morton import morton_pixel_ids
    from physically_based_renderer_tpu.integrator.path import (
        _nee_prepare, closest_hit, frame_tables)
    from physically_based_renderer_tpu.integrator.shading import (
        shade_surface)
    from physically_based_renderer_tpu.models import lights
    from physically_based_renderer_tpu.models.bsdf import sample_bsdf
    from physically_based_renderer_tpu.core import math3d

    @jax.jit
    def build(scene, camera, key):
        pix = jnp.asarray(morton_pixel_ids(cfg.height, cfg.width))
        keys = rng_mod.ray_keys(key, pix)
        jit_ = rng_mod.ray_uniform(keys, 0, rng_mod.STREAM_PIXEL_JITTER, 2)
        o, d = generate_rays_at(camera, cfg.width, cfg.height,
                                (pix % cfg.width).astype(jnp.float32),
                                (pix // cfg.width).astype(jnp.float32), jit_)
        c = dataclasses.replace(cfg, tracer="block")
        hit = closest_hit(scene, o, d, 0.0, c)
        tri_attrs, em_attrs, pyramid = frame_tables(scene)
        sp = shade_surface(scene, hit, o, d, tri_attrs=tri_attrs,
                           pyramid=pyramid)
        active = ~hit.miss
        wo = math3d.to_local(-d, sp.tang, sp.bitang, sp.ns)
        ob = sp.pos + sp.ng * cfg.ray_eps
        u = rng_mod.ray_uniform(keys, 0, rng_mod.STREAM_LIGHT, 5)
        ls = lights.sample_area_emitters(scene, sp.pos, u[:, 0], u[:, 1:3],
                                         emitter_attrs=em_attrs,
                                         pyramid=pyramid)
        tp = jnp.ones_like(o)
        area_d, area_t, _ = _nee_prepare(sp, wo, ls, tp, active, mis=True)
        es = lights.sample_env(scene, o.shape[0], u[:, 3:5])
        env_d, env_t, _ = _nee_prepare(sp, wo, es, tp, active, mis=True)
        ub = rng_mod.ray_uniform(keys, 0, rng_mod.STREAM_BSDF, 3)
        wi, _, pdf = sample_bsdf(sp.bsdf, wo, ub[:, 0], ub[:, 1:3])
        ok = active & (pdf > 1e-9) & (wi[..., 2] > 0.0)
        bd = math3d.normalize(math3d.to_world(wi, sp.tang, sp.bitang,
                                              sp.ns))
        return {
            "camera": (o, d, jnp.full((o.shape[0],), 1e30)),
            "bounce": (ob, bd, jnp.where(ok, 1e30, 0.0)),
            "shadow_area": (ob, area_d, area_t),
            "shadow_env": (ob, env_d, env_t),
        }

    # (any_hit, sort) per stream, as the integrator calls the tracer
    flags = {"camera": (False, False), "bounce": (False, True),
             "shadow_area": (True, True), "shadow_env": (True, True)}
    rays = build(scene, camera, jax.random.key(7))
    return {k: rays[k] + flags[k] for k in flags}


def tracer_study(out: dict) -> None:
    """The `--tracers` measurements (see module docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from physically_based_renderer_tpu.integrator.path import (
        render_with_stats)
    from physically_based_renderer_tpu.ops import blocktrace
    from physically_based_renderer_tpu.ops.pallas_trace import (
        trace_blocks_triton)

    scene, camera, cfg = load_config("helmet")
    grid = scene.clusters
    streams = helmet_streams(scene, camera, cfg)
    t_eps = cfg.ray_eps
    prep = jax.jit(blocktrace.prepare_blocks,
                   static_argnames=("t_min", "block", "max_u", "sort"))
    phase_b_xla = jax.jit(blocktrace._phase_b_xla,
                          static_argnames=("t_min", "any_hit"))
    tiles = [(32, 32, 4), (16, 32, 4), (64, 32, 4), (32, 64, 4),
             (32, 128, 4), (64, 64, 8), (128, 32, 8), (32, 32, 2)]
    study = {}
    for name, (o, d, tmax, any_hit, sort) in streams.items():
        t_min = 0.0 if name == "camera" else t_eps
        _, ob, db, tmb, u_idx, entry, n_valid = prep(
            grid, o, d, tmax, t_min=t_min, block=cfg.block_size,
            max_u=cfg.max_u, sort=sort)
        row = {"rays": int(o.shape[0]),
               "live_rays": int(jnp.sum(tmb > 0)),
               "mean_candidates": float(jnp.mean(n_valid)),
               "max_candidates": int(jnp.max(n_valid))}
        row["phase_a_s"] = timeit(lambda: prep(
            grid, o, d, tmax, t_min=t_min, block=cfg.block_size,
            max_u=cfg.max_u, sort=sort)[4])
        args = (u_idx, n_valid, ob, db, tmb, grid.soup)
        ref_t, ref_f = phase_b_xla(*args, t_min=t_min, any_hit=any_hit)
        mem = phase_b_xla.lower(*args, t_min=t_min,
                                any_hit=any_hit).compile().memory_analysis()
        row["xla_phase_b_temp_bytes"] = int(mem.temp_size_in_bytes)
        row["xla_phase_b_s"] = timeit(lambda: phase_b_xla(
            *args, t_min=t_min, any_hit=any_hit)[0])
        sweep = {}
        for r, kt, w in tiles:
            def run():
                return trace_blocks_triton(
                    u_idx, n_valid, entry, ob, db, tmb, grid.soup,
                    t_min=t_min, any_hit=any_hit, rays_per_program=r,
                    k_tile=kt, num_warps=w)
            t, f = run()
            if any_hit:
                agree = bool(jnp.all(f == ref_f))
            else:
                agree = bool(jnp.all(jnp.isclose(t, ref_t, rtol=1e-5)
                                     | ((t > 1e29) & (ref_t > 1e29))))
            sweep[f"R{r}_KT{kt}_W{w}"] = {
                "s": timeit(lambda: run()[0]), "agrees": agree}
        t_noexit = timeit(lambda: trace_blocks_triton(
            u_idx, n_valid, entry, ob, db, tmb, grid.soup, t_min=t_min,
            any_hit=any_hit, early_exit=False)[0])
        row["triton_sweep"] = sweep
        row["triton_default_no_exit_s"] = t_noexit
        for kern in ("xla", "triton"):
            row[f"call_{kern}_s"] = timeit(
                lambda: blocktrace.intersect_blocks(
                    grid, scene.geometry, o, d, t_min=t_min, t_max=tmax,
                    any_hit=any_hit, block=cfg.block_size, max_u=cfg.max_u,
                    sort=sort, kernel=kern, lean=True))
        study[name] = row
        print(json.dumps({name: row}), file=sys.stderr, flush=True)
    out["streams"] = study

    # Whole frame, both tracers, same key; order block, triton, triton,
    # block so a drift of the card's clock shows as an asymmetry.
    frames = {}
    films = {}
    for tracer in ("block", "triton", "triton", "block"):
        c = dataclasses.replace(cfg, tracer=tracer)
        res = bench_frame(scene, camera, c)
        frames.setdefault(tracer, []).append(res)
        films[tracer] = np.asarray(render_with_stats(
            scene, camera, jax.random.key(1), c)[0].mean())
    out["frame"] = frames
    a, b = films["block"], films["triton"]
    out["frame_mean_abs_diff_rel"] = float(np.abs(a - b).mean()
                                           / max(a.mean(), 1e-12))


def profile_frames(name: str, tracer: str, out: dict,
                   frames: int = 3) -> None:
    """`--profile`: warm frames of one config under jax.profiler, reduced to
    device time per kernel name and the device idle share (1 - device-busy
    time / host wall time over the traced frames)."""
    import glob
    import tempfile
    import jax
    from physically_based_renderer_tpu.integrator.path import (
        render_with_stats)
    scene, camera, cfg = load_config(name)
    cfg = dataclasses.replace(cfg, tracer=tracer)
    key = jax.random.key(1)
    for _ in range(2):
        jax.block_until_ready(render_with_stats(scene, camera, key, cfg)[0])
    with tempfile.TemporaryDirectory() as tmp:
        jax.profiler.start_trace(tmp)
        t0 = time.perf_counter()
        for _ in range(frames):
            jax.block_until_ready(
                render_with_stats(scene, camera, key, cfg)[0])
        wall = time.perf_counter() - t0
        jax.profiler.stop_trace()
        path = glob.glob(f"{tmp}/plugins/profile/*/*.xplane.pb")[0]
        data = jax.profiler.ProfileData.from_file(path)
        plane = next(p for p in data.planes
                     if p.name.startswith("/device:GPU:0"))
        per_kernel = {}
        spans = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):   # kernels, not modules
                continue
            for e in line.events:
                c, ns = per_kernel.get(e.name, (0, 0.0))
                per_kernel[e.name] = (c + 1, ns + e.duration_ns)
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of kernel intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    total = sum(ns for _, ns in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:20]
    out["profile"] = {
        "config": name, "tracer": tracer, "frames": frames, "frame_s": wall / frames,
        "device_busy_s_per_frame": busy / frames / 1e9,
        "idle_share": 1.0 - busy / (wall * 1e9),
        "kernels": [{"name": k, "ms_per_frame": ns / frames / 1e6,
                     "share": ns / total, "calls_per_frame": c / frames}
                    for k, (c, ns) in top]}


def main():
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", default=",".join(CONFIGS))
    p.add_argument("--tracer", default="auto",
                   help="comma list of RenderConfig.tracer values to time "
                        "each config with, in order")
    p.add_argument("--tracers", action="store_true")
    p.add_argument("--profile", metavar="CONFIG",
                   help="profile warm frames of one config instead")
    args = p.parse_args()
    out = {"device": require_gpu(), "nvidia_smi": nvidia_smi()}
    print(f"# {out['nvidia_smi']}", file=sys.stderr, flush=True)
    if args.tracers:
        tracer_study(out)
    elif args.profile:
        profile_frames(args.profile, args.tracer, out)
    else:
        out["configs"] = {}
        tracers = args.tracer.split(",")
        for name in args.configs.split(","):
            scene, camera, cfg = load_config(name)
            runs = {}
            for tracer in tracers:
                c = dataclasses.replace(cfg, tracer=tracer)
                runs.setdefault(tracer, []).append(
                    bench_frame(scene, camera, c))
                print(json.dumps({name: {tracer: runs[tracer][-1]}}),
                      file=sys.stderr, flush=True)
            out["configs"][name] = runs
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""CLI renderer: the gltf_viewer analog, headless.

Reference: `src/gltf_viewer/Main.cpp:15-27` — `gltf_viewer <asset> [-vulkan-
validation]` opening an interactive window.  Here (SURVEY.md section 2.11:
windowing replaced by headless output):

    python -m physically_based_renderer_tpu.apps.render SCENE -o out.png

SCENE is a .gltf/.glb path or a named builtin config (triangle, cornell,
cornell_ggx, helmet).  `--debug-checks` is the validation-layer analog
(checkify OOB-gather checks inside the jitted render + a finite-film
assertion; see utils/debug.py).  `--blinn-phong` renders the reference's
exact headlight shading for comparison images.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbr-render",
        description="differentiable path tracer (headless glTF renderer)")
    p.add_argument("scene", help=".gltf/.glb path or builtin config name")
    p.add_argument("-o", "--output", default="out.png", help="output PNG")
    p.add_argument("--hdr-output", default=None,
                   help="also dump linear HDR radiance as .npy")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-nee", action="store_true")
    p.add_argument("--no-mis", action="store_true")
    p.add_argument("--blinn-phong", action="store_true",
                   help="reference-parity headlight debug shading")
    p.add_argument("--debug-checks", action="store_true",
                   help="checkify-instrumented render: NaN/Inf/OOB checks "
                        "at every site (validation-layer analog)")
    p.add_argument("--tiles", type=int, default=0,
                   help="shard rows over N devices (0 = single device)")
    p.add_argument("--stats", action="store_true",
                   help="print rays/s JSON to stderr")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    import dataclasses
    import numpy as np
    from ..core import film as film_mod
    from ..core.camera import Camera
    from ..integrator.path import RenderConfig, render, render_with_stats
    from ..parallel import distributed
    from ..scene.types import upload_scene
    from ..utils import config as config_mod

    # Multi-host bootstrap (no-op single-process): must precede any device
    # query so jax.devices() is globally consistent across processes.
    distributed.ensure_initialized()

    if args.scene in config_mod.CONFIGS:
        bc = config_mod.get(args.scene)
        scene, camera = config_mod.build_scene(bc.scene)
        rcfg = bc.render
    else:
        from ..scene import gltf as gltf_mod
        from ..scene.types import with_clusters
        try:
            scene, _, camera = gltf_mod.load(args.scene)
        except gltf_mod.GltfError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        # Same policy as the builtin configs (utils/config.build_scene):
        # always attach clusters — tiny scenes become one padded cluster,
        # where the block tracer degenerates to dense brute force.
        scene = with_clusters(scene)
        rcfg = RenderConfig()

    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.spp:
        overrides["spp"] = args.spp
    if args.bounces is not None:
        overrides["max_bounces"] = args.bounces
    if args.no_nee:
        overrides["nee"] = False
    if args.no_mis:
        overrides["mis"] = False
    rcfg = dataclasses.replace(rcfg, **overrides)

    if args.debug_checks and (args.tiles or args.blinn_phong):
        print("error: --debug-checks cannot be combined with --tiles or "
              "--blinn-phong (the checkify instrumentation wraps the dense "
              "single-device integrator only)", file=sys.stderr)
        return 2

    scene = upload_scene(scene)
    t0 = time.perf_counter()
    if args.blinn_phong:
        from ..models.blinn_phong import render_blinn_phong
        hdr = render_blinn_phong(scene, camera, rcfg.width, rcfg.height)
        hdr.block_until_ready()
        rays = rcfg.width * rcfg.height
    elif args.tiles:
        from ..parallel.sharding import (make_mesh, render_sharded,
                                         replicate_scene)
        mesh = make_mesh(jax.devices()[:args.tiles])
        scene = replicate_scene(scene, mesh)
        f = render_sharded(scene, camera, jax.random.key(args.seed), rcfg,
                           mesh)
        hdr = f.mean()
        hdr.block_until_ready()
        rays = None
    elif args.debug_checks:
        # Validation-layer analog: checkify-instrumented render (NaN/Inf/
        # OOB-gather checks at every site; raises naming the failing check).
        from ..utils.debug import checked_render
        f = checked_render(scene, camera, jax.random.key(args.seed), rcfg)
        hdr = f.mean()
        hdr.block_until_ready()
        rays = None
    else:
        f, count = render_with_stats(scene, camera,
                                     jax.random.key(args.seed), rcfg)
        hdr = f.mean()
        hdr.block_until_ready()
        rays = float(count)
    dt = time.perf_counter() - t0

    from ..core.tonemap import aces_gamma
    film_mod.write_png(args.output, aces_gamma(hdr))
    if args.hdr_output:
        np.save(args.hdr_output, np.asarray(hdr))
    print(f"wrote {args.output} ({rcfg.width}x{rcfg.height}, "
          f"{rcfg.spp} spp, {dt:.2f}s incl. compile)")
    if args.stats and rays:
        print(json.dumps({"rays": rays, "seconds": dt,
                          "rays_per_s": rays / dt}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

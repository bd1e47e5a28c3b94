"""Differentiable path-tracing integrator (dense/megasample form).

The estimator the whole framework is built around (BASELINE.json north
star): per-bounce loop of {closest hit, shade, NEE + MIS, BSDF sample}, all
rays advancing in lockstep with masks — the statically-shaped, compiler-
friendly formulation of a wavefront.  "Compaction" lives INSIDE the block
tracers (ops/blocktrace.py): every trace call sorts its detached rays by
(dead, direction bin), so dead lanes pack into trailing all-dead blocks
skipped at n_valid=0 — the static-shape equivalent of shrinking the queue
(an explicit dynamically-sized queue module was tried and removed — XLA's
static shapes made it strictly slower than sort + skip — and so was an
integrator-level resort that permuted all per-lane state: ~12 ray-sized
permute gathers per bounce of pure data movement).

Gradient strategy ("interior term" / detached sampling):
  * radiometric quantities (BSDF value, cosines, emitted radiance, env
    radiance, textures, normals) stay ATTACHED -> gradients flow to material
    factors, texels, emitter radiance, and vertex positions;
  * sampling DECISIONS (sampled directions, pdfs, CDF inversions, MIS
    weights, RR) are DETACHED -> the estimator is an unbiased estimate of
    the interior derivative of the rendering equation.
This matches the finite-difference oracle for albedo / roughness / emission
parameters (BASELINE "pixel gradients allclose vs finite differences").

The reference analog of this file is the lighting pass + frame loop
(`src/pbr_engine/engine/pbr/PbrRenderSystem.cpp:466-501`, `App.cpp:285-318`)
— replaced wholesale by Monte-Carlo light transport.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import rng as rng_mod
from ..core.camera import Camera, generate_rays_at
from ..core.film import Film
from ..core import math3d
from ..models import lights as lights_mod
from ..models.bsdf import eval_bsdf, sample_bsdf
from ..ops.intersect import BIG, Hit, intersect_brute, occluded_brute
from ..scene.types import Scene
from .shading import pack_tri_attrs, shade_surface

sg = jax.lax.stop_gradient


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable -> usable as a jit static arg)."""

    width: int = 256
    height: int = 256
    spp: int = 4
    max_bounces: int = 1          # number of BSDF bounces after the camera hit
    nee: bool = True              # next-event estimation
    mis: bool = True              # MIS between NEE and BSDF sampling
    rr_start: int = 100           # bounce index where Russian roulette starts
    ray_eps: float = 1e-3         # shadow/secondary ray offset
    tri_chunk: int = 2048         # brute-force intersection chunk size
    tracer: str = "auto"          # auto|brute|bvh|block|triton
    block_size: int = 256         # ray block of the cluster tracers
    max_u: int = 48               # candidate clusters per block
    interpret: bool = False       # run the Triton tracer in the Pallas
    #                               interpreter (tests on hosts without a GPU)
    resort: bool = True           # in-tracer direction-bin sort for bounce
    #                               closest-hit calls (block tracers feed on
    #                               block coherence; no-op otherwise)
    exchange_axis: str | None = None  # mesh axis for the ppermute ring
    #                               ray exchange (parallel/exchange.py);
    #                               set by render_sample_sharded(
    #                               exchange=True).  PRIMAL renders only:
    #                               exchanged rays are detached.
    batch_spp: bool = False       # trace ALL spp as one ray stream instead
    #                               of a scan of per-sample passes: blocks
    #                               then cover spp x less screen area
    #                               (tighter candidate bundles) and
    #                               per-call costs amortize.  Same RNG
    #                               streams as the scan — statistically
    #                               identical images.  Primal renders.




def _power_mis(pa: jnp.ndarray, pb: jnp.ndarray) -> jnp.ndarray:
    """Power heuristic (beta=2), detached."""
    pa, pb = sg(pa), sg(pb)
    a2 = pa * pa
    return jnp.where(pa > 0.0, a2 / jnp.maximum(a2 + pb * pb, 1e-20), 0.0)


# Cluster tracer for scenes with a cluster grid on an NVIDIA GPU: the one
# that wins the frame end to end on an H100 in every config, one-cluster
# scenes included (PERF.md).
GPU_CLUSTER_TRACER = "triton"


def select_tracer(scene: Scene, cfg: RenderConfig) -> str:
    """The one tracer dispatch, decided at TRACE time from the platform and
    the scene: cfg.tracer when it names one, otherwise the GPU's cluster
    tracer on "gpu", the XLA block tracer elsewhere, the BVH or brute force
    for scenes without clusters."""
    if cfg.tracer != "auto":
        return cfg.tracer
    if scene.clusters is not None:
        return (GPU_CLUSTER_TRACER if jax.default_backend() == "gpu"
                else "block")
    if scene.bvh is not None:
        return "bvh"
    return "brute"


def _maybe_exchange(tr, o, d, t_max, cfg: RenderConfig):
    """Route a block-tracer call through the ppermute ring ray exchange
    when cfg.exchange_axis names a mesh axis (inside shard_map only)."""
    if cfg.exchange_axis is None:
        return tr(o, d, t_max)
    from ..parallel.exchange import with_ring_exchange
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                                 (o.shape[0],))
    return with_ring_exchange(tr, o, d, t_max_arr, cfg.exchange_axis)


def _block_tracer(scene: Scene, cfg: RenderConfig, tracer: str, t_min,
                  **kw):
    """(o, d, t_max) -> result of the cluster tracer named by `tracer`."""
    from ..ops.blocktrace import intersect_blocks

    def tr(o_, d_, tm_):
        return intersect_blocks(
            scene.clusters, scene.geometry, o_, d_, t_min=t_min, t_max=tm_,
            block=cfg.block_size, max_u=cfg.max_u,
            kernel="triton" if tracer == "triton" else "xla",
            interpret=cfg.interpret, **kw)

    return tr


def closest_hit(scene: Scene, o, d, t_min, cfg: RenderConfig,
                active=None, sort: bool = False) -> Hit:
    """Closest-hit dispatch (select_tracer).

    `active`: optional bool[N] lane mask.  Cluster tracers turn dead lanes
    into t_max=0 rays, which drop out of the bundle bounds AND the kernel's
    live-lane early exit — dead lanes stop dragging whole blocks through
    every candidate cluster.  Dead lanes report miss.

    `sort`: in-tracer direction-bin sort (cluster tracers): bounce rays are
    direction-scattered, and sorting INSIDE the trace call moves only the
    detached o/d/t_max (3 gathers + output unscramble) instead of the
    whole per-lane integrator state.

    Cluster tracers return a lean (detached) Hit: shade_surface re-derives
    the attached (u, v, t), so the tracer's own differentiable finish would
    be duplicate ray-sized gathers.
    """
    tracer = select_tracer(scene, cfg)
    t_max = BIG if active is None else jnp.where(sg(active), BIG, 0.0)
    if tracer in ("block", "triton"):
        tr = _block_tracer(scene, cfg, tracer, t_min, lean=True, sort=sort)
        return _maybe_exchange(tr, o, d, t_max, cfg)
    if tracer == "bvh":
        from ..ops.traverse import intersect_bvh
        return intersect_bvh(scene.bvh, scene.geometry, o, d, t_min=t_min)
    v0, v1, v2 = scene.geometry.tri_vertices()
    return intersect_brute(o, d, v0, v1, v2, t_min=t_min,
                           chunk=cfg.tri_chunk)


def occluded(scene: Scene, o, d, t_min, t_max, cfg: RenderConfig):
    """Any-hit (shadow) dispatch.  Shadow directions are light-sampled, not
    bounce-coherent, so cluster tracers sort them by direction bin in the
    call when cfg.resort is set (the same knob as the bounce-ray sort)."""
    tracer = select_tracer(scene, cfg)
    if tracer in ("block", "triton"):
        tr = _block_tracer(scene, cfg, tracer, t_min, any_hit=True,
                           sort=cfg.resort)
        return _maybe_exchange(tr, o, d, t_max, cfg)
    if tracer == "bvh":
        from ..ops.traverse import intersect_bvh
        return intersect_bvh(scene.bvh, scene.geometry, o, d, t_min=t_min,
                             t_max=t_max, any_hit=True)
    v0, v1, v2 = scene.geometry.tri_vertices()
    return occluded_brute(o, d, v0, v1, v2, t_min=t_min, t_max=t_max,
                          chunk=cfg.tri_chunk)


def frame_tables(scene: Scene):
    """Per-frame derived tables (packed tri attrs, emitter rows, texture
    pyramid) — build ONCE outside the spp scan and pass to trace_radiance
    so the work isn't repeated every scan iteration."""
    from ..ops.texture import build_pyramid
    return (pack_tri_attrs(scene),
            lights_mod.pack_emitter_attrs(scene) if scene.has_emitters
            else None,
            build_pyramid(scene.textures) if scene.has_textures else None)


def trace_radiance(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                   keys: jax.Array, cfg: RenderConfig,
                   return_stats: bool = False, cone_angle=None,
                   tables=None):
    """Estimate radiance along rays (o, d) [N,3] -> L [N,3].

    One sample per ray; callers average over spp.  `keys` is a PER-RAY key
    array [N] (core.rng.ray_keys) so results are invariant to batching and
    sharding.  `cone_angle` (scalar) is the pixel footprint angle driving
    ray-cone mip selection (None => level-0 texture fetches).  With
    return_stats=True also returns the number of ray queries issued by
    ACTIVE lanes (closest-hit + shadow), the honest "rays" numerator for
    rays/s benchmarks.  `tables` (frame_tables) amortizes the per-frame
    packing across spp.
    """
    n = o.shape[0]
    ray_count = jnp.zeros((), jnp.float32)
    has_emitters = scene.has_emitters
    has_env = scene.env is not None
    # Wide attribute tables packed once per frame; each bounce then does a
    # single fused row fetch (see integrator/shading.py, models/lights.py).
    tri_attrs, emitter_attrs, pyramid = (tables if tables is not None
                                         else frame_tables(scene))
    path_dist = jnp.zeros((n,), jnp.float32)   # ray-cone mip selection

    L = jnp.zeros((n, 3), jnp.float32)
    throughput = jnp.ones((n, 3), jnp.float32)
    active = jnp.ones((n,), bool)
    # pdf of the *previous* BSDF sampling decision, for MIS of emitter hits.
    prev_pdf = jnp.zeros((n,), jnp.float32)  # 0 => treat as delta (camera)

    # Per-bounce coherence handling (cluster tracers only): bounce rays are
    # BSDF-sampled and direction-scattered, so their closest-hit calls use
    # the IN-TRACER direction-bin sort (closest_hit sort=True) — only the
    # detached o/d/t_max move, and outputs come back unscrambled.  (An
    # integrator-level resort that permuted the whole per-lane state —
    # L/throughput/keys/etc, ~12 ray-sized arrays — was pure data movement
    # and was removed.)
    use_sort = cfg.resort and select_tracer(scene, cfg) in ("block",
                                                            "triton")

    for bounce in range(cfg.max_bounces + 1):
        ray_count = ray_count + jnp.sum(active.astype(jnp.float32))
        hit = closest_hit(scene, o, d,
                          t_min=0.0 if bounce == 0 else cfg.ray_eps, cfg=cfg,
                          active=None if bounce == 0 else active,
                          sort=use_sort and bounce > 0)
        miss = hit.miss

        # --- escaped rays: environment ---------------------------------
        if has_env:
            env_l = lights_mod.env_radiance(scene, d)
            if cfg.mis and cfg.nee and bounce > 0:
                w_env = jnp.where(prev_pdf > 0.0,
                                  _power_mis(prev_pdf,
                                             lights_mod.env_pdf(scene, d)),
                                  1.0)
            else:
                w_env = jnp.ones((n,), jnp.float32)
            L = L + jnp.where((active & miss)[:, None],
                              throughput * env_l * w_env[:, None], 0.0)
        active = active & ~miss

        path_dist = path_dist + jnp.minimum(sg(hit.t), 1e6) * (
            ~miss).astype(jnp.float32)
        cone_w = (path_dist * cone_angle) if cone_angle is not None else None
        sp = shade_surface(scene, hit, o, d, tri_attrs=tri_attrs,
                           pyramid=pyramid, cone_width=cone_w)

        # --- emitter hit through BSDF sampling (or camera) --------------
        if has_emitters:
            cos_l = jnp.sum(sp.ng * (-d), axis=-1)   # ng is oriented: >= 0
            # Clamp t before squaring: miss lanes carry t=1e30 whose square
            # overflows f32 to inf, and 0 * inf = NaN would ride the masked
            # lanes into the backward pass (0-cotangent x NaN = NaN).
            t_clamped = jnp.minimum(hit.t, 1e6)
            dist2 = jnp.clip(t_clamped * t_clamped, 1e-12, 1e12)
            pdf_nee_hit = (sp.pdf_area * dist2
                           / jnp.maximum(cos_l, 1e-6))
            if cfg.mis and cfg.nee and bounce > 0:
                w_em = jnp.where(prev_pdf > 0.0,
                                 _power_mis(prev_pdf, pdf_nee_hit), 1.0)
            elif cfg.nee and bounce > 0:
                # NEE without MIS: emitter hits already fully counted by NEE.
                w_em = jnp.zeros((n,), jnp.float32)
            else:
                w_em = jnp.ones((n,), jnp.float32)
            L = L + jnp.where(active[:, None],
                              throughput * sp.emissive * w_em[:, None], 0.0)

        if bounce == cfg.max_bounces:
            break

        # --- local frame -----------------------------------------------
        wo_w = -d
        wo = math3d.to_local(wo_w, sp.tang, sp.bitang, sp.ns)
        o_next_base = sp.pos + sp.ng * cfg.ray_eps

        # --- NEE --------------------------------------------------------
        # One occluded() call PER light family.  Batching the families
        # into a single 2N-ray call (they share shadow origins) was slower
        # on the glb helmet: the in-call sort mixes area rays (short
        # t_max, visor-bound) with env rays (root-box t_max) in the same
        # direction-bin blocks, and the heterogeneous t_max population
        # defeats the any-hit early exit's max-over-open-lanes clause.
        if cfg.nee:
            n_shadow = float((1 if has_emitters else 0)
                             + (1 if has_env else 0)
                             + (1 if scene.has_directional else 0))
            ray_count = ray_count + n_shadow * jnp.sum(
                active.astype(jnp.float32))
            u = rng_mod.ray_uniform(keys, bounce, rng_mod.STREAM_LIGHT, 5)

            pending = []          # (contrib_if_visible [N,3])
            if has_emitters:
                ls = lights_mod.sample_area_emitters(
                    scene, sg(sp.pos), u[:, 0], u[:, 1:3],
                    emitter_attrs=emitter_attrs, pyramid=pyramid)
                pending.append(_nee_prepare(sp, wo, ls, throughput, active,
                                            mis=cfg.mis))
            if has_env:
                es = lights_mod.sample_env(scene, n, u[:, 3:5])
                pending.append(_nee_prepare(sp, wo, es, throughput, active,
                                            mis=cfg.mis))
            # Directional (delta) light: always NEE, never MIS.
            if scene.has_directional:
                dl = lights_mod.sample_directional(scene, n)
                pending.append(_nee_prepare(sp, wo, dl, throughput, active,
                                            mis=False, delta=True))
            o_sh = sg(o_next_base)
            for wi_w, t_max_s, contrib in pending:
                occ = occluded(scene, o_sh, wi_w, t_min=cfg.ray_eps,
                               t_max=t_max_s, cfg=cfg)
                L = L + jnp.where((~occ)[:, None], contrib, 0.0)

        # --- BSDF sampling ----------------------------------------------
        ub = rng_mod.ray_uniform(keys, bounce, rng_mod.STREAM_BSDF, 3)
        wi, f, pdf = sample_bsdf(sp.bsdf, wo, ub[:, 0], ub[:, 1:3])
        wi = sg(wi)
        cos_i = jnp.maximum(wi[..., 2], 0.0)
        ok = (sg(pdf) > 1e-9) & (sg(cos_i) > 0.0)
        weight = jnp.where(ok[:, None],
                           f * cos_i[:, None] / sg(pdf)[:, None], 0.0)
        throughput = throughput * weight
        active = active & ok & (jnp.max(sg(throughput), axis=-1) > 0.0)

        wi_world = math3d.to_world(wi, sp.tang, sp.bitang, sp.ns)
        wi_world = sg(math3d.normalize(wi_world))
        o = jnp.where(active[:, None], o_next_base, o)
        d = jnp.where(active[:, None], wi_world, d)
        prev_pdf = sg(pdf)

        # --- Russian roulette ------------------------------------------
        if bounce + 1 >= cfg.rr_start:
            q = jnp.clip(jnp.max(sg(throughput), axis=-1), 0.05, 0.95)
            u_r = rng_mod.ray_uniform(keys, bounce, rng_mod.STREAM_RR,
                                      1)[:, 0]
            survive = u_r < q
            throughput = throughput / jnp.maximum(q, 1e-6)[:, None]
            active = active & survive

    if return_stats:
        return L, ray_count
    return L


def _nee_prepare(sp, wo, ls, throughput, active, mis: bool,
                 delta: bool = False):
    """BSDF-weighted NEE contribution for one light sample, WITHOUT the
    occlusion test: returns (wi_world, t_max, contrib_if_visible) so the
    caller can batch all light families into one shadow trace.  Hopeless
    lanes get t_max=0 (already-zero contribution): static shape, but the
    block tracer's bundle bounds and live-lane early exit skip them."""
    n = wo.shape[0]
    wi_w = sg(ls.wi)
    wi = math3d.to_local(wi_w, sp.tang, sp.bitang, sp.ns)
    f, pdf_b = eval_bsdf(sp.bsdf, wo, wi)
    cos_i = jnp.maximum(wi[..., 2], 0.0)
    cand = active & ls.valid & (sg(cos_i) > 1e-7) & (sg(ls.pdf) > 0.0)
    t_max = jnp.where(sg(cand), sg(ls.dist) * (1.0 - 1e-3), 0.0)
    w = _power_mis(ls.pdf, pdf_b) if (mis and not delta) else jnp.ones(
        (n,), jnp.float32)
    contrib = (throughput * f * ls.radiance
               * (cos_i * w / jnp.maximum(sg(ls.pdf), 1e-12))[:, None])
    contrib = jnp.where(cand[:, None], contrib, 0.0)
    return wi_w, t_max, contrib


# ---------------------------------------------------------------------------
# Full-frame rendering
# ---------------------------------------------------------------------------

def _wants_morton(scene: Scene, cfg: RenderConfig) -> bool:
    """Morton-order the ray stream when a cluster tracer will run: block
    coherence is what its candidate culling feeds on (core/morton.py).
    Other tracers are order-invariant — skip the unscramble gather."""
    return select_tracer(scene, cfg) in ("block", "triton")


def _sample_radiance(scene: Scene, camera: Camera, key: jax.Array,
                     cfg: RenderConfig, row_start=0,
                     n_rows: int | None = None, return_stats: bool = False,
                     tables=None):
    """One sample per pixel for a row band -> radiance [n_rows, W, 3].

    `key` is the per-sample base key; per-ray keys derive from GLOBAL pixel
    ids so a band render equals the corresponding slice of a full render —
    and so the morton PROCESSING order (block tracers) cannot change any
    pixel's random sequence, only which rays share a block.
    """
    if n_rows is None:
        n_rows = cfg.height
    if _wants_morton(scene, cfg):
        from ..core.morton import morton_pixel_ids
        # Band-LOCAL morton permutation (static shapes even when row_start
        # is a traced axis_index under shard_map); offset to global ids.
        local = jnp.asarray(morton_pixel_ids(n_rows, cfg.width))
        pix = local + jnp.asarray(row_start) * cfg.width
    else:
        row_ids = jnp.arange(n_rows) + row_start
        pix = (row_ids[:, None] * cfg.width
               + jnp.arange(cfg.width)).reshape(-1)
    keys = rng_mod.ray_keys(key, pix)
    jitter = rng_mod.ray_uniform(keys, 0, rng_mod.STREAM_PIXEL_JITTER, 2)
    px = (pix % cfg.width).astype(jnp.float32)
    py = (pix // cfg.width).astype(jnp.float32)
    o, d = generate_rays_at(camera, cfg.width, cfg.height, px, py, jitter)
    # Pixel footprint angle for ray-cone mip selection (ops/texture.py).
    cone_angle = (2.0 * jnp.tan(camera.fov_y * 0.5) / cfg.height
                  if scene.has_textures else None)
    out = trace_radiance(scene, o, d, keys, cfg, return_stats=return_stats,
                         cone_angle=cone_angle, tables=tables)
    L, count = out if return_stats else (out, None)
    if _wants_morton(scene, cfg):
        # Unscramble: one static scatter per sample pays for every trace's
        # coherence win.
        band = jnp.zeros((n_rows * cfg.width, 3), L.dtype)
        L = band.at[local].set(L)
    img = L.reshape(n_rows, cfg.width, 3)
    return (img, count) if return_stats else img


def render_sample(scene: Scene, camera: Camera, key: jax.Array,
                  cfg: RenderConfig, row_start=0,
                  n_rows: int | None = None) -> jnp.ndarray:
    """One sample per pixel for a row band -> radiance [n_rows, W, 3]."""
    return _sample_radiance(scene, camera, key, cfg, row_start, n_rows)


@partial(jax.jit, static_argnames=("cfg",))
def render(scene: Scene, camera: Camera, key: jax.Array,
           cfg: RenderConfig) -> Film:
    """Render cfg.spp samples, scanning over samples to bound memory."""
    film = Film.zeros(cfg.height, cfg.width)
    keys = jax.random.split(key, cfg.spp)
    tables = frame_tables(scene)

    def body(f, k):
        return f.add_samples(_sample_radiance(scene, camera, k, cfg,
                                              tables=tables)), None

    film, _ = jax.lax.scan(body, film, keys)
    return film


def render_image(scene: Scene, camera: Camera, seed: int,
                 cfg: RenderConfig) -> jnp.ndarray:
    """Convenience: render -> mean HDR image [H,W,3]."""
    return render(scene, camera, jax.random.key(seed), cfg).mean()


@partial(jax.jit, static_argnames=("cfg",))
def render_with_stats(scene: Scene, camera: Camera, key: jax.Array,
                      cfg: RenderConfig):
    """Render + exact ray-query count (for rays/s benchmarks)."""
    return _render_with_stats_dense(scene, camera, key, cfg)


def _render_with_stats_dense(scene: Scene, camera: Camera, key: jax.Array,
                             cfg: RenderConfig):
    """Dense render + ray-query count (scan over spp, or one batched
    stream of all spp when cfg.batch_spp)."""
    if cfg.batch_spp:
        return _render_batched_spp(scene, camera, key, cfg)
    film = Film.zeros(cfg.height, cfg.width)
    keys = jax.random.split(key, cfg.spp)
    tables = frame_tables(scene)

    def one(key):
        return _sample_radiance(scene, camera, key, cfg, return_stats=True,
                                tables=tables)

    def body(carry, k):
        f, c = carry
        radiance, count = one(k)
        return (f.add_samples(radiance), c + count), None

    (film, count), _ = jax.lax.scan(body, (film, jnp.zeros((),
                                                           jnp.float32)),
                                    keys)
    return film, count


def _render_batched_spp(scene: Scene, camera: Camera, key: jax.Array,
                        cfg: RenderConfig):
    """All cfg.spp samples as ONE trace stream.

    Rays order as [sample-major, morton-pixel within sample]... actually
    sample-INNER: consecutive rays are the spp jitters of the same morton
    pixel, so a block of B rays covers B/spp pixels — spp x tighter
    candidate bundles for every trace call, and per-call fixed costs
    amortize across samples.  Per-ray keys are the SAME
    (sample key, global pixel id) streams as the scan path, so images
    agree with it statistically (block composition only affects which
    conservative candidates are dropped, not the estimator).
    """
    assert cfg.exchange_axis is None, "batch_spp is single-device primal"
    from ..core.morton import morton_pixel_ids
    tables = frame_tables(scene)
    n_pix = cfg.height * cfg.width
    spp = cfg.spp
    skeys = jax.random.split(key, spp)

    if _wants_morton(scene, cfg):
        local = jnp.asarray(morton_pixel_ids(cfg.height, cfg.width))
    else:
        local = jnp.arange(n_pix)
    pix = jnp.repeat(local, spp)                         # sample-inner
    sample_id = jnp.tile(jnp.arange(spp), n_pix)
    keys_per_sample = jax.vmap(lambda k: rng_mod.ray_keys(k, local),
                               out_axes=1)(skeys)        # [n_pix, spp]
    keys = keys_per_sample.reshape(-1)
    jitter = rng_mod.ray_uniform(keys, 0, rng_mod.STREAM_PIXEL_JITTER, 2)
    px = (pix % cfg.width).astype(jnp.float32)
    py = (pix // cfg.width).astype(jnp.float32)
    o, d = generate_rays_at(camera, cfg.width, cfg.height, px, py, jitter)
    cone_angle = (2.0 * jnp.tan(camera.fov_y * 0.5) / cfg.height
                  if scene.has_textures else None)
    L, count = trace_radiance(scene, o, d, keys, cfg, return_stats=True,
                              cone_angle=cone_angle, tables=tables)
    del sample_id
    hdr = jnp.zeros((n_pix, 3), jnp.float32).at[pix].add(L)
    film = Film(hdr=hdr.reshape(cfg.height, cfg.width, 3),
                spp=jnp.asarray(spp, jnp.float32))
    return film, count

"""Runtime validation: the Vulkan-validation-layer / sanitizer analog.

The reference gates `VK_LAYER_KHRONOS_validation` behind a CLI flag
(`src/gltf_viewer/Main.cpp:22-23` -> `GpuHandle.cpp:35-37`) and compiles its
debug preset with ASan/UBSan (`CMakePresets.json:11`).  The XLA dataflow
model makes device races structurally absent (SURVEY.md section 5), so the
meaningful checks here are NUMERICAL: NaN/Inf generation and out-of-bounds
gathers inside the jitted render, surfaced by `jax.experimental.checkify`.

`checked_render` is the `--debug-checks` path of apps/render: it instruments
every gather in the jitted render with OOB-index checks (raising
`checkify.JaxRuntimeError` naming the failing site) and then verifies the
finished film is finite.  ~2x slower than the raw render — a debug mode,
exactly like the reference's validation flag.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify


class NonFiniteRenderError(FloatingPointError):
    """The rendered film contains NaN/Inf radiance."""


def checked_render(scene, camera, key, cfg):
    """Render with OOB-index checks instrumented + a finite-film check.

    Runs on the default device and pins the pure-XLA brute/BVH tracer:
    checkify cannot instrument Pallas kernel bodies, and the checks target
    the estimator math — the Pallas tracer is validated separately by
    interpret-mode equality tests.

    Why not `checkify.float_checks`: the integrator's masked-lane convention
    computes 1/det etc. unconditionally and discards the quotient with
    `jnp.where`, so NaN *generation* (what checkify flags) is routine on
    healthy renders even though no NaN ever reaches the film.  Instead we
    instrument gathers (`index_checks`) and assert the *output* is finite —
    the invariant the user actually cares about.
    """
    import dataclasses

    from ..integrator.path import render as _render

    cfg = dataclasses.replace(
        cfg, tracer="bvh" if scene.bvh is not None else "brute")

    def f(s, c, k):
        return _render(s, c, k, cfg)

    checked = checkify.checkify(f, errors=checkify.index_checks)
    err, film = jax.jit(checked)(scene, camera, key)
    err.throw()
    if not bool(jnp.isfinite(film.hdr).all()):
        bad = int(jnp.sum(~jnp.isfinite(film.hdr)))
        raise NonFiniteRenderError(
            f"rendered film contains {bad} non-finite value(s) "
            f"(NaN/Inf radiance reached the output)")
    return film

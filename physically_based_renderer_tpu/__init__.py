"""physically_based_renderer_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference Vulkan/C++ engine `WeaponizedSchizophrenia/physically-based-
renderer` (glTF 2.0 ingest, metallic-roughness materials with textures and
normal maps, HDR + ACES tonemapping, camera/scene-graph semantics),
re-realized as a wavefront Monte-Carlo light-transport estimator that is
end-to-end differentiable and shards across a device mesh.

Layer map (mirrors SURVEY.md section 7):
    core/        math, camera, RNG, film, tonemap, PNG   (reference L2-L3)
    scene/       glTF ingest -> flat SoA arenas, graph   (reference L5-L6)
    models/      BSDF / light / camera model families    (reference shaders)
    ops/         jnp + Pallas (Triton) compute kernels   (reference SPIR-V)
    accel/       LBVH build + traversal, cluster grid
    integrator/  masked-wavefront path tracing           (reference L4 render)
    grad/        adjoint estimator, inverse rendering
    parallel/    mesh sharding, collectives, multi-host  (new; ref has none)
    utils/       config, logging, profiling, checkpoint
    apps/        CLI renderer + inverse-rendering driver (reference L7)
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache.  JAX_COMPILATION_CACHE_DIR, when set, is
# JAX's own setting and is left alone; otherwise the cache lives at a fixed
# path inside the checkout (.jaxcache/, git-ignored), so every process run
# from this checkout shares it.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jaxcache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from .core.camera import Camera  # noqa: F401
from .core.film import Film  # noqa: F401
from .integrator.path import RenderConfig, render, render_image  # noqa: F401
from .scene.types import Scene, make_scene  # noqa: F401

"""Film: HDR accumulation buffer + LDR output.

Analog of the reference's HdrImage (RGBA16F render target,
`src/pbr_engine/engine/pbr/HdrImage.cpp:12-45`) + swapchain LDR image.  The
film is a plain pytree so it shards over image tiles (parallel/), accumulates
across sample batches (progressive rendering), and is differentiable.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from . import png, struct


@struct.dataclass
class Film:
    """Accumulated radiance. `hdr` holds the RUNNING SUM; `spp` the count."""

    hdr: jnp.ndarray  # f32[H, W, 3] sum of per-sample radiance
    spp: jnp.ndarray  # f32[] number of accumulated samples

    @classmethod
    def zeros(cls, height: int, width: int) -> "Film":
        return cls(hdr=jnp.zeros((height, width, 3), jnp.float32),
                   spp=jnp.zeros((), jnp.float32))

    def add_samples(self, radiance: jnp.ndarray, n: float = 1.0) -> "Film":
        """Accumulate radiance sum over n new samples ([H,W,3] already summed)."""
        return Film(hdr=self.hdr + radiance, spp=self.spp + n)

    def mean(self) -> jnp.ndarray:
        """Current radiance estimate f32[H,W,3]."""
        return self.hdr / jnp.maximum(self.spp, 1.0)

    def to_ldr(self) -> jnp.ndarray:
        """ACES+gamma display output in [0,1] (reference post chain)."""
        from . import tonemap
        return tonemap.aces_gamma(self.mean())


def to_u8(ldr: jnp.ndarray) -> np.ndarray:
    """[0,1] float image -> uint8, round-to-nearest (Unorm store semantics)."""
    arr = np.asarray(jnp.clip(ldr, 0.0, 1.0))
    return (arr * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, ldr: jnp.ndarray) -> None:
    """Write [H,W,3] float [0,1] as PNG (headless replacement for the
    reference's swapchain present, SURVEY.md section 2.11)."""
    png.write(path, to_u8(ldr))


def read_png(path: str) -> np.ndarray:
    rgba = png.to_rgba(png.read(path))
    return rgba[..., :3].astype(np.float32) / 255.0

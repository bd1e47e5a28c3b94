"""What the package needs from its environment: the compile-cache location,
PNG I/O and helmet ingest without Pillow, and the in-repo pytree dataclass
that stands in for flax.struct."""

import dataclasses
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_renderer_tpu.core import png, struct

REPO = Path(__file__).resolve().parents[1]


def _run(code: str, env_extra: dict, drop: tuple = ()) -> str:
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_dir(preset, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is left alone when set; otherwise the
    cache is the checkout's own .jaxcache/."""
    code = ("import jax, physically_based_renderer_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    if preset:
        got = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert got == str(tmp_path)
    else:
        got = _run(code, {}, drop=("JAX_COMPILATION_CACHE_DIR",))
        assert got == str(REPO / ".jaxcache")


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_roundtrip(channels, tmp_path):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (19, 23, channels)).astype(np.uint8)
    png.write(tmp_path / "x.png", img)
    back = png.read(tmp_path / "x.png")
    np.testing.assert_array_equal(back, img)
    rgba = png.to_rgba(back)
    assert rgba.shape == (19, 23, 4)
    if channels < 3:
        np.testing.assert_array_equal(rgba[..., 1], img[..., 0])


def _filtered_png(img: np.ndarray, ftypes) -> bytes:
    """Encode RGB rows with the given PNG filter per row (test oracle)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y, f in enumerate(ftypes):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    plain = png.encode(img)
    # swap the IDAT of the plain encoding for the filtered stream
    head = plain[:plain.index(b"IDAT") - 4]
    data = zlib.compress(b"".join(out))
    return head + png._chunk(b"IDAT", data) + png._chunk(b"IEND", b"")


def test_png_decodes_every_filter():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (10, 9, 3)).astype(np.uint8)
    data = _filtered_png(img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])
    np.testing.assert_array_equal(png.decode(data), img)


def test_helmet_ingest_and_png_without_pillow(tmp_path):
    """Author + ingest a small helmet .glb and write/read a PNG with
    Pillow made unimportable: the main path needs nothing beyond numpy."""
    code = f"""
import sys
sys.modules["PIL"] = None
import numpy as np
from physically_based_renderer_tpu.scene.helmet_asset import load_helmet_scene
from physically_based_renderer_tpu.core import film
s = load_helmet_scene(cache_dir={str(tmp_path)!r}, scale_tris=0.02)
assert s.textures.num_textures == 4 and s.geometry.num_tris > 1000
img = np.linspace(0, 1, 4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
film.write_png({str(tmp_path / "o.png")!r}, img)
back = film.read_png({str(tmp_path / "o.png")!r})
assert np.abs(back - img).max() <= 0.5 / 255 + 1e-6
print("ok", sorted(p.name for p in __import__("pathlib").Path(
    {str(tmp_path)!r}).glob("helmet_*.glb")))
"""
    got = _run(code, {})
    assert got.startswith("ok ['helmet_")


def test_helmet_cache_key_tracks_parameters():
    from physically_based_renderer_tpu.scene import helmet_asset as H
    a, b = H.helmet_asset_name(1.0), H.helmet_asset_name(0.5)
    assert a != b and a == H.helmet_asset_name(1.0)
    assert H.DEFAULT_CACHE_DIR == REPO / ".assets"


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray | None = None
    tag: str = struct.field(pytree_node=False, default="x")


def test_struct_pytree_roundtrip():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones((2,)), tag="t")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                       # the static tag is no leaf
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert q.tag == "t" and np.array_equal(q.a, p.a)
    r = p.replace(b=None)
    assert r.b is None and len(jax.tree_util.tree_leaves(r)) == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(3)
    out = jax.jit(lambda x: x.replace(a=x.a * 2.0))(p)
    np.testing.assert_array_equal(np.asarray(out.a), [0.0, 2.0, 4.0])
    assert out.tag == "t"
    g = jax.grad(lambda x: jnp.sum(x.a * x.b[0]))(p)
    np.testing.assert_array_equal(np.asarray(g.a), [1.0, 1.0, 1.0])
    # static fields are part of the treedef: a new tag is a new structure
    assert (jax.tree_util.tree_structure(p)
            != jax.tree_util.tree_structure(p.replace(tag="u")))

"""ctypes bindings for the native (C++) acceleration-structure builders.

Loads native/libpbr_native.so (built by `make -C native`); if absent,
attempts a one-shot build when a C++ toolchain exists, else falls back to
the numpy builders in accel/bvh.py / accel/clusters.py.  The native and
Python builders produce IDENTICAL output (same Morton presort + median
split; tests/test_native.py asserts bit-equality), so callers can treat
them interchangeably — native is simply ~20-50x faster at ingest for
DamagedHelmet-class meshes and above.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from .bvh import BVH, LEAF_SIZE
from .clusters import CLUSTER_K, ClusterGrid

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libpbr_native.so"
_lib = None
_tried = False


def _try_build() -> bool:
    src = _NATIVE_DIR / "bvh_builder.cpp"
    if not src.exists():
        return False
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception:
        return False


def load_library():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if os.environ.get("PBR_NO_NATIVE"):
        return None
    if not _LIB_PATH.exists() and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.pbr_build_bvh.restype = ctypes.c_int64
    lib.pbr_build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pbr_build_clusters.restype = ctypes.c_int64
    lib.pbr_build_clusters.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    if hasattr(lib, "pbr_build_alias"):  # older prebuilt .so may lack it
        lib.pbr_build_alias.restype = ctypes.c_int64
        lib.pbr_build_alias.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_bvh_native(positions, indices,
                     leaf_size: int = LEAF_SIZE) -> BVH:
    """C++ BVH build; raises RuntimeError if the library is unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable "
                           "(build with `make -C native`)")
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    t = indices.shape[0]
    cap = 2 * t + 1
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_left = np.empty((cap,), np.int32)
    node_right = np.empty((cap,), np.int32)
    tri_order = np.empty((t,), np.int32)
    n = lib.pbr_build_bvh(_fptr(positions), positions.shape[0],
                          _iptr(indices), t, leaf_size, _fptr(node_min),
                          _fptr(node_max), _iptr(node_left),
                          _iptr(node_right), _iptr(tri_order))
    if n < 0:
        raise ValueError("native BVH build failed (bad indices?)")
    return BVH(node_min=node_min[:n].copy(), node_max=node_max[:n].copy(),
               node_left=node_left[:n].copy(),
               node_right=node_right[:n].copy(), tri_order=tri_order)


def build_clusters_native(positions, indices,
                          k: int = CLUSTER_K) -> ClusterGrid:
    """C++ cluster build; raises RuntimeError if unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable "
                           "(build with `make -C native`)")
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    t = indices.shape[0]
    cap_c = -(-t // 1)  # every leaf has >= 1 tri -> at most t clusters
    amin = np.empty((cap_c, 3), np.float32)
    amax = np.empty((cap_c, 3), np.float32)
    tri_id = np.empty((cap_c, k), np.int32)
    c = lib.pbr_build_clusters(_fptr(positions), positions.shape[0],
                               _iptr(indices), t, k, _fptr(amin),
                               _fptr(amax), _iptr(tri_id))
    if c < 0:
        raise ValueError("native cluster build failed")
    from .clusters import _parent_boxes
    pmin, pmax = _parent_boxes(amin[:c], amax[:c])
    return ClusterGrid(aabb_min=amin[:c].copy(), aabb_max=amax[:c].copy(),
                       tri_id=tri_id[:c].copy(),
                       parent_min=pmin, parent_max=pmax)


def build_bvh_fast(positions, indices, leaf_size: int = LEAF_SIZE) -> BVH:
    """Native when available, numpy fallback otherwise."""
    if available():
        return build_bvh_native(positions, indices, leaf_size)
    from .bvh import build_bvh
    return build_bvh(positions, indices, leaf_size)


def build_clusters_fast(positions, indices, k: int = CLUSTER_K
                        ) -> ClusterGrid:
    if available():
        return build_clusters_native(positions, indices, k)
    from .clusters import build_clusters
    return build_clusters(positions, indices, k)


def build_alias_native(p: np.ndarray):
    """C++ Walker/Vose alias build; None if the library lacks it.

    The ingest path for multi-megatexel env maps (scene/types.py): the
    Python loop is ~2M iterations for a 2048x1024 HDR."""
    lib = load_library()
    if lib is None or not hasattr(lib, "pbr_build_alias"):
        return None
    p = np.ascontiguousarray(p, np.float64)
    n = p.size
    prob = np.empty((n,), np.float32)
    alias = np.empty((n,), np.int32)
    rc = lib.pbr_build_alias(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, _fptr(prob),
        _iptr(alias))
    if rc != 0:
        return None
    return prob, alias

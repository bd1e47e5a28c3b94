"""Pallas kernel (Triton route): phase B of the block tracer.

ops/blocktrace.py's phase A gives every ray block of B rays a nearest-first
list of candidate clusters.  Phase B intersects the block's rays with the
triangles of those clusters.  The plain XLA version (blocktrace._phase_b_xla)
scans every candidate of every block; this kernel walks the list per tile of
rays and stops early, which XLA's static shapes cannot express:

  grid = (NB * B / R,)  -- one program per tile of R rays; tiles of the same
                           ray block share its candidate list
  per program:
    * the tile's rays (origin, direction, t_max) are loaded once    [R]
    * a loop over the block's candidates j < n_valid, nearest first:
        - the cluster id is loaded from the candidate row, its K triangles
          from the soup ([C, 9, K] v0/e1/e2 component rows, a few MB that
          stay in L2), in sub-tiles of KT triangles;
        - dense [R, KT] Moller-Trumbore, running (min t, argmin) per ray or
          an occlusion flag (any-hit);
        - EARLY EXIT, closest hit: once every live ray's min(best t, t_max)
          lies before the next candidate's conservative entry distance
          (candidates are sorted by entry, so no later cluster can win);
          any-hit: once every live ray is occluded, or the next entry lies
          beyond the t_max of every ray still open.
  outputs: best_t f32[N], best_flat i32[N] (j * K + k, decoded to a
  triangle id by the caller), or the occlusion flag for any-hit.

Padding triangles need no mask: their soup rows are degenerate (v0 = 2e30,
e1 = e2 = 0), so det = 0, the masked inverse is 0, and t = 0 fails
`t > t_min` (t_min >= 0).  Dead rays carry t_max = 0 and take no part in
the exit tests.

The kernel compiles for NVIDIA GPUs only.  `interpret=True` runs the same
program on any backend, which is how the CPU tests run it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BIG = 1e30

# Tile: R rays x KT triangles per step, num_warps warps per program.  Chosen
# by the sweep in PERF.md (helmet frame on one H100); R must divide the
# tracer's ray block and KT the cluster width.
RAYS_PER_PROGRAM = 16
K_TILE = 32
NUM_WARPS = 4
NUM_STAGES = 1


def _mt(rays, soup_ref, base, kk, k, kt, t_min):
    """Moller-Trumbore of R rays against KT triangles -> (t, ok) [R, KT]."""
    rox, roy, roz, rdx, rdy, rdz, rtm = rays
    rows = [soup_ref[pl.ds(base + c * k + kk, kt)][None, :] for c in range(9)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = px * e1x + py * e1y + pz * e1z
    inv = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (rdx * qx + rdy * qy + rdz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > t_min) & (tt < rtm))
    return tt, ok


def _kernel(u_ref, nv_ref, entry_ref, ox, oy, oz, dx, dy, dz, tmax, soup_ref,
            t_out, flat_out, *, n_u, k, kt, tiles_per_block, t_min, any_hit,
            early_exit):
    g = pl.program_id(0) // tiles_per_block
    r = ox.shape[0]
    # Carries and outputs are [R]; the [R, 1] columns broadcast against
    # the [1, KT] triangle rows.
    rtm = tmax[...]
    rays = tuple(ref[...][:, None] for ref in (ox, oy, oz, dx, dy, dz, tmax))
    live = rtm > 0.0
    nv = nv_ref[g]
    row = g * n_u

    def next_entry(j):
        nxt = jnp.minimum(j + 1, n_u - 1)
        return jnp.where(j + 1 < nv, entry_ref[row + nxt], BIG)

    def body(carry):
        j, best_t, best_flat, occ, _ = carry
        base = u_ref[row + j] * (9 * k)
        if any_hit:
            for kk in range(0, k, kt):
                _, ok = _mt(rays, soup_ref, base, kk, k, kt, t_min)
                occ = jnp.maximum(occ, jnp.max(ok.astype(jnp.int32), axis=1))
            open_ = live & (occ == 0)
            rem = jnp.max(open_.astype(jnp.int32))
            rem_tmax = jnp.max(jnp.where(open_, rtm, 0.0))
            done = (rem == 0) | (next_entry(j) > rem_tmax)
        else:
            lane = jax.lax.broadcasted_iota(jnp.int32, (r, kt), 1)
            for kk in range(0, k, kt):
                tt, ok = _mt(rays, soup_ref, base, kk, k, kt, t_min)
                tt = jnp.where(ok, tt, BIG)
                tmin = jnp.min(tt, axis=1)
                kmin = jnp.min(jnp.where(tt <= tmin[:, None], lane, kt),
                               axis=1)
                better = tmin < best_t
                best_t = jnp.where(better, tmin, best_t)
                best_flat = jnp.where(better, j * k + kk + kmin, best_flat)
            worst = jnp.max(jnp.where(live, jnp.minimum(best_t, rtm), 0.0))
            done = worst <= next_entry(j)
        if not early_exit:
            # Never true, but traced: the Triton lowering cannot carry a
            # literal through a loop.
            done = j < 0
        return j + 1, best_t, best_flat, occ, done

    init = (jnp.int32(0),
            jnp.full((r,), BIG, jnp.float32),
            jnp.full((r,), -1, jnp.int32),
            jnp.zeros((r,), jnp.int32),
            jnp.zeros((), jnp.bool_))
    # A while loop, so the exit ends the program's work (a counted loop
    # with the rest skipped by a branch measured slower, PERF.md).
    _, best_t, best_flat, occ, _ = jax.lax.while_loop(
        lambda c: (c[0] < nv) & jnp.logical_not(c[4]), body, init)
    if any_hit:
        t_out[...] = occ.astype(jnp.float32)
        flat_out[...] = occ
    else:
        t_out[...] = best_t
        flat_out[...] = best_flat


@functools.partial(jax.jit, static_argnames=(
    "t_min", "any_hit", "interpret", "rays_per_program", "k_tile",
    "num_warps", "early_exit"))
def trace_blocks_triton(u_idx, n_valid, entry, o, d, t_max, soup, *,
                        t_min: float, any_hit: bool, interpret: bool = False,
                        rays_per_program: int = RAYS_PER_PROGRAM,
                        k_tile: int = K_TILE, num_warps: int = NUM_WARPS,
                        early_exit: bool = True):
    """Phase B over blocked rays.

    u_idx   i32[NB, U]   candidate clusters per ray block, nearest first
    n_valid i32[NB]      number of real candidates per block
    entry   f32[NB, U]   conservative entry distance of each candidate
    o, d    f32[NB, B, 3] rays (detached), t_max f32[NB, B] (0 = dead ray)
    soup    f32[C, 9, K] v0/e1/e2 component rows per cluster

    Returns (best_t f32[NB, B], best_flat i32[NB, B]); best_flat = j*K + k
    for candidate slot j and triangle lane k, -1 for a miss.  For any_hit,
    best_flat is the 0/1 occlusion flag.
    """
    nb, n_u = u_idx.shape
    b = o.shape[1]
    k = soup.shape[2]
    r = min(rays_per_program, b)
    kt = min(k_tile, k)
    if b % r or k % kt:
        raise ValueError(f"ray block {b} / cluster width {k} must be "
                         f"multiples of the tile {r} x {kt}")
    n = nb * b
    kernel = functools.partial(
        _kernel, n_u=n_u, k=k, kt=kt, tiles_per_block=b // r, t_min=t_min,
        any_hit=any_hit, early_exit=early_exit)
    # Under shard_map the outputs vary over the mesh axes the inputs do.
    vma = frozenset().union(*(jax.typeof(x).vma
                              for x in (u_idx, n_valid, entry, o, d, t_max)))
    tile = pl.BlockSpec((r,), lambda p: (p,))
    flat = lambda x: x.reshape(n)
    best_t, best_flat = pl.pallas_call(
        kernel,
        grid=(n // r,),
        in_specs=[pl.no_block_spec] * 3 + [tile] * 7 + [pl.no_block_spec],
        out_specs=[tile, tile],
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32, vma=vma),
                   jax.ShapeDtypeStruct((n,), jnp.int32, vma=vma)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="block_trace_any_hit" if any_hit else "block_trace_closest",
    )(u_idx.reshape(-1), n_valid, entry.reshape(-1),
      flat(o[..., 0]), flat(o[..., 1]), flat(o[..., 2]),
      flat(d[..., 0]), flat(d[..., 1]), flat(d[..., 2]), flat(t_max),
      soup.reshape(-1))
    return best_t.reshape(nb, b), best_flat.reshape(nb, b)

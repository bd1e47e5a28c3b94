"""Multi-host runtime initialization: the jax.distributed entry point.

The reference is a single-process, single-GPU program (one queue,
`src/pbr_engine/core/pbr/core/GpuHandle.cpp:76-80`); its only "cluster"
bootstrap is Vulkan instance/device creation (`GpuHandle.cpp:94-101`).  The
framework's analog is `jax.distributed.initialize`: one process per host,
each seeing its local devices, with XLA's collectives connecting them
(SURVEY.md section 2.10 "Comm backend").

Usage (one call, before any backend touch):

    from physically_based_renderer_tpu.parallel import distributed
    distributed.ensure_initialized()          # no-op single-process
    mesh = distributed.global_mesh()          # 1-D mesh over ALL chips

The coordinator address / process count / process id come from the
standard env vars (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
JAX_PROCESS_ID) or explicit arguments.
"""

from __future__ import annotations

import logging
import os

import jax
import numpy as np
from jax.sharding import Mesh

log = logging.getLogger("pbr.distributed")

_INITIALIZED = False


def is_multiprocess_env() -> bool:
    """True when env/args indicate a multi-process (multi-host) launch."""
    return (os.environ.get("JAX_COORDINATOR_ADDRESS") is not None
            or os.environ.get("COORDINATOR_ADDRESS") is not None
            or os.environ.get("JAX_NUM_PROCESSES", "1") not in ("", "1"))


def ensure_initialized(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None) -> bool:
    """Initialize jax.distributed exactly once when running multi-process.

    Single-process runs (tests, the one-chip bench box) skip initialization
    entirely — jax.distributed.initialize would hang waiting for peers.
    Returns True iff the distributed runtime is (now) initialized.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    explicit = coordinator_address or num_processes or process_id is not None
    if not (explicit or is_multiprocess_env()):
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    _INITIALIZED = True
    log.info("jax.distributed initialized: process %d/%d, %d local / %d "
             "global devices", jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return True


def global_mesh(axis_name: str = "tiles") -> Mesh:
    """1-D mesh over every chip of every host (jax.devices() is globally
    consistent across processes after ensure_initialized)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def hosts_chips_mesh(tile_axis: str = "tiles",
                     spp_axis: str = "spp") -> Mesh:
    """2-D (hosts, devices-per-host) mesh: image tiles across hosts, spp
    across each host's devices — the per-sample psum stays on the fast
    intra-host links, the slow axis carries only film assembly."""
    n_hosts = jax.process_count()
    per_host = jax.local_device_count()
    devs = np.asarray(jax.devices()).reshape(n_hosts, per_host)
    return Mesh(devs, (tile_axis, spp_axis))

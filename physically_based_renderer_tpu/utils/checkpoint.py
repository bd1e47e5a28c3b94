"""Checkpoint/resume for inverse rendering (orbax).

The reference persists nothing (SURVEY.md section 5 "Checkpoint/resume:
None"); this framework adds it for the inverse-rendering config —
optimizer state + recovered parameters survive preemption.  orbax is
imported lazily, only by checkpointing jobs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np


def save(path: str | Path, step: int, params: Any, opt_state: Any,
         extra: dict | None = None) -> None:
    """Save a training checkpoint (atomic: write tmp, rename)."""
    import orbax.checkpoint as ocp

    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    ckptr = ocp.StandardCheckpointer()
    target = path / f"step_{step:08d}"
    payload = {"params": params, "opt_state": opt_state,
               "extra": extra or {}}
    ckptr.save(target, payload, force=True)
    ckptr.wait_until_finished()
    (path / "LATEST").write_text(str(step))


def latest_step(path: str | Path) -> int | None:
    p = Path(path) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore(path: str | Path, abstract_payload: Any, step: int | None = None):
    """Restore (step, payload). abstract_payload mirrors the saved pytree
    (e.g. the freshly-initialized {params, opt_state, extra})."""
    import orbax.checkpoint as ocp

    path = Path(path).absolute()
    if step is None:
        step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    ckptr = ocp.StandardCheckpointer()
    payload = ckptr.restore(path / f"step_{step:08d}", abstract_payload)
    return step, payload


def save_npz(path: str | Path, **arrays) -> None:
    """Light-weight fallback: flat npz of named arrays (host copies)."""
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
